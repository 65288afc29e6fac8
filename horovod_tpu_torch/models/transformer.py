"""The flagship decoder — the port of ``horovod_tpu/models/transformer.py``:
data, sequence, tensor and pipeline parallel, with MoE experts over dp.

The mesh is the one ``hvd.init(sp=, tp=, pp=)`` made (``parallel/mesh.py``):

- **sp**: tokens are sharded along T; each layer's attention is one
  ``context_parallel_attention`` call on the sp group (ring or Ulysses,
  ``cfg.sp_strategy``); at sp = 1 that is one ``flash_attention`` call
  (the port's CUDA kernels on a GPU). Learned positions are sliced at
  this rank's offset and RoPE takes global positions.
- **tp** (Megatron): a layer holds H/tp query heads, Hkv/tp KV heads and
  d_ff/tp hidden units; ``copy_to_tp`` enters each sharded product and
  ``reduce_from_tp`` sums the partial outputs (the JAX model's
  ``lax.psum(..., "tp")``).
- **pp** (GPipe): a model holds its stage's n_layers/pp layers; the
  forward runs embed (stage 0) -> ``spmd_pipeline`` over
  ``n_microbatches`` -> final norm -> fp32 head on every stage.
- **ep**: with ``use_moe`` the FFN is ``parallel/moe.moe_layer`` over the
  dp group, each rank holding n_experts/dp experts.
- ``remat`` recomputes each layer in the backward
  (``torch.utils.checkpoint``, non-reentrant).

Parameters keep the JAX layouts (``wqkv [d, 3, H, Dh]``, ``wo [H, Dh,
d]``, ...), sliced along the dims the JAX ``_param_specs`` shard, so
``params_from_jax`` maps an ``init_params(cfg, key, n_stages=pp)`` pytree
onto each rank's module. The embedding and positions (pp > 1) and the
experts (dp > 1) name the group their gradient is reduced over
(``parallel/mesh.REDUCE_ATTR``). The numerics follow the JAX model:
layer norm without bias in fp32 (eps 1e-5) cast back, tanh-approximated
GELU in the dense FFN, fp32 experts with the exact GELU, the embedding
plus positions cast to ``cfg.dtype``, and fp32 logits from an fp32 head.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import state as _state
from ..common.state import resolve_device
from ..ops.collectives import copy_to_tp, reduce_from_tp
from ..parallel.mesh import REDUCE_ATTR
from ..parallel.moe import moe_layer
from ..parallel.pipeline import spmd_pipeline
from ..parallel.ulysses import (context_parallel_attention,
                                gather_segment_ids, resolve_strategy)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX model's configuration fields, with a torch dtype."""

    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    d_head: int = 16
    d_ff: int = 256
    n_layers: int = 4
    max_seq: int = 64
    use_moe: bool = False
    n_experts: int = 4
    d_expert: int = 128
    capacity_factor: float = 2.0
    moe_top_k: int = 1
    dtype: torch.dtype = torch.float32
    sp_strategy: str = "ring"
    attention_window: Optional[int] = None
    remat: bool = False
    n_kv_heads: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.n_kv_heads is not None:
            if self.n_kv_heads < 1:
                raise ValueError(
                    f"n_kv_heads must be >= 1, got {self.n_kv_heads}")
            if self.n_heads % self.n_kv_heads != 0:
                raise ValueError(
                    f"n_heads ({self.n_heads}) must divide by n_kv_heads "
                    f"({self.n_kv_heads})")
        if self.rope and self.d_head % 2 != 0:
            raise ValueError(f"rope needs an even d_head, got "
                             f"{self.d_head}")

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads


def _layernorm(x, scale):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * scale).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embeddings, rotate-half convention. x: [b, t, H, Dh]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[:, None].float() * freqs[None]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (None in (a.index, b.index)
                                 or a.index == b.index)


def _sp_axis(device):
    """The sp group of the running world, or None (sp = 1) when
    ``hvd.init`` was not called. Raises for inputs on another device than
    the world's when sp > 1: they cannot be this rank's shard."""
    if not _state.is_initialized():
        return None
    axis = _state.axis_group("sp")
    if axis.size > 1 and not _same_device(device, _state.device()):
        raise ValueError(
            f"sp={axis.size}: the model treats its input as this rank's "
            f"shard of the sequence, but the input is on {device} and the "
            f"sp ranks run on {_state.device()}; run a model on another "
            f"device outside the sp world")
    return axis


def _model_axes(device):
    """This rank's tp, pp and dp (expert) groups when the model is built
    on the device of the running world; (None, None, None) — one rank
    holding the whole model — outside it or before ``hvd.init``."""
    if not _state.is_initialized() or not _same_device(device,
                                                      _state.device()):
        return None, None, None
    return tuple(_state.axis_group(a) for a in ("tp", "pp", "dp"))


def _size(axis) -> int:
    return 1 if axis is None else axis.size


def _index(axis) -> int:
    return 0 if axis is None else axis.rank


# Per-layer leaves that are sharded: the leaf's dim (the JAX _param_specs
# without the [stage, layer] dims) and the mesh axis it is split over.
SHARDED = {"wqkv": (2, "tp"), "wq": (1, "tp"), "wkv": (2, "tp"),
           "wo": (0, "tp"), "w1": (1, "tp"), "w2": (0, "tp"),
           "we_in": (0, "dp"), "we_out": (0, "dp")}
REPLICATED = ("embed", "pos", "final_ln", "head")


def validate_mesh(cfg: "TransformerConfig", tp: int = 1, pp: int = 1,
                  dp: int = 1) -> None:
    """The JAX package's divisibility errors (``_validate_mesh_divisibility``)
    and the splits this model makes: heads, KV heads and d_ff over tp,
    layers over pp, experts over dp."""
    if cfg.n_heads % tp != 0:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must be divisible by the mesh's tp "
            f"axis ({tp}) — wq/wqkv shard the head dim over tp")
    if cfg.kv_heads % tp != 0:
        raise ValueError(
            f"kv_heads ({cfg.kv_heads}) must be divisible by the mesh's "
            f"tp axis ({tp}) — wkv shards the KV-head dim over tp; use "
            f"n_kv_heads that is a multiple of tp (or tp <= n_kv_heads)")
    if not cfg.use_moe and cfg.d_ff % tp != 0:
        raise ValueError(f"d_ff ({cfg.d_ff}) must be divisible by the tp "
                         f"axis ({tp}) — w1/w2 shard the hidden dim")
    if cfg.n_layers % pp != 0:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide into the "
                         f"pp axis's {pp} stages")
    if cfg.use_moe and cfg.n_experts % dp != 0:
        raise ValueError(f"n_experts ({cfg.n_experts}) must be divisible by "
                         f"the dp axis ({dp}) — experts shard over dp")


def _shard(x, leaf, tp, dp):
    """This rank's slice of a per-layer leaf ``x`` (numpy or torch):
    ``tp`` / ``dp`` are (index, size) pairs."""
    if leaf not in SHARDED:
        return x
    dim, axis = SHARDED[leaf]
    index, size = tp if axis == "tp" else dp
    n = x.shape[dim] // size
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * n, (index + 1) * n)
    return x[tuple(sl)]


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class DecoderLayer(nn.Module):
    """One decoder layer: the tp shard ``tp`` (of that many ranks) of its
    heads and hidden units, and ``n_experts / ep`` experts with MoE."""

    def __init__(self, cfg: TransformerConfig, device, tp: int = 1,
                 ep: int = 1):
        super().__init__()
        H, Hkv, Dh, d, Fd = (cfg.n_heads // tp, cfg.kv_heads // tp,
                             cfg.d_head, cfg.d_model, cfg.d_ff // tp)
        dt = cfg.dtype
        self.cfg = cfg
        self.ln1 = _param((d,), torch.float32, device)
        if cfg.kv_heads == cfg.n_heads:
            self.wqkv = _param((d, 3, H, Dh), dt, device)
        else:
            self.wq = _param((d, H, Dh), dt, device)
            self.wkv = _param((d, 2, Hkv, Dh), dt, device)
        self.wo = _param((H, Dh, d), dt, device)
        self.ln2 = _param((d,), torch.float32, device)
        if cfg.use_moe:
            E, Fe = cfg.n_experts // ep, cfg.d_expert
            self.gate = _param((d, cfg.n_experts), torch.float32, device)
            self.we_in = _param((E, d, Fe), dt, device)
            self.we_out = _param((E, Fe, d), dt, device)
        else:
            self.w1 = _param((d, Fd), dt, device)
            self.w2 = _param((Fd, d), dt, device)

    def forward(self, x, positions, axis=None, segment_ids=None,
                gathered_segment_ids=None, tp=None, ep=None):
        """x: this rank's ``[b, t, d]`` shard; ``positions``: its global
        token positions ``[t]``; ``axis``, ``tp``, ``ep``: the sp, tp and
        expert groups (None: one rank)."""
        cfg = self.cfg
        b, t, d = x.shape
        Dh = cfg.d_head
        h = copy_to_tp(_layernorm(x, self.ln1), tp)
        if cfg.kv_heads == cfg.n_heads:
            H = self.wqkv.shape[2]
            qkv = (h @ self.wqkv.reshape(d, -1)).view(b, t, 3, H, Dh)
            q, k, v = qkv.unbind(2)
        else:
            H, Hkv = self.wq.shape[1], self.wkv.shape[2]
            q = (h @ self.wq.reshape(d, -1)).view(b, t, H, Dh)
            kv = (h @ self.wkv.reshape(d, -1)).view(b, t, 2, Hkv, Dh)
            k, v = kv.unbind(2)
        if cfg.rope:
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
        # GQA K/V stay at their reduced width: the sp strategies carry
        # them at that width and expand them at the kernel boundary.
        attn = context_parallel_attention(
            q, k, v, axis, causal=True, strategy=cfg.sp_strategy,
            segment_ids=segment_ids,
            gathered_segment_ids=gathered_segment_ids,
            window=cfg.attention_window)
        out = attn.reshape(b, t, H * Dh) @ self.wo.reshape(H * Dh, d)
        x = x + reduce_from_tp(out, tp)
        h = _layernorm(x, self.ln2)
        if cfg.use_moe:
            y = moe_layer(h.reshape(b * t, d),
                          {"gate": self.gate, "w_in": self.we_in,
                           "w_out": self.we_out}, ep,
                          capacity_factor=cfg.capacity_factor,
                          top_k=cfg.moe_top_k).view(b, t, d)
        else:
            h = copy_to_tp(h, tp)
            y = reduce_from_tp(F.gelu(h @ self.w1, approximate="tanh")
                               @ self.w2, tp)
        return x + y


class Transformer(nn.Module):
    """Causal decoder returning fp32 logits ``[b, t, vocab]``.

    Built on ``device`` (default ``cuda:<local_rank>``) inside the running
    world, the model is this rank's shard: its pp stage's layers, its tp
    slice of each, its dp share of the experts. ``n_microbatches``: the
    pipeline's M (the local batch must divide by it). Parameters are drawn
    like the JAX ``init_params`` (normal, same scales, layer norms at
    one) from ``generator``, or from a generator seeded with ``seed``:
    every leaf is drawn whole and sliced, so a seed gives the same model
    at every tp, pp and dp.
    """

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 n_microbatches: int = 1):
        super().__init__()
        device = resolve_device(device)
        self.tp_axis, self.pp_axis, self.ep_axis = _model_axes(device)
        if not cfg.use_moe:
            self.ep_axis = None
        tp, pp, ep = map(_size, (self.tp_axis, self.pp_axis, self.ep_axis))
        validate_mesh(cfg, tp, pp, ep)
        if n_microbatches < 1:
            raise ValueError(f"n_microbatches must be >= 1, got "
                             f"{n_microbatches}")
        self.cfg = cfg
        self.n_microbatches = n_microbatches
        d, V, dt = cfg.d_model, cfg.vocab, cfg.dtype
        self.embed = _param((V, d), dt, device)
        if not cfg.rope:
            self.pos = _param((cfg.max_seq, d), dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, tp, ep)
                                    for _ in range(cfg.n_layers // pp))
        self.final_ln = _param((d,), torch.float32, device)
        self.head = _param((d, V), dt, device)
        # Gradient placement (mesh.REDUCE_ATTR): stage 0 alone uses the
        # embedding, so it is summed over the stages; an expert's gradient
        # already holds every dp rank's tokens, so it is summed over sp.
        if pp > 1:
            for p in (self.embed, getattr(self, "pos", None)):
                if p is not None:
                    setattr(p, REDUCE_ATTR, "stages")
        if ep > 1:
            for layer in self.layers:
                setattr(layer.we_in, REDUCE_ATTR, "sp")
                setattr(layer.we_out, REDUCE_ATTR, "sp")
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        self.reset_parameters(generator)

    def shard_coords(self) -> dict:
        """This model's slice of the global one, as ``params_from_jax``
        takes it."""
        return dict(stage=_index(self.pp_axis), n_stages=_size(self.pp_axis),
                    tp=(_index(self.tp_axis), _size(self.tp_axis)),
                    dp=(_index(self.ep_axis), _size(self.ep_axis)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every leaf of the global model (all stages, heads and
        experts) in the JAX package's order and keep this rank's slice."""
        cfg = self.cfg
        H, Dh, d, Fd = cfg.n_heads, cfg.d_head, cfg.d_model, cfg.d_ff
        scales = {"embed": 0.02, "pos": 0.02, "wqkv": d ** -0.5,
                  "wq": d ** -0.5, "wkv": d ** -0.5, "wo": (H * Dh) ** -0.5,
                  "w1": d ** -0.5, "w2": Fd ** -0.5, "head": d ** -0.5,
                  "gate": d ** -0.5, "we_in": d ** -0.5,
                  "we_out": cfg.d_expert ** -0.5}
        c = self.shard_coords()
        lps = len(self.layers)
        shapes = global_shapes(cfg)
        dev = self.embed.device

        def draw(leaf, p):
            if leaf in ("ln1", "ln2", "final_ln"):
                return None
            noise = torch.randn(shapes[leaf], generator=generator,
                                device=dev, dtype=torch.float32)
            return (noise * scales[leaf]).to(p.dtype)

        def fill(p, value):
            if value is not None:
                p.copy_(value)
            else:
                p.fill_(1.0)

        params = dict(self.named_parameters())
        for name in ("embed", "pos"):
            if name in params:
                fill(params[name], draw(name, params[name]))
        for stage in range(c["n_stages"]):
            for i in range(lps):
                for leaf, p in self.layers[i].named_parameters():
                    value = draw(leaf, p)
                    if stage == c["stage"]:
                        fill(p, None if value is None else
                             _shard(value, leaf, c["tp"], c["dp"]))
        for name in ("final_ln", "head"):
            fill(params[name], draw(name, params[name]))

    def forward(self, tokens, segment_ids=None):
        """tokens (and optional packed ``segment_ids``): this rank's
        ``[b, t]`` shard, the sp axis's slice ``sp_rank * t`` onward of the
        global sequence (the same on every tp and pp rank). Returns this
        shard's fp32 logits, on every pp stage."""
        cfg = self.cfg
        axis = _sp_axis(tokens.device)
        tp, ep, pp = self.tp_axis, self.ep_axis, self.pp_axis
        sp = _size(axis)
        b, t = tokens.shape
        M = self.n_microbatches
        if b % M:
            raise ValueError(f"local batch {b} does not split into "
                             f"{M} microbatches")
        t0 = 0 if axis is None else axis.rank * t
        if not cfg.rope and t0 + t > cfg.max_seq:
            raise ValueError(f"positions {t0}..{t0 + t} exceed max_seq "
                             f"{cfg.max_seq}")
        if _index(pp) == 0:
            x = self.embed[tokens]
            if not cfg.rope:
                x = x + self.pos[t0:t0 + t][None]
            x = x.to(cfg.dtype)
        else:   # only stage 0 reads the microbatches' values
            x = torch.zeros((b, t, cfg.d_model), dtype=cfg.dtype,
                            device=tokens.device)
        positions = torch.arange(t0, t0 + t, device=tokens.device)
        packed = segment_ids is not None
        ulysses = packed and sp > 1 and resolve_strategy(
            cfg.sp_strategy, cfg.n_heads // _size(tp),
            cfg.kv_heads // _size(tp), sp) == "ulysses"

        def stage(state):
            x, seg = state if packed else (state, None)
            # Once per stage call, not once per layer.
            gathered = gather_segment_ids(seg, axis) if ulysses else None
            for layer in self.layers:
                args = (x, positions, axis, seg, gathered, tp, ep)
                x = (checkpoint(layer, *args, use_reentrant=False)
                     if cfg.remat else layer(*args))
            return (x, seg) if packed else x

        mbs = x.reshape(M, b // M, t, cfg.d_model)
        if packed:
            mbs = (mbs, segment_ids.reshape(M, b // M, t))
        y = spmd_pipeline(stage, mbs, pp,
                          collect_fn=(lambda s: s[0]) if packed else None)
        x = _layernorm(y.reshape(b, t, cfg.d_model), self.final_ln)
        return x.float() @ self.head.float()


def global_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Every leaf's shape in the whole model, per layer for the layers'
    leaves (the JAX ``init_params`` shapes without [stage, layer])."""
    H, Hkv, Dh, d, V = (cfg.n_heads, cfg.kv_heads, cfg.d_head, cfg.d_model,
                        cfg.vocab)
    shapes = {"embed": (V, d), "pos": (cfg.max_seq, d), "ln1": (d,),
              "ln2": (d,), "wo": (H, Dh, d), "final_ln": (d,),
              "head": (d, V)}
    if Hkv == H:
        shapes["wqkv"] = (d, 3, H, Dh)
    else:
        shapes.update(wq=(d, H, Dh), wkv=(d, 2, Hkv, Dh))
    if cfg.use_moe:
        E, Fe = cfg.n_experts, cfg.d_expert
        shapes.update(gate=(d, E), we_in=(E, d, Fe), we_out=(E, Fe, d))
    else:
        shapes.update(w1=(d, cfg.d_ff), w2=(cfg.d_ff, d))
    return shapes


def params_from_jax(params: Dict[str, np.ndarray], cfg: TransformerConfig,
                    stage: int = 0, n_stages: int = 1,
                    tp=(0, 1), dp=(0, 1)) -> Dict[str, torch.Tensor]:
    """A ``Transformer`` state dict from the numpy leaves of the JAX
    package's ``init_params(cfg, key, n_stages)``, for the rank whose
    slice ``Transformer.shard_coords()`` names: pipeline ``stage``'s
    per-layer leaves ``[n_stages, L, ...]`` become ``layers.<i>.<name>``,
    each cut to the tp index of ``tp = (index, size)`` along the dim the
    JAX ``_param_specs`` shard (the experts to ``dp``'s share). Every value
    is cast to the dtype the module keeps it in."""
    out = {}
    for name, value in params.items():
        arr = np.array(value, dtype=np.float32)
        dtype = torch.float32 if name in ("ln1", "ln2", "final_ln", "gate") \
            else cfg.dtype
        if name in REPLICATED:
            out[name] = torch.from_numpy(arr).to(dtype)
            continue
        if arr.shape[0] != n_stages:
            raise ValueError(
                f"param {name!r} has {arr.shape[0]} pipeline stages; the "
                f"model has {n_stages}: build init_params with n_stages = pp")
        for i in range(arr.shape[1]):
            out[f"layers.{i}.{name}"] = torch.from_numpy(np.ascontiguousarray(
                _shard(arr[stage, i], name, tp, dp))).to(dtype)
    return out


def join_shards(shards, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: the JAX package's global leaves
    (per-layer leaves ``[n_stages, L, ...]``) from every rank's
    ``(shard_coords(), {name: array})``, say the parameters or gradients
    of each rank. A slice held by several ranks is taken from the last;
    ``params_from_jax`` of the result gives back each rank's own."""
    shapes = global_shapes(cfg)
    out: Dict[str, np.ndarray] = {}
    for coords, tensors in shards:
        n_stages = coords["n_stages"]
        lps = cfg.n_layers // n_stages
        for name, value in tensors.items():
            value = np.asarray(value, dtype=np.float32)
            if name in REPLICATED:
                out[name] = value
                continue
            _, i, leaf = name.split(".")
            arr = out.setdefault(leaf, np.zeros(
                (n_stages, lps, *shapes[leaf]), np.float32))
            _shard(arr[coords["stage"], int(i)], leaf, coords["tp"],
                   coords["dp"])[...] = value
    return out


def check_parallelism(sp: int = 1, tp: int = 1, pp: int = 1) -> None:
    """Every axis size must be at least 1 (the model checks its
    divisibility when it is built)."""
    for name, n in (("sp", sp), ("tp", tp), ("pp", pp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
