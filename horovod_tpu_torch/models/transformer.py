"""The flagship decoder — the port of ``horovod_tpu/models/transformer.py``
at tp = pp = 1: data parallel, and sequence parallel over the sp group
``hvd.init(sp=...)`` made.

Each layer's attention is one ``context_parallel_attention`` call on the
sp group (ring or Ulysses, ``cfg.sp_strategy``); at sp = 1 that is one
``flash_attention`` call (the port's CUDA kernels on a GPU), exactly as
the JAX model's attention is. Tokens are sharded along T over sp: learned
positions are sliced at this rank's offset and RoPE takes global
positions. Parameters keep the JAX layouts (``wqkv [d, 3, H, Dh]``,
``wo [H, Dh, d]``, ...), one set per layer, so ``params_from_jax`` maps
an ``init_params(cfg, key, n_stages=1)`` pytree onto the module
one-to-one. The numerics follow the JAX model: layer norm without bias in
fp32 (eps 1e-5) cast back, tanh-approximated GELU, the embedding plus
positions cast to ``cfg.dtype``, and fp32 logits from an fp32 head.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import state as _state
from ..common.state import resolve_device
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


def _sp_axis(device):
    """The sp group of the running world, or None (sp = 1) when
    ``hvd.init`` was not called. Raises for inputs on another device than
    the world's when sp > 1: they cannot be this rank's shard."""
    if not _state.is_initialized():
        return None
    axis = _state.axis_group("sp")
    world = _state.device()
    if axis.size > 1 and (device.type != world.type or None not in (
            device.index, world.index) and device.index != world.index):
        raise ValueError(
            f"sp={axis.size}: the model treats its input as this rank's "
            f"shard of the sequence, but the input is on {device} and the "
            f"sp ranks run on {_state.device()}; run a model on another "
            f"device outside the sp world")
    return axis


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        H, Hkv, Dh, d, Fd = (cfg.n_heads, cfg.kv_heads, cfg.d_head,
                             cfg.d_model, cfg.d_ff)
        dt = cfg.dtype
        self.cfg = cfg
        self.ln1 = _param((d,), torch.float32, device)
        if Hkv == H:
            self.wqkv = _param((d, 3, H, Dh), dt, device)
        else:
            self.wq = _param((d, H, Dh), dt, device)
            self.wkv = _param((d, 2, Hkv, Dh), dt, device)
        self.wo = _param((H, Dh, d), dt, device)
        self.ln2 = _param((d,), torch.float32, device)
        self.w1 = _param((d, Fd), dt, device)
        self.w2 = _param((Fd, d), dt, device)

    def forward(self, x, positions, axis=None, segment_ids=None,
                gathered_segment_ids=None):
        """x: this rank's ``[b, t, d]`` shard; ``positions``: its global
        token positions ``[t]``; ``axis``: the sp group (None: sp = 1)."""
        cfg = self.cfg
        b, t, d = x.shape
        H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.d_head
        h = _layernorm(x, self.ln1)
        if Hkv == H:
            qkv = (h @ self.wqkv.reshape(d, -1)).view(b, t, 3, H, Dh)
            q, k, v = qkv.unbind(2)
        else:
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
        x = x + attn.reshape(b, t, H * Dh) @ self.wo.reshape(H * Dh, d)
        h = _layernorm(x, self.ln2)
        y = F.gelu(h @ self.w1, approximate="tanh")
        return x + y @ self.w2


class Transformer(nn.Module):
    """Causal decoder returning fp32 logits ``[b, t, vocab]``.

    Parameters are drawn like the JAX ``init_params`` (normal, same
    scales, layer norms at one) from ``generator``, or from a generator
    seeded with ``seed``, on ``device`` (default ``cuda:<local_rank>``).
    """

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.use_moe:
            raise NotImplementedError(
                "MoE layers come with a later slice of the port")
        if cfg.remat:
            raise NotImplementedError(
                "remat comes with a later slice of the port")
        device = resolve_device(device)
        self.cfg = cfg
        d, V, dt = cfg.d_model, cfg.vocab, cfg.dtype
        self.embed = _param((V, d), dt, device)
        if not cfg.rope:
            self.pos = _param((cfg.max_seq, d), dt, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_ln = _param((d,), torch.float32, device)
        self.head = _param((d, V), dt, device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        H, Dh, d, Fd = cfg.n_heads, cfg.d_head, cfg.d_model, cfg.d_ff
        scales = {"embed": 0.02, "pos": 0.02, "wqkv": d ** -0.5,
                  "wq": d ** -0.5, "wkv": d ** -0.5, "wo": (H * Dh) ** -0.5,
                  "w1": d ** -0.5, "w2": Fd ** -0.5, "head": d ** -0.5}
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "final_ln"):
                p.fill_(1.0)
            else:
                noise = torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                p.copy_(noise * scales[leaf])

    def forward(self, tokens, segment_ids=None):
        """tokens (and optional packed ``segment_ids``): this rank's
        ``[b, t]`` shard, the sp axis's slice ``sp_rank * t`` onward of the
        global sequence. Returns this shard's fp32 logits."""
        cfg = self.cfg
        axis = _sp_axis(tokens.device)
        sp = 1 if axis is None else axis.size
        t = tokens.shape[1]
        t0 = 0 if axis is None else axis.rank * t
        x = self.embed[tokens]
        if not cfg.rope:
            if t0 + t > cfg.max_seq:
                raise ValueError(f"positions {t0}..{t0 + t} exceed max_seq "
                                 f"{cfg.max_seq}")
            x = x + self.pos[t0:t0 + t][None]
        x = x.to(cfg.dtype)
        positions = torch.arange(t0, t0 + t, device=tokens.device)
        gathered = None
        if segment_ids is not None and sp > 1 and resolve_strategy(
                cfg.sp_strategy, cfg.n_heads, cfg.kv_heads, sp) == "ulysses":
            # Once per forward, not once per layer.
            gathered = gather_segment_ids(segment_ids, axis)
        for layer in self.layers:
            x = layer(x, positions, axis, segment_ids, gathered)
        x = _layernorm(x, self.final_ln)
        return x.float() @ self.head.float()


def params_from_jax(params: Dict[str, np.ndarray],
                    cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """A ``Transformer`` state dict from the numpy leaves of the JAX
    package's ``init_params(cfg, key, n_stages=1)``: per-layer leaves
    ``[1, L, ...]`` become ``layers.<i>.<name>``; every value is cast to
    the dtype the module keeps it in."""
    out = {}
    for name, value in params.items():
        arr = np.array(value, dtype=np.float32)
        dtype = torch.float32 if name in ("ln1", "ln2", "final_ln") \
            else cfg.dtype
        if name in ("embed", "pos", "final_ln", "head"):
            out[name] = torch.from_numpy(arr).to(dtype)
            continue
        if arr.shape[0] != 1:
            raise NotImplementedError(
                f"param {name!r} has {arr.shape[0]} pipeline stages; "
                "pipeline parallelism comes with a later slice")
        for i in range(arr.shape[1]):
            out[f"layers.{i}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(arr[0, i])).to(dtype)
    return out


def check_parallelism(sp: int = 1, tp: int = 1, pp: int = 1) -> None:
    """This slice trains data and sequence parallel (any sp); tensor and
    pipeline parallelism come later."""
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if tp != 1 or pp != 1:
        raise NotImplementedError(
            f"tp={tp} pp={pp}: tensor and pipeline parallelism come with "
            "later slices of the port; this slice is data and sequence "
            "parallel")
