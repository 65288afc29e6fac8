"""The flagship decoder, data parallel only — the port of
``horovod_tpu/models/transformer.py`` at dp = world size, sp = tp = pp = 1.

Each layer's attention is one ``flash_attention`` call (the port's CUDA
kernels on a GPU), exactly as the JAX model's attention is at sp = 1.
Parameters keep the JAX layouts (``wqkv [d, 3, H, Dh]``,
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

from ..common.state import resolve_device
from ..ops.flash_attention import flash_attention


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


def _expand_kv(k, v, g):
    """GQA: KV head j serves query heads j*g .. j*g+g-1 (consecutive
    repeat, as the JAX package's ``_expand_kv``)."""
    if g <= 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


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

    def forward(self, x):
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
            pos = torch.arange(t, device=x.device)
            q = _rope(q, pos, cfg.rope_theta)
            k = _rope(k, pos, cfg.rope_theta)
        k, v = _expand_kv(k, v, H // Hkv)
        attn = flash_attention(q, k, v, causal=True,
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
        if segment_ids is not None:
            raise NotImplementedError(
                "packed segment ids come with the ring-attention slice of "
                "the port")
        t = tokens.shape[1]
        x = self.embed[tokens]
        if not self.cfg.rope:
            x = x + self.pos[:t][None]
        x = x.to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x)
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
    """This slice trains data parallel only."""
    if sp != 1 or tp != 1 or pp != 1:
        raise NotImplementedError(
            f"sp={sp} tp={tp} pp={pp}: sequence (ring/Ulysses), tensor and "
            "pipeline parallelism come with later slices of the port; this "
            "slice is data parallel only")
