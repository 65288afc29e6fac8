"""Flash attention: three hand-written Hopper kernels and their plain twins.

Counterpart of ``horovod_tpu/ops/pallas_attention.py``. Each kernel in
``csrc/flash_attention.cu`` has a wrapper here and a plain PyTorch version
of the same function beside it:

=================  ==============================  =========================
wrapper            replaces (Pallas kernel)        plain version
=================  ==============================  =========================
``flash_fwd``      ``_attn_kernel`` (fwd, train)   ``flash_fwd_plain``
``flash_bwd_dq``   ``_attn_bwd_dq_kernel``         ``flash_bwd_dq_plain``
``flash_bwd_dkv``  ``_attn_bwd_dkv_kernel``        ``flash_bwd_dkv_plain``
=================  ==============================  =========================

Dispatch: a wrapper given CPU tensors computes its plain version; given
CUDA tensors it launches its kernel or raises. There is no other path —
no fallback for shapes the kernel does not take (those raise), and no CPU
path for a CUDA caller.

Layouts: q/k/v/dO are ``[B, T, H, D]``; ``lse`` and ``delta`` are fp32
``[B, H, Tq]``. The kernels read q/k/v/dO by strides.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel (flash_fwd counts its two output modes apart).
LAUNCHES = {"flash_fwd": 0, "flash_fwd_train": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require_both_segs(q_seg, k_seg):
    if (q_seg is None) != (k_seg is None):
        raise ValueError("pass both q_segment_ids and k_segment_ids")


def _check_window(window, causal):
    if window is None:
        return
    if not causal:
        raise ValueError("sliding-window attention is defined for the "
                         "causal case; pass causal=True with window")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


# ---- plain versions ---------------------------------------------------------


def _scale(q) -> float:
    return 1.0 / (q.shape[-1] ** 0.5)


def _allowed(q, k, causal, q_off, k_off, window, q_seg, k_seg):
    """Visibility of each (query, key) pair, broadcastable to
    ``[B, H, Tq, Tk]``, or None when every pair is visible."""
    allowed = None
    if causal:
        iq = torch.arange(q.shape[1], device=q.device)[:, None] + q_off
        ik = torch.arange(k.shape[1], device=q.device)[None, :] + k_off
        allowed = iq >= ik
        if window is not None:
            allowed = allowed & (iq - ik < window)
    if q_seg is not None:
        same = q_seg[:, None, :, None] == k_seg[:, None, None, :]
        allowed = same if allowed is None else allowed & same
    return allowed


def _scores(q, k):
    return torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * _scale(q)


def flash_fwd_plain(q, k, v, causal=True, q_off=0, k_off=0, window=None,
                    q_seg=None, k_seg=None, with_lse=False):
    """Plain version of ``flash_fwd`` (the JAX package's ``_xla_flash``,
    plus the train mode's lse): fp32 scores and softmax, O in q's dtype;
    rows with no visible key give O = 0 and lse = +1e30."""
    s = _scores(q, k)
    allowed = _allowed(q, k, causal, q_off, k_off, window, q_seg, k_seg)
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p / l.clamp_min(1e-30), v.float())
    lse = None
    if with_lse:
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                          -NEG_INF)[..., 0]
    return o.to(q.dtype), lse


def _probs_and_dscores(q, k, v, do, lse, delta, causal, q_off, k_off, window,
                       q_seg, k_seg):
    """P = exp(S - lse) under the masks, and dS = P * (dO.V^T - delta) *
    scale, both fp32 ``[B, H, Tq, Tk]`` (``_xla_block_grads``' math)."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    allowed = _allowed(q, k, causal, q_off, k_off, window, q_seg, k_seg)
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * _scale(q)
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True, q_off=0,
                       k_off=0, window=None, q_seg=None, k_seg=None):
    """Plain version of ``flash_bwd_dq``: dQ = dS.K in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, q_off, k_off,
                               window, q_seg, k_seg)
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True, q_off=0,
                        k_off=0, window=None, q_seg=None, k_seg=None):
    """Plain version of ``flash_bwd_dkv``: dK = dS^T.Q, dV = P^T.dO."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, q_off, k_off,
                               window, q_seg, k_seg)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---- kernel wrappers --------------------------------------------------------


def _kernel_strides_ok(t: torch.Tensor) -> bool:
    """The kernels read 16 bytes at a time along a contiguous head dim."""
    es = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * es % 16 == 0 for i in range(3)))


def _use_kernel(name, q, *tensors, q_seg=None) -> bool:
    """True for CUDA inputs the kernel takes, False for CPU inputs (the
    plain version); raises for anything else."""
    devices = {t.device for t in (q, *tensors)}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q_seg is not None:
        raise NotImplementedError(
            f"{name}: segment ids inside the CUDA kernels come with the "
            "ring-attention slice; the plain version (CPU) takes them")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    B, _, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit")
    for t in (q, *tensors[:3]):
        if t.dtype != q.dtype or t.dim() != 4 or t.shape[0] != B or \
                t.shape[2:] != q.shape[2:] or t.shape[1] < 1:
            raise ValueError(f"{name}: tensors must share dtype, batch, "
                             f"heads and head dim; got {q.dtype}{list(q.shape)}"
                             f" and {t.dtype}{list(t.shape)}")
        if not _kernel_strides_ok(t):
            raise ValueError(f"{name}: strides {t.stride()} not taken (head "
                             f"dim contiguous, strides and pointer 16-byte "
                             f"aligned)")
    return True


def _row_stats_ok(name, q, *rows):
    B, Tq, H, _ = q.shape
    for r in rows:
        if r.dtype != torch.float32 or r.shape != (B, H, Tq) or \
                not r.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 "
                             f"[B, H, Tq] = {[B, H, Tq]}")


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, causal=True, q_off=0, k_off=0, window=None,
              q_seg=None, k_seg=None, with_lse=False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward: (O [B,Tq,H,D] in q's dtype, lse fp32 [B,H,Tq]
    when ``with_lse`` (the train mode), else None)."""
    if not _use_kernel("flash_fwd", q, k, v, q_seg=q_seg):
        return flash_fwd_plain(q, k, v, causal, q_off, k_off, window, q_seg,
                               k_seg, with_lse)
    B, Tq, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _strides(q, k, v, o), int(causal), q_off, k_off, window or 0,
            _scale(q), _stream(q))
    _build.check(lib, err, "flash_fwd")
    LAUNCHES["flash_fwd_train" if with_lse else "flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, q_off=0, k_off=0,
                 window=None, q_seg=None, k_seg=None) -> torch.Tensor:
    """dQ [B,Tq,H,D] in q's dtype from the saved lse and delta."""
    if not _use_kernel("flash_bwd_dq", q, k, v, do, lse, delta, q_seg=q_seg):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, q_off,
                                  k_off, window, q_seg, k_seg)
    _row_stats_ok("flash_bwd_dq", q, lse, delta)
    B, Tq, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, dq),
            int(causal), q_off, k_off, window or 0, _scale(q), _stream(q))
    _build.check(lib, err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, q_off=0, k_off=0,
                  window=None, q_seg=None, k_seg=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Tk,H,D] in k's/v's dtype from the saved lse and delta."""
    if not _use_kernel("flash_bwd_dkv", q, k, v, do, lse, delta,
                       q_seg=q_seg):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, q_off,
                                   k_off, window, q_seg, k_seg)
    _row_stats_ok("flash_bwd_dkv", q, lse, delta)
    B, Tq, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dkv(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), int(causal), q_off, k_off,
            window or 0, _scale(q), _stream(q))
    _build.check(lib, err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---- autograd ---------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Training attention: the forward saves lse; the backward computes
    delta = rowsum(dO * O) in fp32 as plain torch (it lies outside the
    Pallas kernels in the JAX package too), then launches dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, causal, q_off, k_off, window):
        o, lse = flash_fwd(q, k, v, causal, q_off, k_off, window, q_seg,
                           k_seg, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.segs = (q_seg, k_seg)
        ctx.args = (causal, q_off, k_off, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        q_seg, k_seg = ctx.segs
        causal, q_off, k_off, window = ctx.args
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        if do.device.type == "cuda" and not _kernel_strides_ok(do):
            do = do.contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, q_off, k_off,
                          window, q_seg, k_seg)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, q_off, k_off,
                               window, q_seg, k_seg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, q_off: int = 0,
                    k_off: int = 0, q_segment_ids=None, k_segment_ids=None,
                    window: Optional[int] = None):
    """Flash attention on ``[B, T, H, D]`` tensors.

    ``q_off``/``k_off`` are the global token offsets of the blocks (the
    causal mask compares global positions). ``q_segment_ids`` /
    ``k_segment_ids`` (int ``[B, T]``) restrict attention to equal ids
    (packed sequences). ``window`` (causal only): each query sees itself
    and the ``window - 1`` keys before it.

    When autograd records (grad enabled and an input requires grad) the
    call runs the train-mode forward and the two backward kernels;
    otherwise it runs the plain-mode forward alone.
    """
    _require_both_segs(q_segment_ids, k_segment_ids)
    _check_window(window, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_segment_ids, k_segment_ids,
                                     causal, q_off, k_off, window)
    o, _ = flash_fwd(q, k, v, causal, q_off, k_off, window, q_segment_ids,
                     k_segment_ids)
    return o
