"""Flash attention: three hand-written Hopper kernels and their plain twins.

Counterpart of ``horovod_tpu/ops/pallas_attention.py``. Each kernel in
``csrc/flash_attention.cu`` has a wrapper here and a plain PyTorch version
of the same function beside it:

===================  ==============================  ==========================
wrapper              replaces (Pallas kernel)        plain version
===================  ==============================  ==========================
``flash_fwd``        ``_attn_kernel`` (fwd, train)   ``flash_fwd_plain``
``flash_fwd_state``  ``_attn_kernel_state`` (ring)   ``flash_fwd_state_plain``
``flash_bwd_dq``     ``_attn_bwd_dq_kernel``         ``flash_bwd_dq_plain``
``flash_bwd_dkv``    ``_attn_bwd_dkv_kernel``        ``flash_bwd_dkv_plain``
===================  ==============================  ==========================

``flash_fwd`` and ``flash_fwd_state`` are the three output modes of one
kernel. Every wrapper takes packed-sequence segment ids, and the backward
wrappers write fp32 outputs on request (``out_dtype``), as ring attention's
backward needs (``flash_attention_block_grads``).

Dispatch: a wrapper given CPU tensors computes its plain version; given
CUDA tensors it launches its kernel or raises. There is no other path —
no fallback for shapes the kernel does not take (those raise), and no CPU
path for a CUDA caller.

Layouts: q/k/v/dO are ``[B, T, H, D]``; ``lse``, ``delta``, ``m`` and
``l`` are fp32 ``[B, H, Tq]``; segment ids are integer ``[B, T]``. The
kernels read q/k/v/dO by strides.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Keys per tile of the forward kernel, by (dtype, head dim): the state
# mode's P is rounded to bf16 against the running max of each such tile,
# so a reference that rounds as the kernel does walks the keys in these
# tiles. The library reports the tile its launcher uses
# (``hvd_flash_fwd_key_tile``); ``chip_smoke.py`` holds the two equal.
FWD_KEY_TILE = {(torch.bfloat16, 64): 128, (torch.bfloat16, 128): 128,
                (torch.float32, 64): 64, (torch.float32, 128): 32}

# Launches of each kernel. flash_fwd counts its three output modes apart,
# and the backward kernels their fp32-output mode; a launch with segment
# ids counts under its mode's "_seg" name instead.
MODES = ("flash_fwd", "flash_fwd_train", "flash_fwd_state", "flash_bwd_dq",
         "flash_bwd_dkv", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
LAUNCHES = {name: 0 for mode in MODES for name in (mode, mode + "_seg")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(mode: str, q_seg) -> None:
    LAUNCHES[mode if q_seg is None else mode + "_seg"] += 1


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


def _masked_probs(q, k, causal, q_off, k_off, window, q_seg, k_seg):
    """(p = exp(s - m) under the masks, m, l), fp32, [B, H, Tq, Tk] and
    [B, H, Tq, 1]; a row with no visible key has m = -1e30 and l = 0."""
    s = _scores(q, k)
    allowed = _allowed(q, k, causal, q_off, k_off, window, q_seg, k_seg)
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    return p, m, p.sum(-1, keepdim=True)


def flash_fwd_plain(q, k, v, causal=True, q_off=0, k_off=0, window=None,
                    q_seg=None, k_seg=None, with_lse=False):
    """Plain version of ``flash_fwd`` (the JAX package's ``_xla_flash``,
    plus the train mode's lse): fp32 scores and softmax, O in q's dtype;
    rows with no visible key give O = 0 and lse = +1e30."""
    p, m, l = _masked_probs(q, k, causal, q_off, k_off, window, q_seg, k_seg)
    o = torch.einsum("bhts,bshd->bthd", p / l.clamp_min(1e-30), v.float())
    lse = None
    if with_lse:
        lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                          -NEG_INF)[..., 0]
    return o.to(q.dtype), lse


def flash_fwd_state_plain(q, k, v, causal=True, q_off=0, k_off=0,
                          window=None, q_seg=None, k_seg=None):
    """Plain version of ``flash_fwd_state`` (the JAX package's
    ``_xla_block_state``): (acc fp32 [B,Tq,H,D] = unnormalized P.V, m and
    l fp32 [B,H,Tq]). P is rounded to V's dtype before P.V, as the Pallas
    kernel does; the product accumulates in fp32."""
    p, m, l = _masked_probs(q, k, causal, q_off, k_off, window, q_seg, k_seg)
    acc = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    return acc, m[..., 0], l[..., 0]


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
                       k_off=0, window=None, q_seg=None, k_seg=None,
                       out_dtype=None):
    """Plain version of ``flash_bwd_dq``: dQ = dS.K in ``out_dtype``
    (default q's dtype)."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, q_off, k_off,
                               window, q_seg, k_seg)
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(
        out_dtype or q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True, q_off=0,
                        k_off=0, window=None, q_seg=None, k_seg=None,
                        out_dtype=None):
    """Plain version of ``flash_bwd_dkv``: dK = dS^T.Q, dV = P^T.dO in
    ``out_dtype`` (default k's and v's dtypes)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, q_off, k_off,
                               window, q_seg, k_seg)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


# ---- kernel wrappers --------------------------------------------------------


def _kernel_strides_ok(t: torch.Tensor) -> bool:
    """The kernels read 16 bytes at a time along a contiguous head dim;
    the bf16 kernels' TMA tensor maps also need a 16-byte-aligned base and
    b/t/h strides that are multiples of 16 bytes."""
    es = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * es % 16 == 0 for i in range(3)))


def _use_kernel(name, q, *tensors, q_seg=None, k_seg=None) -> bool:
    """True for CUDA inputs the kernel takes, False for CPU inputs (the
    plain version); raises for anything else. ``tensors`` starts with k
    and v."""
    segs = () if q_seg is None else (q_seg, k_seg)
    devices = {t.device for t in (q, *tensors, *segs)}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
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
    if segs:
        for ids, t in zip(segs, (q, tensors[0])):
            if ids.dtype.is_floating_point or ids.shape != t.shape[:2]:
                raise ValueError(f"{name}: segment ids must be integer "
                                 f"[B, T] = {list(t.shape[:2])}; got "
                                 f"{ids.dtype}{list(ids.shape)}")
    return True


def _row_stats_ok(name, q, *rows):
    B, Tq, H, _ = q.shape
    for r in rows:
        if r.dtype != torch.float32 or r.shape != (B, H, Tq) or \
                not r.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 "
                             f"[B, H, Tq] = {[B, H, Tq]}")


def _ids(seg):
    """Segment ids as the kernels read them: int32 [B, T], contiguous
    (None passes through)."""
    return None if seg is None else seg.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _out_f32(name, q, out_dtype) -> bool:
    if out_dtype not in (None, q.dtype, torch.float32):
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported "
                         f"(None, the input dtype or float32)")
    return out_dtype == torch.float32


def _launch_fwd(q, k, v, o, lse, m, l, causal, q_off, k_off, window, q_seg,
                k_seg):
    """One launch of the forward kernel in the mode its outputs select."""
    B, Tq, H, D = q.shape
    q_ids, k_ids = _ids(q_seg), _ids(k_seg)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), _ptr(m),
            _ptr(l), _ptr(q_ids), _ptr(k_ids), _strides(q, k, v, o),
            int(causal), q_off, k_off, window or 0, _scale(q), _stream(q))
    _build.check(lib, err, "flash_fwd")


def flash_fwd(q, k, v, causal=True, q_off=0, k_off=0, window=None,
              q_seg=None, k_seg=None, with_lse=False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward: (O [B,Tq,H,D] in q's dtype, lse fp32 [B,H,Tq]
    when ``with_lse`` (the train mode), else None)."""
    if not _use_kernel("flash_fwd", q, k, v, q_seg=q_seg, k_seg=k_seg):
        return flash_fwd_plain(q, k, v, causal, q_off, k_off, window, q_seg,
                               k_seg, with_lse)
    B, Tq, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch_fwd(q, k, v, o, lse, None, None, causal, q_off, k_off, window,
                q_seg, k_seg)
    _launched("flash_fwd_train" if with_lse else "flash_fwd", q_seg)
    return o, lse


def flash_fwd_state(q, k, v, causal=True, q_off=0, k_off=0, window=None,
                    q_seg=None, k_seg=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's state mode, one K/V block's unmerged online-softmax
    state: (acc fp32 [B,Tq,H,D] unnormalized, m and l fp32 [B,H,Tq]). A
    block with no visible key gives acc = 0, m = -1e30, l = 0."""
    if not _use_kernel("flash_fwd_state", q, k, v, q_seg=q_seg, k_seg=k_seg):
        return flash_fwd_state_plain(q, k, v, causal, q_off, k_off, window,
                                     q_seg, k_seg)
    B, Tq, H, D = q.shape
    acc = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m, l = torch.empty((2, B, H, Tq), dtype=torch.float32,
                       device=q.device).unbind(0)
    _launch_fwd(q, k, v, acc, None, m, l, causal, q_off, k_off, window,
                q_seg, k_seg)
    _launched("flash_fwd_state", q_seg)
    return acc, m, l


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, q_off=0, k_off=0,
                 window=None, q_seg=None, k_seg=None,
                 out_dtype=None) -> torch.Tensor:
    """dQ [B,Tq,H,D] in ``out_dtype`` (default q's dtype; float32 for the
    ring's accumulation) from the saved lse and delta."""
    if not _use_kernel("flash_bwd_dq", q, k, v, do, lse, delta, q_seg=q_seg,
                       k_seg=k_seg):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, q_off,
                                  k_off, window, q_seg, k_seg, out_dtype)
    _row_stats_ok("flash_bwd_dq", q, lse, delta)
    out_f32 = _out_f32("flash_bwd_dq", q, out_dtype)
    B, Tq, H, D = q.shape
    dq = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    q_ids, k_ids = _ids(q_seg), _ids(k_seg)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _ptr(q_ids), _ptr(k_ids),
            _strides(q, k, v, do, dq), int(out_f32), int(causal), q_off,
            k_off, window or 0, _scale(q), _stream(q))
    _build.check(lib, err, "flash_bwd_dq")
    _launched("flash_bwd_dq_f32" if out_dtype == torch.float32
              else "flash_bwd_dq", q_seg)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, q_off=0, k_off=0,
                  window=None, q_seg=None, k_seg=None, out_dtype=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Tk,H,D] in ``out_dtype`` (default k's/v's dtype) from
    the saved lse and delta."""
    if not _use_kernel("flash_bwd_dkv", q, k, v, do, lse, delta,
                       q_seg=q_seg, k_seg=k_seg):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, q_off,
                                   k_off, window, q_seg, k_seg, out_dtype)
    _row_stats_ok("flash_bwd_dkv", q, lse, delta)
    out_f32 = _out_f32("flash_bwd_dkv", q, out_dtype)
    B, Tq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=out_dtype or k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype or v.dtype, device=q.device)
    q_ids, k_ids = _ids(q_seg), _ids(k_seg)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dkv(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(q_ids),
            _ptr(k_ids), _strides(q, k, v, do, dk, dv), int(out_f32),
            int(causal), q_off, k_off, window or 0, _scale(q), _stream(q))
    _build.check(lib, err, "flash_bwd_dkv")
    _launched("flash_bwd_dkv_f32" if out_dtype == torch.float32
              else "flash_bwd_dkv", q_seg)
    return dk, dv


def kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels read it by strides, else a
    contiguous copy (a CPU tensor is returned as it is)."""
    if t.device.type == "cuda" and not _kernel_strides_ok(t):
        return t.contiguous()
    return t


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
        do = kernel_ready(do)
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


def flash_attention_block(q, k, v, q_off, k_off, causal: bool = True,
                          q_segment_ids=None, k_segment_ids=None,
                          window: Optional[int] = None):
    """One K/V block's unmerged attention state for ring attention.

    q/k/v: ``[B, T, H, D]``. Returns (acc fp32 ``[B, Tq, H, D]``
    (unnormalized P.V), m fp32 ``[B, H, Tq]``, l fp32 ``[B, H, Tq]``):
    merge blocks with the online-softmax combine. Runs the forward
    kernel's state mode; records no autograd (the ring's own backward
    calls ``flash_attention_block_grads``).
    """
    _require_both_segs(q_segment_ids, k_segment_ids)
    _check_window(window, causal)
    return flash_fwd_state(q, k, v, causal, q_off, k_off, window,
                           q_segment_ids, k_segment_ids)


def flash_attention_block_grads(q, k, v, do, lse, delta, q_off, k_off,
                                causal: bool = True, q_segment_ids=None,
                                k_segment_ids=None,
                                window: Optional[int] = None):
    """One K/V block's (dq, dk, dv) for ring attention's backward pass.

    q/k/v/do: ``[B, T, H, D]``; lse/delta: fp32 ``[B, H, Tq]`` — the
    GLOBAL row statistics (lse over all keys, delta = rowsum(dO*O)), so
    each block's P = exp(S - lse) is already globally normalized and the
    per-block gradients simply sum across the ring. Returns fp32 tensors
    in the ``[B, T, H, D]`` layout, so the ring sums blocks in fp32.
    """
    _require_both_segs(q_segment_ids, k_segment_ids)
    _check_window(window, causal)
    args = (q, k, v, do, lse, delta, causal, q_off, k_off, window,
            q_segment_ids, k_segment_ids)
    dq = flash_bwd_dq(*args, out_dtype=torch.float32)
    dk, dv = flash_bwd_dkv(*args, out_dtype=torch.float32)
    return dq, dk, dv
