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
backward needs (``flash_attention_block_grads``). With bf16 and fp16
inputs the kernels read the ids through id tables (``IdTables``) that the
first launch of a call builds and its later launches share.

Dispatch: a wrapper given CPU tensors computes its plain version; given
CUDA tensors it launches its kernel or raises. There is no other path —
no fallback for shapes the kernel does not take (those raise), and no CPU
path for a CUDA caller.

Layouts: q/k/v/dO are ``[B, T, H, D]``; ``lse``, ``delta``, ``m`` and
``l`` are fp32 ``[B, H, Tq]``; segment ids are integer ``[B, T]``. The
kernels read q/k/v/dO by strides.

Dtypes and head dims: the kernels take fp32, bf16 and fp16 inputs
(``DTYPES``; the JAX attention's float dtypes) at any head dim D >= 1. D
up to 256 runs at the smallest tile width of ``D_TILES`` that holds it;
past 256 the kernels run the 256 width in chunks of 256 output columns
on the grid, each reducing S (and dP) over the whole head dim
(``kernel_layout``). An operand whose rows the kernels cannot read in
place (D not a whole number of 16-byte words, or a pointer or stride off
16 bytes) is copied into a contiguous buffer with D padded with zeros to a
multiple of 8 (``needs_copy``; counted in ``LAYOUT_COPIES``), the same
kernel runs on it, and the outputs are sliced back to D. Other dtypes and
D < 1 raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
# The head-dim tile widths the kernels are built at: a head dim D runs at
# the smallest that holds it, with D itself passed at run time; past the
# last, in chunks of that width.
D_TILES = (64, 128, 256)
# The input dtypes the kernels take, by their code in the C interface.
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DTYPES = tuple(_DTYPE_CODE)

# Keys per tile of the forward kernel, by (dtype, tile width): the state
# mode's P is rounded to the inputs' dtype against the running max of each
# such tile, so a reference that rounds as the kernel does walks the keys
# in these tiles. The library reports the tile its launcher uses
# (``hvd_flash_fwd_key_tile``); ``chip_smoke.py`` holds the two equal.
FWD_KEY_TILE = {(torch.bfloat16, 64): 128, (torch.bfloat16, 128): 128,
                (torch.bfloat16, 256): 64, (torch.float16, 64): 128,
                (torch.float16, 128): 128, (torch.float16, 256): 64,
                (torch.float32, 64): 64, (torch.float32, 128): 32,
                (torch.float32, 256): 32}

# Launches of each kernel. flash_fwd counts its three output modes apart,
# and the backward kernels their fp32-output mode; a launch with segment
# ids counts under its mode's "_seg" name instead.
MODES = ("flash_fwd", "flash_fwd_train", "flash_fwd_state", "flash_bwd_dq",
         "flash_bwd_dkv", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
LAUNCHES = {name: 0 for mode in MODES for name in (mode, mode + "_seg")}
# Operands each wrapper copied into the kernels' layout (``needs_copy``):
# a main path whose tensors the kernels read in place makes none.
LAYOUT_COPIES = {name: 0 for name in ("flash_fwd", "flash_fwd_state",
                                      "flash_bwd_dq", "flash_bwd_dkv")}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``LAYOUT_COPIES``."""
    for counts in (LAUNCHES, LAYOUT_COPIES):
        for name in counts:
            counts[name] = 0


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
    l fp32 [B,H,Tq]). P is rounded to V's dtype (bf16 or fp16; P <= 1, so
    fp16 cannot overflow) before P.V, as the Pallas kernel does; the
    product accumulates in fp32."""
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


def kernel_layout(D: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(D_T, D_k) of head dim D: the tile width the kernels run it at (the
    smallest of ``D_TILES`` that holds it; past the last, that width in
    chunks of D_T output columns, ``chunks``) and the head dim they read,
    D itself when a row of D values is a whole number of 16-byte words,
    else D padded to the next multiple of 8 (16-bit D % 8, fp32 D % 4: TMA
    and the 16-byte loads read whole words). Raises for a dtype without
    kernels and for D < 1."""
    if dtype not in _DTYPE_CODE:
        names = ", ".join(str(d).replace("torch.", "") for d in DTYPES)
        raise ValueError(f"dtype {dtype} not supported ({names})")
    if D < 1:
        raise ValueError(f"head dim {D} not supported (at least 1)")
    es = torch.finfo(dtype).bits // 8
    Dk = D if D * es % 16 == 0 else -(-D // 8) * 8
    return next((t for t in D_TILES if D <= t), D_TILES[-1]), Dk


def chunks(D: int, dtype: torch.dtype) -> int:
    """The kernels' chunks of output columns at head dim D: 1 up to the
    widest tile, then one CTA per D_T columns of the read head dim, each
    computing S (and dP) over all of it."""
    tile, Dk = kernel_layout(D, dtype)
    return -(-Dk // tile)


def _kernel_strides_ok(t: torch.Tensor) -> bool:
    """The kernels read 16 bytes at a time along a contiguous head dim;
    the 16-bit kernels' TMA tensor maps also need a 16-byte-aligned base and
    b/t/h strides that are multiples of 16 bytes."""
    es = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * es % 16 == 0 for i in range(3)))


def needs_copy(t: torch.Tensor, Dk: int) -> bool:
    """Whether the wrapper copies operand ``t`` into the kernels' layout
    before a launch at head dim ``Dk`` (``kernel_layout``): when its head
    dim is not Dk (it gets zero columns up to Dk) or the kernels cannot
    read it by its strides."""
    return t.shape[-1] != Dk or not _kernel_strides_ok(t)


def _kernel_operands(name, Dk, *tensors):
    """``tensors`` as the kernels read them at head dim ``Dk``: each as it
    is, or a contiguous copy with zero columns from its D up to Dk (counted
    in ``LAYOUT_COPIES[name]``)."""
    out = []
    for t in tensors:
        if needs_copy(t, Dk):
            c = t.new_zeros((*t.shape[:3], Dk))
            c[..., :t.shape[-1]] = t
            LAYOUT_COPIES[name] += 1
            t = c
        out.append(t)
    return out


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
    B, _, H, D = q.shape
    try:
        kernel_layout(D, q.dtype)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit")
    for t in (q, *tensors[:3]):
        if t.dtype != q.dtype or t.dim() != 4 or t.shape[0] != B or \
                t.shape[2:] != q.shape[2:] or t.shape[1] < 1:
            raise ValueError(f"{name}: tensors must share dtype, batch, "
                             f"heads and head dim; got {q.dtype}{list(q.shape)}"
                             f" and {t.dtype}{list(t.shape)}")
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


def _id_table_ints(B, T):
    """int32 values of one side's id table (``id_table_ints`` in
    ``csrc/flash_attention.cu``): each row's ids padded to a multiple of
    128, then each 64-token tile's [min, max], the sum rounded up to a
    multiple of 4 so that the k side's table starts 16-byte aligned."""
    n = B * (-(-T // 128) * 128 + 2 * -(-T // 64))
    return -(-n // 4) * 4


def _id_scratch(q, k, q_seg):
    """Scratch for the id tables that the 16-bit kernels build from
    segment ids before they run: the q side's table, then the k side's
    (None without ids, and for fp32 inputs, whose kernels read the ids as
    given)."""
    if q_seg is None or q.dtype == torch.float32:
        return None
    B = q.shape[0]
    n = _id_table_ints(B, q.shape[1]) + _id_table_ints(B, k.shape[1])
    return torch.empty(n, dtype=torch.int32, device=q.device)


class IdTables:
    """The id tables of one call's segment ids, for the 16-bit kernels on
    the card: the first launch handed them builds them into ``scratch``
    (``flash_id_table``, ahead of its kernel), and every later launch on
    the same ids reads them as built. ``flash_attention``'s forward builds
    them and its two backward kernels read them;
    ``flash_attention_block_grads`` builds them once for its two kernels.
    Without ids, for fp32 inputs or on the CPU there is nothing to build
    (``scratch`` None)."""

    def __init__(self, q, k, q_seg):
        self.shape = (q.shape[0], q.shape[1], k.shape[1])
        self.scratch = _id_scratch(q, k, q_seg) if q.is_cuda else None
        self.built = False


def _seg_args(name, q, k, q_seg, k_seg, tables):
    """(q_ids, k_ids, id_scratch, tables) of one launch, as the C
    interface takes them: the ids (int32) while the tables are not built,
    with the scratch to build them in (16-bit inputs); the scratch alone
    once they are. ``tables`` None: this launch's own."""
    if tables is None:
        tables = IdTables(q, k, q_seg)
    elif q_seg is None or tables.shape != (q.shape[0], q.shape[1],
                                           k.shape[1]):
        raise ValueError(f"{name}: id tables of {tables.shape} for a call "
                         f"of {(q.shape[0], q.shape[1], k.shape[1])}"
                         f"{'' if q_seg is not None else ' without ids'}")
    if tables.built:
        return None, None, tables.scratch, tables
    return _ids(q_seg), _ids(k_seg), tables.scratch, tables


def _out_f32(name, q, out_dtype) -> bool:
    if out_dtype not in (None, q.dtype, torch.float32):
        raise ValueError(f"{name}: out_dtype {out_dtype} not supported "
                         f"(None, the input dtype or float32)")
    return out_dtype == torch.float32


def _launch_fwd(q, k, v, o, lse, m, l, causal, q_off, k_off, window, q_seg,
                k_seg, id_tables, scale):
    """One launch of the forward kernel in the mode its outputs select, on
    tensors the kernel reads and writes in place (outputs may be views);
    ``scale`` the softmax scale of the true head dim."""
    B, Tq, H, D = q.shape
    q_ids, k_ids, scratch, tables = _seg_args("flash_fwd", q, k, q_seg,
                                              k_seg, id_tables)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse), _ptr(m),
            _ptr(l), _ptr(q_ids), _ptr(k_ids), _ptr(scratch),
            _strides(q, k, v, o), int(causal), q_off, k_off, window or 0,
            scale, _stream(q))
    _build.check(lib, err, "flash_fwd")
    tables.built = scratch is not None


def _launch_dq(q, k, v, do, lse, delta, dq, causal, q_off, k_off, window,
               q_seg, k_seg, id_tables, scale):
    """One launch of the dQ kernel into ``dq`` (fp32 or q's dtype), as
    ``_launch_fwd``."""
    B, Tq, H, D = q.shape
    q_ids, k_ids, scratch, tables = _seg_args("flash_bwd_dq", q, k, q_seg,
                                              k_seg, id_tables)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), _ptr(q_ids), _ptr(k_ids),
            _ptr(scratch), _strides(q, k, v, do, dq),
            int(dq.dtype == torch.float32), int(causal), q_off, k_off,
            window or 0, scale, _stream(q))
    _build.check(lib, err, "flash_bwd_dq")
    tables.built = scratch is not None


def _launch_dkv(q, k, v, do, lse, delta, dk, dv, causal, q_off, k_off,
                window, q_seg, k_seg, id_tables, scale):
    """One launch of the dK/dV kernel into ``dk`` and ``dv`` (both fp32 or
    both the inputs' dtype), as ``_launch_fwd``."""
    B, Tq, H, D = q.shape
    q_ids, k_ids, scratch, tables = _seg_args("flash_bwd_dkv", q, k, q_seg,
                                              k_seg, id_tables)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd_dkv(
            _DTYPE_CODE[q.dtype], D, B, H, Tq, k.shape[1], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(q_ids),
            _ptr(k_ids), _ptr(scratch), _strides(q, k, v, do, dk, dv),
            int(dk.dtype == torch.float32), int(causal), q_off, k_off,
            window or 0, scale, _stream(q))
    _build.check(lib, err, "flash_bwd_dkv")
    tables.built = scratch is not None


def _out(t, D):
    """A kernel output of head dim D_k >= D, as the caller's D columns."""
    return t if t.shape[-1] == D else t[..., :D]


def flash_fwd(q, k, v, causal=True, q_off=0, k_off=0, window=None,
              q_seg=None, k_seg=None, with_lse=False, id_tables=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention forward: (O [B,Tq,H,D] in q's dtype, lse fp32 [B,H,Tq]
    when ``with_lse`` (the train mode), else None). ``id_tables``: an
    ``IdTables`` of these ids to build (or read) the tables in."""
    if not _use_kernel("flash_fwd", q, k, v, q_seg=q_seg, k_seg=k_seg):
        return flash_fwd_plain(q, k, v, causal, q_off, k_off, window, q_seg,
                               k_seg, with_lse)
    B, Tq, H, D = q.shape
    Dk = kernel_layout(D, q.dtype)[1]
    qk, kk, vk = _kernel_operands("flash_fwd", Dk, q, k, v)
    o = torch.empty((B, Tq, H, Dk), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch_fwd(qk, kk, vk, o, lse, None, None, causal, q_off, k_off, window,
                q_seg, k_seg, id_tables, _scale(q))
    _launched("flash_fwd_train" if with_lse else "flash_fwd", q_seg)
    return _out(o, D), lse


def flash_fwd_state(q, k, v, causal=True, q_off=0, k_off=0, window=None,
                    q_seg=None, k_seg=None, id_tables=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's state mode, one K/V block's unmerged online-softmax
    state: (acc fp32 [B,Tq,H,D] unnormalized, m and l fp32 [B,H,Tq]). A
    row with no visible key gives acc = 0, m = -1e30, l = 0."""
    if not _use_kernel("flash_fwd_state", q, k, v, q_seg=q_seg, k_seg=k_seg):
        return flash_fwd_state_plain(q, k, v, causal, q_off, k_off, window,
                                     q_seg, k_seg)
    B, Tq, H, D = q.shape
    Dk = kernel_layout(D, q.dtype)[1]
    qk, kk, vk = _kernel_operands("flash_fwd_state", Dk, q, k, v)
    acc = torch.empty((B, Tq, H, Dk), dtype=torch.float32, device=q.device)
    m, l = torch.empty((2, B, H, Tq), dtype=torch.float32,
                       device=q.device).unbind(0)
    _launch_fwd(qk, kk, vk, acc, None, m, l, causal, q_off, k_off, window,
                q_seg, k_seg, id_tables, _scale(q))
    _launched("flash_fwd_state", q_seg)
    return _out(acc, D), m, l


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, q_off=0, k_off=0,
                 window=None, q_seg=None, k_seg=None,
                 out_dtype=None, id_tables=None) -> torch.Tensor:
    """dQ [B,Tq,H,D] in ``out_dtype`` (default q's dtype; float32 for the
    ring's accumulation) from the saved lse and delta."""
    if not _use_kernel("flash_bwd_dq", q, k, v, do, lse, delta, q_seg=q_seg,
                       k_seg=k_seg):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, q_off,
                                  k_off, window, q_seg, k_seg, out_dtype)
    _row_stats_ok("flash_bwd_dq", q, lse, delta)
    out_f32 = _out_f32("flash_bwd_dq", q, out_dtype)
    B, Tq, H, D = q.shape
    Dk = kernel_layout(D, q.dtype)[1]
    ops = _kernel_operands("flash_bwd_dq", Dk, q, k, v, do)
    dq = torch.empty((B, Tq, H, Dk), dtype=out_dtype or q.dtype,
                     device=q.device)
    _launch_dq(*ops, lse, delta, dq, causal, q_off, k_off, window, q_seg,
               k_seg, id_tables, _scale(q))
    _launched("flash_bwd_dq_f32" if out_f32 else "flash_bwd_dq", q_seg)
    return _out(dq, D)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, q_off=0, k_off=0,
                  window=None, q_seg=None, k_seg=None, out_dtype=None,
                  id_tables=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Tk,H,D] in ``out_dtype`` (default k's/v's dtype) from
    the saved lse and delta."""
    if not _use_kernel("flash_bwd_dkv", q, k, v, do, lse, delta,
                       q_seg=q_seg, k_seg=k_seg):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, q_off,
                                   k_off, window, q_seg, k_seg, out_dtype)
    _row_stats_ok("flash_bwd_dkv", q, lse, delta)
    out_f32 = _out_f32("flash_bwd_dkv", q, out_dtype)
    B, Tk, H, D = k.shape
    Dk = kernel_layout(D, q.dtype)[1]
    ops = _kernel_operands("flash_bwd_dkv", Dk, q, k, v, do)
    dk = torch.empty((B, Tk, H, Dk), dtype=out_dtype or k.dtype,
                     device=q.device)
    dv = torch.empty((B, Tk, H, Dk), dtype=out_dtype or v.dtype,
                     device=q.device)
    _launch_dkv(*ops, lse, delta, dk, dv, causal, q_off, k_off, window,
                q_seg, k_seg, id_tables, _scale(q))
    _launched("flash_bwd_dkv_f32" if out_f32 else "flash_bwd_dkv", q_seg)
    return _out(dk, D), _out(dv, D)


# ---- autograd ---------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Training attention: the forward saves lse (and, with ids, the id
    tables it built); the backward computes delta = rowsum(dO * O) in fp32
    as plain torch (it lies outside the Pallas kernels in the JAX package
    too), then launches dQ and dK/dV on the forward's tables."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, causal, q_off, k_off, window):
        ctx.tables = IdTables(q, k, q_seg) if q_seg is not None else None
        o, lse = flash_fwd(q, k, v, causal, q_off, k_off, window, q_seg,
                           k_seg, with_lse=True, id_tables=ctx.tables)
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
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, q_off, k_off,
                          window, q_seg, k_seg, id_tables=ctx.tables)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, q_off, k_off,
                               window, q_seg, k_seg, id_tables=ctx.tables)
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
    tables = (IdTables(q, k, q_segment_ids) if q_segment_ids is not None
              else None)
    dq = flash_bwd_dq(*args, out_dtype=torch.float32, id_tables=tables)
    dk, dv = flash_bwd_dkv(*args, out_dtype=torch.float32, id_tables=tables)
    return dq, dk, dv
