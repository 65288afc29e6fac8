"""Ring attention: context parallelism for long sequences over the sp axis.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``. The sequence is
sharded across the ranks of an sp group (``parallel/mesh.AxisGroup``); each
rank keeps its Q block while the K/V blocks travel around the ring
(``ops/collectives.ring_exchange``, one ``batch_isend_irecv`` per step, in
the role of ``lax.ppermute``). Each step starts the exchange of the next
block before it runs the current block through the forward kernel's state
mode (``flash_attention_block``), so the transfer overlaps the kernel; the
blocks' unnormalized states merge with the online-softmax combine in fp32.

The backward is the second ring: K/V travel again, each block's (dq, dk,
dv) comes from the backward kernels in their fp32-output mode with the
GLOBAL lse and delta (``flash_attention_block_grads``), and the dK/dV
accumulators travel with their blocks, so after sp steps every gradient
is home. GQA K/V travel at their reduced head width and are expanded only
at the kernel boundary; their gradients are group-summed before they are
accumulated.
"""

from __future__ import annotations

import torch

from ..ops.collectives import ring_exchange
from ..ops.flash_attention import (NEG_INF, flash_attention,
                                   flash_attention_block,
                                   flash_attention_block_grads)


def expand_kv(k, v, g):
    """GQA: KV head j serves query heads j*g .. j*g+g-1 (consecutive
    repeat, as the JAX package's ``_expand_kv``). The backward adjoint is
    the group sum ``x.reshape(B, T, Hkv, g, D).sum(3)``."""
    if g <= 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def _axis_size(axis) -> int:
    return 1 if axis is None else axis.size


def local_attention(q, k, v, causal, segment_ids, window):
    """Both strategies at sp = 1: one ``flash_attention`` call (train-mode
    kernel) with GQA K/V expanded at the kernel boundary."""
    k, v = expand_kv(k, v, q.shape[2] // k.shape[2])
    return flash_attention(q, k, v, causal=causal,
                           q_segment_ids=segment_ids,
                           k_segment_ids=segment_ids, window=window)


def _rows(x):
    """[B, H, T] -> [B, T, H, 1], to scale [B, T, H, D] rows."""
    return x.transpose(1, 2)[..., None]


def _ring_forward(q, k, v, seg, axis, causal, window):
    """The forward ring. Returns (o in q's dtype, lse fp32 [B, H, Tq])."""
    sp, my = axis.size, axis.rank
    Tq, H = q.shape[1], q.shape[2]
    Tk, g = k.shape[1], H // k.shape[2]
    blocks = [k, v] if seg is None else [k, v, seg]
    o = m = l = None
    for step in range(sp):
        # Block `step` left rank (my - step) mod sp; the next one starts
        # travelling before this one's kernel runs.
        pending = ring_exchange(blocks, axis) if step < sp - 1 else None
        kf, vf = expand_kv(blocks[0], blocks[1], g)
        acc_b, m_b, l_b = flash_attention_block(
            q, kf, vf, q_off=my * Tq, k_off=((my - step) % sp) * Tk,
            causal=causal, q_segment_ids=seg,
            k_segment_ids=None if seg is None else blocks[2], window=window)
        if o is None:
            # The merge with the empty state (m = -1e30, l = 0, o = 0)
            # returns the block's own state unchanged.
            o, m, l = acc_b, m_b, l_b
        else:
            m_new = torch.maximum(m, m_b)
            alive = m_new > NEG_INF / 2
            c_old = torch.where(alive, torch.exp(m - m_new), 1.0)
            c_blk = torch.where(alive & (m_b > NEG_INF / 2),
                                torch.exp(m_b - m_new), 0.0)
            l = l * c_old + l_b * c_blk
            o = o.mul_(_rows(c_old)).addcmul_(acc_b, _rows(c_blk))
            m = m_new
        if pending is not None:
            blocks = pending.wait()
    l_safe = l.clamp_min(1e-30)
    # Rows with no visible key take lse = +1e30, so the backward's
    # exp(s - lse) is exactly zero for them.
    lse = torch.where(l > 0.0, m + torch.log(l_safe), -NEG_INF)
    return o.div_(_rows(l_safe)).to(q.dtype), lse.contiguous()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, axis, causal, window):
        o, lse = _ring_forward(q, k, v, seg, axis, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seg = seg
        ctx.args = (axis, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        seg = ctx.seg
        axis, causal, window = ctx.args
        sp, my = axis.size, axis.rank
        B, Tq, H, D = q.shape
        Tk, Hkv = k.shape[1], k.shape[2]
        g = H // Hkv
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        blocks = [k, v] if seg is None else [k, v, seg]
        dq = dk = dv = None
        for step in range(sp):
            pending = ring_exchange(blocks, axis) if step < sp - 1 else None
            kf, vf = expand_kv(blocks[0], blocks[1], g)
            dq_b, dk_b, dv_b = flash_attention_block_grads(
                q, kf, vf, do, lse, delta, q_off=my * Tq,
                k_off=((my - step) % sp) * Tk, causal=causal,
                q_segment_ids=seg,
                k_segment_ids=None if seg is None else blocks[2],
                window=window)
            if g > 1:
                dk_b = dk_b.reshape(B, Tk, Hkv, g, D).sum(3)
                dv_b = dv_b.reshape(B, Tk, Hkv, g, D).sum(3)
            dq = dq_b if dq is None else dq.add_(dq_b)
            # dk/dv hold the sums for the block this rank holds (arrived
            # with it); they leave with it, and after sp steps are home.
            dk = dk_b if dk is None else dk.add_(dk_b)
            dv = dv_b if dv is None else dv.add_(dv_b)
            dk, dv = ring_exchange([dk, dv], axis, tag=3).wait()
            if pending is not None:
                blocks = pending.wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, axis=None, causal: bool = True,
                   segment_ids=None, window=None):
    """Context-parallel attention. q/k/v: ``[B, T_local, H(kv), D]`` on
    each rank of the sp group ``axis`` (an ``AxisGroup``; None means
    sp = 1), sequence-sharded in axis-rank order.

    sp == 1 is ``local_attention``. sp > 1 runs the forward kernel's
    state mode once per ring step and the two backward kernels (fp32
    outputs) once per step of the second ring.
    ``segment_ids`` (int ``[B, T_local]``, sharded like q): packed
    sequences; the K-side ids travel with their K/V block.
    """
    if _axis_size(axis) == 1:
        return local_attention(q, k, v, causal, segment_ids, window)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _RingAttention.apply(q, k, v, segment_ids, axis, causal, window)
