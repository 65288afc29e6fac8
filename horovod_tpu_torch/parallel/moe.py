"""Mixture-of-Experts with expert parallelism (top-1 Switch or top-2
GShard routing).

Counterpart of ``horovod_tpu/parallel/moe.py``. Expert parallelism rides
the dp group: each of its ep ranks owns ``E / ep`` experts, and tokens
reach their expert's owner through one ``all_to_all`` over the group and
come back through a second. Capacity is static, ``max(1, int(cf * k * T /
E))`` slots per expert, so every exchanged buffer has a fixed shape; a
token past its expert's capacity is dropped (its output is zero).

The JAX package dispatches and combines with a dense ``[kT, E, C]``
one-hot tensor (einsums); here the same slot positions drive an index
copy into the expert buffers and a gather back out, the same function
without the ``kT * E * C`` tensor (2.1 GB per layer in fp32 at 16,384
tokens, 8 experts and capacity 4,096). Routing, the buffers and the
expert FFN run in fp32 whatever the input dtype; the experts use the
exact (erf) GELU, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.collectives import all_to_all, mean_over


def moe_layer(x, params, axis=None, capacity_factor: float = 1.25,
              top_k: int = 1, return_aux: bool = False):
    """Top-k MoE over tokens. ``x``: this rank's tokens ``[T, d]``;
    ``params``: ``gate [d, E]`` (fp32) and this rank's experts ``w_in
    [E / ep, d, f]``, ``w_out [E / ep, f, d]``; ``axis``: the expert
    group (an ``AxisGroup``; None for one rank holding every expert).

    ``top_k``: 1 (Switch) or 2 (GShard: the gates renormalized over the
    two picks; every first choice takes capacity before any second
    choice). ``return_aux``: also return the Switch load-balance loss
    E * sum_e(f_e * P_e), averaged over the group (1.0 when balanced).

    Returns ``[T, d]`` in ``x``'s dtype, or (that, aux).
    """
    ep = 1 if axis is None else axis.size
    T, d = x.shape
    e_local = params["w_in"].shape[0]
    E = e_local * ep
    if not 1 <= top_k <= E:
        raise ValueError(f"top_k={top_k} must be in [1, {E}]")

    # --- routing (fp32) -----------------------------------------------------
    x32 = x.float()
    probs = torch.softmax(x32 @ params["gate"], dim=-1)   # [T, E]
    topg, topi = torch.topk(probs, top_k, dim=-1)          # [T, k]
    if top_k > 1:
        topg = topg / topg.sum(-1, keepdim=True)
    # Choice-major virtual tokens ([all 1st choices; all 2nd ...]): the
    # running count below gives every first choice priority.
    vidx = topi.T.reshape(-1)                              # [kT]
    vgate = topg.T.reshape(-1)
    capacity = max(1, int(capacity_factor * top_k * T / E))
    onehot = F.one_hot(vidx, E)
    pos = (onehot.cumsum(0) - 1).gather(1, vidx[:, None])[:, 0]
    kept = pos < capacity
    # A kept choice's slot is unique; every dropped one lands on the
    # scratch row E * C, cut off below (fixed shapes: no host sync).
    slots = torch.where(kept, vidx * capacity + pos, E * capacity)
    src = torch.arange(top_k * T, device=x.device) % T     # token of each

    # --- dispatch: expert buffers [E * C, d], a token once per choice -------
    buffers = x32.new_zeros(E * capacity + 1, d).index_copy(
        0, slots, x32[src])[:-1]
    # chunk i of dim 0 (rank i's experts) goes to rank i; what comes back
    # is [ep (sender), e_local, C, d]
    recv = buffers.view(E, capacity, d)
    if ep > 1:
        recv = all_to_all(recv, 0, 0, axis)
    recv = recv.view(ep, e_local, capacity, d).transpose(0, 1).reshape(
        e_local, ep * capacity, d)

    # --- expert FFN (fp32) --------------------------------------------------
    h = F.gelu(torch.bmm(recv, params["w_in"].float()), approximate="none")
    out = torch.bmm(h, params["w_out"].float())            # [e_local, ep*C, d]

    # --- return trip and combine --------------------------------------------
    back = out.view(e_local, ep, capacity, d).transpose(0, 1).reshape(
        E, capacity, d)
    if ep > 1:
        back = all_to_all(back, 0, 0, axis)
    weight = (vgate * kept).unsqueeze(1)
    combined = back.reshape(E * capacity, d)[slots.clamp(max=E * capacity - 1)]
    y = (combined * weight).view(top_k, T, d).sum(0).to(x.dtype)
    if not return_aux:
        return y
    first = F.one_hot(topi[:, 0], E).float()
    f = mean_over(first.mean(0), axis)
    p = mean_over(probs.mean(0), axis)
    return y, E * (f * p).sum()
