"""ZeRO sharded training — stages 1, 2 and 3 — and ZeRO-1 over a mesh axis.

Counterpart of ``horovod_tpu/zero.py`` (Rajbhandari et al.'s ZeRO,
arXiv:1910.02054). The stage selects how much of the training state is
partitioned 1/d over the ranks of ``axis`` (default the world):

    stage 1   fp32 masters and optimizer state sharded; each bucket's
              gradient is all-reduced in full and every rank slices its
              own shard. Memory: params + grads O(P), state O(P/d).
    stage 2   gradients partitioned too (the default): each bucket is
              reduce-scattered into its owner's shard. With two ranks
              (or any power of two on the same batch) every element of
              the sum is one exact addition, so stages 1 and 2 agree
              bitwise.
    stage 3   parameters partitioned too: the model's parameters live on
              the ``meta`` device (zero bytes, the shape and dtype
              template); only the fp32 master shard is real. The forward
              all-gathers each fusion bucket just in time, in forward
              bucket order (``common/fusion.forward_bucket_order``), with
              at most ``prefetch + 1`` gathers in flight; the gather's
              backward is the stage-2 reduce-scatter. The gathered
              buckets are dropped once the forward is done and gathered
              again when the backward first needs one of their tensors.

The plan (``_make_plan``) fuses the parameters into buckets by fp32 bytes
(``plan_buckets``; one bucket when there is no cap), each padded to a
multiple of d and flattened in parameter order. The state is born
sharded: each rank keeps only its segment of each bucket's fp32 flat, so
no rank holds a full fp32 copy of the masters, the optimizer state, the
gradient accumulator or the error-feedback residual past the init.

The optimizer is any elementwise ``torch.optim`` optimizer (SGD,
momentum, Adam, AdamW, RMSprop, ...), given as a callable that builds it
over a parameter list and run on the flat fp32 shard, which is
elementwise equal to running it on the structured parameters. Optimizers
that need global structure (global-norm clipping, layer-wise LARS) must
stay outside or be re-derived with a reduction over the ranks.

``accumulate_steps = k`` keeps a sharded accumulator and updates with
the **mean** of the k micro-batch gradients, as the JAX ZeRO step does;
the port's ``DistributedOptimizer`` (``backward_passes_per_step``)
reduces their sum, as the torch binding does. The batch-norm statistics
and the loss are averaged over the ranks after the step.

The state owns its mode: the stage, the bucket cap and the presence of
residuals are stamped into ``ZeroTrainState`` at init, and a step whose
explicit arguments disagree with them, a state whose stamps are missing
or forged, or shards built for another tree or cap are refused.

At stage 3 a parameter is gathered when the forward of the module that
holds it starts (a forward pre-hook): a model whose forward reads a
submodule's parameter without calling that submodule is not supported.
The saved tensors the backward needs that are views of a gathered bucket
are replaced by a token (``torch.autograd.graph.saved_tensors_hooks``) and
re-gathered when unpacked; a tensor derived from a parameter by a copy
(say, its bf16 cast) is an activation of its layer and is kept.

The gathers are asynchronous collectives (``ops/collectives.
zero_allgather``): NCCL runs them on its own stream, and waiting on one
orders the compute stream after it, so a gather launched ``prefetch``
buckets ahead overlaps the forward of the buckets before it. Depth only
changes when gathers are issued, never a number (on the CPU, gloo runs
them in its own thread).

``ZeroOverAxis`` is the transformer's ZeRO-1 (the JAX
``init_opt_state(zero_axis="dp")``): after the ``DistributedOptimizer``'s
reduction each rank of the axis updates its 1/d slice of every parameter
the axis replicates and all-gathers the result. Unlike the JAX helper,
which shards a leaf only along a dimension the axis size divides, it
slices every such leaf flat (padded), so no leaf stays whole; the
numbers are the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn as nn

from .common import config as _config
from .common.compression import Compression, resolve_compression
from .common.fusion import (Bucket, forward_bucket_order, plan_buckets,
                            resolve_bucket_cap, resolve_prefetch_depth)
from .ops import collectives as _coll
from .training import cross_entropy_loss


@dataclasses.dataclass
class ZeroTrainState:
    """The training state of one rank.

    ``model``: the module (its buffers are the batch-norm statistics; at
    stage 3 its parameters are on the ``meta`` device). ``pshard``: this
    rank's flat fp32 master shard. ``optimizer``: built over
    ``[pshard]``; its state is the optimizer shard. ``gaccum``: the
    gradient accumulator shard (None unless accumulating). ``residual``:
    the error-feedback residual shard (None without ef16). ``bucket_cap``
    (-1: one bucket) and ``stage``: the stamps the step reads.
    ``axis``: the ranks the state is sharded over."""

    model: nn.Module
    pshard: torch.Tensor
    optimizer: torch.optim.Optimizer
    gaccum: Optional[torch.Tensor]
    step: int
    bucket_cap: Optional[int]
    residual: Optional[torch.Tensor]
    stage: Optional[int]
    axis: object

    def state_dict(self) -> dict:
        """The state's tensors and stamps (for ``checkpoint.py``); at stage
        3 the model contributes its buffers only."""
        model = {n: t for n, t in self.model.state_dict().items()
                 if t.device.type != "meta"}
        return {"model": model, "pshard": self.pshard.detach(),
                "optimizer": self.optimizer.state_dict(),
                "gaccum": self.gaccum, "residual": self.residual,
                "step": self.step, "bucket_cap": self.bucket_cap,
                "stage": self.stage, "axis_size": self.axis.size}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load a ``state_dict()`` in place; a state of another stage,
        cap, compression mode, accumulation or world is refused."""
        for key, what in (("stage", "ZeRO stage"), ("bucket_cap",
                                                    "bucket cap"),
                          ("axis_size", "number of ranks")):
            mine = self.axis.size if key == "axis_size" else getattr(
                self, key)
            if sd[key] != mine:
                raise ValueError(
                    f"ZeRO state mismatch: the saved state has {what} "
                    f"{sd[key]} but this state has {mine}; restore into a "
                    f"template built with the same settings")
        for key in ("gaccum", "residual"):
            if (sd[key] is None) != (getattr(self, key) is None):
                raise ValueError(
                    f"ZeRO state mismatch: {key} is "
                    f"{'absent' if sd[key] is None else 'present'} in the "
                    f"saved state but not in this one (accumulate_steps or "
                    f"compression differ)")
        if sd["pshard"].shape != self.pshard.shape:
            raise ValueError(
                f"ZeRO state mismatch: the saved master shard has "
                f"{sd['pshard'].numel()} elements, this one "
                f"{self.pshard.numel()}: another parameter tree")
        self.model.load_state_dict(sd["model"], strict=self.stage != 3)
        self.pshard.copy_(sd["pshard"])
        self.optimizer.load_state_dict(sd["optimizer"])
        for key in ("gaccum", "residual"):
            if sd[key] is not None:
                getattr(self, key).copy_(sd[key])
        self.step = int(sd["step"])


def _shard_len(total: int, d: int) -> int:
    """Flat length padded up to a multiple of d, divided over d shards."""
    return ((total + d - 1) // d * d) // d


def _resolve_stage(zero_stage) -> int:
    """``"auto"`` follows ``HOROVOD_ZERO_STAGE`` (default 2); else 1-3."""
    if isinstance(zero_stage, str):
        if zero_stage != "auto":
            raise ValueError(
                f"zero_stage must be 1, 2, 3, or 'auto'; got {zero_stage!r}")
        return _config.zero_stage()
    s = int(zero_stage)
    if s not in (1, 2, 3):
        raise ValueError(f"zero_stage must be 1, 2, or 3; got {s}")
    return s


def _params_are_template(model: nn.Module) -> bool:
    """True when every parameter is on the ``meta`` device (the stage-3
    representation)."""
    params = list(model.parameters())
    return bool(params) and all(p.device.type == "meta" for p in params)


class _ZeroPlan(NamedTuple):
    """The flattening plan: bucket j flattens its leaves at fp32 in
    parameter order, pads to a multiple of d, and contributes
    ``bucket_padded[j] // d`` elements to each rank's shard."""

    names: tuple
    shapes: tuple
    dtypes: tuple
    sizes: tuple          # per-leaf element counts
    total: int
    buckets: tuple        # leaf indices per bucket
    bucket_elems: tuple   # unpadded element count per bucket
    bucket_padded: tuple  # padded element count per bucket (multiple of d)
    shard_len: int        # elements of one rank's shard

    @property
    def padded(self) -> int:
        return sum(self.bucket_padded)

    def seg_offsets(self, d: int) -> List[int]:
        """Where each bucket's segment starts in a rank's shard."""
        offs, off = [], 0
        for p in self.bucket_padded:
            offs.append(off)
            off += p // d
        return offs


def _make_plan(named, d: int, bucket_cap_bytes=None) -> _ZeroPlan:
    """``named``: (name, shape, dtype) of every parameter in order."""
    names = tuple(n for n, _, _ in named)
    shapes = tuple(tuple(s) for _, s, _ in named)
    dtypes = tuple(dt for _, _, dt in named)
    sizes = tuple(int(torch.Size(s).numel()) for s in shapes)
    if bucket_cap_bytes:
        # The scatter travels at fp32 whatever the model's dtype, so the
        # planner sees fp32 byte sizes and one dtype.
        buckets = tuple(b.indices for b in plan_buckets(
            [n * 4 for n in sizes], [torch.float32] * len(sizes),
            bucket_cap_bytes))
    else:
        buckets = (tuple(range(len(sizes))),) if sizes else ()
    elems = tuple(sum(sizes[i] for i in idxs) for idxs in buckets)
    padded = tuple(_shard_len(n, d) * d for n in elems)
    return _ZeroPlan(names, shapes, dtypes, sizes, sum(sizes), buckets,
                     elems, padded, sum(p // d for p in padded))


def _model_plan(model: nn.Module, d: int, cap) -> _ZeroPlan:
    return _make_plan([(n, p.shape, p.dtype)
                       for n, p in model.named_parameters()], d, cap)


def _forward_order(plan: _ZeroPlan):
    """Bucket visit order of the stage-3 gathers: the backward-order plan
    run forward."""
    return forward_bucket_order([Bucket(idxs, None, 0)
                                 for idxs in plan.buckets])


def _gather_dtype(plan: _ZeroPlan) -> torch.dtype:
    """Uniform-dtype models gather at their dtype, mixed ones at fp32."""
    dts = set(plan.dtypes)
    return plan.dtypes[0] if len(dts) == 1 else torch.float32


def _bucket_flat_f32(tensors, plan: _ZeroPlan, j: int) -> torch.Tensor:
    """Bucket j's tensors as one fresh padded fp32 flat."""
    idxs = plan.buckets[j]
    parts = [tensors[i].detach().reshape(-1).float() for i in idxs]
    pad = plan.bucket_padded[j] - plan.bucket_elems[j]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _unflatten_bucket(flat, plan: _ZeroPlan, j: int):
    """(leaf index, tensor) of bucket j's leaves as views of ``flat``
    (cast to each leaf's dtype where it differs). One ``split``: its
    backward joins the leaves' gradients in one buffer (a slice per leaf
    would build a full-size gradient for each)."""
    idxs = plan.buckets[j]
    sizes = [plan.sizes[i] for i in idxs]
    pad = plan.bucket_padded[j] - plan.bucket_elems[j]
    parts = flat.split(sizes + [pad] if pad else sizes)
    for i, part in zip(idxs, parts):
        yield i, part.view(plan.shapes[i]).to(plan.dtypes[i])


def _resolve_axis(axis):
    return axis if axis is not None else _coll._world()


def init_zero_train_state(model: nn.Module,
                          optimizer: Callable[[list], torch.optim.Optimizer],
                          axis=None, accumulate_steps: int = 1,
                          bucket_cap_bytes="auto", compression="auto",
                          zero_stage="auto") -> ZeroTrainState:
    """The ZeRO state of ``model`` (built on this rank's device, the same
    on every rank) for the resolved stage.

    ``optimizer``: a callable building the optimizer over a list of
    parameters, e.g. ``functools.partial(torch.optim.SGD, lr=0.01,
    momentum=0.9)``; it is built over the fp32 master shard. ``axis``:
    the ``AxisGroup`` to shard over (default the world).
    ``accumulate_steps > 1`` adds a sharded accumulator.
    ``bucket_cap_bytes`` (int, None, or ``"auto"`` following
    ``HOROVOD_FUSION_THRESHOLD``) defines the shard layout and is stamped
    into the state. ``compression``: ``"ef16"`` adds a sharded fp32
    residual; fp16 and bf16 are stateless wire casts. ``zero_stage``:
    1, 2, 3 or ``"auto"`` (``HOROVOD_ZERO_STAGE``, default 2). At stage 3
    the model's parameters are moved to the ``meta`` device once the
    shard is carved."""
    axis = _resolve_axis(axis)
    d, r = axis.size, axis.rank
    stage = _resolve_stage(zero_stage)
    cap = resolve_bucket_cap(bucket_cap_bytes)
    if cap is not None and cap >= 2 ** 31:
        raise ValueError(
            f"bucket_cap_bytes={cap} does not fit int32; use a smaller "
            f"cap (or None for monolithic fusion)")
    plan = _model_plan(model, d, cap)
    leaves = [p for _, p in model.named_parameters()]
    if not leaves:
        raise ValueError("the model has no parameters")
    device = leaves[0].device
    with torch.no_grad():
        segs = []
        for j in range(len(plan.buckets)):
            slen = plan.bucket_padded[j] // d
            segs.append(_bucket_flat_f32(leaves, plan, j)[r * slen:
                                                          (r + 1) * slen])
        pshard = nn.Parameter(torch.cat(segs), requires_grad=stage == 3)
    opt = optimizer([pshard])
    if stage == 3:
        _to_template(model)

    def zeros():
        return torch.zeros(plan.shard_len, dtype=torch.float32,
                           device=device)

    comp = resolve_compression(compression)
    return ZeroTrainState(
        model, pshard, opt, zeros() if accumulate_steps > 1 else None, 0,
        -1 if cap is None else cap,
        zeros() if comp is not None and comp.error_feedback else None,
        stage, axis)


def _to_template(model: nn.Module) -> None:
    """Replace every parameter by a ``meta`` parameter of its shape and
    dtype: the stage-3 template, zero bytes."""
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is not None and p.device.type != "meta":
                module._parameters[name] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    requires_grad=p.requires_grad)


def gather_params(state: ZeroTrainState) -> Dict[str, torch.Tensor]:
    """The full parameters by name from any state: the model's own at
    stages 1 and 2; at stage 3 the master shards all-gathered bucket by
    bucket (for evaluation, export or checkpoint; the step never calls
    it). Collective at stage 3."""
    if not _params_are_template(state.model):
        return {n: p.detach() for n, p in state.model.named_parameters()}
    cap = None if state.bucket_cap < 0 else state.bucket_cap
    d = state.axis.size
    plan = _model_plan(state.model, d, cap)
    offs = plan.seg_offsets(d)
    out = {}
    with torch.no_grad():
        for j in range(len(plan.buckets)):
            slen = plan.bucket_padded[j] // d
            flat = _coll.zero_allgather(
                state.pshard[offs[j]:offs[j] + slen], state.axis).wait()
            for i, t in _unflatten_bucket(flat, plan, j):
                out[i] = t
    return {plan.names[i]: out[i] for i in range(len(plan.names))}


def state_bytes(state: ZeroTrainState) -> Dict[str, int]:
    """This rank's bytes of the state by part: ``params`` (the model's
    parameters: zero at stage 3), ``masters`` (the fp32 shard),
    ``optimizer`` (the optimizer's tensors), ``accumulator`` and
    ``residual``, and ``buffers`` (batch-norm statistics)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None and t.device.type != "meta")

    opt = [v for s in state.optimizer.state.values() for v in s.values()
           if torch.is_tensor(v)]
    return {"params": nbytes(state.model.parameters()),
            "masters": nbytes([state.pshard]),
            "optimizer": nbytes(opt),
            "accumulator": nbytes([state.gaccum]),
            "residual": nbytes([state.residual]),
            "buffers": nbytes(state.model.buffers())}


class _Gather(torch.autograd.Function):
    """The differentiable stage-3 bucket gather. Forward: the launched
    all-gather's flat (the caller waits on it before the first read).
    Backward: the stage-2 reduce-scatter of the bucket's cotangent at
    fp32 (or the wire dtype); with ef16 the rank's residual is injected
    into its own block first and the quantization error of that block is
    written back as the new residual."""

    @staticmethod
    def forward(ctx, seg, pending, j, run):
        ctx.j, ctx.run = j, run
        return pending.out

    @staticmethod
    def backward(ctx, cot):
        return ctx.run.scatter(ctx.j, cot), None, None, None


class _Stage3Run:
    """One stage-3 forward and backward: the just-in-time gathers with
    their prefetch window, the re-gathers of the backward and the
    scatters."""

    def __init__(self, state, plan, prefetch, wire):
        self.state, self.plan, self.pf, self.wire = state, plan, prefetch, wire
        self.axis = state.axis
        self.d = self.axis.size
        self.offs = plan.seg_offsets(self.d)
        self.slens = [p // self.d for p in plan.bucket_padded]
        self.gather_dtype = _gather_dtype(plan)
        self.order = _forward_order(plan)
        self.pos = {j: k for k, j in enumerate(self.order)}
        self.bucket_of = {i: j for j, idxs in enumerate(plan.buckets)
                          for i in idxs}
        self.launched: Dict[int, object] = {}   # bucket -> pending gather
        self.flats: Dict[int, torch.Tensor] = {}  # bucket -> gathered flat
        self.next = 0          # next position of the forward order to launch
        self.ptrs: Dict[int, int] = {}          # storage pointer -> bucket
        self.saved: Dict[int, int] = {}         # bucket -> tokens unpacked
        self.regathered: Dict[int, torch.Tensor] = {}
        self.gathers = 0       # forward gathers and backward re-gathers
        # (module, attribute) of every parameter, by leaf index.
        where = {}
        for mname, module in state.model.named_modules():
            for pname, p in module._parameters.items():
                if p is not None:
                    where[f"{mname}.{pname}" if mname else pname] = (module,
                                                                    pname)
        self.where = [where[n] for n in plan.names]
        self.template = [m._parameters[a] for m, a in self.where]

    def _seg(self, j):
        return self.state.pshard[self.offs[j]:self.offs[j] + self.slens[j]]

    def _launch_through(self, k):
        while self.next <= min(k, len(self.order) - 1):
            j = self.order[self.next]
            self.launched[j] = _coll.zero_allgather(self._seg(j), self.axis,
                                                    self.gather_dtype)
            self.gathers += 1
            self.next += 1

    def materialize(self, j):
        """Bucket j's parameters set on their modules, gathers launched
        through p buckets ahead of it."""
        if j in self.flats:
            return
        self._launch_through(self.pos[j] + self.pf)
        pending = self.launched.pop(j)
        pending.wait()
        flat = _Gather.apply(self._seg(j), pending, j, self)
        self.flats[j] = flat
        self.ptrs[flat.untyped_storage().data_ptr()] = j
        for i, t in _unflatten_bucket(flat, self.plan, j):
            module, attr = self.where[i]
            module._parameters[attr] = t

    def unused(self):
        """Zero, weighted onto every bucket the forward did not gather
        (gathered now): its backward then runs on every rank, as in the
        JAX step, where each bucket's cotangent (zeros here) goes through
        the reduce-scatter and the residual update."""
        zero = None
        for j in self.order:
            if j not in self.flats:
                self.materialize(j)
                term = self.flats[j].sum() * 0
                zero = term if zero is None else zero + term
        return zero

    def pre_hook(self, buckets):
        def hook(module, args):
            for j in sorted(buckets, key=self.pos.get):
                self.materialize(j)
        return hook

    def pack(self, t):
        j = self.ptrs.get(t.untyped_storage().data_ptr())
        if j is None or t.device.type == "meta":
            return t
        self.saved[j] = self.saved.get(j, 0) + 1
        return (j, t.storage_offset(), tuple(t.size()), tuple(t.stride()))

    def unpack(self, packed):
        if not isinstance(packed, tuple):
            return packed
        j, offset, size, stride = packed
        flat = self.regathered.get(j)
        if flat is None:
            with torch.no_grad():
                flat = _coll.zero_allgather(self._seg(j), self.axis,
                                            self.gather_dtype).wait()
            self.gathers += 1
            self.regathered[j] = flat
        self.saved[j] -= 1
        if self.saved[j] == 0:
            del self.regathered[j]
        return flat.as_strided(size, stride, offset)

    def scatter(self, j, cot):
        """The gather's backward: bucket j's gradient block of the sum."""
        state, lo = self.state, self.axis.rank * self.slens[j]
        flat = cot.float()
        if state.residual is not None:
            res = state.residual[self.offs[j]:self.offs[j] + self.slens[j]]
            flat = flat.clone() if flat is cot else flat
            my = flat[lo:lo + self.slens[j]] + res
            flat[lo:lo + self.slens[j]] = my
            sent = my.to(self.wire).float()
            res.copy_(my - sent)
        return _coll.zero_reducescatter(flat, self.axis, self.wire)

    @contextlib.contextmanager
    def forward_hooks(self):
        """Pre-hooks that gather each module's buckets as its forward
        starts; on exit every parameter is the template again and the
        gathered buckets are let go."""
        owners: Dict[nn.Module, set] = {}
        for i, (module, _) in enumerate(self.where):
            owners.setdefault(module, set()).add(self.bucket_of[i])
        handles = [m.register_forward_pre_hook(self.pre_hook(bs))
                   for m, bs in owners.items()]
        try:
            yield
        finally:
            for h in handles:
                h.remove()
            for (module, attr), p in zip(self.where, self.template):
                module._parameters[attr] = p
            for pending in self.launched.values():
                pending.wait()
            self.launched.clear()
            self.flats.clear()


def _check_state(state, k, requested, auto_comp, requested_comp):
    """The state-owns-the-mode checks: (cap, stage, compressor)."""
    if (state.gaccum is None) != (k <= 1):
        raise ValueError(
            "state/step accumulate_steps mismatch: build the state with "
            "init_zero_train_state(..., accumulate_steps=k) matching "
            "make_zero_train_step's")
    if state.bucket_cap is None:
        raise ValueError(
            "ZeroTrainState has no bucket_cap stamp — it was built by hand "
            "or restored without the field. Rebuild it with "
            "init_zero_train_state(...), or set bucket_cap=-1 if the "
            "layout is known-monolithic.")
    if state.stage is None:
        raise ValueError(
            "ZeroTrainState has no stage stamp — it was built by hand or "
            "restored from a pre-stage checkpoint. Rebuild it with "
            "init_zero_train_state(...), or set stage=2 if it predates "
            "stages (the historical behavior is stage 2: scattered "
            "gradients).")
    cap_raw, stage = int(state.bucket_cap), int(state.stage)
    cap = None if cap_raw < 0 else cap_raw
    if stage not in (1, 2, 3):
        raise ValueError(f"ZeroTrainState carries invalid stage stamp "
                         f"{stage}; expected 1, 2, or 3")
    req_cap, req_stage = requested
    if req_stage is not None and req_stage != stage:
        raise ValueError(
            f"state/step ZeRO stage mismatch: the state was built for "
            f"stage {stage} but make_zero_train_step was given "
            f"zero_stage={req_stage}. Rebuild the state with "
            f"init_zero_train_state(..., zero_stage={req_stage}) or drop "
            f"the explicit argument to follow the state.")
    is_template = _params_are_template(state.model)
    if stage == 3 and not is_template:
        raise ValueError(
            "stage-3 ZeroTrainState must hold its params as a zero-byte "
            "shape template (parameters on the meta device) — this state "
            "carries concrete tensors, so it was built by hand or its "
            "stage stamp was forged. Rebuild it with "
            "init_zero_train_state(..., zero_stage=3).")
    if stage != 3 and is_template:
        raise ValueError(
            f"stage-{stage} ZeroTrainState must carry replicated params, "
            f"but this state holds a shape template (stage-3 layout). "
            f"Rebuild it with init_zero_train_state(..., "
            f"zero_stage={stage}).")
    if auto_comp:
        comp = (Compression.ef16 if state.residual is not None
                else resolve_compression("auto"))
        if (comp is not None and comp.error_feedback
                and state.residual is None):
            raise ValueError(
                "HOROVOD_COMPRESSION resolves to error feedback (ef16) but "
                "this ZeroTrainState carries no residual — it was built "
                "without it. Rebuild the state with init_zero_train_state("
                "..., compression='ef16') (or under the same env) so the "
                "residual is born sharded.")
    else:
        comp = requested_comp
        ef_req = comp is not None and comp.error_feedback
        if ef_req != (state.residual is not None):
            mode = comp.name if comp is not None else "none"
            has = "carries" if state.residual is not None else "has no"
            raise ValueError(
                f"state/step compression mismatch: the state {has} "
                f"error-feedback residuals but make_zero_train_step was "
                f"given compression={mode!r}. Rebuild the state with "
                f"init_zero_train_state(..., compression={mode!r}) or pass "
                f"the state's mode.")
    if req_cap is not False and req_cap != cap:
        raise ValueError(
            f"state/step bucket cap mismatch: the state's shard layout was "
            f"built under bucket_cap_bytes={cap} but make_zero_train_step "
            f"was given {req_cap}. Rebuild the state with "
            f"init_zero_train_state(..., bucket_cap_bytes={req_cap}) or "
            f"drop the explicit argument to follow the state.")
    d = state.axis.size
    plan = _model_plan(state.model, d, cap)
    if state.pshard.numel() * d != plan.padded:
        raise ValueError(
            f"ZeroTrainState shards were built for a different parameter "
            f"tree or bucket cap: params flatten to {plan.total} elements "
            f"(padded {plan.padded} under bucket_cap_bytes={cap}) but the "
            f"shards hold {state.pshard.numel() * d}. After changing "
            f"either, rebuild the state with init_zero_train_state(...) "
            f"using the same model and bucket_cap_bytes as this step "
            f"instead of reusing the old one.")
    if state.residual is not None and state.residual.numel() * d != \
            plan.padded:
        raise ValueError(
            f"ZeroTrainState residual was built for a different layout: "
            f"expected {plan.padded} elements under bucket_cap_bytes={cap}, "
            f"got {state.residual.numel() * d}. Rebuild the state with "
            f"init_zero_train_state(...).")
    return plan, stage, comp


def make_zero_train_step(accumulate_steps: int = 1, bucket_cap_bytes="auto",
                         compression="auto", zero_stage="auto",
                         prefetch="auto"):
    """``step(state, images, labels) -> (state, loss)``: one ZeRO training
    step of ``state`` (updated in place and returned) on this rank's
    batch, the loss averaged over the state's ranks.

    The stage, cap and compression mode are read from the state; an
    explicit (non-``"auto"``) argument here is only a cross-check.
    ``prefetch`` (stage 3; ``"auto"`` follows ``HOROVOD_ZERO_PREFETCH``,
    default 1): how many bucket gathers may run ahead of the one the
    forward consumes; it changes the order of the gathers, never the
    numbers. ``accumulate_steps = k``: k micro-batches, then one update
    with their mean gradient (the state must be built with the same k).
    ``compression``: fp16/bf16 make the reduce-scatter payload travel
    and sum at 16 bits (upcast to fp32 before the average); ef16 also
    re-injects the sharded residual. The step's ``gathers`` attribute
    counts the bucket all-gathers of the last call."""
    k = accumulate_steps
    auto_cap = isinstance(bucket_cap_bytes, str) and bucket_cap_bytes == "auto"
    req_cap = False if auto_cap else resolve_bucket_cap(bucket_cap_bytes)
    auto_comp = isinstance(compression, str) and compression == "auto"
    req_comp = None if auto_comp else resolve_compression(compression)
    auto_stage = isinstance(zero_stage, str) and zero_stage == "auto"
    req_stage = None if auto_stage else _resolve_stage(zero_stage)

    def step(state: ZeroTrainState, images, labels):
        plan, stage, comp = _check_state(state, k, (req_cap, req_stage),
                                         auto_comp, req_comp)
        wire = comp.wire_dtype(torch.float32) if comp is not None else None
        model = state.model
        model.train()
        if stage == 3:
            loss, gshard = _grads_zero3(state, plan, images, labels, wire,
                                        resolve_prefetch_depth(prefetch))
        else:
            loss, gshard = _grads_dp(state, plan, stage, images, labels,
                                     wire)
            step.gathers = 0
        state.step += 1
        with torch.no_grad():
            if k > 1:
                state.gaccum.add_(gshard)
                update = state.step % k == 0
                if update:
                    gshard = state.gaccum / k
                    state.gaccum.zero_()
            else:
                update = True
            if update:
                state.pshard.grad = gshard
                state.optimizer.step()
                state.pshard.grad = None
                if stage != 3:
                    step.gathers = _gather_into_model(state, plan)
            stats = [b for b in model.buffers() if b.is_floating_point()]
            if stats:
                torch._foreach_copy_(stats, _coll.grouped_allreduce(
                    stats, axis=state.axis))
        return state, _coll.allreduce(loss.detach(), axis=state.axis)

    def _grads_zero3(state, plan, images, labels, wire, pf):
        run = _Stage3Run(state, plan, pf, wire)
        state.pshard.grad = None
        with torch.autograd.graph.saved_tensors_hooks(run.pack, run.unpack):
            with run.forward_hooks():
                loss = cross_entropy_loss(state.model(images), labels)
                unused = run.unused()
            (loss if unused is None else loss + unused).backward()
        step.gathers = run.gathers
        g = state.pshard.grad
        g = torch.zeros_like(state.pshard) if g is None else g
        state.pshard.grad = None
        return loss, g / state.axis.size

    step.gathers = 0
    return step


def _grads_dp(state, plan, stage, images, labels, wire):
    """Stages 1 and 2: backward on the replicated parameters, then each
    bucket's gradient reduced to this rank's shard of the mean."""
    model, axis = state.model, state.axis
    d, r = axis.size, axis.rank
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(images), labels)
    loss.backward()
    params = [p for _, p in model.named_parameters()]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    offs = plan.seg_offsets(d)
    pending = []
    with torch.no_grad():
        for j in range(len(plan.buckets)):
            flat = _bucket_flat_f32(grads, plan, j)
            slen = plan.bucket_padded[j] // d
            lo = r * slen
            if state.residual is not None:
                # Sharded error feedback: this rank's residual covers its
                # own contribution to its own block.
                res = state.residual[offs[j]:offs[j] + slen]
                my = flat[lo:lo + slen] + res
                flat[lo:lo + slen] = my
                res.copy_(my - my.to(wire).float())
            if stage == 1:
                payload = flat.to(wire) if wire is not None else flat
                work = torch.distributed.all_reduce(
                    payload, group=axis.group, async_op=True)
                pending.append((work, payload, lo, slen))
            else:
                pending.append((None, _coll.zero_reducescatter(
                    flat, axis, wire), 0, slen))
        model.zero_grad(set_to_none=True)
        segs = []
        for work, out, lo, slen in pending:
            if work is not None:
                work.wait()
            seg = out[lo:lo + slen]
            segs.append((seg.float() if wire is not None else seg) / d)
    return loss, torch.cat(segs) if len(segs) > 1 else segs[0]


def _gather_into_model(state, plan) -> int:
    """Stages 1 and 2 after an update: every bucket's fresh masters
    all-gathered at the model's dtype into the replicated parameters.
    Returns the number of gathers."""
    d = state.axis.size
    offs = plan.seg_offsets(d)
    dtype = _gather_dtype(plan)
    params = [p for _, p in state.model.named_parameters()]
    pending = [_coll.zero_allgather(
        state.pshard[offs[j]:offs[j] + plan.bucket_padded[j] // d],
        state.axis, dtype) for j in range(len(plan.buckets))]
    for j, handle in enumerate(pending):
        flat = handle.wait()
        for i, t in _unflatten_bucket(flat, plan, j):
            params[i].copy_(t)
    return len(pending)


class ZeroOverAxis:
    """ZeRO-1 over a mesh axis for the ``DistributedOptimizer``: each rank
    of ``axis`` keeps the optimizer state of its 1/n slice of every
    parameter the axis replicates, updates that slice after the
    reduction and all-gathers it (at the parameter's dtype).

    The parameters of one ``param_group`` and dtype are fused into one
    flat, padded to a multiple of n; each rank's slice of that flat is a
    parameter of the wrapped optimizer. Parameters the axis does not
    replicate (the experts, which dp already spreads) stay whole. The
    update is the unsharded optimizer's, element for element."""

    def __init__(self, param_groups, axis, sharded: Callable):
        self.axis = axis
        n, r = axis.size, axis.rank
        self.flats = []    # (params, shard, padded)
        groups = []
        for group in param_groups:
            by_dtype: Dict[torch.dtype, list] = {}
            whole = []
            for p in group["params"]:
                (by_dtype.setdefault(p.dtype, []) if sharded(p)
                 else whole).append(p)
            shards = []
            for ps in by_dtype.values():
                total = sum(p.numel() for p in ps)
                padded = _shard_len(total, n) * n
                with torch.no_grad():
                    flat = torch.cat([p.detach().reshape(-1) for p in ps])
                    s = padded // n
                    shard = flat.new_zeros(s)
                    lo, hi = r * s, min((r + 1) * s, total)
                    if hi > lo:
                        shard[:hi - lo] = flat[lo:hi]
                shard = nn.Parameter(shard)
                self.flats.append((ps, shard, padded))
                shards.append(shard)
            groups.append(dict(group, params=shards + whole))
        self.param_groups = groups

    @torch.no_grad()
    def load(self) -> None:
        """Each shard's value and gradient: its slice of the parameters
        (which a restore or a broadcast may have changed since the last
        step) and of their reduced ``.grad``s."""
        n, r = self.axis.size, self.axis.rank
        for ps, shard, padded in self.flats:
            s = padded // n
            lo = r * s
            hi = min(lo + s, sum(p.numel() for p in ps))
            grad = shard.new_zeros(s)
            if hi > lo:
                shard.data[:hi - lo] = torch.cat(
                    [p.reshape(-1) for p in ps])[lo:hi]
                grad[:hi - lo] = torch.cat(
                    [p.grad.reshape(-1) for p in ps])[lo:hi]
            shard.grad = grad

    @torch.no_grad()
    def gather(self) -> None:
        """The updated slices all-gathered over the axis into the
        parameters."""
        pending = [(ps, _coll.zero_allgather(shard, self.axis))
                   for ps, shard, _ in self.flats]
        for ps, handle in pending:
            flat, off = handle.wait(), 0
            for p in ps:
                p.copy_(flat[off:off + p.numel()].view_as(p))
                off += p.numel()
