"""Eager collective engine: Horovod's named, asynchronous collectives on
``torch.distributed``.

The port's counterpart of ``horovod_tpu/ops/eager.py``. Two planes:

- **Control plane (native, C++)**: the port's copy of the native core
  (``csrc/hvd``, bound by ``common/native.py``) owns the background cycle,
  the tensor queue, the coordinator's negotiation (a TCP star on the
  base port + 1), fusion planning, the response cache, the stall
  inspector and join. Each rank submits a named tensor; the coordinator
  answers once every rank has submitted it, fusing what arrived together
  into one response, in an order every rank shares.
- **Execution plane (torch.distributed)**: fused responses come back
  through a callback on the core's thread, which only queues them. One
  executor thread runs each response as collectives on a process group of
  the engine's own (NCCL on a GPU, gloo on the CPU): the caller's thread
  keeps the world's group for its own collectives (the optimizer's bucket
  all-reduces, ZeRO's gathers), and two threads issuing on one
  communicator could queue their collectives in different orders on two
  ranks. Its hierarchical dispatch runs on local and cross groups of
  the engine's own for the same reason. On a GPU the executor runs on a
  CUDA stream of its own: a
  submission records a ready event on the caller's current stream, which
  the executor's stream waits for before the collective reads the tensor
  (Horovod's ReadyEvent); a completion event recorded after it is what
  ``poll`` queries and what ``synchronize`` makes the caller's stream
  wait for. ``record_stream`` keeps inputs and results alive across the
  two streams.

Handles are the native handle table's ints (negative ones are direct).
A failed response raises ``HorovodInternalError`` at ``synchronize``.

The runtime planes hook in as in the JAX package's engine: a named
submission opens its ``NEGOTIATE_<KIND>`` span in the timeline, the
executor closes it and opens the execution activity (``NCCL_<KIND>`` on
the card, ``GLOO_<KIND>`` on the CPU; on the card it closes when the
response's completion event has passed, read by a finalizer thread, as
Horovod's GPU timeline does) and records the coordinator's per-rank
ticks; the ``xla.exec`` fault point (the reference's name, so one
``HOROVOD_FAULT_SPEC`` drives both) fires at the top of each response;
the autotuner is fed each response's application bytes (before
compression); the metrics pump runs while the engine does.

Direct mode: with ``HOROVOD_NATIVE=0`` every collective runs at once on
the caller's thread and the world's group (no negotiation, no fusion),
with the same results. ``grouped_allreduce_async`` always runs so, as in
the JAX package (one explicitly fused unit).

One device a process: a tensor (torch or numpy) is this rank's
contribution. A torch tensor gives back a tensor on the engine's device,
a numpy array gives back numpy; a list raises.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common import config as _config
from ..common import faults as _faults
from ..common import logging as _log
from ..common import metrics as _metrics
from ..common import native as _native
from ..common import timeline as _timeline
from ..common.compression import resolve_compression
from ..common.exceptions import DuplicateTensorNameError, HorovodInternalError
from ..parallel.mesh import AxisGroup, host_ranks
from . import collectives as _coll
from .collectives import ReduceOp

_OP_TO_NATIVE = {
    "allreduce": _native.OP_ALLREDUCE,
    "allgather": _native.OP_ALLGATHER,
    "broadcast": _native.OP_BROADCAST,
    "reducescatter": _native.OP_REDUCESCATTER,
    "alltoall": _native.OP_ALLTOALL,
}
_KIND_FROM_OP = {v: k for k, v in _OP_TO_NATIVE.items()}

_DTYPE_CODE = _native.TORCH_DTYPE_CODES
_DTYPE_FROM_CODE = _native.TORCH_FROM_CODE
_WIRE = _native.WIRE_DTYPES


class _Pending:
    """A tensor submitted to the native queue, awaiting execution."""

    __slots__ = ("tensor", "was_numpy", "kind", "op", "prescale",
                 "postscale", "root", "ready", "done", "result", "error")

    def __init__(self, tensor, was_numpy, kind, op, prescale, postscale,
                 root, ready):
        self.tensor = tensor
        self.was_numpy = was_numpy
        self.kind = kind
        self.op = op
        self.prescale = prescale
        self.postscale = postscale
        self.root = root
        self.ready = ready
        self.done = None
        self.result = None
        self.error = None


class EagerEngine:
    """Per-process engine: native control plane + torch.distributed
    execution plane. ``hvd.init`` makes it after the process groups (every
    rank makes the engine's group in the same order); ``hvd.shutdown``
    stops it before any group is destroyed."""

    def __init__(self, state):
        self._state = state
        self._device = state.device
        self._lock = threading.Lock()
        self._name_counter = 0
        self._pending: Dict[str, _Pending] = {}
        self._handle_names: Dict[int, str] = {}
        # Direct handles count down from -1, so they never collide with
        # the native table's, which count up from 0.
        self._direct_handles: Dict[int, Tuple] = {}
        self._next_direct = -1
        self._joined = False
        # (kind, tensors) of each response the executor ran, newest last.
        self.response_sizes = collections.deque(maxlen=4096)
        backend = "nccl" if self._device.type == "cuda" else "gloo"
        self._group = dist.new_group(backend=backend)
        self._own_groups = [self._group]
        self._axis = AxisGroup(self._group, tuple(range(state.size)),
                               state.rank)
        self._world = AxisGroup(None, tuple(range(state.size)), state.rank)
        self._stream = None
        self._native = False
        # (done event, names, activity) of responses whose execution
        # activity closes when the card has run them (timeline only).
        self._finalize_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._finalizer = None
        try:
            self._hosts = self._make_hosts(backend)
            self._core = _native.NativeCore()
            if self._core.available:
                self._start_native()
        except BaseException:
            self._destroy_groups()
            raise
        _metrics.maybe_start_pump()

    def _make_hosts(self, backend):
        """The engine's own (local, cross) groups, so that a hierarchical
        response never runs on a communicator of the caller's thread; None
        when the local size does not divide the world. Every rank makes
        every group in the same order."""
        st = self._state
        lines = host_ranks(st.size, st.local_size)
        if lines is None:
            return None
        pair = []
        for groups in lines:
            for ranks in groups:
                if len(ranks) == st.size:
                    group = self._group
                else:
                    group = dist.new_group(list(ranks), backend=backend)
                if st.rank in ranks:
                    if group is not self._group:
                        self._own_groups.append(group)
                    mine = AxisGroup(group, ranks, ranks.index(st.rank))
            pair.append(mine)
        return tuple(pair)

    def _destroy_groups(self):
        for group in self._own_groups:
            dist.destroy_process_group(group)
        self._own_groups = []

    def _start_native(self):
        st, cfg = self._state, self._state.config
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)
        self._exec_q: "queue.SimpleQueue" = queue.SimpleQueue()
        port = _config.native_controller_port()
        ok = self._core.init(
            rank=st.rank, size=st.size, local_rank=st.local_rank,
            local_size=st.local_size, cross_rank=st.cross_rank,
            cross_size=st.cross_size,
            coordinator_addr=_config.controller_addr(),
            coordinator_port=port,
            my_host=_config.hostname("127.0.0.1"),
            cycle_time_ms=cfg.cycle_time_ms,
            fusion_threshold=cfg.fusion_threshold_bytes,
            cache_capacity=cfg.cache_capacity,
            stall_warning_sec=cfg.stall_warning_seconds,
            stall_shutdown_sec=cfg.stall_shutdown_seconds,
            stall_check_enabled=not cfg.stall_check_disable,
            exec_callback=self._on_responses,
            heartbeat_ms=_config.heartbeat_ms(),
            liveness_timeout_ms=_config.liveness_timeout_ms())
        if not ok:
            raise HorovodInternalError(
                f"the native core did not start (controller "
                f"{_config.controller_addr()}:{port}); HOROVOD_NATIVE=0 "
                f"runs the eager collectives in direct mode")
        if cfg.timeline_filename:
            # The coordinator records each rank's submission ticks for the
            # timeline (NegotiateRankReady) from the first one on: a peer
            # may submit as soon as the core is up.
            self._core.set_record_negotiation(True)
        self._native = True
        self._executor = threading.Thread(
            target=self._executor_loop, daemon=True, name="hvd-eager-executor")
        self._executor.start()

    # -- lifecycle -----------------------------------------------------------

    @property
    def native_core(self):
        """The NativeCore when the native control plane is live, else
        None (direct mode)."""
        return self._core if self._native else None

    def _record_autotune(self, tensors) -> None:
        """Feed the tuner (rank 0) one response's application bytes, before
        compression."""
        tuner = self._state.autotuner
        if tuner is None or not tuner.active:
            return
        tuner.update(sum(t.numel() * t.element_size() for t in tensors))

    def shutdown(self):
        # The pump's last publish still sees the live core and timeline.
        _metrics.stop_pump()
        if self._native:
            self._core.shutdown()
            self._exec_q.put(None)
            self._executor.join(timeout=30.0)
            if self._executor.is_alive():
                raise HorovodInternalError(
                    "the eager executor did not stop within 30 s")
            self._native = False
        if self._finalizer is not None:
            self._finalize_q.put(None)
            self._finalizer.join(timeout=30.0)
            self._finalizer = None
        if self._stream is not None:
            self._stream.synchronize()
        with self._lock:
            self._pending.clear()
            self._handle_names.clear()
            self._direct_handles.clear()
        self._destroy_groups()

    # -- native callback + executor ------------------------------------------

    def _on_responses(self, responses, response_id):
        """Called on the native cycle thread: only queue the work."""
        self._exec_q.put((responses, response_id))

    def _executor_loop(self):
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        if self._stream is not None:
            torch.cuda.set_device(self._device)
        with torch.no_grad(), stream:
            while True:
                item = self._exec_q.get()
                if item is None:
                    return
                responses, response_id = item
                try:
                    for resp in responses:
                        self._execute_response(resp)
                    self._core.response_done(response_id, True)
                # Not swallowed: the error lands in every pending entry
                # (raised at synchronize) and in response_done(False).
                except Exception as e:
                    _log.error(f"eager executor failure: {e}")
                    with self._lock:
                        for resp in responses:
                            for name in resp.names:
                                p = self._pending.get(name)
                                if p is not None:
                                    p.error = e
                    self._core.response_done(response_id, False, str(e))

    def _execute_response(self, resp: "_native.NativeResponse"):
        # The device plane's chaos seam: a fault here fails the response
        # like a real executor failure (every pending entry errors), on
        # every rank (voted, so no rank waits in a collective its peer
        # skipped).
        _faults.voted_point("xla.exec", self._vote, rank=self._state.rank)
        timeline = self._state.timeline
        if timeline is not None:
            # The coordinator's per-rank submission ticks (rank 0 only).
            for rank, mono_ns, tname in self._core.drain_negotiation():
                timeline.rank_ready(tname, rank, mono_ns)
        names = resp.names
        with self._lock:
            found = {n: self._pending[n] for n in names if n in self._pending}
        if not found and not self._joined:
            return
        kind = _KIND_FROM_OP.get(resp.op)
        if kind is None:
            return
        self.response_sizes.append((kind, len(names)))
        activity = _timeline.execution_activity(kind, self._device.type)
        if timeline is not None:
            for n in found:
                timeline.end_activity(n, _timeline.negotiate_activity(kind))
                timeline.start_activity(n, activity)
        for p in found.values():
            self._wait_ready(p)
        # The hierarchical flags stamped into this frame (-1: untuned, the
        # env config decides), the same on every rank.
        hf = resp.hier_flags
        hier_ar = None if hf < 0 else bool(hf & 1)
        hier_ag = None if hf < 0 else bool(hf & 2)
        if kind == "allreduce":
            # The response's canonical order; a joined rank contributes
            # zeros for the tensors it does not hold.
            dtype = _DTYPE_FROM_CODE[resp.dtype]
            ts = [found[n].tensor if n in found
                  else torch.zeros(resp.shapes[i], dtype=dtype,
                                   device=self._device)
                  for i, n in enumerate(names)]
            outs = self._allreduce(ts, resp.reduce_op, resp.prescale,
                                   resp.postscale, self._axis,
                                   self._hosts, hier_ar)
            for n, out in zip(names, outs):
                if n in found:
                    found[n].result = out
        elif kind == "allgather":
            for i, n in enumerate(names):
                if n in found:
                    fd = resp.first_dims[i] if i < len(resp.first_dims) \
                        else ()
                    found[n].result = self._allgather(
                        found[n].tensor, fd, self._axis, self._hosts,
                        hier_ag)
        else:
            for p in found.values():
                p.result = self._one(kind, p, self._axis)
        done = None
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
            for p in found.values():
                p.done = done
        if timeline is not None:
            self._end_activity(timeline, done, list(found), activity)
        self._record_autotune([p.tensor for p in found.values()])

    def _end_activity(self, timeline, done, names, activity):
        """Close the execution activity of ``names``: at once on the CPU,
        when ``done`` has passed on the card (a finalizer thread waits for
        it, so the executor never does)."""
        if done is None:
            for n in names:
                timeline.end_activity(n, activity)
            return
        if self._finalizer is None:
            self._finalizer = threading.Thread(
                target=self._finalize_loop, daemon=True,
                name="hvd-eager-timeline-finalizer")
            self._finalizer.start()
        self._finalize_q.put((done, names, activity))

    def _finalize_loop(self):
        while True:
            item = self._finalize_q.get()
            if item is None:
                return
            done, names, activity = item
            done.synchronize()
            timeline = self._state.timeline
            if timeline is not None:
                for n in names:
                    timeline.end_activity(n, activity)

    def _vote(self, ok: bool) -> bool:
        """True when every rank's ``ok`` is (a MIN all-reduce on the
        engine's group, on the executor's thread)."""
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=self._device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self._group)
        return bool(flag.item())

    def _wait_ready(self, p: _Pending):
        if p.ready is not None:
            self._stream.wait_event(p.ready)
            p.tensor.record_stream(self._stream)

    # -- execution (the executor on the engine's group, direct mode on
    #    the world's) ----------------------------------------------------------

    def _use_hierarchical(self, flag: bool, op=None, override=None) -> bool:
        """``HOROVOD_HIERARCHICAL_*`` dispatch: the flag (or the frame's
        tuned override, which every rank applies alike) routes to the
        local/cross legs when those groups exist. Sum and Average only;
        for Adasum flat and hierarchical are different math, so only the
        static flag picks."""
        groups = self._state.groups
        has_hier = "local" in groups and "cross" in groups
        if op == ReduceOp.ADASUM:
            return bool(flag) and has_hier
        if override is not None:
            flag = override
        if not flag or not has_hier:
            return False
        return op is None or op in (ReduceOp.SUM, ReduceOp.AVERAGE)

    def _allreduce(self, ts: List[torch.Tensor], op, prescale, postscale,
                   axis, hosts=None, hier_override=None
                   ) -> List[torch.Tensor]:
        """``ops/collectives.grouped_allreduce``'s wire and arithmetic on
        one bucket per dtype (16-bit floats accumulate in fp32); the
        ``"auto"`` compression, with ef16 on its fp16 wire (error feedback
        needs per-parameter state that only the optimizer keeps). ``axis``
        and ``hosts`` (the local and cross groups, default the world's)
        are the groups to run on."""
        hier = self._use_hierarchical(
            self._state.config.hierarchical_allreduce, op,
            override=hier_override)
        comp = resolve_compression("auto")
        if comp is not None and comp.error_feedback:
            comp = comp.inner
        dtypes = [t.dtype for t in ts]
        ts = [t.to(_WIRE.get(t.dtype, t.dtype)) for t in ts]
        if hier:
            outs = _coll.grouped_hierarchical_allreduce(
                ts, op=op, prescale_factor=prescale,
                postscale_factor=postscale, compression=comp, hosts=hosts)
        else:
            outs = _coll.grouped_allreduce(
                ts, op=op, prescale_factor=prescale,
                postscale_factor=postscale, compression=comp, axis=axis)
        return [o.to(d) for o, d in zip(outs, dtypes)]

    def _allgather(self, t, first_dims, axis, hosts=None,
                   hier_override=None):
        """Every rank's ``t`` joined along dim 0; when the first dims are
        ragged, each rank pads to the largest, gathers, and slices."""
        hier = self._use_hierarchical(
            self._state.config.hierarchical_allgather,
            override=hier_override)
        dtype = t.dtype
        t = t.to(_WIRE.get(dtype, dtype))

        def gather(x):
            return (_coll.hierarchical_allgather(x, hosts) if hier
                    else _coll.allgather(x, axis=axis))

        if first_dims and len(set(first_dims)) > 1:
            max0 = max(first_dims)
            pad = t.new_zeros((max0 - t.shape[0],) + tuple(t.shape[1:]))
            views = gather(torch.cat([t, pad])).view(
                (len(first_dims), max0) + tuple(t.shape[1:]))
            out = torch.cat([views[r, :n] for r, n in enumerate(first_dims)])
        else:
            out = gather(t)
        return out.to(dtype)

    def _one(self, kind, p: _Pending, axis):
        """broadcast, reducescatter or alltoall of one entry."""
        dtype = p.tensor.dtype
        t = p.tensor.to(_WIRE.get(dtype, dtype))
        if kind in ("reducescatter", "alltoall"):
            _check_same_shape(kind, t, axis)
        if kind == "broadcast":
            out = t.clone()
            dist.broadcast(out, src=axis.global_rank(p.root), group=axis.group)
        elif kind == "reducescatter":
            out = _coll.reducescatter(t, op=p.op, axis=axis)
        elif kind == "alltoall":
            out = _coll.alltoall(t, axis=axis)
        else:
            raise ValueError(f"unknown response kind {kind}")
        return out.to(dtype)

    # -- submission ----------------------------------------------------------

    def _auto_name(self, prefix: str) -> str:
        with self._lock:
            self._name_counter += 1
            return f"{prefix}.noname.{self._name_counter}"

    def _normalize(self, tensor) -> Tuple[torch.Tensor, bool]:
        """(this rank's tensor on the engine's device, was numpy)."""
        if isinstance(tensor, (list, tuple)):
            raise ValueError(
                "eager collectives take one tensor a process (one device a "
                "process); got a list")
        if isinstance(tensor, torch.Tensor):
            t, was_numpy = tensor.detach(), False
        else:
            t, was_numpy = torch.from_numpy(np.array(tensor)), True
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"eager collectives do not carry {t.dtype}")
        return t.to(self._device), was_numpy

    def _submit(self, kind: str, name: Optional[str], tensor, op=None,
                prescale=1.0, postscale=1.0, root=-1) -> int:
        t, was_numpy = self._normalize(tensor)
        if kind in ("reducescatter", "alltoall") and (
                t.dim() == 0 or t.shape[0] % self._state.size):
            raise ValueError(
                f"{kind} requires dim 0 divisible by size "
                f"({list(t.shape)}, size {self._state.size})")
        if kind == "allgather" and t.dim() == 0:
            raise ValueError("allgather requires at least one dimension")
        name = name or self._auto_name(kind)
        if not self._native:
            return self._direct(kind, name, [t], [was_numpy], op, prescale,
                                postscale, root)
        ready = None
        if t.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(t.device))
        with self._lock:
            if name in self._pending:
                raise DuplicateTensorNameError(
                    f"tensor name '{name}' already submitted and not yet "
                    "complete")
            self._pending[name] = _Pending(t, was_numpy, kind, op, prescale,
                                           postscale, root, ready)
        timeline = self._state.timeline
        negotiate = _timeline.negotiate_activity(kind)
        if timeline is not None:
            timeline.start_activity(name, negotiate)
        handle = self._core.enqueue(
            name, _OP_TO_NATIVE[kind], op if op is not None else ReduceOp.SUM,
            _DTYPE_CODE[t.dtype], tuple(t.shape), root_rank=root,
            prescale=prescale, postscale=postscale, plane=_native.PLANE_XLA)
        if handle < 0:
            with self._lock:
                self._pending.pop(name, None)
            if timeline is not None:
                timeline.end_activity(name, negotiate)
            raise HorovodInternalError(
                "native enqueue failed (runtime not initialized or shutting "
                "down)")
        r, reason = self._core.test(handle)
        if r < 0 and "Duplicate tensor name" in reason:
            with self._lock:
                self._pending.pop(name, None)
            if timeline is not None:
                timeline.end_activity(name, negotiate)
            raise DuplicateTensorNameError(reason)
        with self._lock:
            self._handle_names[handle] = name
        return handle

    def _direct(self, kind, name, ts, was_numpy, op=None, prescale=1.0,
                postscale=1.0, root=-1, grouped=False) -> int:
        """Run at once on the caller's thread and the world's group; the
        handle keeps the result (a list when ``grouped``), or the error,
        which synchronize raises."""
        with self._lock:
            if name in {e[2] for e in self._direct_handles.values()}:
                raise DuplicateTensorNameError(
                    f"tensor name '{name}' already submitted and not yet "
                    "complete")
        try:
            if kind == "allreduce":
                outs = self._allreduce(ts, op, prescale, postscale,
                                       self._world)
            elif kind == "allgather":
                # No negotiated dim table: exchange the first dims first.
                dims = self._world_first_dims(ts[0])
                outs = [self._allgather(ts[0], dims, self._world)]
            else:
                p = _Pending(ts[0], False, kind, op, prescale, postscale,
                             root, None)
                outs = [self._one(kind, p, self._world)]
            self._record_autotune(ts)
            err = None
        # Deferred, not swallowed: synchronize raises it on this thread.
        except Exception as e:
            outs, err = None, e
        done = None
        if err is None and self._device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._device))
        with self._lock:
            h = self._next_direct
            self._next_direct -= 1
            self._direct_handles[h] = (err if err is not None else outs,
                                       was_numpy, name, done, grouped)
        return h

    def _world_first_dims(self, t) -> Tuple[int, ...]:
        mine = torch.tensor([t.shape[0]], dtype=torch.int64,
                            device=self._device)
        return tuple(int(d) for d in _coll.allgather(mine, axis=self._world))

    # -- public API ----------------------------------------------------------

    def allreduce_async(self, tensor, name: Optional[str] = None,
                        op: int = ReduceOp.AVERAGE,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0) -> int:
        if op == ReduceOp.ADASUM:
            # Hierarchical Adasum needs a power-of-two cross size, flat
            # Adasum a power-of-two world.
            hier = self._use_hierarchical(
                self._state.config.hierarchical_allreduce, op)
            n = self._state.cross_size if hier else self._state.size
            if not _is_pow2(n):
                _log.warning("Adasum requested with non-power-of-two "
                             "participant count; falling back to Average")
                op = ReduceOp.AVERAGE
        return self._submit("allreduce", name, tensor, op=op,
                            prescale=prescale_factor,
                            postscale=postscale_factor)

    def grouped_allreduce_async(self, tensors: List,
                                name: Optional[str] = None,
                                op: int = ReduceOp.AVERAGE,
                                prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0) -> int:
        """An explicitly fused allreduce of a list of tensors (one bucket
        per dtype), run at once on the caller's thread as one unit,
        whatever the mode, as in the JAX package."""
        norm = [self._normalize(t) for t in tensors]
        return self._direct("allreduce",
                            name or self._auto_name("grouped_allreduce"),
                            [t for t, _ in norm], [w for _, w in norm], op,
                            prescale_factor, postscale_factor, grouped=True)

    def allgather_async(self, tensor, name: Optional[str] = None) -> int:
        return self._submit("allgather", name, tensor)

    def broadcast_async(self, tensor, root_rank: int,
                        name: Optional[str] = None) -> int:
        if not 0 <= root_rank < self._state.size:
            raise ValueError(f"root_rank {root_rank} outside the world of "
                             f"{self._state.size}")
        return self._submit("broadcast", name, tensor, root=root_rank)

    def reducescatter_async(self, tensor, name: Optional[str] = None,
                            op: int = ReduceOp.SUM) -> int:
        return self._submit("reducescatter", name, tensor, op=op)

    def alltoall_async(self, tensor, name: Optional[str] = None) -> int:
        return self._submit("alltoall", name, tensor)

    def join(self) -> int:
        """Graceful departure: blocks until every rank has joined; while
        waiting, this rank contributes zeros to the others' allreduces.
        Returns the rank that joined last."""
        st = self._state
        if not self._native or st.size == 1:
            self.barrier()
            return st.size - 1
        self._joined = True
        try:
            handle = self._core.join()
            if handle < 0:
                raise HorovodInternalError("join enqueue failed")
            r, reason = self._core.wait(handle)
            if r < 0:
                raise HorovodInternalError(reason)
        finally:
            self._joined = False
        return self._core.last_joined()

    def barrier(self):
        """Wait for every rank. With the native core and more than one
        process it is negotiated, so it completes among the active ranks
        while another is blocked in ``join``."""
        if self._native and self._state.size > 1:
            z = np.zeros(1, np.uint8)
            h = self._core.enqueue(
                self._auto_name("eager.barrier"), _native.OP_BARRIER, 1, 0,
                tuple(z.shape), data_ptr=z.ctypes.data,
                output_ptr=z.ctypes.data, plane=_native.PLANE_HOST)
            if h < 0:
                raise HorovodInternalError("barrier enqueue failed")
            r, reason = self._core.wait(h)
            if r < 0:
                raise HorovodInternalError(reason)
            return
        int(_coll.barrier(self._world))

    # -- handles -------------------------------------------------------------

    def poll(self, handle: int) -> bool:
        """True once the collective behind ``handle`` has completed (on a
        GPU: its completion event has passed)."""
        with self._lock:
            name = self._handle_names.get(handle)
        if self._native and name is not None:
            r, _ = self._core.test(handle)
            if r == 0:
                return False
            with self._lock:
                p = self._pending.get(name)
            return p is None or p.done is None or p.done.query()
        with self._lock:
            entry = self._direct_handles.get(handle)
        if entry is None:
            raise ValueError(f"unknown handle {handle}")
        done = entry[3]
        return done is None or done.query()

    def synchronize(self, handle: int):
        """Wait for the collective behind ``handle`` and return its result
        (ordered before later work on the caller's current stream)."""
        if self._native and handle in self._handle_names:
            r, reason = self._core.wait(handle)
            with self._lock:
                name = self._handle_names.pop(handle)
                pending = self._pending.pop(name, None)
            if r < 0:
                # An error response resolves in the core and never reaches
                # the executor: close its negotiation span here.
                timeline = self._state.timeline
                if timeline is not None and pending is not None:
                    timeline.end_activity(
                        name, _timeline.negotiate_activity(pending.kind))
                raise HorovodInternalError(reason)
            if pending is None or (pending.result is None
                                   and pending.error is None):
                raise HorovodInternalError(f"no result recorded for "
                                           f"'{name}'")
            if pending.error is not None:
                raise HorovodInternalError(str(pending.error)) \
                    from pending.error
            return self._to_caller(pending.result, pending.was_numpy,
                                   pending.done)
        with self._lock:
            entry = self._direct_handles.pop(handle, None)
        if entry is None:
            raise ValueError(
                f"unknown or already-synchronized handle {handle}")
        outs, was_numpy, _, done, grouped = entry
        if isinstance(outs, Exception):
            raise HorovodInternalError(str(outs)) from outs
        res = [self._to_caller(o, w, done) for o, w in zip(outs, was_numpy)]
        return res if grouped else res[0]

    def _to_caller(self, result, was_numpy, done):
        if done is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(done)
            result.record_stream(current)
        return result.cpu().numpy() if was_numpy else result


def _check_same_shape(kind, t, axis):
    """Raise on every rank when the ranks' shapes differ. The native
    controller checks the shapes of allreduce and broadcast only; a
    reducescatter or alltoall of unequal shapes would otherwise hang in
    the collective. One small allgather of the shapes, so every rank sees
    the same table and raises alike."""
    if t.dim() > 15:
        raise ValueError(f"{kind}: at most 15 dimensions")
    mine = torch.full((16,), -1, dtype=torch.int64, device=t.device)
    mine[0] = t.dim()
    mine[1:1 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    table = _coll.allgather(mine[None], axis=axis)
    if not bool((table == table[0]).all()):
        shapes = [tuple(int(d) for d in row[1:1 + int(row[0])])
                  for row in table.cpu()]
        raise ValueError(f"Mismatched shapes submitted for {kind}: "
                         f"{shapes} by rank")


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0
