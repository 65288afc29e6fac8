"""Host-tensor staging through NCCL (``HOROVOD_HOST_VIA_XLA=1``).

The port's counterpart of ``horovod_tpu/common/host_staging.py``, which
staged a host world's large fused responses through one compiled psum
over a mesh of one device a process. Here the native cycle routes each
fused host allreduce, broadcast or allgather at or above
``HOROVOD_HOST_VIA_XLA_THRESHOLD`` bytes (``hvd_set_host_via_xla``;
int64, float64, bool allreduces and Adasum stay on the ring, by the
core's guard) to this executor, which copies the fused CPU buffer to the
world's device (``cuda:<local rank>`` by default; the CPU with gloo when
the caller asks, as the tests do), runs one collective there on a process
group and a CUDA stream of its own (the core's ring thread is live in this
process, and two threads on one communicator can hang), and copies the
result back into the output buffers. The knob keeps the reference's name.

The group forms on the controller's base port (the core listens on base
+ 1). Activation is unanimous: a MIN all-reduce on the ring before the
routing turns on. Where the knob is set and this process owns the core's
executor slot, nothing degrades to the ring: no usable device, a group
that does not form, or any rank that cannot stage raises on every rank
after the vote. A process whose core is borrowed from the eager engine
(``hvd.init`` ran) does not stage: the engine owns the slot.

Arithmetic is the ring's, so routing never changes a result: 16-bit floats
accumulate in fp32 and round once; an integer Average is the ring's Sum
(the ring does not scale integers), and integer scale factors are ignored
as there.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import datetime
import queue
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import config as _config
from . import logging as _log
from . import native as _native
from . import timeline as _timeline
from .exceptions import HorovodInternalError

# ReduceOp codes (csrc/hvd/common.h).
_OP_AVERAGE = 0
_OP_SUM = 1
_OP_MIN = 3
_OP_MAX = 4
_DIST_OP = {_OP_AVERAGE: dist.ReduceOp.SUM, _OP_SUM: dist.ReduceOp.SUM,
            _OP_MIN: dist.ReduceOp.MIN, _OP_MAX: dist.ReduceOp.MAX}

# bool moves as its bytes: staging only moves bool data (the core keeps
# bool allreduce on the ring).
_TORCH_FROM_CODE = {**_native.TORCH_FROM_CODE,
                    _native.DTYPE_CODES["bool"]: torch.uint8}
_WIRE = _native.WIRE_DTYPES

# How long forming the staging group may wait for a peer.
GROUP_TIMEOUT = datetime.timedelta(seconds=120)

# No chunked ring broadcast here: the reference built one
# (``_bcast_plan``, ``build_ring_broadcast``) because its psum of zeros
# moved ~2x the payload; NCCL's broadcast moves 1x.


def _as_tensor(ptr: int, count: int, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor over ``count`` elements at the raw address ``ptr``
    (no copy; writes go to that memory)."""
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype)


class HostStagingExecutor:
    """An executor thread and a process group of its own on the world's
    device."""

    def __init__(self, world, core, device):
        self._world = world
        self._core = core
        self.device = torch.device(device)
        self._pg = None
        self._store = None
        self._stream = None
        self._timeline = None
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self.threshold = -1
        self._closed = False
        # (kind, tensors) of each staged response, newest last.
        self.staged = collections.deque(maxlen=4096)

    # -- activation ----------------------------------------------------------

    def check_device(self) -> None:
        """This rank's part of activation, before any peer is contacted:
        the device is there. Raises when it is not."""
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise HorovodInternalError(
                    f"HOROVOD_HOST_VIA_XLA: staging device {self.device} "
                    f"asked for and no CUDA device is available")
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            if index >= torch.cuda.device_count():
                raise HorovodInternalError(
                    f"HOROVOD_HOST_VIA_XLA: no {self.device} "
                    f"({torch.cuda.device_count()} visible)")
            self.device = torch.device("cuda", index)
        elif self.device.type != "cpu":
            raise HorovodInternalError(
                f"HOROVOD_HOST_VIA_XLA: cannot stage on {self.device}")

    def form_group(self) -> None:
        """Form the staging group (NCCL on the card, gloo on the CPU) on
        the controller's base port and prove it with one all-reduce; then
        start the executor thread. Raises on any failure."""
        world = self._world
        store = dist.TCPStore(
            _config.controller_addr(), _config.controller_base_port(),
            world.size, is_master=world.rank == 0, timeout=GROUP_TIMEOUT)
        self._store = dist.PrefixStore("hvd.host_staging", store)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            self._pg = dist.ProcessGroupNCCL(self._store, world.rank,
                                             world.size)
            self._stream = torch.cuda.Stream(self.device)
        else:
            self._pg = dist.ProcessGroupGloo(self._store, world.rank,
                                             world.size, GROUP_TIMEOUT)
        probe = torch.ones(1, device=self.device)
        with self._on_stream():
            self._wait(self._pg.allreduce([probe]))
            if probe.item() != world.size:
                raise HorovodInternalError(
                    f"HOROVOD_HOST_VIA_XLA: the staging group's probe "
                    f"summed to {probe.item()}, not {world.size}")
        cfg = _config.RuntimeConfig.from_env()
        if cfg.timeline_filename:
            self._timeline = _timeline.Timeline(cfg.timeline_filename)
        self.threshold = cfg.host_via_xla_threshold
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hvd-host-staging")
        self._thread.start()
        self._core.register_exec_callback(self._on_responses)

    def enable_routing(self):
        """Route fused host responses at or above the threshold here. Only
        after every rank agreed to stage (``maybe_activate``): a rank on
        the ring and one in NCCL would wait for each other for ever."""
        self._core.set_host_via_xla(self.threshold)
        _log.info(
            f"HOROVOD_HOST_VIA_XLA active: fused host responses >= "
            f"{self.threshold} bytes go through {self._backend()} on "
            f"{self.device} over {self._world.size} processes")

    def close(self):
        """Stop the executor thread and close the timeline. A reject
        callback takes the exec slot first, so a response that arrives
        later fails at once instead of waiting on a queue no thread
        drains."""
        self._closed = True
        core = self._core

        def _reject(responses, rid):
            core.response_done(rid, False, "host staging executor closed")

        core.register_exec_callback(_reject)
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=30.0)
        # Fail anything queued between the thread's exit and the reject
        # callback.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                core.response_done(item[1], False,
                                   "host staging executor closed")
        if self._stream is not None:
            self._stream.synchronize()
        self._pg = None
        self._store = None
        if self._timeline is not None:
            self._timeline.close()
            self._timeline = None

    # -- native callback (cycle thread: enqueue only) ------------------------

    def _on_responses(self, responses, response_id):
        self._q.put((responses, response_id))

    # -- executor thread -----------------------------------------------------

    def _backend(self) -> str:
        return "NCCL" if self.device.type == "cuda" else "gloo"

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad(), self._on_stream():
            while True:
                item = self._q.get()
                if item is None:
                    return
                responses, response_id = item
                if self._closed:
                    self._core.response_done(response_id, False,
                                             "host staging executor closed")
                    continue
                try:
                    for resp in responses:
                        self._execute(resp, response_id)
                    self._core.response_done(response_id, True)
                # Not swallowed: response_done(False) is the host plane's
                # error channel (the waiting caller raises from it).
                except Exception as e:
                    _log.error(f"host staging executor failure: {e}")
                    self._core.response_done(response_id, False, str(e))

    @contextlib.contextmanager
    def _activity(self, names, activity):
        """A timeline span over every tensor of a response, closed in
        ``finally``."""
        if self._timeline:
            for n in names:
                self._timeline.start_activity(n, activity)
        try:
            yield
        finally:
            if self._timeline:
                for n in names:
                    self._timeline.end_activity(n, activity)

    @staticmethod
    def _wait(work):
        """Wait for a collective: on the card, the current stream waits
        for NCCL's."""
        work.wait()

    def _execute(self, resp, response_id):
        kinds = {_native.OP_ALLREDUCE: "allreduce",
                 _native.OP_BROADCAST: "broadcast",
                 _native.OP_ALLGATHER: "allgather"}
        kind = kinds.get(resp.op)
        if resp.plane != _native.PLANE_HOST or kind is None:
            raise HorovodInternalError(
                f"host staging executor got an unexpected response "
                f"(plane={resp.plane}, op={resp.op})")
        self.staged.append((kind, len(resp.names)))
        activity = _timeline.execution_activity(kind, self.device.type)
        with self._activity(resp.names, activity):
            if kind == "allgather":
                self._execute_allgather(resp, response_id)
            else:
                self._execute_reduce(resp, response_id, kind == "broadcast")

    def _execute_reduce(self, resp, response_id, is_bcast):
        """One fused buffer in the response's order (a joined rank's
        missing slots stay zero; a broadcast's non-root ranks send zeros
        that the root's bytes overwrite), one collective, the result
        copied back into each output."""
        dtype = _TORCH_FROM_CODE[resp.dtype]
        counts = [int(np.prod(s)) if s else 1 for s in resp.shapes]
        contribute = not is_bcast or resp.root_rank == self._world.rank
        fused = torch.zeros(sum(counts), dtype=dtype, device=self.device)
        outs = []
        off = 0
        for name, count in zip(resp.names, counts):
            ptrs = self._core.inflight_ptrs(response_id, name)
            if ptrs is not None:
                data_ptr, out_ptr = ptrs
                if contribute:
                    fused[off:off + count].copy_(
                        _as_tensor(data_ptr, count, dtype))
                outs.append((off, count,
                             _as_tensor(out_ptr or data_ptr, count, dtype)))
            off += count
        if is_bcast:
            wire = fused.to(_WIRE.get(dtype, dtype))
            opts = dist.BroadcastOptions()
            opts.rootRank, opts.rootTensor = resp.root_rank, 0
            self._wait(self._pg.broadcast([wire], opts))
            result = wire.to(dtype)
        else:
            result = self._allreduce(fused, resp.reduce_op, resp.prescale,
                                     resp.postscale)
        host = result.cpu()
        for off, count, out in outs:
            out.copy_(host[off:off + count])

    def _allreduce(self, fused, reduce_op, prescale, postscale):
        """The ring's arithmetic: 16-bit floats in fp32, rounded once; an
        Average divides floats by the world's size; integers take no
        scaling."""
        dtype = fused.dtype
        floating = dtype.is_floating_point
        y = fused.float() if dtype in (torch.float16, torch.bfloat16) \
            else fused.to(_WIRE.get(dtype, dtype))
        if floating and prescale != 1.0:
            y = y * prescale
        opts = dist.AllreduceOptions()
        opts.reduceOp = _DIST_OP[reduce_op]
        self._wait(self._pg.allreduce([y], opts))
        if floating:
            if reduce_op == _OP_AVERAGE:
                y = y / self._world.size
            if postscale != 1.0:
                y = y * postscale
        return y.to(dtype)

    def _execute_allgather(self, resp, response_id):
        """Every tensor of the response in one flat buffer (each padded to
        its largest rank's rows), one all-gather, then each tensor's
        per-rank slices joined: into the caller's output, or deposited
        with ``store_result`` for a ragged one (the ring's fetch path)."""
        rank, size = self._world.rank, self._world.size
        dtype = _TORCH_FROM_CODE[resp.dtype]
        regions = []
        off = 0
        for i, name in enumerate(resp.names):
            shape = resp.shapes[i]
            trailing = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            fd = (resp.first_dims[i]
                  if i < len(resp.first_dims) and resp.first_dims[i]
                  else ((shape[0] if shape else 1,) * size))
            counts = [int(d) * trailing for d in fd]
            ptrs = self._core.inflight_ptrs(response_id, name)
            regions.append((name, off, counts, fd, ptrs))
            off += max(int(d) for d in fd) * trailing
        wire_dtype = _WIRE.get(dtype, dtype)
        buf = torch.zeros(max(off, 1), dtype=wire_dtype, device=self.device)
        for name, roff, counts, fd, ptrs in regions:
            if ptrs is not None:
                buf[roff:roff + counts[rank]].copy_(
                    _as_tensor(ptrs[0], counts[rank], dtype))
        parts = [torch.empty_like(buf) for _ in range(size)]
        self._wait(self._pg.allgather([parts], [buf]))
        gathered = torch.stack(parts).to(dtype).cpu()     # [size, len]
        for name, roff, counts, fd, ptrs in regions:
            if ptrs is None:
                continue  # a joined rank's missing slot
            out = torch.cat([gathered[r, roff:roff + counts[r]]
                             for r in range(size)])
            if ptrs[1]:
                _as_tensor(ptrs[1], out.numel(), dtype).copy_(out)
            else:
                handle = self._core.inflight_handle(response_id, name)
                if handle >= 0:
                    self._core.store_result(
                        handle, out.view(torch.uint8).numpy().tobytes(),
                        tuple(int(d) for d in fd))


def _vote(core, values) -> np.ndarray:
    """A MIN all-reduce of ``values`` (float32) on the ring. Straight onto
    the core: the host world is not initialized yet."""
    flag = np.asarray(values, np.float32)
    h = core.enqueue("__hvd.staging.agree", _native.OP_ALLREDUCE, _OP_MIN,
                     _native.DTYPE_CODES["float32"], flag.shape,
                     data_ptr=flag.ctypes.data, output_ptr=flag.ctypes.data,
                     plane=_native.PLANE_HOST)
    r, err = core.wait(h)
    if r != 1:
        raise HorovodInternalError(
            f"HOROVOD_HOST_VIA_XLA: the staging vote failed on the ring "
            f"({err})")
    return flag


def maybe_activate(world, core, owns_exec_slot: bool = True,
                   device=None) -> Optional[HostStagingExecutor]:
    """Called by ``HostWorld.init`` on every multi-process world, with the
    knob or without it: returns the active executor, or None when no rank
    asked for staging. Every rank votes twice on the ring: once on its
    local activation (``[ok, -wanted]``, MIN), once on the group's
    formation. When any rank asked and any rank cannot stage, every rank
    raises ``HorovodInternalError``: a world never splits between the
    ring and NCCL, and a rank that asked for the device never degrades to
    the ring. ``owns_exec_slot=False`` (the core is the eager engine's)
    refuses staging with a warning and votes no."""
    if core is None or world.size <= 1:
        return None
    wanted = _config._get_bool(_config.HOROVOD_HOST_VIA_XLA)
    if wanted and not owns_exec_slot:
        _log.warning("HOROVOD_HOST_VIA_XLA ignored: the eager engine "
                     "(hvd.init) owns the executor slot of this process's "
                     "core")
        wanted = False
    ex, why = None, ""
    if wanted:
        if device is None:
            device = f"cuda:{world.local_rank}"
        ex = HostStagingExecutor(world, core, device)
        try:
            ex.check_device()
        except HorovodInternalError as e:
            ex, why = None, str(e)
    ok_min, neg_wanted = _vote(core, [1.0 if ex is not None else 0.0,
                                      -1.0 if wanted else 0.0])
    if neg_wanted == 0.0:
        return None          # no rank asked for staging
    if ok_min < 1.0:
        raise HorovodInternalError(
            f"HOROVOD_HOST_VIA_XLA is set on some rank, but not every rank "
            f"can stage (unanimity required; no fallback to the ring)"
            + (f": on rank {world.rank}, {why}" if why else
               ("" if wanted else f": rank {world.rank} did not ask")))
    formed, why = 1.0, ""
    try:
        ex.form_group()
    except Exception as e:
        formed, why = 0.0, f"{type(e).__name__}: {e}"
    if _vote(core, [formed])[0] < 1.0:
        ex.close()
        raise HorovodInternalError(
            f"HOROVOD_HOST_VIA_XLA: the staging group did not form on every "
            f"rank" + (f" (rank {world.rank}: {why})" if why else ""))
    ex.enable_routing()
    return ex
