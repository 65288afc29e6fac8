"""ctypes binding to the port's native core (``csrc/hvd``).

The port's own copy of the JAX package's binding: it builds the C++ core
from ``horovod_tpu_torch/csrc/hvd`` (a copy of the JAX package's sources,
with the same wire format), loads it, exposes the C API, and bridges the
device-plane execution callback. The library owns the background cycle
thread, the tensor queue, the controller's negotiation, fusion planning,
the response cache and the stall inspector; Python owns only the
execution of the responses (``ops/eager.py``, on ``torch.distributed``).

The build: every ``.cc`` compiles at once with ``g++ -O2 -std=c++17
-fPIC -pthread`` and the objects link into one library in
``build/horovod_tpu_torch/``, named by a hash of the sources, the headers,
the flags, the compiler's version and the host's machine and C library,
so an edit, or a build directory copied from another host, builds anew
and an unchanged tree builds once.
It runs under a file lock (processes that start together build once) and
renames the library into place. Nothing is built when the module is
imported. A failed build or load raises: there is no quiet fallback, and
only ``HOROVOD_NATIVE=0`` turns the core off.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from . import config as _config
from . import logging as _log

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc" / "hvd"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "horovod_tpu_torch"
# The translation units of the core, in link order.
SOURCES = ("message.cc", "tensor_queue.cc", "socket.cc", "controller.cc",
           "response_cache.cc", "stall_inspector.cc", "op_manager.cc",
           "shm_transport.cc", "stripe_transport.cc", "ring_ops.cc",
           "metrics.cc", "operations.cc")
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread"]
# librt: shm_open/shm_unlink live there on pre-2.34 glibc.
LDLIBS = ["-lrt"]


def source_paths() -> List[Path]:
    """Every file the library is built from: the sources, then the
    headers beside them."""
    return ([CSRC_DIR / name for name in SOURCES]
            + sorted(CSRC_DIR.glob("*.h")))


def library_path() -> Path:
    """Where the library lives: named by a hash of every source and
    header (names and bytes), the flags and the toolchain."""
    digest = hashlib.sha256()
    for path in source_paths():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(CXXFLAGS + LDLIBS).encode())
    digest.update(_toolchain().encode())
    return BUILD_DIR / f"libhvdcore-{digest.hexdigest()[:16]}.so"


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def _toolchain() -> str:
    """The compiler's ``--version``, the machine and the C library: a
    library built by another toolchain or host gets another name."""
    cxx = _compiler()
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"native core: the compiler {cxx!r} does not "
                           f"run: {e}") from e
    return "\n".join([cxx, version, platform.machine(),
                      " ".join(platform.libc_ver())])


def build() -> Path:
    """Build the library unless it exists; returns its path. Raises with
    the compiler's output when a step fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "hvdcore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():          # built while this process waited
            return out
        tmp = Path(tempfile.mkdtemp(prefix="hvdcore-", dir=BUILD_DIR))
        try:
            cxx = _compiler()
            objs = [tmp / (name[:-3] + ".o") for name in SOURCES]
            procs = [subprocess.Popen(
                [cxx, *CXXFLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for name, obj in zip(SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            failed = [f"{name}:\n{log}" for name, p, log
                      in zip(SOURCES, procs, logs) if p.returncode != 0]
            if failed:
                raise RuntimeError("native core build failed:\n"
                                   + "\n".join(failed))
            lib = tmp / out.name
            link = subprocess.run(
                [cxx, *CXXFLAGS, "-shared", "-o", str(lib),
                 *map(str, objs), *LDLIBS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"native core link failed:\n"
                                   f"{link.stdout}")
            os.replace(lib, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


# dtype codes must match csrc/hvd/common.h DataType
DTYPE_CODES = {
    "uint8": 0,
    "int8": 1,
    "uint16": 2,
    "int16": 3,
    "int32": 4,
    "int64": 5,
    "float16": 6,
    "float32": 7,
    "float64": 8,
    "bool": 9,
    "bfloat16": 10,
}

# The torch dtype of each code, and back.
TORCH_DTYPES = {
    "uint8": torch.uint8, "int8": torch.int8, "uint16": torch.uint16,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bool": torch.bool,
    "bfloat16": torch.bfloat16,
}
TORCH_DTYPE_CODES = {TORCH_DTYPES[n]: c for n, c in DTYPE_CODES.items()}
TORCH_FROM_CODE = {c: TORCH_DTYPES[n] for n, c in DTYPE_CODES.items()}
# Dtypes neither NCCL nor gloo carries travel as int32: exact for every
# op the executors run (a sum wraps to the same 16 bits either way).
WIRE_DTYPES = {torch.int16: torch.int32, torch.uint16: torch.int32}

OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_JOIN = 3
OP_REDUCESCATTER = 4
OP_ALLTOALL = 5
OP_BARRIER = 6

# The request's plane (the wire keeps the JAX package's names). PLANE_XLA
# is the device plane: its responses go to the executor callback, which
# the port's ops/eager.py runs on torch.distributed. PLANE_HOST runs in
# the C++ core on its TCP ring (the port's barrier uses it).
PLANE_XLA = 0
PLANE_HOST = 1

_EXEC_CB_TYPE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_char),
                                 ctypes.c_int, ctypes.c_long)
# hvd_enqueue_cb's per-handle completion callback:
# done(done_arg, handle, ok, reason)
_DONE_CB_TYPE = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_char_p)


_lib = None
_load_lock = threading.Lock()
# Every registered CFUNCTYPE trampoline stays referenced forever: the C++
# cycle thread may hold a superseded pointer across a re-registration,
# and freeing it would turn that in-flight call into a jump to freed
# memory.
_keepalive_cbs = []


def load_library():
    """The bound library, built on first use; None only when
    ``HOROVOD_NATIVE`` turns the core off. A failed build or load raises.
    The gate is read before the cache, so turning the core off later in a
    process (a direct-mode world after a native one) is honored."""
    if not _config.native_enabled():
        return None
    if _lib is None:
        with _load_lock:
            if _lib is None:
                _bind_prototypes(ctypes.CDLL(str(build())))
    return _lib


def _bind_prototypes(lib):
    global _lib
    lib.hvd_init.restype = ctypes.c_int
    lib.hvd_init.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hvd_shutdown.restype = None
    lib.hvd_enqueue.restype = ctypes.c_longlong
    lib.hvd_enqueue.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int,
    ]
    lib.hvd_enqueue_chips.restype = ctypes.c_longlong
    lib.hvd_enqueue_chips.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int,
    ]
    lib.hvd_test.restype = ctypes.c_int
    lib.hvd_test.argtypes = [ctypes.c_longlong, ctypes.c_char_p,
                             ctypes.c_int]
    lib.hvd_wait.restype = ctypes.c_int
    lib.hvd_wait.argtypes = [ctypes.c_longlong, ctypes.c_char_p,
                             ctypes.c_int]
    lib.hvd_response_done.restype = None
    lib.hvd_response_done.argtypes = [ctypes.c_long, ctypes.c_int,
                                      ctypes.c_char_p]
    lib.hvd_register_exec_callback.restype = None
    lib.hvd_register_exec_callback.argtypes = [_EXEC_CB_TYPE]
    lib.hvd_pending_count.restype = ctypes.c_int
    lib.hvd_set_host_via_xla.restype = None
    lib.hvd_set_host_via_xla.argtypes = [ctypes.c_longlong]
    lib.hvd_inflight_ptrs.restype = ctypes.c_int
    lib.hvd_inflight_ptrs.argtypes = [
        ctypes.c_long, ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.hvd_inflight_handle.restype = ctypes.c_longlong
    lib.hvd_inflight_handle.argtypes = [ctypes.c_long, ctypes.c_char_p]
    lib.hvd_store_result.restype = ctypes.c_int
    lib.hvd_store_result.argtypes = [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
    ]
    lib.hvd_join.restype = ctypes.c_longlong
    lib.hvd_join.argtypes = []
    lib.hvd_last_joined.restype = ctypes.c_int
    lib.hvd_last_joined.argtypes = []
    lib.hvd_result_bytes.restype = ctypes.c_longlong
    lib.hvd_result_bytes.argtypes = [ctypes.c_longlong]
    lib.hvd_result_dims.restype = ctypes.c_int
    lib.hvd_result_dims.argtypes = [ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.c_int]
    lib.hvd_result_fetch.restype = ctypes.c_int
    lib.hvd_result_fetch.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_longlong]
    lib.hvd_set_parameters.restype = None
    lib.hvd_set_parameters.argtypes = [ctypes.c_double, ctypes.c_longlong]
    lib.hvd_set_hier_flags.restype = None
    lib.hvd_set_hier_flags.argtypes = [ctypes.c_int]
    lib.hvd_get_hier_flags.restype = ctypes.c_int
    lib.hvd_get_cycle_time_ms.restype = ctypes.c_double
    lib.hvd_cache_hits.restype = ctypes.c_longlong
    lib.hvd_stall_report.restype = ctypes.c_int
    lib.hvd_stall_report.argtypes = [ctypes.POINTER(ctypes.c_char),
                                     ctypes.c_int]
    lib.hvd_drain.restype = None
    lib.hvd_drain.argtypes = []
    lib.hvd_liveness_report.restype = ctypes.c_int
    lib.hvd_liveness_report.argtypes = [ctypes.POINTER(ctypes.c_char),
                                        ctypes.c_int]
    lib.hvd_set_record_negotiation.restype = None
    lib.hvd_set_record_negotiation.argtypes = [ctypes.c_int]
    lib.hvd_drain_negotiation.restype = ctypes.c_int
    lib.hvd_drain_negotiation.argtypes = [ctypes.POINTER(ctypes.c_char),
                                          ctypes.c_int]
    lib.hvd_get_fusion_threshold.restype = ctypes.c_longlong
    lib.hvd_ring_bytes_sent.restype = ctypes.c_longlong
    lib.hvd_ring_bytes_sent.argtypes = []
    lib.hvd_ring_local_bytes.restype = ctypes.c_longlong
    lib.hvd_ring_local_bytes.argtypes = []
    lib.hvd_ring_cross_bytes.restype = ctypes.c_longlong
    lib.hvd_ring_cross_bytes.argtypes = []
    lib.hvd_ring_shm_bytes.restype = ctypes.c_longlong
    lib.hvd_ring_shm_bytes.argtypes = []
    lib.hvd_shm_active.restype = ctypes.c_int
    lib.hvd_shm_active.argtypes = []
    lib.hvd_ring_stripe_bytes.restype = ctypes.c_longlong
    lib.hvd_ring_stripe_bytes.argtypes = []
    lib.hvd_ring_cross_ns.restype = ctypes.c_longlong
    lib.hvd_ring_cross_ns.argtypes = []
    lib.hvd_ring_stripe_count.restype = ctypes.c_int
    lib.hvd_ring_stripe_count.argtypes = []
    lib.hvd_set_stripes.restype = None
    lib.hvd_set_stripes.argtypes = [ctypes.c_int]
    lib.hvd_host_hier_flags.restype = ctypes.c_int
    lib.hvd_host_hier_flags.argtypes = []
    lib.hvd_metrics_snapshot.restype = ctypes.c_int
    lib.hvd_metrics_snapshot.argtypes = [ctypes.POINTER(ctypes.c_char),
                                         ctypes.c_int, ctypes.c_int]
    # Contract-only bindings: no NativeCore wrapper uses these yet (the
    # topology getters are served by Python-side state; the callback
    # enqueue is reached through hvd_enqueue), but declaring
    # restype/argtypes for EVERY extern "C" export keeps the ctypes
    # surface in lock-step with operations.cc — hvdlint's
    # binding-contract check cross-checks existence and arity both ways,
    # so a renamed export or drifted signature fails the lint, not a
    # 3 a.m. load.
    lib.hvd_initialized.restype = ctypes.c_int
    lib.hvd_initialized.argtypes = []
    lib.hvd_rank.restype = ctypes.c_int
    lib.hvd_rank.argtypes = []
    lib.hvd_size.restype = ctypes.c_int
    lib.hvd_size.argtypes = []
    lib.hvd_local_rank.restype = ctypes.c_int
    lib.hvd_local_rank.argtypes = []
    lib.hvd_local_size.restype = ctypes.c_int
    lib.hvd_local_size.argtypes = []
    lib.hvd_cross_rank.restype = ctypes.c_int
    lib.hvd_cross_rank.argtypes = []
    lib.hvd_cross_size.restype = ctypes.c_int
    lib.hvd_cross_size.argtypes = []
    lib.hvd_enqueue_cb.restype = ctypes.c_longlong
    lib.hvd_enqueue_cb.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, _DONE_CB_TYPE, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


# ---- response wire parsing (mirror of csrc/hvd/message.cc) -----------------


@dataclass
class NativeResponse:
    op: int
    reduce_op: int
    dtype: int
    plane: int
    root_rank: int
    error: str
    prescale: float
    postscale: float
    names: List[str] = field(default_factory=list)
    shapes: List[Tuple[int, ...]] = field(default_factory=list)
    # allgather only: per-tensor per-rank first-dim sizes (ragged support)
    first_dims: List[Tuple[int, ...]] = field(default_factory=list)
    # autotuned hierarchical-dispatch flags stamped into this frame
    # (bit0 = allreduce, bit1 = allgather; -1 = untuned -> env config)
    hier_flags: int = -1
    # autotuned cross-host stripe count riding the same piggyback
    # (-1 = untuned; consumed by the native cycle loop, carried here so
    # the parse stays a faithful mirror of the wire layout)
    stripes: int = -1
    # world incarnation the coordinator stamped (docs/self-healing.md);
    # a worker holding a different epoch is split-brained and shuts
    # down. -1 = no hint.
    epoch: int = -1


class FrameRejected(ValueError):
    """A structurally invalid response frame (truncated, bad magic, or a
    count/length field outside the wire contract). The mirror of the C++
    ``DeserializeResponseList`` returning false: the two codecs must
    accept and reject IDENTICALLY — the differential fuzzer in
    tests/test_hvdmc.py holds them to it."""


class _Cursor:
    """Bounds-checked little-endian reader — the Python twin of
    ``hvd::Reader`` (csrc/hvd/message.h). Every read past the end and
    every out-of-range count raises ``FrameRejected`` instead of
    ``struct.error``/``IndexError``, and count-driven loops are bounded
    by the bytes actually present, so a hostile length field can never
    drive a huge allocation or a multi-million-iteration spin."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def _take(self, n: int) -> int:
        o = self.o
        if o + n > len(self.d):
            raise FrameRejected(f"truncated frame: {n} bytes needed at "
                                f"offset {o} of {len(self.d)}")
        self.o = o + n
        return o

    def remaining(self) -> int:
        return len(self.d) - self.o

    def u8(self):
        return self.d[self._take(1)]

    def i32(self):
        return struct.unpack_from("<i", self.d, self._take(4))[0]

    def i64(self):
        return struct.unpack_from("<q", self.d, self._take(8))[0]

    def f64(self):
        return struct.unpack_from("<d", self.d, self._take(8))[0]

    def s(self):
        n = self.i32()
        if n < 0 or n > self.remaining():
            raise FrameRejected(f"bad string length {n} at offset "
                                f"{self.o}")
        return self.d[self._take(n): self.o].decode(errors="replace")

    def count(self, limit: int = 1 << 24) -> int:
        """A count-prefixed list header: mirror of the C++
        ``n < 0 || n > (1 << 24)`` rejections."""
        n = self.i32()
        if n < 0 or n > limit:
            raise FrameRejected(f"count {n} outside [0, {limit}]")
        return n


def parse_response_list(data: bytes) -> List[NativeResponse]:
    """Parse one response broadcast frame; raises ``FrameRejected`` on
    any structurally invalid input — byte-for-byte the same accept/
    reject verdicts as the C++ ``DeserializeResponseList`` (asserted by
    the differential codec fuzzer, docs/protocol-models.md)."""
    c = _Cursor(data)
    if c.u8() != 0xA2:
        raise FrameRejected("bad response magic")
    # Tuned-parameter piggyback (mirror of SerializeResponseList):
    # cycle/fusion hints ride every response frame and are applied in the
    # C++ worker cycle; the hierarchical-dispatch flags are stamped into
    # each frame at PerformOperation time and consumed HERE — the
    # executor must dispatch this frame's responses with exactly these
    # flags to stay in lockstep with every other rank.
    c.f64()
    c.i64()
    hier_flags = c.i32()
    stripes = c.i32()
    epoch = c.i64()
    out = []
    for _ in range(c.count()):
        r = NativeResponse(op=c.u8(), reduce_op=c.u8(), dtype=c.u8(),
                           plane=c.u8(), root_rank=c.i32(), error=c.s(),
                           prescale=c.f64(), postscale=c.f64(),
                           hier_flags=hier_flags, stripes=stripes,
                           epoch=epoch)
        for _ in range(c.count()):
            r.names.append(c.s())
            ndim = c.i32()
            if ndim < 0 or ndim >= 256:
                # Mirror of ReadShape: out-of-range rank rejects the
                # frame (skipping would misalign every later field).
                raise FrameRejected(f"shape rank {ndim} outside [0, 256)")
            r.shapes.append(tuple(c.i64() for _ in range(ndim)))
        for _ in range(c.count()):
            nr = c.count()
            r.first_dims.append(tuple(c.i64() for _ in range(nr)))
        out.append(r)
    return out


@dataclass
class NativeDelta:
    """One parsed delta control frame (hierarchical control plane,
    docs/control-plane.md): a fully-cached cycle's submissions as a
    response-cache-id bitset."""
    rank: int
    cached_ids: Tuple[int, ...]
    shutdown: bool
    drain: bool


@dataclass
class NativeAggMember:
    rank: int
    kind: int  # 0 = request-list body, 1 = delta body
    body: bytes


@dataclass
class NativeAggregate:
    """One parsed leader->coordinator aggregate frame: every member's
    control frame embedded verbatim as a length-prefixed body."""
    members: List[NativeAggMember]
    shutdown: bool
    drain: bool


def parse_delta_frame(data: bytes) -> NativeDelta:
    """Parse one delta control frame; raises ``FrameRejected`` on any
    structurally invalid input — verdict-identical to the C++
    ``DeserializeDeltaFrame`` (held to it by the differential fuzzer)."""
    c = _Cursor(data)
    if c.u8() != 0xA5:
        raise FrameRejected("bad delta magic")
    flags = c.u8()
    rank = c.i32()
    base = c.i32()
    nbits = c.i32()
    if rank < 0 or base < 0 or nbits < 0 or nbits > (1 << 24):
        raise FrameRejected(f"delta header out of range: rank {rank}, "
                            f"base {base}, span {nbits}")
    nbytes = (nbits + 7) // 8
    if c.remaining() < nbytes:
        raise FrameRejected(f"truncated delta bitset: {nbytes} bytes "
                            f"needed, {c.remaining()} present")
    bits = c.d[c.o:c.o + nbytes]
    ids = tuple(base + i for i in range(nbits)
                if bits[i // 8] & (1 << (i % 8)))
    return NativeDelta(rank=rank, cached_ids=ids,
                       shutdown=bool(flags & 1), drain=bool(flags & 2))


def parse_aggregate_frame(data: bytes) -> NativeAggregate:
    """Parse one aggregate control frame; raises ``FrameRejected`` on
    any structurally invalid input — verdict-identical to the C++
    ``DeserializeAggregateFrame``."""
    c = _Cursor(data)
    if c.u8() != 0xA4:
        raise FrameRejected("bad aggregate magic")
    flags = c.u8()
    members = []
    # Same clamp family as the C++ side: a host holds at most a few
    # hundred ranks, 2^16 members in one aggregate is hostile.
    for _ in range(c.count(limit=1 << 16)):
        rank = c.i32()
        kind = c.u8()
        n = c.i32()
        if n < 0 or n > c.remaining():
            raise FrameRejected(f"bad aggregate body length {n}")
        body = c.d[c._take(n): c.o]
        if rank < 0 or kind not in (0, 1):
            raise FrameRejected(f"bad aggregate member: rank {rank}, "
                                f"kind {kind}")
        members.append(NativeAggMember(rank=rank, kind=kind, body=body))
    return NativeAggregate(members=members, shutdown=bool(flags & 1),
                           drain=bool(flags & 2))


@dataclass
class NativeResume:
    """One parsed link resume frame (docs/self-healing.md): after a
    cross-host data link redials in place, each end announces its world
    epoch and how many frames it has sent/received, so both sides agree
    which in-flight chunk to replay and which to discard."""
    epoch: int
    rank: int
    send_seq: int
    recv_seq: int


def parse_resume_frame(data: bytes) -> NativeResume:
    """Parse one link resume frame; raises ``FrameRejected`` on any
    structurally invalid input — verdict-identical to the C++
    ``DeserializeResume`` (a negative rank or seq rejects: counters only
    ever grow from zero, so a negative one is a desynced stream)."""
    c = _Cursor(data)
    if c.u8() != 0xA6:
        raise FrameRejected("bad resume magic")
    epoch = c.i64()
    rank = c.i32()
    send_seq = c.i64()
    recv_seq = c.i64()
    if rank < 0 or send_seq < 0 or recv_seq < 0:
        raise FrameRejected(f"resume fields out of range: rank {rank}, "
                            f"send_seq {send_seq}, recv_seq {recv_seq}")
    return NativeResume(epoch=epoch, rank=rank, send_seq=send_seq,
                        recv_seq=recv_seq)


# ---- high-level wrapper ----------------------------------------------------


class NativeCore:
    """One per process. Wraps init/shutdown/enqueue/wait + exec callback."""

    def __init__(self):
        self.lib = load_library()
        self.available = self.lib is not None
        self._executor = None
        self._neg_buf = None  # lazily-allocated drain buffer (hot path)

    def init(self, rank: int, size: int, local_rank: int, local_size: int,
             cross_rank: int, cross_size: int, coordinator_addr: str,
             coordinator_port: int, my_host: str, cycle_time_ms: float,
             fusion_threshold: int, cache_capacity: int,
             stall_warning_sec: float, stall_shutdown_sec: float,
             stall_check_enabled: bool, exec_callback,
             heartbeat_ms: int = 0, liveness_timeout_ms: int = 0) -> bool:
        """exec_callback(responses: List[NativeResponse], response_id: int)
        is invoked from the native background thread; it must be quick
        (push to an executor queue). ``heartbeat_ms=0`` (the default)
        keeps the controller's pre-liveness blocking protocol; > 0 arms
        heartbeat frames + the timed gather (docs/liveness.md)."""
        if not self.available:
            return False
        self.register_exec_callback(exec_callback)
        rc = self.lib.hvd_init(
            rank, size, local_rank, local_size, cross_rank, cross_size,
            coordinator_addr.encode(), coordinator_port, my_host.encode(),
            cycle_time_ms, fusion_threshold, cache_capacity,
            stall_warning_sec, stall_shutdown_sec,
            1 if stall_check_enabled else 0, heartbeat_ms,
            liveness_timeout_ms)
        return rc == 0

    def register_exec_callback(self, exec_callback) -> None:
        """(Re-)install the executor callback (callable after init too).
        It runs on the C++ cycle thread: its trampoline stays referenced
        for the life of the process, and an exception never crosses into
        C++ (it becomes ``response_done(False)``)."""

        def _cb(data_ptr, length, response_id):
            try:
                raw = ctypes.string_at(data_ptr, length)
                exec_callback(parse_response_list(raw), response_id)
            # hvdlint: ignore[exception-discipline] -- an exception must
            # never cross into the C++ cycle thread; response_done(False)
            # is the error channel every waiting rank raises from
            except Exception as e:
                _log.error(f"exec callback error: {e}")
                self.response_done(response_id, False, str(e))

        trampoline = _EXEC_CB_TYPE(_cb)
        _keepalive_cbs.append(trampoline)
        self.lib.hvd_register_exec_callback(trampoline)

    def set_host_via_xla(self, threshold: int) -> None:
        """Route fused host-plane allreduces >= threshold bytes to the
        executor callback for XLA-plane staging; -1 disables."""
        if self.available:
            self.lib.hvd_set_host_via_xla(threshold)

    def inflight_ptrs(self, response_id: int, name: str):
        """Raw (data_ptr, output_ptr) of one named entry of an in-flight
        response; None when this rank holds no such entry (joined)."""
        data = ctypes.c_void_p()
        out = ctypes.c_void_p()
        r = self.lib.hvd_inflight_ptrs(response_id, name.encode(),
                                       ctypes.byref(data), ctypes.byref(out))
        if r != 1:
            return None
        return data.value, out.value

    def inflight_handle(self, response_id: int, name: str) -> int:
        """Native handle of one named in-flight entry (-1 if absent)."""
        return int(self.lib.hvd_inflight_handle(response_id, name.encode()))

    def store_result(self, handle: int, data: bytes,
                     dims: Tuple[int, ...]) -> None:
        """Deposit an executor-allocated result for ``handle`` (staged
        allgather); the caller fetches it via ``result_fetch``."""
        arr = (ctypes.c_longlong * len(dims))(*dims)
        self.lib.hvd_store_result(handle, data, len(data), arr, len(dims))

    def shutdown(self):
        if self.available:
            self.lib.hvd_shutdown()

    def drain(self):
        """Mark this rank's departure as a graceful DRAIN (preemption):
        the final controller frame sent during the following
        ``shutdown()`` carries the drain flag, so the coordinator logs a
        clean departure — zero blacklist strikes — instead of a crash."""
        if self.available:
            self.lib.hvd_drain()

    def enqueue(self, name: str, op: int, reduce_op: int, dtype_code: int,
                shape: Tuple[int, ...], data_ptr: Optional[int] = None,
                output_ptr: Optional[int] = None, root_rank: int = -1,
                prescale: float = 1.0, postscale: float = 1.0,
                plane: int = PLANE_XLA,
                chip_dims: Optional[Tuple[int, ...]] = None) -> int:
        """``chip_dims`` (allgather, XLA plane): first dims of the chips
        this process drives, possibly ragged; they ride the Request so the
        coordinator publishes the per-chip dim table in the response."""
        arr = (ctypes.c_longlong * len(shape))(*shape)
        if chip_dims:
            cd = (ctypes.c_longlong * len(chip_dims))(*chip_dims)
            h = self.lib.hvd_enqueue_chips(
                name.encode(), op, reduce_op, dtype_code, arr, len(shape),
                cd, len(chip_dims), data_ptr or None, output_ptr or None,
                root_rank, prescale, postscale, plane)
        else:
            h = self.lib.hvd_enqueue(
                name.encode(), op, reduce_op, dtype_code, arr, len(shape),
                data_ptr or None, output_ptr or None, root_rank, prescale,
                postscale, plane)
        return int(h)

    def test(self, handle: int) -> Tuple[int, str]:
        buf = ctypes.create_string_buffer(1024)
        r = self.lib.hvd_test(handle, buf, 1024)
        return r, buf.value.decode(errors="replace")

    def wait(self, handle: int) -> Tuple[int, str]:
        buf = ctypes.create_string_buffer(1024)
        r = self.lib.hvd_wait(handle, buf, 1024)
        return r, buf.value.decode(errors="replace")

    def response_done(self, response_id: int, ok: bool, error: str = ""):
        self.lib.hvd_response_done(response_id, 1 if ok else 0,
                                   error.encode())

    def pending_count(self) -> int:
        return int(self.lib.hvd_pending_count())

    def join(self) -> int:
        """Enqueue a JOIN; returns a handle resolved when all ranks join."""
        return int(self.lib.hvd_join())

    def result_fetch(self, handle: int):
        """Fetch an executor-allocated result (ragged allgather): returns
        (bytes, per_rank_first_dims) and erases the stored buffer, or None
        if the handle has no stored result."""
        n = int(self.lib.hvd_result_bytes(handle))
        if n < 0:
            return None
        ndims = int(self.lib.hvd_result_dims(handle, None, 0))
        dims = (ctypes.c_longlong * max(ndims, 1))()
        if ndims > 0:
            self.lib.hvd_result_dims(handle, dims, ndims)
        buf = ctypes.create_string_buffer(max(n, 1))
        rc = int(self.lib.hvd_result_fetch(handle, buf, n))
        if rc != 1:
            return None
        return bytes(buf.raw[:n]), tuple(int(dims[i]) for i in range(ndims))

    def last_joined(self) -> int:
        return int(self.lib.hvd_last_joined())

    def set_parameters(self, cycle_time_ms: float = -1.0,
                       fusion_threshold: int = -1):
        """Autotuner hook: apply new tunables to the running world."""
        self.lib.hvd_set_parameters(cycle_time_ms, fusion_threshold)

    def set_hier_flags(self, flags: int) -> None:
        """Autotuner hook (coordinator): propose categorical
        hierarchical-dispatch flags (bit0 = allreduce, bit1 = allgather);
        they ride the next response broadcast to every rank."""
        self.lib.hvd_set_hier_flags(flags)

    def get_hier_flags(self) -> int:
        return int(self.lib.hvd_get_hier_flags())

    def get_parameters(self) -> Tuple[float, int]:
        return (float(self.lib.hvd_get_cycle_time_ms()),
                int(self.lib.hvd_get_fusion_threshold()))

    # Drain flags for ``metrics_snapshot`` (mirror of
    # hvd_metrics_snapshot's contract in csrc/hvd/operations.cc).
    METRICS_DRAIN_LIVENESS = 1
    METRICS_DRAIN_STRAGGLER = 2

    def metrics_snapshot(self, drain_flags: int = 0) -> dict:
        """THE unified native metrics read (docs/metrics.md): every
        counter and histogram as one parsed JSON document —
        ``{"counters": {...}, "histograms": {...}, "straggler": {...}}``
        (+ ``"reports"`` when a drain flag consumed one). New native
        measurements appear here; they do not grow new getters. A
        too-small buffer is retried at the size the native side reports,
        with drained reports restored in between — nothing is lost."""
        import json as _json

        cap = 1 << 16
        for _ in range(4):
            buf = ctypes.create_string_buffer(cap)
            n = int(self.lib.hvd_metrics_snapshot(buf, cap, drain_flags))
            if n >= 0:
                if n == 0:
                    return {}
                return _json.loads(buf.raw[:n].decode(errors="replace"))
            cap = -n + 1
        return {}

    def cache_hits(self) -> int:
        """Requests this rank sent as 4-byte cache ids (fast path).
        Routed through the unified snapshot — the single native
        observability path; the legacy ``hvd_cache_hits`` symbol stays
        bound (and exported) for out-of-tree callers only."""
        snap = self.metrics_snapshot()
        return int(snap.get("counters", {}).get("cache_hits", 0))

    def ring_bytes_sent(self) -> int:
        """Payload bytes this rank has sent on the host data plane (ring
        + VHDD peer links). Test hook for traffic-complexity assertions."""
        return int(self.lib.hvd_ring_bytes_sent())

    def ring_local_bytes(self) -> int:
        """Host-plane bytes this rank sent to SAME-host peers (loopback
        links of the hierarchical paths)."""
        return int(self.lib.hvd_ring_local_bytes())

    def ring_cross_bytes(self) -> int:
        """Host-plane bytes this rank sent to peers on OTHER hosts — the
        scarce cross-host budget the hierarchical paths minimize."""
        return int(self.lib.hvd_ring_cross_bytes())

    def ring_shm_bytes(self) -> int:
        """Payload bytes this rank moved over the shared-memory
        transport (the zero-socket-syscall intra-host legs,
        docs/shm-transport.md). With shm active the local TCP counter
        collapses to ~0 and this one carries the entire local leg."""
        return int(self.lib.hvd_ring_shm_bytes())

    def shm_active(self) -> bool:
        """True when this rank's shm transport is plausibly carrying
        traffic: its segment is live and not every peer attach has
        failed (the transport choice bench.py records). False with
        HOROVOD_SHM off, on init failure, in a world with no same-host
        peers, or once all attaches fell back to TCP."""
        return bool(self.lib.hvd_shm_active())

    def ring_stripe_bytes(self) -> int:
        """Payload bytes this rank moved over the striped cross-host
        transport (docs/cross-transport.md) — a subset of
        ``ring_cross_bytes``, which stays byte-identical to the
        single-socket path (stripe headers ride no counter)."""
        return int(self.lib.hvd_ring_stripe_bytes())

    def ring_cross_ns(self) -> int:
        """Wall-clock nanoseconds this rank spent inside cross-host
        leader-leg exchanges (send + receive + pipelined accumulate,
        whichever transport carried them) — the leg-local timing the
        ``--cross-leg`` A/B compares."""
        return int(self.lib.hvd_ring_cross_ns())

    def ring_stripe_count(self) -> int:
        """The stripe count in ACTIVE use: K once at least one leader
        pair carries striped traffic, 0 with striping off
        (HOROVOD_STRIPES unset/1) or once every pair fell back to
        single-socket TCP (the transport choice bench.py records)."""
        return int(self.lib.hvd_ring_stripe_count())

    def set_stripes(self, stripes: int) -> None:
        """Autotuner hook (coordinator): propose a cross-host stripe
        count; it rides the next response broadcast and every rank
        applies it at that frame boundary, so both sides of every
        leader pair renegotiate their cross transport in lock-step."""
        self.lib.hvd_set_stripes(stripes)

    def host_hier_flags(self) -> int:
        """The EFFECTIVE host-plane hierarchical dispatch (bit0 =
        allreduce, bit1 = allgather): the autotuner's synced value when
        present, else the env default — unlike ``get_hier_flags``, which
        reports only the tuned value (-1 until a tuner syncs one)."""
        return int(self.lib.hvd_host_hier_flags())

    def set_record_negotiation(self, enabled: bool) -> None:
        """Record per-rank submission ticks on the coordinator (reference
        Timeline::NegotiateRankReady, controller.cc:797-809)."""
        self.lib.hvd_set_record_negotiation(1 if enabled else 0)

    def drain_negotiation(self):
        """Drained ticks as (rank, mono_ns, tensor_name) tuples. Loops
        until the native side reports empty (it requeues whole events that
        did not fit, so partial drains never lose ticks)."""
        buf = self._neg_buf
        if buf is None:
            buf = self._neg_buf = ctypes.create_string_buffer(1 << 16)
        out = []
        while True:
            n = self.lib.hvd_drain_negotiation(buf, len(buf))
            if n <= 0:
                break
            for line in buf.raw[:n].decode(errors="replace").splitlines():
                parts = line.split(" ", 2)
                if len(parts) == 3:
                    out.append((int(parts[0]), int(parts[1]), parts[2]))
        return out

    def stall_report(self) -> str:
        """Accumulated stall-inspector warnings (coordinator); consumed on
        read. Loops until the native side drains so no tail is lost."""
        buf = ctypes.create_string_buffer(65536)
        parts = []
        while True:
            n = self.lib.hvd_stall_report(buf, len(buf))
            if n <= 0:
                break
            parts.append(buf.raw[:n].decode(errors="replace"))
            if n < len(buf) - 1:
                break
        return "".join(parts)

    def liveness_report(self) -> str:
        """Accumulated liveness events (SUSPECT/EVICT/DRAIN/RECOVER lines
        from the controller's liveness plane, docs/liveness.md); consumed
        on read. Routed through the unified snapshot's drain flag — the
        single native observability path; the snapshot's retry contract
        restores an undelivered drain, so no tail is ever lost. (The
        legacy ``hvd_liveness_report`` symbol stays bound, for
        out-of-tree callers only: a .so missing the snapshot symbol
        never binds at all.)"""
        snap = self.metrics_snapshot(self.METRICS_DRAIN_LIVENESS)
        return str(snap.get("reports", {}).get("liveness", ""))
