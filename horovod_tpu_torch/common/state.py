"""Process-global runtime state and the basics API.

Counterpart of ``horovod_tpu/common/state.py``. The JAX package runs one
process that drives every local chip through one mesh; the port runs one
process per GPU, as Horovod does on GPUs. The world comes from the
launcher's environment (``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/
CROSS_*`` and ``HOROVOD_CONTROLLER_ADDR/PORT`` for the rendezvous), and
the collectives run on one ``torch.distributed`` process group: NCCL when
the device is a GPU, gloo when the caller asks for the CPU. Without a
launcher the world has size 1, and the group is still made, so the
collective path is the same at every size. ``init`` also starts the
eager engine (``ops/eager.py``: the native core's negotiation and an
executor on a process group of its own) after the groups are made;
``shutdown`` stops it before any group is destroyed.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist

from . import config as _config
from .exceptions import NotInitializedError


class _GlobalState:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.config: Optional[_config.RuntimeConfig] = None
        self.device: Optional[torch.device] = None
        self.owns_group = False
        self.size = 0
        self.rank = 0
        self.local_size = 0
        self.local_rank = 0
        self.cross_size = 0
        self.cross_rank = 0
        self.axis_sizes = None   # {"dp", "pp", "sp", "tp"} sizes
        self.groups = None       # name -> this rank's AxisGroup
        self.engine = None       # the eager engine (ops/eager.py)

    def reset(self):
        self.__init__()


_state = _GlobalState()


def global_state() -> _GlobalState:
    return _state


def resolve_device(device=None, local_rank: Optional[int] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda:<local_rank>``. Raises when that GPU is not there — the port
    never moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if local_rank is None:
        local_rank = (_state.local_rank if _state.initialized
                      else _config.local_rank())
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on CUDA devices by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local_rank} has no GPU "
            f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", local_rank)


def init(device=None, sp: int = 1, tp: int = 1, pp: int = 1):
    """Join the world and make its process groups.

    ``device``: where this process computes; defaults to
    ``cuda:<local_rank>``. Pass ``device="cpu"`` to run on the CPU (gloo).
    ``sp``, ``tp``, ``pp``: the sequence-, tensor- and pipeline-parallel
    axis sizes; the world is the rank grid ``reshape(dp, pp, sp, tp)``
    with dp = size / (sp * tp * pp) (``parallel/mesh.py``), and a group is
    made for each axis, for the data shards (dp x sp), the stages
    (dp x pp x sp) and the local and cross hosts. Idempotent (a second
    call must ask for the same sizes). Adopts a ``torch.distributed``
    group the caller already made.
    """
    from ..ops.eager import EagerEngine
    from ..parallel.mesh import build_groups, factor_devices

    asked = {"sp": sp, "tp": tp, "pp": pp}
    with _state.lock:
        if _state.initialized:
            have = {a: _state.axis_sizes[a] for a in asked}
            if have != asked:
                raise ValueError(
                    f"already initialized with {have}; shutdown() before "
                    f"asking for {asked}")
            return
        size, rank = _config.size(), _config.rank()
        # Bad axis sizes raise before the world is joined.
        factor_devices(dist.get_world_size() if dist.is_initialized()
                       else size, tp=tp, pp=pp, sp=sp)
        local_rank = _config.local_rank()
        local_size = _config.local_size(size)
        dev = resolve_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        owns = False
        if not dist.is_initialized():
            backend = "nccl" if dev.type == "cuda" else "gloo"
            if size == 1:
                store = dist.HashStore()
            else:
                store = dist.TCPStore(
                    _config.controller_addr(), _config.controller_base_port(),
                    world_size=size, is_master=rank == 0)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size)
            owns = True
        _state.config = _config.RuntimeConfig.from_env()
        _state.device = dev
        _state.owns_group = owns
        _state.size = dist.get_world_size()
        _state.rank = dist.get_rank()
        _state.local_rank = local_rank
        _state.local_size = local_size
        _state.cross_size = _config.cross_size(
            max(1, _state.size // max(1, local_size)))
        _state.cross_rank = _config.cross_rank(_state.rank // max(1, local_size))
        _state.axis_sizes, _state.groups = build_groups(
            _state.size, _state.rank, sp=sp, tp=tp, pp=pp,
            local_size=local_size)
        try:
            _state.engine = EagerEngine(_state)
        except BaseException:
            if owns and dist.is_initialized():
                dist.destroy_process_group()
            _state.reset()
            raise
        _state.initialized = True


def shutdown():
    """Tear down the runtime: stops the eager engine (its native core,
    then its executor), then destroys the process group if ``init`` made
    it."""
    with _state.lock:
        if not _state.initialized:
            return
        try:
            _state.engine.shutdown()
        finally:
            if _state.owns_group and dist.is_initialized():
                dist.destroy_process_group()
            _state.reset()


def is_initialized() -> bool:
    return _state.initialized


def _require_init(name: str) -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError(name)
    return _state


def size() -> int:
    """Number of processes (one per GPU) in the world."""
    return _require_init("size").size


def rank() -> int:
    return _require_init("rank").rank


def local_size() -> int:
    return _require_init("local_size").local_size


def local_rank() -> int:
    return _require_init("local_rank").local_rank


def cross_size() -> int:
    return _require_init("cross_size").cross_size


def cross_rank() -> int:
    return _require_init("cross_rank").cross_rank


def device() -> torch.device:
    """The device ``init`` chose for this process."""
    return _require_init("device").device


def _axis(name: str):
    return _require_init(f"{name} of the mesh").groups[name]


def sp_size() -> int:
    """Ranks along the sequence-parallel axis."""
    return _axis("sp").size


def sp_rank() -> int:
    """This rank's index along the sequence-parallel axis."""
    return _axis("sp").rank


def dp_size() -> int:
    """Ranks along the data-parallel axis (size / (sp * tp * pp))."""
    return _axis("dp").size


def dp_rank() -> int:
    """This rank's index along the data-parallel axis."""
    return _axis("dp").rank


def tp_size() -> int:
    """Ranks along the tensor-parallel axis."""
    return _axis("tp").size


def tp_rank() -> int:
    """This rank's index along the tensor-parallel axis."""
    return _axis("tp").rank


def pp_size() -> int:
    """Ranks along the pipeline axis (the number of stages)."""
    return _axis("pp").size


def pp_rank() -> int:
    """This rank's pipeline stage."""
    return _axis("pp").rank


def axis_group(axis: str):
    """This rank's ``AxisGroup`` of ``axis``: a mesh axis ("dp", "pp",
    "sp", "tp"), "data" (dp x sp), "stages" (dp x pp x sp), or "local" /
    "cross" (the hosts' axes; raises when the local size does not divide
    the world)."""
    groups = _require_init(f"axis_group({axis!r})").groups
    if axis not in groups:
        if axis in ("local", "cross"):
            raise ValueError(
                f"no {axis} group: the local size {_state.local_size} does "
                f"not divide the world of {_state.size}")
        raise ValueError(f"unknown axis group {axis!r}")
    return groups[axis]


def axis_sizes() -> dict:
    """The mesh's axis sizes, {"dp", "pp", "sp", "tp"}."""
    return dict(_require_init("axis_sizes").axis_sizes)
