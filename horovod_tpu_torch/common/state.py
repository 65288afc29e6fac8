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
executor on a process group of its own) after the groups are made, the
timeline on a rank whose ``HOROVOD_TIMELINE`` names a file, and the
autotuner (``HOROVOD_AUTOTUNE``) on rank 0; ``shutdown`` stops them before
any group is destroyed.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist

from . import config as _config
from . import logging as _log
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
        self.timeline = None     # common/timeline.Timeline when written
        self.autotuner = None    # common/parameter_manager (rank 0)

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
        if _state.config.timeline_filename:
            from .timeline import Timeline

            _state.timeline = Timeline(
                _state.config.timeline_filename,
                mark_cycles=_state.config.timeline_mark_cycles)
        if _state.config.autotune:
            _state.autotuner = _make_autotuner(_state.engine.native_core)
        _state.initialized = True


def _make_autotuner(core):
    """The parameter manager, on rank 0 only: its (cycle ms, fusion
    bytes) point rides the response frames to every rank. In a world of
    more than one process the Python-side publishes stay off (the bucket
    cap of ``fusion.resolve_bucket_cap("auto")``, the compression mode and
    the ZeRO prefetch depth): they would change rank 0's config alone, and
    ranks whose bucket plans differ issue mismatched NCCL calls. Set
    ``HOROVOD_FUSION_THRESHOLD`` / ``HOROVOD_COMPRESSION`` /
    ``HOROVOD_ZERO_PREFETCH`` alike on every rank to govern those."""
    if core is None:
        _log.warning("HOROVOD_AUTOTUNE requested but the native core is "
                     "off (direct mode has no cycle or fusion to tune); "
                     "autotuning disabled")
        return None
    if _state.rank != 0:
        _log.debug("autotune: the tuner runs on rank 0; this rank applies "
                   "the parameters the response frames carry")
        return None
    from .parameter_manager import ParameterManager

    cfg = _state.config
    one_process = _state.size == 1

    def publish_cap(nbytes: int) -> None:
        cfg.fusion_threshold_bytes = int(nbytes)
        cfg.fusion_threshold_explicit = True

    def publish_compression(mode: str) -> None:
        cfg.compression = mode
        cfg.compression_explicit = True

    def publish_prefetch(depth: int) -> None:
        cfg.zero_prefetch = int(depth)
        cfg.zero_prefetch_explicit = True

    # Compression is explored only when the user asked for a mode: the
    # grid then answers whether that mode pays on this model.
    comp_candidates = ()
    if one_process and cfg.compression_explicit and \
            cfg.compression != "none":
        comp_candidates = ("none", cfg.compression)
    stripe_candidates = ()
    if _config.stripes() > 1:
        stripe_candidates = (1, _config.stripes())
    prefetch_candidates = ()
    if one_process and _config.zero_stage() == 3:
        prefetch_candidates = (0, 1, 2)
    if not one_process:
        _log.debug("autotune: bucket-cap/compression/prefetch publish off "
                   "in a world of more than one process")
    groups = _state.groups or {}
    return ParameterManager(
        core, warmup_samples=cfg.autotune_warmup_samples,
        steps_per_sample=cfg.autotune_steps_per_sample,
        max_samples=cfg.autotune_bayes_opt_max_samples,
        gp_noise=cfg.autotune_gaussian_process_noise,
        log_file=cfg.autotune_log,
        initial_cycle_ms=cfg.cycle_time_ms,
        initial_fusion_bytes=cfg.fusion_threshold_bytes,
        # The hierarchical grid only when the hierarchy spans hosts.
        tune_hierarchical=("local" in groups and "cross" in groups
                           and _state.cross_size > 1),
        bucket_cap_setter=publish_cap if one_process else None,
        compression_setter=(publish_compression if comp_candidates
                            else None),
        compression_candidates=comp_candidates,
        stripe_candidates=stripe_candidates,
        zero_prefetch_setter=(publish_prefetch if prefetch_candidates
                              else None),
        zero_prefetch_candidates=prefetch_candidates)


def shutdown():
    """Tear down the runtime: stops the eager engine (its metrics pump,
    its native core, then its executor), closes the timeline, then
    destroys the process group if ``init`` made it."""
    with _state.lock:
        if not _state.initialized:
            return
        try:
            _state.engine.shutdown()
        finally:
            if _state.timeline is not None:
                _state.timeline.close()
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
