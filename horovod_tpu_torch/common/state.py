"""Process-global runtime state and the basics API.

Counterpart of ``horovod_tpu/common/state.py``. The JAX package runs one
process that drives every local chip through one mesh; the port runs one
process per GPU, as Horovod does on GPUs. The world comes from the
launcher's environment (``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/
CROSS_*`` and ``HOROVOD_CONTROLLER_ADDR/PORT`` for the rendezvous), and
the collectives run on one ``torch.distributed`` process group: NCCL when
the device is a GPU, gloo when the caller asks for the CPU. Without a
launcher the world has size 1, and the group is still made, so the
collective path is the same at every size.
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


def init(device=None):
    """Join the world and make its process group.

    ``device``: where this process computes; defaults to
    ``cuda:<local_rank>``. Pass ``device="cpu"`` to run on the CPU (gloo).
    Idempotent. Adopts a ``torch.distributed`` group the caller already
    made.
    """
    with _state.lock:
        if _state.initialized:
            return
        size, rank = _config.size(), _config.rank()
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
        _state.initialized = True


def shutdown():
    """Tear down the runtime; destroys the process group if ``init`` made
    it."""
    with _state.lock:
        if not _state.initialized:
            return
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
