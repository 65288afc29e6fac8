"""Broadcasts of parameters, optimizer state and objects (the port's
counterpart of ``horovod_tpu/torch/functions.py``)."""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np
import torch

from . import mpi_ops as _ops


def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite, in place, every tensor of ``params`` (a ``state_dict``
    or an iterable of ``(name, tensor)``) with ``root_rank``'s, by named
    broadcasts (``bcast.param.<name>``)."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = [_ops.broadcast_async_(p.data, root_rank,
                                     name=f"bcast.param.{name}")
               for name, p in items if isinstance(p, torch.Tensor)]
    for h in handles:
        _ops.synchronize(h)


def _local_step(optimizer: torch.optim.Optimizer) -> None:
    """One step of the optimizer itself, without a distributed wrapper's
    reduction."""
    cls = type(optimizer)
    while getattr(cls, "_hvd_wrapper", False) and "step" in vars(cls):
        cls = cls.__bases__[0]
    cls.step(optimizer)


@torch.no_grad()
def _materialize_state(optimizer: torch.optim.Optimizer) -> None:
    """Create an optimizer's lazily made state (its momentum buffers,
    moments and step counts) with a step on zero gradients, as Horovod
    does, so that every rank broadcasts the same entries. The parameters
    and their gradients are left as they were (a step on zero gradients
    still moves a parameter under weight decay)."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    saved = [(p.detach().clone(), p.grad) for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    _local_step(optimizer)
    for p, (value, grad) in zip(params, saved):
        p.copy_(value)
        p.grad = grad


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0):
    """Make every rank's optimizer state ``root_rank``'s: the
    hyperparameters of each group and the state's scalars by one object
    broadcast, every state tensor in place by a named broadcast
    (``bcast.opt.<param index>.<key>``). State a rank has not made yet is
    made first (``_materialize_state``)."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    if _ops.size() == 1:
        return
    if not optimizer.state_dict()["state"]:
        _materialize_state(optimizer)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = optimizer.state
    layout = {i: {k: ("tensor", tuple(v.shape), v.dtype, v.device.type)
                  if isinstance(v, torch.Tensor) else ("value", v)
                  for k, v in state[p].items()}
              for i, p in enumerate(params) if p in state}
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in optimizer.param_groups]
    layout, groups = broadcast_object((layout, groups), root_rank,
                                      name="bcast.opt.layout")
    for group, synced in zip(optimizer.param_groups, groups):
        group.update(synced)
    handles = []
    for i in sorted(layout):
        p = params[i]
        entry = state[p]
        for key in sorted(layout[i], key=str):
            kind, *rest = layout[i][key]
            if kind == "value":
                entry[key] = rest[0]
                continue
            shape, dtype, dev_type = rest
            t = entry.get(key)
            if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape \
                    or t.dtype != dtype:
                dev = p.device if dev_type != "cpu" else "cpu"
                t = entry[key] = torch.zeros(shape, dtype=dtype, device=dev)
            handles.append(_ops.broadcast_async_(
                t, root_rank, name=f"bcast.opt.{i}.{key}"))
    for h in handles:
        _ops.synchronize(h)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Broadcast a picklable object from ``root_rank`` (its pickle's
    length, then its bytes, on the CPU plane of the world). Unpickle only
    what your own ranks sent."""
    name = name or "bcast.object"
    if _ops.size() == 1:
        return obj
    payload = pickle.dumps(obj) if _ops.rank() == root_rank else b""
    dev = _host_device()
    length = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    length = _ops.broadcast(length, root_rank, name=name + ".len")
    buf = torch.zeros(int(length[0]), dtype=torch.uint8, device=dev)
    if _ops.rank() == root_rank:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    buf = _ops.broadcast(buf, root_rank, name=name + ".data")
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """Every rank's picklable ``obj``, in rank order (one ragged
    allgather of the pickles and one of their lengths)."""
    name = name or "allgather.object"
    if _ops.size() == 1:
        return [obj]
    dev = _host_device()
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(dev)
    sizes = _ops.allgather(torch.tensor([payload.numel()],
                                        dtype=torch.int64, device=dev),
                           name=name + ".len").cpu().numpy()
    gathered = _ops.allgather(payload, name=name + ".data").cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return [pickle.loads(gathered[offsets[r]:offsets[r + 1]].tobytes())
            for r in range(len(sizes))]


def _host_device() -> torch.device:
    """Where small object payloads travel: the CPU (the host ring) in a
    world on a GPU whose host world is up, the world's device
    otherwise."""
    from ..common import state as _state
    from ..common.host_world import world

    dev = _state.device()
    if dev.type == "cuda" and world().initialized:
        return torch.device("cpu")
    return dev
