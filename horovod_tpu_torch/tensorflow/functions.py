"""The TF binding's helpers (the port's copy of
``horovod_tpu/tensorflow/functions.py``): ``broadcast_variables``,
``broadcast_object``, ``broadcast_object_fn`` and ``allgather_object``.
After a restore on the root, they make every rank's variables and
objects the root's before training goes on.
"""

from __future__ import annotations

import pickle
from typing import Iterable, Optional

import numpy as np
import tensorflow as tf

from ..common import host_ops as _host_ops
from .mpi_ops import _world, broadcast, size


def broadcast_variables(variables: Iterable[tf.Variable],
                        root_rank: int = 0) -> None:
    """Assign every variable its value on ``root_rank``."""
    for i, var in enumerate(variables):
        var.assign(broadcast(var, root_rank,
                             name=f"tf.bcast.var.{i}.{var.name}"))


def broadcast_object(obj, root_rank: int = 0,
                     name: Optional[str] = None):
    """Broadcast a picklable object from ``root_rank``: its length, then
    its bytes."""
    return _host_ops.np_broadcast_object(obj, root_rank,
                                         name or "tf.bcast.obj")


def broadcast_object_fn(root_rank: int = 0, name: Optional[str] = None):
    def _fn(obj):
        return broadcast_object(obj, root_rank=root_rank, name=name)

    return _fn


def allgather_object(obj, name: Optional[str] = None):
    """One picklable object of each rank, in rank order."""
    w = _world()
    w.require_init()
    if size() == 1:
        return [obj]
    name = name or "tf.allgather.obj"
    payload = np.frombuffer(pickle.dumps(obj), np.uint8)
    gathered = _host_ops.np_allgather(payload, name)
    sizes = _host_ops.np_allgather(np.asarray([len(payload)], np.int64),
                                   name + ".sizes")
    out, off = [], 0
    for s in sizes.reshape(-1):
        out.append(pickle.loads(gathered[off: off + int(s)].tobytes()))
        off += int(s)
    return out
