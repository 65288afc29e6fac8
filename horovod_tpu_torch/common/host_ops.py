"""Blocking collectives of numpy arrays on the host world
(``host_world.py``), shared by the bindings whose tensors live in host
memory: TensorFlow's (``tensorflow/mpi_ops.py``) and MXNet's
(``mxnet/__init__.py``). Nothing here imports a framework, so the MXNet
binding runs without TensorFlow. In a world of one each collective is the
identity (a scaled copy for an allreduce with scale factors).
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np

from . import native as _native
from .exceptions import HorovodInternalError
from .host_world import NUMPY_DTYPE_CODES, world as _world
from ..ops.collectives import Max, Min


def np_code(arr: np.ndarray) -> int:
    code = NUMPY_DTYPE_CODES.get(str(arr.dtype))
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    return code


def np_allreduce(arr: np.ndarray, name: str, op: int, prescale: float,
                 postscale: float) -> np.ndarray:
    w = _world()
    w.require_init()
    arr = np.asarray(arr, order="C")
    if w.size == 1:
        scale = prescale * (postscale if op not in (Min, Max) else 1.0)
        if scale == 1.0:
            # The identity: an integer never goes through a float.
            return arr.copy()
        return (arr.astype(np.float64) * scale).astype(arr.dtype)
    out = np.empty_like(arr)
    h = w.enqueue(name, _native.OP_ALLREDUCE, op, np_code(arr), arr.shape,
                  arr.ctypes.data, out.ctypes.data, prescale=prescale,
                  postscale=postscale)
    r, err = w.wait(h)
    if r < 0:
        raise HorovodInternalError(err)
    return out


def np_allgather(arr: np.ndarray, name: str) -> np.ndarray:
    """Ragged allgather on dim 0 (MPI_Allgatherv): the ranks' sizes ride
    the response, with no size exchange and no padding."""
    out, _sizes = _world().allgatherv_np(np.asarray(arr), name)
    return out


def np_broadcast(arr: np.ndarray, root_rank: int, name: str) -> np.ndarray:
    w = _world()
    w.require_init()
    arr = np.asarray(arr, order="C")
    if w.size == 1:
        return arr.copy()
    return w.broadcast_np(arr, root_rank, name)


def np_broadcast_object(obj: Any, root_rank: int, name: str) -> Any:
    """A picklable object from ``root_rank``: its pickle's length, then
    its bytes. Unpickle only what your own ranks sent."""
    w = _world()
    w.require_init()
    if w.size == 1:
        return obj
    payload = pickle.dumps(obj) if w.rank == root_rank else b""
    n = np_broadcast(np.asarray([len(payload)], np.int64), root_rank,
                     name + ".len")
    buf = np.zeros(int(n[0]), np.uint8)
    if w.rank == root_rank:
        buf[:] = np.frombuffer(payload, np.uint8)
    return pickle.loads(np_broadcast(buf, root_rank, name + ".data")
                        .tobytes())
