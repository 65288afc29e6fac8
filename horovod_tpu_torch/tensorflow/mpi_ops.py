"""TensorFlow binding: the world and its collective ops with their
gradients (the port's copy of ``horovod_tpu/tensorflow/mpi_ops.py``).

Ranks are processes, one a worker of the port's launcher
(``python -m horovod_tpu_torch.run``), as in Horovod's TF binding. The
plane is the port's host world (``common/host_world.py``): the native
core's controller negotiates, fuses and runs each collective on its TCP
ring, or stages it through NCCL under ``HOROVOD_HOST_VIA_XLA=1``.

- In a world of more than one process the ops are the port's own native
  TF kernels (``native_ops.py``, ``csrc/tf_ops.cc``), which the TF
  executor drives with no Python hop. They are built and loaded at the
  first collective, or the collective raises: there is no
  ``tf.py_function`` fallback.
- In a world of one every collective is the identity (a scaled copy for
  an allreduce with scale factors), as in the JAX package's binding.

Gradients follow Horovod's table: allreduce' = allreduce, allgather' =
the summed gradient's slice of this rank's rows, broadcast' = the summed
gradient at the root and zero elsewhere.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import tensorflow as tf

from ..common import host_ops as _host_ops
from ..common.host_world import world as _world
from ..ops.collectives import (Adasum, Average, Max, Min,  # noqa: F401
                               ReduceOp, Sum)
from . import native_ops as _native_ops

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "mpi_threads_supported",
    "mpi_built", "mpi_enabled", "gloo_built", "gloo_enabled", "nccl_built",
    "ddl_built", "ccl_built", "_allreduce", "allgather", "broadcast", "join",
    "barrier", "Average", "Sum", "Adasum", "Min", "Max", "ReduceOp",
]

_name_counter = 0
_name_lock = threading.Lock()


def _auto_name(prefix: str) -> str:
    global _name_counter
    with _name_lock:
        _name_counter += 1
        return f"tf.{prefix}.noname.{_name_counter}"


def init(comm=None):
    """Join the process world (``hvd.init()``). ``comm``: a subset of the
    launched ranks."""
    _world().init(comm=comm)


def shutdown():
    _world().shutdown()


def is_initialized() -> bool:
    return _world().initialized


def rank() -> int:
    _world().require_init()
    return _world().rank


def size() -> int:
    _world().require_init()
    return _world().size


def local_rank() -> int:
    _world().require_init()
    return _world().local_rank


def local_size() -> int:
    _world().require_init()
    return _world().local_size


def cross_rank() -> int:
    _world().require_init()
    return _world().cross_rank


def cross_size() -> int:
    _world().require_init()
    return _world().cross_size


def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    return False


def gloo_enabled() -> bool:
    return False


def nccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


# ---- numpy-level collectives on the host plane ------------------------------

# Also the Keras callbacks' (``_keras/callbacks.py``).
_np_allreduce = _host_ops.np_allreduce


# ---- TF op wrappers with gradients ------------------------------------------


def _kernels():
    """The native op library in a world of more than one process (built
    and loaded at the first call, or ``HorovodInternalError``); None in a
    world of one, where every collective is the identity."""
    w = _world()
    w.require_init()
    if w.size == 1:
        return None
    return _native_ops.load()


def _to_numpy(tensor: tf.Tensor) -> np.ndarray:
    return tensor.numpy() if hasattr(tensor, "numpy") else np.asarray(tensor)


def _identity(np_fn, tensor: tf.Tensor) -> tf.Tensor:
    """A world of one's collective on a TF tensor: eagerly on its value,
    in a graph through ``tf.py_function`` with the input's shape."""
    if tf.executing_eagerly() and not isinstance(tensor, tf.Variable) \
            and not tf.is_symbolic_tensor(tensor):
        return tf.constant(np_fn(_to_numpy(tensor)))
    out = tf.py_function(lambda t: np_fn(t.numpy()), [tensor], tensor.dtype)
    out = tf.reshape(out, tf.shape(tensor))
    out.set_shape(tensor.shape)
    return out


def _allreduce(tensor: tf.Tensor, name: Optional[str] = None, op: int = Sum,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> tf.Tensor:
    """The raw allreduce, with no gradient of its own."""
    name = name or _auto_name("allreduce")
    k = _kernels()
    if k is not None:
        return k.horovod_tpu_torch_allreduce(
            tensor, tensor_name=name, reduce_op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
    return _identity(
        lambda a: _np_allreduce(a, name, op, prescale_factor,
                                postscale_factor), tensor)


def allgather(tensor: tf.Tensor, name: Optional[str] = None) -> tf.Tensor:
    """Differentiable allgather, concatenated on dim 0 (ranks may differ
    in dim 0). Gradient: the summed upstream gradient's slice of this
    rank's rows."""
    name = name or _auto_name("allgather")
    tensor = tf.convert_to_tensor(tensor)
    if tensor.shape.rank == 0:
        tensor = tf.reshape(tensor, [1])
    dim0 = tf.shape(tensor)[0]

    @tf.custom_gradient
    def _fn(t):
        k = _kernels()
        out = (k.horovod_tpu_torch_allgather(t, tensor_name=name)
               if k is not None else tf.identity(t))
        if t.shape.rank is not None and t.shape.rank > 0:
            out.set_shape(tf.TensorShape([None]).concatenate(t.shape[1:]))

        def grad(dy):
            summed = _allreduce(dy, name=name + ".grad", op=Sum)
            if k is None:
                return summed
            dim0v = tf.reshape(tf.cast(dim0, tf.int64), [1])
            sizes = k.horovod_tpu_torch_allgather(
                dim0v, tensor_name=name + ".grad.dim0")
            offset = tf.reduce_sum(sizes[: rank()])
            return tf.slice(
                summed, tf.concat(
                    [[tf.cast(offset, tf.int32)],
                     tf.zeros([tf.rank(dy) - 1], tf.int32)], axis=0),
                tf.concat([[tf.cast(dim0, tf.int32)],
                           tf.fill([tf.rank(dy) - 1], -1)], axis=0))

        return out, grad

    return _fn(tensor)


def broadcast(tensor: tf.Tensor, root_rank: int,
              name: Optional[str] = None) -> tf.Tensor:
    """Differentiable broadcast from ``root_rank``. Gradient: the summed
    upstream gradient at the root, zero elsewhere."""
    name = name or _auto_name("broadcast")
    tensor = tf.convert_to_tensor(tensor)

    @tf.custom_gradient
    def _fn(t):
        k = _kernels()
        out = (k.horovod_tpu_torch_broadcast(t, tensor_name=name,
                                             root_rank=root_rank)
               if k is not None else tf.identity(t))
        out.set_shape(t.shape)

        def grad(dy):
            summed = _allreduce(dy, name=name + ".grad", op=Sum)
            if rank() == root_rank:
                return summed
            return tf.zeros_like(summed)

        return out, grad

    return _fn(tensor)


def join() -> int:
    """The departure barrier (``hvd.join()``): returns the last rank."""
    w = _world()
    w.require_init()
    w.barrier("tf.join")
    return w.size - 1


def barrier():
    _world().barrier("tf.barrier")
