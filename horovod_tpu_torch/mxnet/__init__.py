"""``import horovod_tpu_torch.mxnet as hvd``: the MXNet binding (the port's
copy of ``horovod_tpu/mxnet/__init__.py``, after upstream Horovod's
``horovod/mxnet/__init__.py``).

Upstream Horovod puts its collectives on MXNet's dependency engine
through a C API; here an NDArray's collective runs on the port's host
world (``common/host_world.py``) through its host buffer
(``common/host_ops.py``), as the TensorFlow binding's numpy collectives
do, but without TensorFlow. The module imports without mxnet: the world's
functions and ``broadcast_object`` work, and every NDArray entry point
raises ``ImportError`` until mxnet is installed.
"""

from __future__ import annotations

try:
    import mxnet  # noqa: F401

    _MXNET_AVAILABLE = True
except ImportError:
    _MXNET_AVAILABLE = False

from ..common import host_ops as _host_ops
from ..common.host_world import world as _world
from ..ops.collectives import (  # noqa: F401
    Adasum, Average, Max, Min, ReduceOp, Sum)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "allreduce", "allreduce_",
    "allgather", "broadcast", "broadcast_", "broadcast_parameters",
    "broadcast_object", "DistributedOptimizer", "DistributedTrainer",
    "Average", "Sum", "Adasum", "Min", "Max", "ReduceOp",
]


def _require_mxnet():
    if not _MXNET_AVAILABLE:
        raise ImportError(
            "horovod_tpu_torch.mxnet requires the mxnet package, which is "
            "not installed in this environment. The torch/tensorflow/keras "
            "bindings cover the same collective surface.")


def init(comm=None):
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


def _nd_collective(kind, tensor, **kw):
    """An NDArray's collective through its host buffer."""
    _require_mxnet()
    arr = tensor.asnumpy()
    if kind == "allreduce":
        # The ring applies Average's 1/size itself (the identity at size 1).
        out = _host_ops.np_allreduce(arr, kw["name"], kw["op"], 1.0, 1.0)
    elif kind == "allgather":
        out = _host_ops.np_allgather(arr, kw["name"])
    else:
        out = _host_ops.np_broadcast(arr, kw["root_rank"], kw["name"])
    return mxnet.nd.array(out, dtype=arr.dtype.name)


_name_counter = 0


def _auto_name(prefix):
    global _name_counter
    _name_counter += 1
    return f"mx.{prefix}.{_name_counter}"


def allreduce(tensor, average=True, name=None, priority=0):
    """Upstream Horovod's ``mxnet/mpi_ops.py`` ``allreduce``; ``priority``
    is accepted and unused (the host world runs collectives in the order
    the ranks agree on)."""
    return _nd_collective("allreduce", tensor,
                          name=name or _auto_name("allreduce"),
                          op=Average if average else Sum)


def allreduce_(tensor, average=True, name=None, priority=0):
    out = allreduce(tensor, average, name, priority)
    tensor[:] = out
    return tensor


def allgather(tensor, name=None, priority=0):
    return _nd_collective("allgather", tensor,
                          name=name or _auto_name("allgather"))


def broadcast(tensor, root_rank, name=None, priority=0):
    return _nd_collective("broadcast", tensor, root_rank=root_rank,
                          name=name or _auto_name("broadcast"))


def broadcast_(tensor, root_rank, name=None, priority=0):
    out = broadcast(tensor, root_rank, name, priority)
    tensor[:] = out
    return tensor


def broadcast_parameters(params, root_rank=0):
    """Broadcast a gluon ParameterDict or a dict of NDArrays, in the order
    of their names."""
    _require_mxnet()
    for i, (name, p) in enumerate(sorted(params.items())):
        try:
            tensor = p.data() if hasattr(p, "data") else p
        except Exception:
            continue
        broadcast_(tensor, root_rank, name=f"mx.bcast.{i}.{name}")


def broadcast_object(obj, root_rank=0, name=None):
    """Broadcast a picklable object (as the other bindings do), on the
    host world; it needs no mxnet."""
    return _host_ops.np_broadcast_object(obj, root_rank,
                                         name or "mx.bcast.object")


class DistributedOptimizer:
    """An mxnet Optimizer whose ``update`` averages the gradients over the
    world first."""

    def __init__(self, optimizer):
        _require_mxnet()
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def _do_allreduce(self, index, grad):
        if size() == 1:
            return grad
        if isinstance(index, (tuple, list)):
            return [allreduce(g, average=True, name=f"mx.grad.{i}")
                    for i, g in zip(index, grad)]
        return allreduce(grad, average=True, name=f"mx.grad.{index}")

    def update(self, index, weight, grad, state):
        grad = self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        grad = self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)


def DistributedTrainer(params, optimizer, optimizer_params=None, **kwargs):
    """A gluon Trainer whose ``step`` averages the gradients over the
    world: they are summed, and the trainer's scale divides by the size."""
    _require_mxnet()
    import mxnet.gluon as gluon

    class _Trainer(gluon.Trainer):
        def __init__(self):
            super().__init__(params, optimizer,
                             optimizer_params=optimizer_params, **kwargs)
            self._scale /= size()

        def _allreduce_grads(self):
            if size() == 1:
                return
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    for g in param.list_grad():
                        allreduce_(g, average=False,
                                   name=f"mx.trainer.grad.{i}")

    return _Trainer()
