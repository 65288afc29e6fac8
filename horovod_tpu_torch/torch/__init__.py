"""``import horovod_tpu_torch.torch as hvd``: Horovod's PyTorch binding on
the port (the counterpart of ``horovod_tpu/torch``).

``hvd.init()`` puts this rank on ``cuda:<local rank>`` with NCCL
(``device="cpu"``: gloo). The collectives (``allreduce``, ``allgather``,
``broadcast``, their ``_async`` and in-place forms, ``poll``,
``synchronize``, ``join``, ``barrier``) take a tensor on the world's
device through the named eager plane and, beside a GPU, a CPU tensor
through the host ring (``mpi_ops.py``). ``DistributedOptimizer``
reduces a gradient a parameter as backward makes it;
``broadcast_parameters``, ``broadcast_optimizer_state``,
``broadcast_object`` and ``allgather_object`` bring ranks into line;
``SyncBatchNorm`` normalizes over the world's batch; ``hvd.elastic``
holds ``TorchState`` and ``run``.
"""

from ..common.exceptions import (  # noqa: F401
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from .. import (  # noqa: F401
    liveness_report,
    metrics,
    metrics_report,
    ring_traffic,
    stall_report,
)
from .mpi_ops import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    cross_rank,
    cross_size,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    poll,
    rank,
    shutdown,
    size,
    synchronize,
)
from .compression import Compression  # noqa: F401
from .functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .optimizer import DistributedOptimizer  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from . import elastic  # noqa: F401


# The build queries of Horovod's binding: the port's collectives are
# NCCL's on a GPU and gloo's on the CPU (torch.distributed); there is no
# MPI, DDL, oneCCL or XLA backend.
def nccl_built() -> bool:
    import torch.distributed as dist

    return dist.is_nccl_available()


def gloo_built() -> bool:
    import torch.distributed as dist

    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """Whether this world runs on gloo (``init(device="cpu")``)."""
    from ..common import state

    return state.is_initialized() and state.device().type == "cpu"


def mpi_built() -> bool:
    return False


mpi_enabled = mpi_threads_supported = ddl_built = ccl_built = xla_built = \
    mpi_built
