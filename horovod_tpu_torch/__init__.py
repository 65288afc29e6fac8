"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

The JAX package ``horovod_tpu`` stays the reference; this package does its
work on torch tensors in CUDA memory, with NCCL in the role of XLA's
compiled collectives and hand-written Hopper kernels in place of the
Pallas TPU kernels. It imports neither ``jax`` nor ``horovod_tpu``.

Typical use, one process per GPU::

    import horovod_tpu_torch as hvd

    hvd.init()                                  # cuda:<local rank>, NCCL
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

``hvd.init(sp=, tp=, pp=)`` lays the world out as dp x pp x sp x tp
(``parallel/mesh.py``); ``hvd.axis_group(name)`` returns this rank's group
of an axis. The flagship transformer runs on them: sequence-parallel
attention (ring or Ulysses) on sp, Megatron tensor parallelism on tp, the
GPipe pipeline on pp and MoE experts on dp
(``horovod_tpu_torch.parallel``, ``models/transformer.py``,
``transformer_bench``); the image trainer (``image_bench``) is data
parallel. ROADMAP.md lists what is still to port.
"""

from .common import exceptions  # noqa: F401
from .common.compression import Compression  # noqa: F401
from .common.exceptions import NotInitializedError  # noqa: F401
from .common.state import (  # noqa: F401
    axis_group,
    axis_sizes,
    cross_rank,
    cross_size,
    device,
    dp_rank,
    dp_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    pp_rank,
    pp_size,
    rank,
    shutdown,
    size,
    sp_rank,
    sp_size,
    tp_rank,
    tp_size,
)
from .ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    allgather,
    allreduce,
    allreduce_async,
    alltoall,
    barrier,
    broadcast,
    broadcast_parameters,
    grouped_allreduce,
    grouped_hierarchical_allreduce,
    hierarchical_allgather,
    hierarchical_allreduce,
    reducescatter,
)
from .opt import DistributedOptimizer  # noqa: F401
