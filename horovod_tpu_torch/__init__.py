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

``hvd.init(sp=N)`` lays the world out as dp x sp; sequence-parallel
attention (ring or Ulysses, ``horovod_tpu_torch.parallel``) runs on the sp
groups. The port carries the data- and sequence-parallel transformer
trainer (``horovod_tpu_torch.transformer_bench``); ROADMAP.md lists what
is still to port.
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
    rank,
    shutdown,
    size,
    sp_rank,
    sp_size,
)
from .ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    allreduce,
    allreduce_async,
    broadcast,
    broadcast_parameters,
    grouped_allreduce,
)
from .opt import DistributedOptimizer  # noqa: F401
