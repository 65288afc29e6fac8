"""Exception types of the port (the port's own copy of the JAX package's
``common/exceptions.py`` types that the port raises)."""


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class NotInitializedError(HorovodTpuError):
    """An API requiring ``hvd.init()`` was called before initialization."""

    def __init__(self, name: str = ""):
        msg = (
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first" + (f" (required by {name})" if name else "")
        )
        super().__init__(msg)


class HorovodInternalError(HorovodTpuError):
    """A collective failed: the native core refused or aborted it, or its
    execution raised. Raised at ``synchronize``."""


class TensorShapeMismatchError(HorovodTpuError):
    """The ranks submitted one collective with shapes that do not agree.
    Every rank of the collective gets it, where the collective would
    otherwise hang (``ops/eager._check_same_shape``)."""


class DuplicateTensorNameError(HorovodTpuError):
    """A tensor name was submitted again before its first submission
    completed (the tensor queue's duplicate-name rejection)."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The elastic driver changed the set of hosts. The results so far
    stand; training goes on after a re-initialization against the new
    world (``skip_sync``: without the broadcast from rank 0 first)."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class PreemptionInterrupt(HostsUpdatedInterrupt):
    """This worker's host got a preemption notice: the retry loop commits,
    announces the drain and exits 0, so the driver charges the host no
    blacklist strike."""

    def __init__(self):
        super().__init__(skip_sync=True)
