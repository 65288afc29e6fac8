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


class DuplicateTensorNameError(HorovodTpuError):
    """A tensor name was submitted again before its first submission
    completed (the tensor queue's duplicate-name rejection)."""
