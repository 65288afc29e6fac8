"""Exception types of the port (the port's own copy of the JAX package's
``common/exceptions.py`` types that this slice raises)."""


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
