"""Elastic state of the torch binding: ``TorchState`` (a model, its
optimizer and picklable attributes) and ``run`` (the port's counterpart
of ``horovod_tpu/torch/elastic.py``)."""

from __future__ import annotations

from ..elastic.state import (ObjectState, State, check_snapshot,  # noqa: F401
                              retry_loop, to_host)
from . import mpi_ops as _ops
from .functions import (broadcast_object, broadcast_optimizer_state,
                        broadcast_parameters)


class TorchState(ObjectState):
    """A model and its optimizer plus picklable attributes. ``save()``
    copies both state dicts to host memory (a restore after a failure on
    the card reads nothing the card held, and the snapshot costs the card
    no memory); ``restore()`` loads them back; ``sync()`` broadcasts the
    model's state, the optimizer's state and the attributes from rank 0
    (what a worker that joined mid-job needs, so no
    ``broadcast_parameters`` before the loop)."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._saved_model_state = None
        self._saved_optimizer_state = None
        super().__init__(bcast_object=broadcast_object, **kwargs)

    def _public_attrs(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_") and k not in ("model", "optimizer")}

    def save(self):
        model = (to_host(self.model.state_dict())
                 if self.model is not None else None)
        optimizer = (to_host(self.optimizer.state_dict())
                     if self.optimizer is not None else None)
        check_snapshot()
        self._saved_model_state = model
        self._saved_optimizer_state = optimizer
        super().save()

    def restore(self):
        if self.model is not None and self._saved_model_state is not None:
            self.model.load_state_dict(self._saved_model_state)
        if self.optimizer is not None and \
                self._saved_optimizer_state is not None:
            self.optimizer.load_state_dict(self._saved_optimizer_state)
        super().restore()

    def sync(self):
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            broadcast_optimizer_state(self.optimizer, root_rank=0)
        super().sync()


def run(func):
    """The elastic retry loop around ``func(state, ...)``: a
    ``HorovodInternalError`` restores the last commit and re-initializes
    the world (``mpi_ops.reinitialize``), a ``HostsUpdatedInterrupt``
    re-initializes it."""
    return retry_loop(func, _ops.reinitialize)
