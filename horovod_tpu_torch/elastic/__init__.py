"""Elastic training: state that commits, restores and syncs, and the
retry loop around a training function (the port's counterpart of
``horovod_tpu/elastic``). ``TensorState`` holds a tree of tensors on the
world's device; ``horovod_tpu_torch.torch.elastic.TorchState`` a model and
its optimizer."""

from .state import (  # noqa: F401
    ObjectState, State, TensorState, register_preemption_signal, run)
