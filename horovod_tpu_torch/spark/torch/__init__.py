"""The torch Spark estimator (the port's copy of
``horovod_tpu/spark/torch/``)."""

from .estimator import TorchEstimator, TorchModel  # noqa: F401
