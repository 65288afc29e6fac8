"""The Keras Spark estimator (the port's copy of
``horovod_tpu/spark/keras/``)."""

from .estimator import KerasEstimator, KerasModel  # noqa: F401
