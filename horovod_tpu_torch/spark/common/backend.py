"""Where an estimator's training function runs (the port's copy of
``horovod_tpu/spark/common/backend.py``, after upstream Horovod's
``spark/common/backend.py``).

- ``LocalBackend`` runs the function once, in this process: a world of
  one, on this process's device.
- ``SparkBackend`` runs it on ``num_proc`` Spark executors through
  ``horovod_tpu_torch.spark.run`` (pyspark required).
"""

from __future__ import annotations

from typing import Callable, Optional


class Backend:
    """The interface (upstream Horovod's ``Backend``)."""

    def run(self, fn: Callable, args=(), kwargs=None, env=None):
        raise NotImplementedError

    def num_processes(self) -> int:
        raise NotImplementedError


class LocalBackend(Backend):
    """Run the function once, in this process."""

    def __init__(self, num_proc: Optional[int] = None, verbose: int = 0):
        self._num_proc = num_proc or 1
        self.verbose = verbose

    def num_processes(self) -> int:
        return self._num_proc

    def run(self, fn, args=(), kwargs=None, env=None):
        return [fn(*args, **(kwargs or {}))]


class SparkBackend(Backend):
    """Run on Spark executors (upstream Horovod's ``SparkBackend``)."""

    def __init__(self, num_proc: Optional[int] = None, env=None,
                 verbose: int = 0, nics=None,
                 prefix_output_with_timestamp=False):
        self._num_proc = num_proc
        self._env = env
        self.verbose = verbose
        self._nics = nics
        self._prefix = prefix_output_with_timestamp

    def num_processes(self) -> int:
        return self._num_proc or 1

    def run(self, fn, args=(), kwargs=None, env=None):
        from .. import run as spark_run

        return spark_run(fn, args=args, kwargs=kwargs or {},
                         num_proc=self._num_proc, env=env or self._env,
                         verbose=self.verbose, nics=self._nics)
