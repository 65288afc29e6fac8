"""The Spark integration (the port's copy of ``horovod_tpu/spark/``, after
upstream Horovod's ``horovod/spark/``).

``horovod_tpu_torch.spark.run(fn, ...)`` runs ``fn`` once on each of
``num_proc`` Spark executors with the world's environment set, as
``horovod.spark.run`` does: the driver starts one long-lived task a rank,
each task registers a service with the driver, and the driver sends the
pickled ``fn`` to each and collects the results (``exec.py``). The
estimators (``TorchEstimator``, ``KerasEstimator``) train over Parquet
data that a ``Store`` holds (``common/``). ``TorchEstimator`` trains on
``cuda:<local rank>`` unless it is given ``device="cpu"``.

pyspark is optional: ``run`` raises a clear ``ImportError`` without it,
while the stores and the estimators (on the ``LocalBackend``) work
without it.
"""

from __future__ import annotations

from typing import Optional

from .common.store import HDFSStore, LocalStore, S3Store, Store  # noqa: F401


def __getattr__(name):
    # Lazy, so importing horovod_tpu_torch.spark loads neither Keras nor
    # the torch binding.
    if name in ("KerasEstimator", "KerasModel"):
        from .keras import KerasEstimator, KerasModel

        return {"KerasEstimator": KerasEstimator,
                "KerasModel": KerasModel}[name]
    if name in ("TorchEstimator", "TorchModel"):
        from .torch import TorchEstimator, TorchModel

        return {"TorchEstimator": TorchEstimator,
                "TorchModel": TorchModel}[name]
    raise AttributeError(name)


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark, which is not "
            "installed in this environment. Use horovod_tpu_torch.run "
            "(the horovodrun launcher) for clusters without Spark.") from e


def run(fn, args=(), kwargs=None, num_proc: Optional[int] = None,
        start_timeout: Optional[int] = None, env=None,
        stdout=None, stderr=None, verbose: int = 1,
        nics=None, prefix_output_with_timestamp: bool = False,
        use_ssh: bool = False):
    """Run ``fn`` on ``num_proc`` Spark executors and return the results
    in rank order (upstream Horovod's ``spark/runner.py`` ``run``).

    By default ``fn`` runs inside the executors: one long-lived Spark task
    a rank starts an authenticated task service, the driver sends the
    pickled ``fn`` over it, and ``fn`` runs as a subprocess of the
    executor, with no ssh between hosts. ``fn``'s output goes to the
    executors' logs; ``stdout`` and ``stderr`` apply only to the ssh
    path. ``start_timeout`` (120 s by default) bounds the registration,
    not ``fn``.

    ``use_ssh=True`` collects the executors' hostnames and starts the
    ranks from the driver with ``horovod_tpu_torch.run``: the driver then
    needs passwordless ssh to every executor host.
    """
    _require_pyspark()
    import pyspark

    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise ValueError("run() requires an active SparkContext")
    if num_proc is None:
        num_proc = sc.defaultParallelism

    if use_ssh:
        import socket

        from ..run import run as _local_run

        hosts = sc.parallelize(range(num_proc), num_proc) \
            .map(lambda _: socket.gethostname()).collect()
        counts = {}
        for h in hosts:
            counts[h] = counts.get(h, 0) + 1
        hosts_str = ",".join(f"{h}:{n}" for h, n in sorted(counts.items()))
        return _local_run(fn, args=args, kwargs=kwargs, np=num_proc,
                          hosts=hosts_str, env=env, verbose=bool(verbose))

    import threading

    from ..run.common.util import secret
    from .exec import (SparkDriverService, run_via_task_services,
                       shutdown_registered_tasks, task_main)

    key = secret.make_secret_key()
    driver = SparkDriverService(num_proc, key, nics=nics)
    driver_addresses = driver.addresses()
    timeout = float(start_timeout or 120)

    def _spark_task(index, _iterator):
        # No time limit: fn runs unbounded, and every exit of the driver
        # sends ShutdownRequest (a lost driver ends the task too).
        yield task_main(index, driver_addresses, key, nics=nics)

    collect_result = {}

    def _collect():
        try:
            collect_result["states"] = sc.parallelize(
                range(num_proc), num_proc) \
                .mapPartitionsWithIndex(_spark_task).collect()
        except Exception as e:  # raised after the exec round
            collect_result["error"] = e

    spark_thread = threading.Thread(target=_collect, daemon=True)
    spark_thread.start()
    try:
        driver.wait_for_initial_registration(timeout)
        results = run_via_task_services(
            driver, fn, args, kwargs, num_proc, key, env=env)
    except Exception:
        # The driver gives up: later registrations are refused and the
        # tasks that registered are shut down.
        shutdown_registered_tasks(driver, num_proc, key)
        raise
    finally:
        spark_thread.join(timeout=30)
        driver.shutdown()
    if "error" in collect_result:
        raise collect_result["error"]
    return results
