"""``horovod_tpu_torch.spark.run`` and its in-executor transport
(``spark/exec.py``), as ``tests/test_spark_run.py`` runs the JAX
package's: a fake pyspark runs each partition on a thread of its own, as
executors do, and the job itself is real. The function runs in a
subprocess a rank (``python -m horovod_tpu_torch.spark.task_exec``),
joins the port's world through its torch binding on the CPU and
allreduces.

A task never serves without a driver that wants it: one that registers
after its driver gave up is refused and stops at once, and one whose
driver is gone stops within ``exec.DRIVER_LOST_BOUND_S``. The JAX
package's tasks waited for a shutdown without bound
(``test_spark_run.py::test_registration_timeout_shuts_down_registered_tasks``
failed whenever the task's interpreter took more than the test's 5 s
window to register)."""

import multiprocessing as mp
import os
import sys
import threading
import time
import types

import pytest

from horovod_tpu_torch.run.common.util import secret
from horovod_tpu_torch.spark import exec as spark_exec


class _FakeRDD:
    def __init__(self, items):
        self._items = list(items)

    def map(self, f):
        return _FakeRDD([f(x) for x in self._items])

    def mapPartitionsWithIndex(self, f):
        # One element a partition, each partition on a thread of its own:
        # the tasks serve until shutdown, as executors do.
        results = [None] * len(self._items)
        errors = []

        def _one(i, x):
            try:
                results[i] = list(f(i, iter([x])))
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=_one, args=(i, x), daemon=True)
                   for i, x in enumerate(self._items)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors:
            raise errors[0]
        return _FakeRDD([r for part in results if part for r in part])

    def collect(self):
        return list(self._items)


class _FakeSparkContext:
    defaultParallelism = 2
    _active_spark_context = None

    def parallelize(self, seq, num):
        assert num == len(list(seq))
        return _FakeRDD(seq)


@pytest.fixture
def fake_pyspark(monkeypatch):
    mod = types.ModuleType("pyspark")
    ctx = _FakeSparkContext()
    _FakeSparkContext._active_spark_context = ctx
    mod.SparkContext = _FakeSparkContext
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    yield mod
    _FakeSparkContext._active_spark_context = None


def _make_train():
    # Nested, so that cloudpickle carries it by value: the subprocesses
    # cannot import this test module.
    def _train(scale):
        import os

        import numpy as np
        import torch

        import horovod_tpu_torch.torch as hvd

        hvd.init(device="cpu")
        x = torch.from_numpy(np.random.RandomState(hvd.rank()).rand(5)
                             .astype(np.float32))
        out = hvd.allreduce(x * scale, op=hvd.Sum)
        r = (hvd.rank(), hvd.size(), hvd.local_rank(),
             os.environ["HOROVOD_HOSTNAME"], out.numpy().tolist())
        hvd.shutdown()
        return r

    return _train


def test_spark_run_in_executor(fake_pyspark):
    """register -> exec -> collect: fn runs in a subprocess a rank, the
    world forms, the results come back in rank order and the allreduce
    is the numpy sum of the ranks' inputs."""
    import numpy as np

    import horovod_tpu_torch.spark as spark

    results = spark.run(_make_train(), args=(2.0,), num_proc=2, verbose=0)
    want = sum(np.random.RandomState(r).rand(5).astype(np.float32) * 2.0
               for r in range(2))
    assert [r[0] for r in results] == [0, 1]
    assert [r[2] for r in results] == [0, 1]   # one host, two slots
    assert all(r[1] == 2 for r in results)
    for r in results:
        np.testing.assert_allclose(r[4], want, rtol=1e-6)


def test_spark_run_reports_task_failure(fake_pyspark):
    import horovod_tpu_torch.spark as spark

    def _boom():
        raise RuntimeError("exploded in executor")

    with pytest.raises(RuntimeError, match="exploded in executor") as e:
        spark.run(_boom, num_proc=2, verbose=0)
    assert "spark tasks failed" in str(e.value)
    assert "rc=1" in str(e.value)


def test_spark_run_requires_active_context(fake_pyspark):
    import horovod_tpu_torch.spark as spark

    _FakeSparkContext._active_spark_context = None
    with pytest.raises(ValueError, match="active SparkContext"):
        spark.run(lambda: None)


def test_spark_run_without_pyspark(monkeypatch):
    import horovod_tpu_torch.spark as spark

    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError, match="requires pyspark"):
        spark.run(lambda: None)


def test_exec_round_without_spark():
    """spark/exec.py needs no pyspark: a pool of processes stands in for
    the executors and the whole round runs."""
    key = secret.make_secret_key()
    driver = spark_exec.SparkDriverService(2, key)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=spark_exec.task_main,
                         args=(i, driver.addresses(), key))
             for i in range(2)]
    for p in procs:
        p.start()
    try:
        driver.wait_for_initial_registration(60)

        def _double_with_env(x):
            import os

            return (x * 2, os.environ["HOROVOD_RANK"],
                    os.environ["HOROVOD_SIZE"])

        results = spark_exec.run_via_task_services(
            driver, _double_with_env, (21,), {}, 2, key)
        assert results == [(42, "0", "2"), (42, "1", "2")]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        driver.shutdown()
    assert [p.exitcode for p in procs] == [0, 0]


def test_registration_timeout_shuts_down_registered_tasks():
    """A registration timeout with part of the world: the task stops,
    whether it registered before the driver gave up (a ShutdownRequest
    reaches it) or after (its registration is refused)."""
    key = secret.make_secret_key()
    driver = spark_exec.SparkDriverService(2, key)  # only 1 registers
    p = mp.get_context("spawn").Process(
        target=spark_exec.task_main, args=(0, driver.addresses(), key))
    p.start()
    try:
        with pytest.raises(TimeoutError):
            driver.wait_for_initial_registration(5)
        spark_exec.shutdown_registered_tasks(driver, 2, key)
        p.join(timeout=30)
        assert not p.is_alive(), \
            "registered task kept serving after the driver gave up"
    finally:
        if p.is_alive():
            p.terminate()
        driver.shutdown()


def _timed_task(index, addresses, key, out_dir):
    """A task that records when it registered and when, and how, it
    stopped (a spawn target: module level)."""
    import json

    t0 = time.time()
    state = spark_exec.task_main(index, addresses, key)
    with open(os.path.join(out_dir, f"task.{index}.json"), "w") as f:
        json.dump({"start": t0, "end": time.time(), "state": state}, f)


RUNS = 10


def _start_tasks(driver, key, tmp_path, n):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_timed_task,
                         args=(i, driver.addresses(), key, str(tmp_path)))
             for i in range(n)]
    for p in procs:
        p.start()
    return procs


def _finish(procs, tmp_path, n, timeout):
    import json

    try:
        for p in procs:
            p.join(timeout=timeout)
        assert not any(p.is_alive() for p in procs), "a task kept serving"
        assert [p.exitcode for p in procs] == [0] * n
        return [json.loads((tmp_path / f"task.{i}.json").read_text())
                for i in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()


def test_a_task_that_registers_after_the_driver_gave_up_stops():
    """Ten tasks register after the driver's registration timeout, all at
    once: each is refused and stops at once (10 of 10)."""
    import tempfile
    from pathlib import Path

    key = secret.make_secret_key()
    driver = spark_exec.SparkDriverService(RUNS, key)
    with tempfile.TemporaryDirectory() as d:
        tmp_path = Path(d)
        try:
            with pytest.raises(TimeoutError):
                driver.wait_for_initial_registration(0.1)
            procs = _start_tasks(driver, key, tmp_path, RUNS)
            records = _finish(procs, tmp_path, RUNS, timeout=120)
        finally:
            driver.shutdown()
    assert [r["state"] for r in records] == ["refused"] * RUNS
    assert all(driver.task_addresses_for_driver(i) is None
               for i in range(RUNS))


def test_a_task_whose_driver_is_gone_stops_within_the_bound():
    """Ten registered tasks whose driver stops without a ShutdownRequest:
    each stops within DRIVER_LOST_BOUND_S of the driver's end (10 of 10)."""
    import tempfile
    from pathlib import Path

    key = secret.make_secret_key()
    driver = spark_exec.SparkDriverService(RUNS, key)
    with tempfile.TemporaryDirectory() as d:
        tmp_path = Path(d)
        procs = _start_tasks(driver, key, tmp_path, RUNS)
        try:
            driver.wait_for_initial_registration(120)
            deadline = time.monotonic() + 30
            while len(driver.hostnames) < RUNS and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            gone = time.time()
            # The service's own shutdown, not shutdown_registered_tasks.
            spark_exec.HorovodRunDriverService.shutdown(driver)
        records = _finish(procs, tmp_path, RUNS,
                          timeout=spark_exec.DRIVER_LOST_BOUND_S + 30)
    assert [r["state"] for r in records] == ["driver_lost"] * RUNS
    late = [r["end"] - gone for r in records]
    assert max(late) <= spark_exec.DRIVER_LOST_BOUND_S, late


def test_a_stopping_task_ends_its_function():
    """A task told to shut down while its function still runs (the driver
    failed fast on another rank) ends the subprocess."""
    key = secret.make_secret_key()
    driver = spark_exec.SparkDriverService(1, key)
    t = threading.Thread(target=spark_exec.task_main,
                         args=(0, driver.addresses(), key), daemon=True)
    t.start()
    try:
        driver.wait_for_initial_registration(30)
        client = spark_exec.network.BasicClient(
            spark_exec.SparkTaskService.NAME_FMT % 0,
            driver.task_addresses_for_driver(0), key)
        payload = spark_exec.pickler().dumps((time.sleep, (600,), {}))
        client._request(spark_exec.ExecuteRequest({}, payload))
        deadline = time.monotonic() + 30
        while client._request(spark_exec.ResultRequest()).state != \
                "running" and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.0)
        client._request(spark_exec.ShutdownRequest())
        t.join(timeout=20)
        assert not t.is_alive(), "the task did not stop"
    finally:
        driver.shutdown()
