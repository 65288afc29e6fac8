"""The user's function run inside the Spark executors, over the
authenticated task services (the port's copy of
``horovod_tpu/spark/exec.py``, after upstream Horovod's
``spark/runner.py``, ``spark/driver/mpirun_rsh.py`` and
``spark/task/mpirun_exec_fn.py``).

Each Spark task starts a service and registers with the driver; the
driver reaches the executors through those services, so there is no
ssh between hosts, and the function sees the executor's Python, working
directory and resource limits:

driver                                  executor (one task a rank)
------                                  --------------------------
SparkDriverService                       SparkTaskService starts
  <- RegisterTaskRequest(index, addrs)
  <- RegisterTaskHostnameRequest
probe routable addrs
  -> FreePortRequest (task 0)            picks the world's base port
  -> ExecuteRequest(env, payload)        subprocess runs fn (task_exec)
  -> ResultRequest (poll)                running -> done | failed
  -> ShutdownRequest                     service stops, Spark task returns

Nothing here needs pyspark: a pool of processes can stand in for the
executors. The requests travel under the JAX package's class paths
(``horovod_tpu.spark.exec.<name>``), as the launcher's do.

A task never serves without a driver that wants it (the JAX package's
tasks could: a task that registered after the driver gave up waited for
a shutdown that never came). A driver that gave up (a registration
timeout, ``shutdown_registered_tasks``, ``shutdown``) answers a later
registration with ``RegistrationClosedResponse``, and the task stops at
once; a registered task pings its driver every ``WATCH_INTERVAL_S`` and
stops once ``DRIVER_LOST_PINGS`` pings in a row went unanswered, within
``DRIVER_LOST_BOUND_S`` of the driver's end. A task that stops ends the
function's subprocess if it still runs.
"""

from __future__ import annotations

import collections
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..common import config as _config
from ..run.common.util import network
from ..run.common.util.hosts import SlotInfo
from ..run.driver.driver_service import (
    HorovodRunDriverService, RegisterTaskRequest, probe_routable_addresses)
from ..run.launch import slot_env
from .task_exec import pickler

EXEC_WIRE_MODULE = "horovod_tpu.spark.exec"
# A request and response of the port's own, with no counterpart in the JAX
# package.
PORT_WIRE_MODULE = "horovod_tpu_torch.spark.exec"

WATCH_INTERVAL_S = 1.0    # a registered task pings its driver this often
WATCH_TIMEOUT_S = 2.0     # the connect and reply bound of one ping
DRIVER_LOST_PINGS = 3     # unanswered pings in a row that end the task
DRIVER_LOST_BOUND_S = DRIVER_LOST_PINGS * (WATCH_INTERVAL_S + WATCH_TIMEOUT_S)

# -- protocol ----------------------------------------------------------------


@network.wire_class(EXEC_WIRE_MODULE)
class RegisterTaskHostnameRequest:
    def __init__(self, index: int, hostname: str):
        self.index = index
        self.hostname = hostname


@network.wire_class(EXEC_WIRE_MODULE)
class FreePortRequest:
    pass


@network.wire_class(EXEC_WIRE_MODULE)
class FreePortResponse:
    def __init__(self, base_port: int):
        self.base_port = base_port


@network.wire_class(EXEC_WIRE_MODULE)
class ExecuteRequest:
    def __init__(self, env: Dict[str, str], payload: bytes):
        self.env = env          # the HOROVOD_* block of the rank
        self.payload = payload  # pickled (fn, args, kwargs)


@network.wire_class(EXEC_WIRE_MODULE)
class ResultRequest:
    pass


@network.wire_class(EXEC_WIRE_MODULE)
class ResultResponse:
    def __init__(self, state: str, result: Optional[bytes], error: str):
        self.state = state      # idle | running | done | failed
        self.result = result
        self.error = error


@network.wire_class(EXEC_WIRE_MODULE)
class ShutdownRequest:
    pass


@network.wire_class(PORT_WIRE_MODULE)
class RegistrationClosedResponse:
    """The driver gave up on its world: the task that asked stops."""


# -- driver side -------------------------------------------------------------


class SparkDriverService(HorovodRunDriverService):
    """The driver service, which also records each task's hostname (the
    local and cross ranks when executors share a host) and refuses
    registrations once it gave up (``close_registration``)."""

    NAME = "horovod spark driver service"

    def __init__(self, num_tasks: int, key: bytes, nics=None):
        super().__init__(num_tasks, key, nics)
        self.hostnames: Dict[int, str] = {}
        self._closed = False

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            # Under the lock that close_registration takes: a task is
            # either among the registered ones that shutdown reaches, or
            # refused.
            with self._wait_cond:
                if self._closed:
                    return RegistrationClosedResponse()
                return super()._handle(req, client_address)
        if isinstance(req, RegisterTaskHostnameRequest):
            self.hostnames[req.index] = req.hostname
            return network.AckResponse()
        return super()._handle(req, client_address)

    def close_registration(self) -> None:
        """Refuse every later registration."""
        with self._wait_cond:
            self._closed = True

    def wait_for_initial_registration(
            self, timeout: Optional[float] = None) -> None:
        """As the base class's, and on a timeout the driver gives up: it
        refuses later registrations and shuts down the tasks that
        registered, then raises."""
        try:
            super().wait_for_initial_registration(timeout)
        except TimeoutError:
            shutdown_registered_tasks(self, self._num_hosts, self._key)
            raise

    def shutdown(self):
        self.close_registration()
        super().shutdown()


# -- task (executor) side ----------------------------------------------------


class SparkTaskService(network.BasicService):
    """Runs inside one Spark executor and executes fn as a subprocess of
    it (upstream Horovod's mpirun_exec_fn role), so fn inherits the
    executor's environment, working directory and container."""

    NAME_FMT = "horovod spark task service #%d"

    def __init__(self, index: int, key: bytes, nics=None):
        super().__init__(self.NAME_FMT % index, key, nics)
        self.index = index
        self._state = "idle"
        self._result: Optional[bytes] = None
        self._error = ""
        self._proc: Optional[subprocess.Popen] = None
        self._shutdown_ev = threading.Event()

    def _handle(self, req, client_address):
        if isinstance(req, FreePortRequest):
            return FreePortResponse(_config.free_port_pair())
        if isinstance(req, ExecuteRequest):
            if self._state == "running":
                return ResultResponse("running", None,
                                      "already executing")
            self._state = "running"
            threading.Thread(target=self._exec, args=(req,),
                             daemon=True).start()
            return network.AckResponse()
        if isinstance(req, ResultRequest):
            return ResultResponse(self._state, self._result, self._error)
        if isinstance(req, ShutdownRequest):
            self._shutdown_ev.set()
            return network.AckResponse()
        return super()._handle(req, client_address)

    def _exec(self, req: ExecuteRequest):
        try:
            with tempfile.NamedTemporaryFile(
                    suffix=".hvdtask", delete=False) as f:
                f.write(req.payload)
                payload_path = f.name
            env = dict(os.environ)
            env.update(req.env)
            # fn's output goes to the executor's stdout and stderr, which
            # Spark keeps as the executor's logs; only the last lines of
            # stderr are kept here, for the driver's error report.
            tail: collections.deque = collections.deque(maxlen=20)
            self._proc = subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.spark.task_exec",
                 payload_path],
                env=env, stdout=None, stderr=subprocess.PIPE, text=True)
            for line in self._proc.stderr:
                sys.stderr.write(line)
                tail.append(line.rstrip("\n"))
            rc = self._proc.wait()
            out_path = payload_path + ".out"
            if rc == 0 and os.path.exists(out_path):
                with open(out_path, "rb") as f:
                    self._result = f.read()
                self._state = "done"
            else:
                self._error = (f"task fn exited rc={rc}: " +
                               "\n".join(tail))
                self._state = "failed"
            for p in (payload_path, out_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        except Exception as e:
            self._error = str(e)
            self._state = "failed"

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        return self._shutdown_ev.wait(timeout)

    def serve(self, driver: network.BasicClient,
              timeout: Optional[float] = None) -> str:
        """Serve until the driver says shutdown, ``timeout`` passes, or
        the driver stops answering (``DRIVER_LOST_PINGS`` pings in a
        row). Returns the task's state, or ``"driver_lost"``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        missed = 0
        while True:
            wait = WATCH_INTERVAL_S if deadline is None else \
                min(WATCH_INTERVAL_S, deadline - time.monotonic())
            if self.wait_for_shutdown(max(0.0, wait)):
                return self._state
            if deadline is not None and time.monotonic() >= deadline:
                return self._state
            try:
                driver.ping()
                missed = 0
            except Exception:
                # Refused, timed out or cut mid-frame: one missed ping.
                missed += 1
                if missed >= DRIVER_LOST_PINGS:
                    return "driver_lost"

    def shutdown(self):
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        super().shutdown()


def task_main(index: int, driver_addresses: List[Tuple[str, int]],
              key: bytes, timeout: Optional[float] = None, nics=None):
    """The body of one Spark task: start the service, register, and serve
    until the driver says shutdown, ``timeout`` passes (when given: the
    driver's whole registration and exec budget, since the driver polls
    the service during the exec round), or the driver is lost. Returns
    the task's final state: ``"refused"`` when the driver had given up,
    ``"driver_lost"`` when it stopped answering."""
    service = SparkTaskService(index, key, nics)
    try:
        client = network.BasicClient(SparkDriverService.NAME,
                                     driver_addresses, key)
        reply = client._request(RegisterTaskRequest(index,
                                                    service.addresses()))
        if isinstance(reply, RegistrationClosedResponse):
            return "refused"
        client._request(
            RegisterTaskHostnameRequest(index, socket.gethostname()))
        watch = network.BasicClient(
            SparkDriverService.NAME, [client._address], key,
            probe_timeout=WATCH_TIMEOUT_S, attempts=1)
        return service.serve(watch, timeout)
    finally:
        service.shutdown()


# -- orchestration (driver) --------------------------------------------------


def run_via_task_services(driver: SparkDriverService, fn, args, kwargs,
                          num_proc: int, key: bytes,
                          exec_timeout: Optional[float] = None,
                          env: Optional[Dict[str, str]] = None
                          ) -> List[Any]:
    """The register -> exec -> collect round. Every task must have
    registered already (``wait_for_initial_registration``).
    ``exec_timeout=None`` lets fn run without a bound. Every exit shuts
    the task services down, so executors never idle out their lifetime."""
    # Every task's addresses are probed at once: each dead address costs
    # a connect timeout.
    routable: Dict[int, List[Tuple[str, int]]] = {}
    errors: Dict[int, str] = {}

    def _probe(i):
        addrs = driver.task_addresses_for_driver(i)
        if not addrs:
            errors[i] = f"task {i} never registered"
            return
        ok = probe_routable_addresses(
            addrs, SparkTaskService.NAME_FMT % i, key)
        if not ok:
            errors[i] = (f"task {i} registered but none of its addresses "
                         f"{addrs} are routable from the driver")
            return
        routable[i] = ok

    probers = [threading.Thread(target=_probe, args=(i,), daemon=True)
               for i in range(num_proc)]
    for t in probers:
        t.start()
    for t in probers:
        t.join()
    if errors:
        _best_effort_shutdown(routable, key)
        raise RuntimeError("; ".join(errors[i] for i in sorted(errors)))

    clients = {
        i: network.BasicClient(SparkTaskService.NAME_FMT % i, routable[i],
                               key)
        for i in range(num_proc)
    }

    def _shutdown_all():
        for i in range(num_proc):
            try:
                clients[i]._request(ShutdownRequest())
            except (ConnectionError, OSError):
                pass

    try:
        return _exec_round(driver, clients, routable, fn, args, kwargs,
                           num_proc, exec_timeout, env)
    finally:
        # A task takes a second shutdown as a no-op.
        _shutdown_all()


def _best_effort_shutdown(routable, key):
    for i, addrs in routable.items():
        try:
            network.BasicClient(SparkTaskService.NAME_FMT % i, addrs,
                                key)._request(ShutdownRequest())
        except Exception:
            # A task in its teardown can answer with a cut frame; one bad
            # reply must not leave the other tasks serving or hide the
            # caller's exception.
            pass


def shutdown_registered_tasks(driver, num_proc: int, key: bytes) -> None:
    """The driver gives up: it refuses every later registration, then
    sends ``ShutdownRequest`` to every task that registered. Driver exits
    that never reach ``run_via_task_services`` (a registration timeout
    with part of the world) call it, so that no task serves on."""
    if hasattr(driver, "close_registration"):
        driver.close_registration()
    registered = {}
    for i in range(num_proc):
        addrs = driver.task_addresses_for_driver(i)
        if addrs:
            registered[i] = addrs
    _best_effort_shutdown(registered, key)


def _exec_round(driver, clients, routable, fn, args, kwargs, num_proc,
                exec_timeout, env):
    # Ranks follow task order, grouped by executor host (upstream
    # Horovod's get_host_assignments). The hostname comes in a second
    # request, so wait for all of them.
    deadline = time.monotonic() + 30
    while len(driver.hostnames) < num_proc:
        if time.monotonic() > deadline:
            missing = sorted(set(range(num_proc)) - set(driver.hostnames))
            raise RuntimeError(
                f"tasks {missing} registered addresses but never their "
                f"hostname")
        time.sleep(0.05)
    hostnames = {i: driver.hostnames[i] for i in range(num_proc)}
    by_host: Dict[str, List[int]] = {}
    for i in range(num_proc):
        by_host.setdefault(hostnames[i], []).append(i)
    cross_size = len(by_host)
    cross_of = {h: c for c, h in enumerate(sorted(by_host))}

    # Rank 0's executor picks the world's base port: it must be free there.
    base_port = clients[0]._request(FreePortRequest()).base_port
    # The other executors must reach rank 0's controller, so loopback
    # (which a driver beside task 0 finds routable) serves only a world
    # on one host.
    non_loop = [a for a, _ in routable[0] if a != "127.0.0.1"]
    if non_loop:
        controller_addr = non_loop[0]
    elif len(set(hostnames.values())) <= 1:
        controller_addr = routable[0][0][0]
    else:
        raise RuntimeError(
            f"task 0 on {hostnames[0]} advertised no non-loopback "
            f"address reachable from the driver, but the job spans "
            f"{len(set(hostnames.values()))} hosts — other executors "
            f"cannot reach its controller")

    p = pickler()
    payload = p.dumps((fn, tuple(args), dict(kwargs or {})))
    for i in range(num_proc):
        h = hostnames[i]
        slot = SlotInfo(
            hostname=h, rank=i, local_rank=by_host[h].index(i),
            cross_rank=cross_of[h], size=num_proc,
            local_size=len(by_host[h]), cross_size=cross_size)
        block = slot_env(slot, controller_addr, base_port,
                         controller_addr, base_port, base_env={})
        if env:
            block.update(env)
        clients[i]._request(ExecuteRequest(block, payload))

    deadline = (time.monotonic() + exec_timeout
                if exec_timeout is not None else None)
    results: Dict[int, Any] = {}
    failed: Dict[int, str] = {}

    while len(results) < num_proc:
        for i in range(num_proc):
            if i in results or i in failed:
                continue
            r = clients[i]._request(ResultRequest())
            if r.state == "done":
                results[i] = p.loads(r.result)
            elif r.state == "failed":
                failed[i] = r.error
        if failed:
            # Fail fast: the peers likely wait in hvd.init for the dead
            # rank (the caller's finally shuts every task down).
            raise RuntimeError(
                "spark tasks failed: " +
                "; ".join(f"rank {i}: {e}"
                          for i, e in sorted(failed.items())))
        if len(results) < num_proc and deadline is not None and \
                time.monotonic() > deadline:
            raise TimeoutError(
                f"spark tasks still running after {exec_timeout}s "
                f"(ranks {sorted(set(range(num_proc)) - set(results))})")
        time.sleep(0.5)

    return [results[i] for i in range(num_proc)]
