"""The driver and task services of a job's set-up round (the port's copy
of ``horovod_tpu/run/driver/driver_service.py``, after upstream Horovod's
``run/common/service/driver_service.py`` and ``task_service.py``).

A ``HorovodRunDriverService`` runs on the launch host; one
``HorovodRunTaskService`` a target host registers its addresses with it.
The driver then probes every advertised address and keeps those it can
reach (``get_common_interfaces``): the NIC round of upstream Horovod. The
pair is also the transport of the Spark integration (``spark/exec.py``).

The requests travel under the JAX package's class paths
(``horovod_tpu.run.driver.driver_service.<name>``, see
``run/common/util/network.py``), so the JAX package's clients and
services talk to the port's.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ...common import config as _config
from ..common.util import network

DRIVER_WIRE_MODULE = "horovod_tpu.run.driver.driver_service"


@network.wire_class(DRIVER_WIRE_MODULE)
class RegisterTaskRequest:
    def __init__(self, index: int, task_addresses: List[Tuple[str, int]]):
        self.index = index
        self.task_addresses = task_addresses


@network.wire_class(DRIVER_WIRE_MODULE)
class AllTaskAddressesRequest:
    def __init__(self, index: int):
        self.index = index


@network.wire_class(DRIVER_WIRE_MODULE)
class AllTaskAddressesResponse:
    def __init__(self, all_task_addresses: Dict[int, List[Tuple[str, int]]]):
        self.all_task_addresses = all_task_addresses


@network.wire_class(DRIVER_WIRE_MODULE)
class TaskIndexRequest:
    def __init__(self, hostname: str):
        self.hostname = hostname


@network.wire_class(DRIVER_WIRE_MODULE)
class TaskIndexResponse:
    def __init__(self, index: int):
        self.index = index


class HorovodRunDriverService(network.BasicService):
    NAME = "horovodrun driver service"

    def __init__(self, num_hosts: int, key: bytes, nics=None):
        super().__init__(self.NAME, key, nics)
        self._num_hosts = num_hosts
        self._all_task_addresses: Dict[int, List[Tuple[str, int]]] = {}
        self._hostnames: Dict[str, int] = {}
        self._wait_cond = threading.Condition()

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._wait_cond:
                self._all_task_addresses[req.index] = req.task_addresses
                self._wait_cond.notify_all()
            return network.AckResponse()
        if isinstance(req, AllTaskAddressesRequest):
            return AllTaskAddressesResponse(dict(self._all_task_addresses))
        if isinstance(req, TaskIndexRequest):
            with self._wait_cond:
                if req.hostname not in self._hostnames:
                    self._hostnames[req.hostname] = len(self._hostnames)
            return TaskIndexResponse(self._hostnames[req.hostname])
        return super()._handle(req, client_address)

    def wait_for_initial_registration(
            self, timeout: Optional[float] = None) -> None:
        """Block until every host registered. The default deadline is the
        ``DRIVER`` retry scope's (``HOROVOD_RETRY_DRIVER_DEADLINE``, 30 s;
        0 waits without a deadline)."""
        if timeout is None:
            timeout = _config.retry_policy_from_env(
                "DRIVER", deadline=30.0).deadline
            if timeout <= 0:
                timeout = None
        with self._wait_cond:
            ok = self._wait_cond.wait_for(
                lambda: len(self._all_task_addresses) >= self._num_hosts,
                timeout=timeout)
        if not ok:
            raise TimeoutError(
                f"only {len(self._all_task_addresses)}/{self._num_hosts} "
                "hosts registered with the driver service")

    def task_addresses_for_driver(self, index: int):
        return self._all_task_addresses.get(index)


class HorovodRunTaskService(network.BasicService):
    NAME_FMT = "horovodrun task service #%d"

    def __init__(self, index: int, key: bytes, nics=None):
        super().__init__(self.NAME_FMT % index, key, nics)
        self.index = index


def probe_routable_addresses(addresses: List[Tuple[str, int]],
                             service_name: str, key: bytes,
                             timeout: Optional[float] = None
                             ) -> List[Tuple[str, int]]:
    """The advertised (ip, port) pairs of a service that the caller
    reaches: an authenticated ping answered by that service. Each address
    gets one connect, bounded by ``timeout`` when given, else by the
    ``PROBE`` retry scope's deadline (``HOROVOD_RETRY_PROBE_DEADLINE``,
    2 s); the attempts are pinned to one, so a dead address costs one
    bounded connect."""
    policy = _config.retry_policy_from_env(
        "PROBE",
        pinned=("max_attempts",) + (
            ("deadline",) if timeout is not None else ()),
        deadline=timeout if timeout is not None else 2.0,
        max_attempts=1)
    # A deadline of 0 means none to a retry policy, but a probe stays
    # bounded (and a 0 s socket timeout would fail every address).
    probe_timeout = policy.deadline if policy.deadline > 0 else 2.0
    reachable = []
    for addr in addresses:
        try:
            network.BasicClient(service_name, [addr], key,
                                probe_timeout=probe_timeout,
                                attempts=max(1, policy.max_attempts))
            reachable.append(addr)
        except (ConnectionError, OSError):
            continue
    return reachable


def get_common_interfaces(driver: "HorovodRunDriverService",
                          num_hosts: int, key: bytes,
                          timeout: Optional[float] = None
                          ) -> Dict[int, List[Tuple[str, int]]]:
    """The routable addresses of each registered host: every address a
    task advertised, probed from here. With more than one host loopback
    is left out (the other hosts cannot use it). A host that never
    registered, or has no routable address, raises."""
    routable: Dict[int, List[Tuple[str, int]]] = {}
    for index in range(num_hosts):
        addrs = driver.task_addresses_for_driver(index)
        if addrs is None:
            raise RuntimeError(f"host index {index} never registered")
        if num_hosts > 1:
            addrs = [a for a in addrs if not a[0].startswith("127.")]
        ok = probe_routable_addresses(
            addrs, HorovodRunTaskService.NAME_FMT % index, key,
            timeout=timeout)
        if not ok:
            raise RuntimeError(
                f"no routable interface to host index {index} "
                f"(advertised: {addrs})")
        routable[index] = ok
    return routable


class HorovodRunDriverClient(network.BasicClient):
    def __init__(self, addresses, key):
        super().__init__(HorovodRunDriverService.NAME, addresses, key)

    def register_task(self, index: int,
                      task_addresses: List[Tuple[str, int]]) -> None:
        self._request(RegisterTaskRequest(index, task_addresses))

    def all_task_addresses(self, index: int = 0):
        resp = self._request(AllTaskAddressesRequest(index))
        return resp.all_task_addresses

    def task_index(self, hostname: str) -> int:
        return self._request(TaskIndexRequest(hostname)).index
