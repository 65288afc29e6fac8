"""The worker's notification plane (the port's copy of
``horovod_tpu/run/elastic/worker.py``).

Each worker of an elastic job runs a ``WorkerNotificationService`` and
puts its addresses in the rendezvous KV under
``/workers/<hostname>:<local_rank>``. When the driver sees the hosts
change it sends every worker a ``HostsUpdatedRequest``; the service posts
it to the process's mailbox (``elastic/state.py``), which raises
``HostsUpdatedInterrupt`` at the next ``state.commit()``. With
``HOROVOD_HEARTBEAT_MS`` set, a thread also puts a heartbeat in the KV
that often.
"""

from __future__ import annotations

import base64
import pickle
import threading
from typing import List, Optional, Tuple

from ...common import config as _config
from ...common import faults as _faults
from ...common import logging as _log
from ..common.util import network
from ..http.http_client import put_data_into_kvstore

WORKER_WIRE_MODULE = "horovod_tpu.run.elastic.worker"


class _HeartbeatSender(threading.Thread):
    """One KV put every ``HOROVOD_HEARTBEAT_MS`` under
    ``/heartbeat/<hostname>:<local_rank>``; the driver escalates silence
    to SUSPECT and EVICT. A failed beat is dropped, never fatal. The
    ``control.heartbeat`` fault point drops (``drop_conn``) or delays
    beats."""

    def __init__(self, addr: str, port: int, hostname: str,
                 local_rank: int, interval_ms: int):
        super().__init__(daemon=True, name="hvd-heartbeat")
        self._addr = addr
        self._port = port
        self._hostname = hostname
        self._local_rank = local_rank
        self._interval_s = max(interval_ms, 1) / 1000.0
        self._stop_beating = threading.Event()

    def run(self):
        from .rendezvous import put_heartbeat

        seq = 0
        while not self._stop_beating.wait(self._interval_s):
            seq += 1
            try:
                _faults.point("control.heartbeat")
                put_heartbeat(self._addr, self._port, self._hostname,
                              self._local_rank, seq)
            except OSError:
                continue

    def stop(self):
        self._stop_beating.set()


@network.wire_class(WORKER_WIRE_MODULE)
class HostsUpdatedRequest:
    def __init__(self, timestamp: float):
        self.timestamp = timestamp


class WorkerNotificationService(network.BasicService):
    NAME = "worker notification service"

    def __init__(self, key: bytes):
        super().__init__(self.NAME, key)

    def _handle(self, req, client_address):
        if isinstance(req, HostsUpdatedRequest):
            from ...elastic.state import notification_mailbox

            notification_mailbox.post(req.timestamp)
            return network.AckResponse()
        return super()._handle(req, client_address)


class WorkerNotificationClient(network.BasicClient):
    def __init__(self, addresses: List[Tuple[str, int]], key: bytes):
        super().__init__(WorkerNotificationService.NAME, addresses, key)

    def notify_hosts_updated(self, timestamp: float) -> None:
        self._request(HostsUpdatedRequest(timestamp))


class WorkerNotificationManager:
    """The process's notification service and heartbeat, started once
    under the elastic driver (its notification key in the environment)."""

    def __init__(self):
        self._service: Optional[WorkerNotificationService] = None
        self._heartbeat: Optional[_HeartbeatSender] = None

    def init(self) -> None:
        if self._service is not None:
            return
        key_b64 = _config.secret_key_b64()
        if not key_b64:
            return
        self._service = WorkerNotificationService(base64.b64decode(key_b64))
        if _config.preempt_signal_spec():
            from ...elastic.state import register_preemption_signal

            try:
                register_preemption_signal()
            except (ValueError, AttributeError, OSError) as e:
                # Off the main thread, an unknown signal name, or one that
                # cannot be caught.
                _log.warning(
                    f"preemption-signal handler not installed: {e}")
        addr = _config.rendezvous_addr()
        port = _config.rendezvous_port()
        hostname = _config.hostname("localhost")
        local_rank = _config.slot_local_rank()
        if addr and port:
            put_data_into_kvstore(
                addr, port, "workers", f"{hostname}:{local_rank}",
                pickle.dumps(self._service.addresses()))
            hb_ms = _config.heartbeat_ms()
            if hb_ms > 0 and self._heartbeat is None:
                self._heartbeat = _HeartbeatSender(
                    addr, port, hostname, local_rank, hb_ms)
                self._heartbeat.start()

    def shutdown(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        if self._service is not None:
            self._service.shutdown()
            self._service = None


notification_manager = WorkerNotificationManager()

