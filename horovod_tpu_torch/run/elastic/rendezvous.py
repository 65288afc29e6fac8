"""The worker's side of the elastic rendezvous KV (the port's copy of the
worker functions of ``horovod_tpu/run/elastic/rendezvous.py``).

The driver writes each round's slot plan under
``/rank/<hostname>:<local_rank>`` as ``rank,size,local_rank,local_size,
cross_rank,cross_size,round``; every (re-)init reads this worker's slot.
Rank 0 publishes where its world's store listens under
``/controller/endpoint.<round>``, keyed by the round it read, so a worker
only ever pairs a round's layout with that round's coordinator. Workers
also put heartbeats under ``/heartbeat`` and drain phases under
``/drain``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from ...common import config as _config
from ...common import faults as _faults
from ..http.http_client import put_data_into_kvstore, read_data_from_kvstore

RANK_SCOPE = "rank"
CONTROLLER_SCOPE = "controller"
HEARTBEAT_SCOPE = "heartbeat"
DRAIN_SCOPE = "drain"

SlotLayout = Tuple[int, int, int, int, int, int]


def put_heartbeat(addr: str, port: int, hostname: str, local_rank: int,
                  seq: int) -> None:
    """One heartbeat into the KV, with a short timeout: a beat that cannot
    land soon is better dropped than queued."""
    put_data_into_kvstore(addr, port, HEARTBEAT_SCOPE,
                          f"{hostname}:{local_rank}",
                          str(seq).encode(), timeout=2.0)


def announce_drain(addr: str, port: int, hostname: str, local_rank: int,
                   phase: str) -> None:
    """Publish this worker's drain phase ("begin", then "commit"), one
    key a phase (``<host>:<slot>.<phase>``) so the driver's ~1 s poll
    sees both."""
    put_data_into_kvstore(addr, port, DRAIN_SCOPE,
                          f"{hostname}:{local_rank}.{phase}", b"1",
                          timeout=2.0)


def fetch_slot_info(addr: str, port: int, hostname: str, local_rank: int,
                    rank: Optional[int] = None
                    ) -> Optional[Tuple[SlotLayout, int]]:
    """((rank, size, local_rank, local_size, cross_rank, cross_size),
    round) of this worker's slot, or None when the round's plan leaves it
    out. ``rank`` (the current one) targets the ``rendezvous.poll``
    fault point."""
    _faults.point("rendezvous.poll", rank=rank)
    blob = read_data_from_kvstore(addr, port, RANK_SCOPE,
                                  f"{hostname}:{local_rank}")
    if blob is None:
        return None
    parts = [int(p) for p in blob.decode().split(",")]
    return tuple(parts[:6]), parts[6]  # type: ignore[return-value]


def publish_controller_endpoint(addr: str, port: int, controller_host: str,
                                controller_port: int,
                                rendezvous_round: int) -> None:
    """Rank 0 announces where its world's store listens this round (the
    native controller is on the next port)."""
    put_data_into_kvstore(addr, port, CONTROLLER_SCOPE,
                          f"endpoint.{rendezvous_round}",
                          f"{controller_host}:{controller_port}".encode())


def fetch_controller_endpoint(addr: str, port: int, rendezvous_round: int,
                              timeout: float = 120.0,
                              rank: Optional[int] = None
                              ) -> Optional[Tuple[str, int]]:
    """Poll the KV until the round's endpoint appears: (host, port), or
    None past ``timeout`` (a contract: the poll's deadline and attempts
    take no environment override, only its cadence does, under
    ``HOROVOD_RETRY_RENDEZVOUS_*``). Each read is one attempt clamped to
    what is left of the deadline."""
    retrier = _faults.Retrier(
        _config.retry_policy_from_env(
            "RENDEZVOUS", pinned=("max_attempts", "deadline"),
            max_attempts=0, base_delay=0.25, max_delay=2.0,
            deadline=timeout),
        f"rendezvous.endpoint.{rendezvous_round}")
    overall_deadline = time.monotonic() + timeout

    def fetch() -> Optional[Tuple[str, int]]:
        _faults.point("rendezvous.endpoint", rank=rank)
        remaining = overall_deadline - time.monotonic()
        per_req = max(0.2, min(2.0, remaining))
        try:
            blob = read_data_from_kvstore(addr, port, CONTROLLER_SCOPE,
                                          f"endpoint.{rendezvous_round}",
                                          timeout=per_req, retries=1)
        except OSError:
            return None
        if not blob:
            return None
        host, _, p = blob.decode().rpartition(":")
        return host, int(p)

    try:
        return retrier.poll(fetch)
    except _faults.RetryExhausted:
        return None
