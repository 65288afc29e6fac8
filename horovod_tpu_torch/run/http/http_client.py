"""The rendezvous KV's HTTP client (the port's copy of
``horovod_tpu/run/http/http_client.py``). Reads retry through
``common/faults.Retrier`` under the ``KV`` scope, so
``HOROVOD_RETRY_KV_*`` tunes their backoff."""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Optional

from ...common import config as _config
from ...common import faults as _faults


def read_data_from_kvstore(addr: str, port: int, scope: str,
                           key: str, timeout: float = 10.0,
                           retries: int = 3) -> Optional[bytes]:
    """One KV GET; None when the key is not there (yet). ``timeout``
    bounds each request and ``retries`` is the call site's attempt budget
    (a short-deadline caller passes 1, so no environment knob may raise
    it); the backoff between attempts follows ``HOROVOD_RETRY_KV_*``."""
    url = f"http://{addr}:{port}/{scope}/{key}"

    def get() -> Optional[bytes]:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    retrier = _faults.Retrier(
        _config.retry_policy_from_env(
            "KV", pinned=("max_attempts",), max_attempts=retries,
            base_delay=0.5, max_delay=2.0, multiplier=1.5),
        f"kv.read/{scope}/{key}")
    return retrier.call(get, retry_on=(urllib.error.URLError, OSError))


def put_data_into_kvstore(addr: str, port: int, scope: str, key: str,
                          value: bytes, timeout: float = 10.0) -> None:
    url = f"http://{addr}:{port}/{scope}/{key}"
    req = urllib.request.Request(url, data=value, method="PUT")
    with urllib.request.urlopen(req, timeout=timeout):
        pass


def delete_data_from_kvstore(addr: str, port: int, scope: str, key: str,
                             timeout: float = 10.0) -> None:
    url = f"http://{addr}:{port}/{scope}/{key}"
    req = urllib.request.Request(url, method="DELETE")
    with urllib.request.urlopen(req, timeout=timeout):
        pass
