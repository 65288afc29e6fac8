"""The port's task services' driver (``horovod_tpu_torch/run/driver``)
against the JAX package's (``tests/test_driver_service.py``'s cases, run
on each package), and across them: a client of one package registers with
the other's service, so the requests' class paths on the wire are
checked in both directions."""

import pytest

from horovod_tpu.run.common.util import secret
from horovod_tpu.run.driver import driver_service as ref_ds
from horovod_tpu_torch.run.driver import driver_service as port_ds

PACKAGES = {"reference": ref_ds, "port": port_ds}


@pytest.fixture(params=sorted(PACKAGES))
def ds(request):
    return PACKAGES[request.param]


def test_local_address_enumeration():
    from horovod_tpu.run.common.util.network import get_local_addresses as ref
    from horovod_tpu_torch.run.common.util.network import (
        get_local_addresses as port)

    assert ("lo", "127.0.0.1") in port()
    assert port() == ref()


def _common_interfaces(service_ds, client_ds):
    """The routable set of two task services registered through
    ``client_ds``'s client with ``service_ds``'s driver, each beside a
    black-hole address the probe must drop (TEST-NET-1)."""
    key = secret.make_secret_key()
    driver = service_ds.HorovodRunDriverService(num_hosts=2, key=key)
    tasks = [service_ds.HorovodRunTaskService(i, key) for i in range(2)]
    try:
        client = client_ds.HorovodRunDriverClient(driver.addresses(), key)
        for t in tasks:
            client.register_task(
                t.index, [("192.0.2.254", 9)] + t.addresses())
        driver.wait_for_initial_registration(timeout=10.0)
        assert client.task_index("host-a") == 0
        assert client.task_index("host-b") == 1
        assert client.task_index("host-a") == 0
        advertised = client.all_task_addresses()
        assert sorted(advertised) == [0, 1]
        common = service_ds.get_common_interfaces(driver, 2, key,
                                                  timeout=1.0)
        for i, t in enumerate(tasks):
            assert common[i], "no routable addresses found"
            assert ("192.0.2.254", 9) not in common[i]
            assert all(a in t.addresses() for a in common[i])
            assert advertised[i] == [("192.0.2.254", 9)] + t.addresses()
        return {i: len(a) for i, a in common.items()}
    finally:
        driver.shutdown()
        for t in tasks:
            t.shutdown()


def test_common_interfaces_probe(ds):
    _common_interfaces(ds, ds)


@pytest.mark.parametrize("service,client", [("port", "reference"),
                                            ("reference", "port")])
def test_the_packages_register_with_each_other(service, client):
    """Each package's client speaks to the other's driver: the frames name
    the JAX package's class paths on both sides."""
    got = _common_interfaces(PACKAGES[service], PACKAGES[client])
    assert got == _common_interfaces(ref_ds, ref_ds)


def test_probe_rejects_wrong_service(ds):
    key = secret.make_secret_key()
    t = ds.HorovodRunTaskService(0, key)
    try:
        ok = ds.probe_routable_addresses(
            t.addresses(), "some other service", key, timeout=1.0)
        assert ok == []
        assert ds.probe_routable_addresses(
            t.addresses(), ds.HorovodRunTaskService.NAME_FMT % 0, key,
            timeout=1.0) == t.addresses()
    finally:
        t.shutdown()


def test_unregistered_host_raises(ds):
    key = secret.make_secret_key()
    driver = ds.HorovodRunDriverService(num_hosts=1, key=key)
    try:
        with pytest.raises(RuntimeError, match="never registered"):
            ds.get_common_interfaces(driver, 1, key, timeout=1.0)
        with pytest.raises(TimeoutError, match="0/1 hosts registered"):
            driver.wait_for_initial_registration(timeout=0.2)
    finally:
        driver.shutdown()


def test_registration_deadline_comes_from_the_driver_scope(ds, monkeypatch):
    """No timeout given: the ``DRIVER`` retry scope's deadline bounds the
    wait."""
    import time

    monkeypatch.setenv("HOROVOD_RETRY_DRIVER_DEADLINE", "0.3")
    key = secret.make_secret_key()
    driver = ds.HorovodRunDriverService(num_hosts=1, key=key)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            driver.wait_for_initial_registration()
        assert 0.25 < time.monotonic() - t0 < 5.0
    finally:
        driver.shutdown()


def test_a_frame_with_bytes_crosses_the_wire():
    """A wire object with a ``bytes`` field (the Spark transport's
    payloads and results) decodes on the port's side and on the JAX
    package's: the port's frames once wrote bytes through a global its own
    unpickler refuses, and the frame was dropped."""
    import pickle

    import horovod_tpu.spark.exec as ref_exec
    from horovod_tpu_torch.run.common.util import network
    from horovod_tpu_torch.spark import exec as port_exec

    blob = bytes(range(256)) * 3
    frame = network.dumps(port_exec.ResultResponse("done", blob, "é"))
    got = network.loads(frame)
    assert isinstance(got, port_exec.ResultResponse)
    assert (got.state, got.result, got.error) == ("done", blob, "é")
    ref = pickle.loads(frame)
    assert isinstance(ref, ref_exec.ResultResponse) and ref.result == blob
    back = network.loads(pickle.dumps(
        ref_exec.ExecuteRequest({"HOROVOD_RANK": "1"}, blob)))
    assert isinstance(back, port_exec.ExecuteRequest)
    assert (back.env, back.payload) == ({"HOROVOD_RANK": "1"}, blob)
