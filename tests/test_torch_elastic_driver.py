"""The port's elastic driver (``horovod_tpu_torch/run/elastic/``) against
the JAX package's (``horovod_tpu/run/elastic/``), scenario for scenario
those of ``tests/test_elastic_driver.py`` and the driver's liveness
monitor of ``tests/test_liveness.py``.

Each scenario runs on both drivers with ``FixedHosts`` and a fake
rendezvous that records every round's plan; the workers are functions
that wait for their slot's event or a release. Both give the same
rounds (the slot strings of every plan, in order), the same final plan
and result: age order, the blacklist with its cooldown and parole on a
fake clock, stable ranks as the world grows, a removed host's worker
stopped, a failed worker's host blacklisted and the world re-formed,
the min-np gate, the dedupe of an unchanged plan, and a silent worker
evicted with the same timeline instants. Then both KV servers through
both clients (GET, PUT and DELETE codes), and the port's driver
notifying a reference worker over the frames (PR 10's test in
``tests/test_torch_elastic.py`` has the other direction).
"""

import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from horovod_tpu.run.common.util import hosts as ref_hosts
from horovod_tpu.run.elastic import discovery as ref_discovery
from horovod_tpu.run.elastic import driver as ref_driver
from horovod_tpu.run.elastic import registration as ref_registration
from horovod_tpu.run.elastic import rendezvous as ref_rendezvous
from horovod_tpu.run.http import http_client as ref_client
from horovod_tpu.run.http import http_server as ref_server
from horovod_tpu_torch.run.common.util import hosts as port_hosts
from horovod_tpu_torch.run.elastic import discovery as port_discovery
from horovod_tpu_torch.run.elastic import driver as port_driver
from horovod_tpu_torch.run.elastic import registration as port_registration
from horovod_tpu_torch.run.elastic import rendezvous as port_rendezvous
from horovod_tpu_torch.run.http import http_client as port_client
from horovod_tpu_torch.run.http import http_server as port_server

REF = types.SimpleNamespace(
    name="ref", hosts=ref_hosts, discovery=ref_discovery, driver=ref_driver,
    registration=ref_registration, rendezvous=ref_rendezvous,
    server=ref_server, client=ref_client)
PORT = types.SimpleNamespace(
    name="port", hosts=port_hosts, discovery=port_discovery,
    driver=port_driver, registration=port_registration,
    rendezvous=port_rendezvous, server=port_server, client=port_client)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


class FakeRendezvous:
    """Records each round's plan as its slot strings."""

    def __init__(self):
        self.rounds = []
        self.kv = {}

    def init(self, plan, rendezvous_round=0):
        self.rounds.append((rendezvous_round, [
            (s.hostname, s.local_rank, s.to_response_string())
            for s in plan]))

    def put(self, scope, key, value):
        self.kv[(scope, key)] = value

    def get(self, scope, key):
        return self.kv.get((scope, key))

    def delete(self, scope, key):
        self.kv.pop((scope, key), None)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _worker(release, exits=None, fail=None):
    """A worker that returns 0 once released or told to stop (noting the
    slot in ``exits``); ``fail(slot)`` true makes it return 1 at once."""

    def fn(slot, events):
        if fail is not None and fail(slot):
            return 1
        while not release.is_set():
            if any(e.is_set() for e in events):
                if exits is not None:
                    exits.append((slot.hostname, slot.local_rank))
                return 0
            time.sleep(0.01)
        return 0

    return fn


def _plan(driver):
    return [(s.hostname, s.rank, s.to_response_string())
            for s in driver.get_assignments()]


def _settle(driver, want_len, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(driver.get_assignments()) == want_len:
            return
        time.sleep(0.02)
    raise AssertionError(f"the plan never reached {want_len} slots")


def _scenario(pkg, name):
    """Run scenario ``name`` on ``pkg``'s driver; what it observed."""
    rdv = FakeRendezvous()
    release = threading.Event()
    seen = {}
    if name == "spawn_and_complete":
        driver = pkg.driver.ElasticDriver(
            rdv, pkg.discovery.FixedHosts({"a": 2}), min_np=2, timeout=5.0)
        driver.start(2, _worker(release))
        seen["plan"] = _plan(driver)
        release.set()
        seen["result"] = driver.get_results()
    elif name == "scale_up":
        disc = pkg.discovery.FixedHosts({"a": 2})
        driver = pkg.driver.ElasticDriver(rdv, disc, min_np=2, max_np=4,
                                          timeout=5.0)
        driver.start(2, _worker(release))
        seen["before"] = _plan(driver)
        disc.set({"b": 2, "a": 2})
        _settle(driver, 4)
        seen["after"] = _plan(driver)
        release.set()
        seen["result"] = driver.get_results()
    elif name == "removed_host":
        exits = []
        disc = pkg.discovery.FixedHosts({"a": 1, "b": 1})
        driver = pkg.driver.ElasticDriver(rdv, disc, min_np=1, max_np=2,
                                          timeout=5.0)
        driver.start(2, _worker(release, exits))
        disc.set({"a": 1})
        _settle(driver, 1)
        deadline = time.time() + 5.0
        while ("b", 0) not in exits and time.time() < deadline:
            time.sleep(0.02)
        seen["exits"] = list(exits)
        seen["plan"] = _plan(driver)
        release.set()
        seen["result"] = driver.get_results()
    elif name == "failure_recovers":
        failed = []

        def fail(slot):
            if slot.hostname == "b" and not failed:
                failed.append(slot.hostname)
                return True
            return False

        driver = pkg.driver.ElasticDriver(
            rdv, pkg.discovery.FixedHosts({"a": 1, "b": 1}), min_np=1,
            max_np=2, timeout=5.0)
        driver.start(2, _worker(release, fail=fail))
        deadline = time.time() + 5.0
        while time.time() < deadline and not (
                driver.host_manager.is_blacklisted("b")
                and len(driver.get_assignments()) == 1):
            time.sleep(0.02)
        seen["blacklisted"] = driver.host_manager.is_blacklisted("b")
        seen["plan"] = _plan(driver)
        release.set()
        seen["result"] = driver.get_results()
    elif name == "dedupe":
        disc = pkg.discovery.FixedHosts({"a": 2})
        driver = pkg.driver.ElasticDriver(rdv, disc, min_np=2, timeout=5.0)
        driver.start(2, _worker(release))
        seen["again"] = driver._activate_workers(2)
        notified = []
        driver.set_notify_client_factory(
            lambda h, lr: notified.append((h, lr)) or None)
        driver._on_hosts_updated()
        seen["notified"] = notified
        disc.set({"a": 2, "b": 1})
        driver.host_manager.update_available_hosts()
        seen["grown"] = driver._activate_workers(3)
        seen["round"] = driver._rendezvous_round
        release.set()
        driver.stop()
    else:
        raise ValueError(name)
    driver.stop()
    seen["rounds"] = [plan for _, plan in rdv.rounds]
    seen["round_numbers"] = [r for r, _ in rdv.rounds]
    return seen


@pytest.mark.parametrize("name", ["spawn_and_complete", "scale_up",
                                  "removed_host", "failure_recovers",
                                  "dedupe"])
def test_driver_scenarios_give_the_same_rounds_and_plans(name):
    ref = _scenario(REF, name)
    port = _scenario(PORT, name)
    assert port == ref
    if name == "scale_up":
        assert [h for h, _, _ in port["after"]] == ["a", "a", "b", "b"]
    if name == "failure_recovers":
        assert port["blacklisted"] and port["result"] == 0
        assert [h for h, _, _ in port["plan"]] == ["a"]


def _host_manager_trace(pkg):
    clk = FakeClock()
    disc = pkg.discovery.FixedHosts({"a": 2, "b": 2})
    mgr = pkg.discovery.HostManager(disc, cooldown_range=(5, 5),
                                    max_strikes=2, parole_window=30.0,
                                    clock=clk)
    trace = []

    def note(what):
        trace.append((what, mgr.current_hosts, mgr.available_slots(),
                      mgr.blacklist_info()))

    note(mgr.update_available_hosts())
    disc.set({"c": 2, "a": 2, "b": 2})
    note(mgr.update_available_hosts())
    note(mgr.update_available_hosts())
    disc.set({"c": 2, "b": 2})
    note(mgr.update_available_hosts())
    mgr.blacklist("b")
    mgr.blacklist("b")          # the same incident: one strike
    note("strike 1")
    clk.t += 6.0                # cooldown over: back on parole
    note(mgr.update_available_hosts())
    clk.t += 31.0               # clean parole: strikes forgiven
    note(mgr.update_available_hosts())
    mgr.blacklist("c")
    clk.t += 6.0
    mgr.update_available_hosts()
    mgr.blacklist("c")          # second strike: permanent
    note("permanent")
    mgr.quarantine("b", seconds=10.0)
    note("quarantined")
    clk.t += 11.0
    note(mgr.update_available_hosts())
    note(mgr.has_recoverable_hosts())
    events = [{k: v for k, v in e.items()} for e in mgr.blacklist_events()]
    return trace, events


def test_host_manager_age_order_blacklist_and_parole_match():
    ref, port = _host_manager_trace(REF), _host_manager_trace(PORT)
    assert port == ref
    trace, events = port
    assert [h for h, _ in trace[1][1]] == ["a", "b", "c"]
    assert events[-2]["permanent"] and events[-1].get("drained")


def _discovery_trace(pkg, tmp_path):
    script = tmp_path / f"discover_{pkg.name}.sh"
    script.write_text("#!/bin/sh\necho hostA:4\necho hostB\n")
    script.chmod(0o755)
    out = [pkg.discovery.HostDiscoveryScript(
        str(script), slots=8).find_available_hosts_and_slots()]
    with pytest.raises(ValueError) as e:
        pkg.discovery.HostDiscoveryScript(
            str(script)).find_available_hosts_and_slots()
    out.append(str(e.value))
    return out


def test_discovery_script_reads_alike(tmp_path):
    assert _discovery_trace(PORT, tmp_path) == \
        _discovery_trace(REF, tmp_path)


@BOTH
def test_min_np_gate_times_out(pkg):
    driver = pkg.driver.ElasticDriver(
        FakeRendezvous(), pkg.discovery.FixedHosts({"a": 1}), min_np=4,
        timeout=0.5)
    driver.host_manager.update_available_hosts()
    with pytest.raises(TimeoutError, match="only 1 available"):
        driver.wait_for_available_slots(4)
    driver.stop()


class RecordingTimeline:
    def __init__(self):
        self.instants = []

    def instant(self, name, args=None):
        self.instants.append((name, dict(args or {})))


def _eviction_trace(pkg, monkeypatch):
    """``tests/test_liveness.py``'s monitor drive: one active worker
    beats twice, then falls silent on a fake clock until evicted, then a
    drain on a second slot; the timeline instants, the eviction and the
    notified survivors."""
    monkeypatch.setenv("HOROVOD_HEARTBEAT_MS", "100")
    monkeypatch.setenv("HOROVOD_LIVENESS_TIMEOUT_MS", "3000")
    clk = FakeClock()
    kv, tl = FakeRendezvous(), RecordingTimeline()
    driver = pkg.driver.ElasticDriver(
        kv, pkg.discovery.FixedHosts({"h": 2}), min_np=1, timeline=tl)
    live = __import__(f"{pkg.driver.__name__.split('.run.')[0]}"
                      ".common.liveness", fromlist=["x"])
    driver._liveness = live.LivenessTracker(heartbeat_ms=100,
                                            timeout_ms=3000, clock=clk)
    handles = {}
    for slot in (0, 1):
        info = pkg.hosts.SlotInfo(hostname="h", rank=slot, local_rank=slot,
                                  cross_rank=0, size=2, local_size=2,
                                  cross_size=1)
        driver._assignments[("h", slot)] = info
        handles[slot] = driver._workers_active[("h", slot)] = \
            pkg.driver._WorkerHandle()
    notified = []
    driver.set_notify_client_factory(
        lambda h, s: notified.append((h, s)) or None)
    ticks = []
    for beat in (b"1", b"2"):
        kv.put("heartbeat", "h:0", beat)
        kv.put("heartbeat", "h:1", beat)
        driver._check_liveness()
        clk.t += 1.0
    for _ in range(8):
        kv.put("heartbeat", "h:1", f"{clk.t}".encode())
        clk.t += 1.0
        driver._check_liveness()
        ticks.append((handles[0].evicted, handles[0].event.is_set()))
    kv.put("drain", "h:1.begin", b"1")
    driver._check_liveness()
    kv.put("drain", "h:1.commit", b"1")
    driver._check_liveness()
    drained = driver._consume_drain_marker("h", 1)
    driver.stop()
    return {"instants": tl.instants, "ticks": ticks, "notified": notified,
            "drained": drained, "draining": handles[1].draining,
            "kv": sorted(kv.kv)}


def test_liveness_monitor_evicts_alike(monkeypatch):
    ref = _eviction_trace(REF, monkeypatch)
    port = _eviction_trace(PORT, monkeypatch)
    assert port == ref
    names = [n for n, _ in port["instants"]]
    assert names.index("RANK_SUSPECT") < names.index("RANK_EVICTED")
    assert port["notified"] == [("h", 1)] and port["drained"]


@BOTH
def test_driver_arms_the_tracker_only_with_heartbeats(pkg, monkeypatch):
    monkeypatch.delenv("HOROVOD_HEARTBEAT_MS", raising=False)
    driver = pkg.driver.ElasticDriver(
        FakeRendezvous(), pkg.discovery.FixedHosts({"h": 1}), min_np=1)
    assert driver._liveness is None
    monkeypatch.setenv("HOROVOD_HEARTBEAT_MS", "50")
    monkeypatch.setenv("HOROVOD_LIVENESS_TIMEOUT_MS", "1234")
    driver = pkg.driver.ElasticDriver(
        FakeRendezvous(), pkg.discovery.FixedHosts({"h": 1}), min_np=1)
    assert (driver._liveness.heartbeat_ms,
            driver._liveness.timeout_ms) == (50, 1234)


def _registration_trace(pkg):
    calls = []

    class DriverStub:
        def on_worker_exit(self, host, slot, state):
            calls.append((host, slot, state))

    hm = pkg.discovery.HostManager(
        pkg.discovery.FixedHosts({"h": 1, "g": 1}), clock=FakeClock())
    hm.update_available_hosts()
    reg = pkg.registration.WorkerStateRegistry(DriverStub(), hm)
    reg.record_ready("g", 0)
    reg.record_drained("h", 0)
    reg.record_failure("g", 0)
    reg.record_success("g", 0)
    return (calls, reg.count(pkg.registration.SUCCESS),
            reg.last_worker_states(), hm.blacklist_info())


def test_registration_records_alike():
    assert _registration_trace(PORT) == _registration_trace(REF)


# ---- the KV servers and clients --------------------------------------------


def _codes(port):
    """Each raw request's HTTP status (a 404 as 404)."""

    def call(method, path, data=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, b""

    return [call("GET", "/s/k"), call("PUT", "/s/k", b"v1"),
            call("GET", "/s/k"), call("PUT", "/s/k", b""),
            call("GET", "/s/k"), call("DELETE", "/s/k"),
            call("GET", "/s/k"), call("DELETE", "/s/missing"),
            call("GET", "/noscope")]


@pytest.mark.parametrize("server", [REF, PORT], ids=["ref_server",
                                                     "port_server"])
@pytest.mark.parametrize("client", [REF, PORT], ids=["ref_client",
                                                     "port_client"])
def test_both_kv_servers_through_both_clients(server, client):
    srv = server.server.RendezvousServer()
    port = srv.start_server()
    try:
        codes = _codes(port)
        if server is PORT:
            ref_srv = REF.server.RendezvousServer()
            try:
                assert codes == _codes(ref_srv.start_server())
            finally:
                ref_srv.stop_server()
        assert [c for c, _ in codes] == [404, 200, 200, 200, 200, 200, 404,
                                         200, 404]
        c = client.client
        c.put_data_into_kvstore("127.0.0.1", port, "scope", "key", b"value")
        assert c.read_data_from_kvstore("127.0.0.1", port, "scope",
                                        "key") == b"value"
        assert c.read_data_from_kvstore("127.0.0.1", port, "scope",
                                        "missing") is None
        c.delete_data_from_kvstore("127.0.0.1", port, "scope", "key")
        assert c.read_data_from_kvstore("127.0.0.1", port, "scope",
                                        "key") is None
        plan = server.hosts.get_host_assignments(
            server.hosts.parse_hosts("localhost:2,127.0.0.1:1"), 3)
        srv.init(plan, rendezvous_round=4)
        got = client.rendezvous.fetch_slot_info("127.0.0.1", port,
                                                "localhost", 1)
        assert got == ((1, 3, 1, 2, 0, 1), 4)
        client.rendezvous.publish_controller_endpoint(
            "127.0.0.1", port, "localhost", 41000, 4)
        assert client.rendezvous.fetch_controller_endpoint(
            "127.0.0.1", port, 4, timeout=2.0) == ("localhost", 41000)
        srv.init(plan, rendezvous_round=5)   # drops round 4's endpoint
        assert srv.get("controller", "endpoint.4") is None
    finally:
        srv.stop_server()


# ---- the port's driver notifies a reference worker ---------------------------


def test_the_ports_driver_notifies_a_reference_worker(monkeypatch):
    """A reference worker's notification service registers its addresses
    in the port's KV as the reference worker does (a pickled list); the
    port's driver reads them through its restricted unpickler and its
    ``HostsUpdatedRequest`` lands in the reference worker's mailbox."""
    import pickle

    from horovod_tpu.elastic.state import notification_mailbox
    from horovod_tpu.run.common.util import secret
    from horovod_tpu.run.elastic.worker import WorkerNotificationService
    from horovod_tpu_torch.run.elastic.worker import get_worker_client

    key = secret.make_secret_key()
    service = WorkerNotificationService(key)
    srv = PORT.server.RendezvousServer()
    port = srv.start_server()
    notification_mailbox.pending()          # empty it
    try:
        srv.put("workers", "h:0", pickle.dumps(service.addresses()))
        srv.put("workers", "h:1", pickle.dumps(service.addresses()))
        driver = PORT.driver.ElasticDriver(
            srv, PORT.discovery.FixedHosts({"h": 2}), min_np=1)
        for slot in (0, 1):
            driver._assignments[("h", slot)] = PORT.hosts.SlotInfo(
                "h", slot, slot, 0, 2, 2, 1)
        driver.set_notify_client_factory(
            lambda h, lr: get_worker_client("127.0.0.1", port, h, lr, key))
        driver._notify_survivors(exclude={("h", 0)})
        assert notification_mailbox.pending() == "update"
        assert get_worker_client("127.0.0.1", port, "h", 9, key) is None
        # A blob that names a class is refused, not unpickled.
        srv.put("workers", "h:2", pickle.dumps(types.SimpleNamespace()))
        with pytest.raises(pickle.UnpicklingError):
            get_worker_client("127.0.0.1", port, "h", 2, key)
        driver.stop()
    finally:
        srv.stop_server()
        service.shutdown()


# ---- the worker holds an update until the driver's plan moves ------------------


def test_a_host_update_waits_for_the_plan_to_move(monkeypatch):
    """The driver tells the workers before it writes the new round, and
    tells a failure's survivors again when the world they re-formed is
    already the new round's: an update raises ``HostsUpdatedInterrupt``
    at the first commit that finds a newer round (or none for this slot)
    in the KV, and one whose round never comes is dropped after the
    rejoin grace."""
    from horovod_tpu_torch.common import host_world
    from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt
    from horovod_tpu_torch.elastic import state as estate

    srv = PORT.server.RendezvousServer()
    port = srv.start_server()
    plan = PORT.hosts.get_host_assignments(
        PORT.hosts.parse_hosts("h:2"), 2)
    try:
        monkeypatch.setenv("HOROVOD_ELASTIC", "1")
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HOROVOD_HOSTNAME", "h")
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
        monkeypatch.setenv("HOROVOD_ELASTIC_REJOIN_GRACE", "30")
        monkeypatch.setattr(host_world, "_last_round", 3)
        srv.init(plan, rendezvous_round=3)
        state = estate.ObjectState(bcast_object=lambda o, root_rank=0: o,
                                   batch=0)
        estate.notification_mailbox.pending()
        estate.notification_mailbox.release()
        estate.notification_mailbox.post(1.0)
        state.commit()                      # round 3 is this worker's
        state.commit()
        assert estate.notification_mailbox.held_for() is not None
        srv.init(plan, rendezvous_round=4)  # the driver's next round
        with pytest.raises(HostsUpdatedInterrupt):
            state.commit()
        state.commit()                      # answered: nothing held
        assert estate.notification_mailbox.held_for() is None
        # A slot the new plan leaves out moves too.
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", "5")
        estate.notification_mailbox.post(2.0)
        with pytest.raises(HostsUpdatedInterrupt):
            state.commit()
        # No newer round within the grace: the update is dropped.
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
        monkeypatch.setattr(host_world, "_last_round", 4)
        monkeypatch.setenv("HOROVOD_ELASTIC_REJOIN_GRACE", "0")
        estate.notification_mailbox.post(3.0)
        state.commit()
        assert estate.notification_mailbox.held_for() is None
    finally:
        estate.notification_mailbox.release()
        srv.stop_server()


def test_a_worker_that_marked_its_exit_is_bounded_by_the_drain_grace(
        monkeypatch):
    """A worker's heartbeats stop when its interpreter finalizes, and its
    teardown goes on after that: silent, not hung. One that put its exit
    mark (``/exit``, at ``atexit``) is not evicted at the liveness timeout
    but past twice the drain grace, and the mark is retired with the slot;
    a worker silent without the mark is evicted at the timeout."""
    monkeypatch.setenv("HOROVOD_HEARTBEAT_MS", "100")
    clk = FakeClock()
    kv = FakeRendezvous()
    driver = port_driver.ElasticDriver(
        kv, port_discovery.FixedHosts({"h": 2}), min_np=1)
    from horovod_tpu_torch.common import liveness

    driver._liveness = liveness.LivenessTracker(
        heartbeat_ms=100, timeout_ms=2000, drain_grace_ms=5000, clock=clk)
    handles = {}
    for slot in (0, 1):
        driver._assignments[("h", slot)] = port_hosts.SlotInfo(
            hostname="h", rank=slot, local_rank=slot, cross_rank=0, size=2,
            local_size=2, cross_size=1)
        handles[slot] = driver._workers_active[("h", slot)] = \
            port_driver._WorkerHandle()
    kv.put("heartbeat", "h:0", b"1")
    kv.put("heartbeat", "h:1", b"1")
    driver._check_liveness()
    kv.put("exit", "h:0", b"1")
    evicted = []
    for _ in range(12):
        clk.t += 1.0
        driver._check_liveness()
        evicted.append((handles[0].evicted, handles[1].evicted))
    assert evicted[1] == (False, True)
    assert evicted[9] == (False, True) and evicted[10] == (True, True)
    driver._consume_drain_marker("h", 0)
    driver.stop()
    assert ("exit", "h:0") not in kv.kv and ("heartbeat", "h:0") not in kv.kv


def test_a_respawned_worker_enters_the_tracker_at_its_first_beat(
        monkeypatch):
    """A slot's worker dies and its replacement is spawned before a
    liveness pass sees the slot empty. The replacement, still starting,
    is not charged the dead worker's silence nor its last beat in the KV:
    it is not evicted before it beats, and once it has beaten, its own
    silence is bounded at the timeout as any worker's."""
    monkeypatch.setenv("HOROVOD_HEARTBEAT_MS", "100")
    clk = FakeClock()
    kv = FakeRendezvous()
    driver = port_driver.ElasticDriver(
        kv, port_discovery.FixedHosts({"h": 2}), min_np=1)
    from horovod_tpu_torch.common import liveness

    driver._liveness = liveness.LivenessTracker(
        heartbeat_ms=100, timeout_ms=2000, clock=clk)
    release = threading.Event()
    driver._create_worker_fn = _worker(release)
    slots = {}
    for slot in (0, 1):
        slots[slot] = driver._assignments[("h", slot)] = port_hosts.SlotInfo(
            hostname="h", rank=slot, local_rank=slot, cross_rank=0, size=2,
            local_size=2, cross_size=1)
        driver._workers_active[("h", slot)] = port_driver._WorkerHandle()
    for beat in (b"1", b"2"):
        kv.put("heartbeat", "h:0", beat)
        kv.put("heartbeat", "h:1", beat)
        driver._check_liveness()
        clk.t += 0.5
    kv.put("heartbeat", "h:1", b"3")      # the dead worker's last beat
    with driver._lock:                     # its exit, then the respawn
        driver._workers_active.pop(("h", 1))
        driver._spawn(slots[1])
        fresh = driver._workers_active[("h", 1)]
    evicted = []
    for i in range(12):
        clk.t += 0.5
        kv.put("heartbeat", "h:0", f"{i + 3}".encode())
        if i == 6:
            kv.put("heartbeat", "h:1", b"1")   # the replacement's first beat
        driver._check_liveness()
        evicted.append(fresh.evicted)
    release.set()
    driver.stop()
    # Never before its first beat (i = 6, 3.5 s after the respawn); at
    # the 2 s timeout after it (i = 10).
    assert evicted == [False] * 10 + [True] * 2, evicted
