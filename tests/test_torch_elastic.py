"""Elastic training on the port (``horovod_tpu_torch.elastic``,
``horovod_tpu_torch.torch.elastic``, ``horovod_tpu_torch.run``), on the
CPU.

- ``TensorState``, case for case the ``JaxState`` tests of
  ``tests/test_elastic_jax_state.py``: restore places the snapshot on the
  world's device, commit then restore, sync broadcasts the host snapshot
  and the attributes in one message and commits them, sync pairs the live
  tree with the live attributes, restore defers placement while the world
  is down, save refuses a leaf sharded across processes (ZeRO-3's meta
  parameters, a tp shard), on_reset keeps a live tree, a custom
  placement.
- ``TorchState``: commit and restore with host snapshots, the optimizer's
  state included.
- The mailbox: a posted host update raises ``HostsUpdatedInterrupt`` at
  ``commit``, a posted drain ``PreemptionInterrupt``.
- The frames: the port reads a frame the reference's ``_send_frame``
  wrote with the reference's ``HostsUpdatedRequest`` (into the port's
  class), the reference reads the port's responses (into its own
  classes), and the port refuses a frame that names any other class.
- The retry loop at 2 ranks of a gloo world without a launcher: an
  ``xla.exec`` fault spec armed alike on both ranks at batch 2 of 6
  (voted, so both ranks raise) inside ``elastic.run`` with a
  ``TorchState``: both ranks restore the last commit, re-initialize on the
  same ports and finish with parameters bitwise those of an unfaulted
  run.
- The port's workers under the reference launcher (``python -m
  horovod_tpu.run``, elastic, a discovery script): a script that imports
  only ``horovod_tpu_torch.torch`` trains 6 committed batches on both
  ranks, with neither jax nor the JAX package loaded; a worker that dies
  at batch 3 is replaced after the blacklist cooldown and both ranks
  finish 8 batches; the hosts grow from 2 slots to 3 and shrink back,
  and the run finishes with rank 0 past every size.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import torch_worlds
from horovod_tpu_torch.common.exceptions import (HostsUpdatedInterrupt,
                                                 PreemptionInterrupt)
from horovod_tpu_torch.elastic import TensorState
from horovod_tpu_torch.elastic import state as estate
from horovod_tpu_torch.parallel.mesh import SHARD_ATTR

REPO = torch_worlds.REPO


@pytest.fixture
def thvd():
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _tree(scale=1.0):
    return {"w": torch.arange(8.0) * scale, "b": torch.ones(8) * scale}


def _scaled(tree, f):
    return {k: f(v) for k, v in tree.items()}


def _bcast_stub(obj, root_rank=0):
    return obj


# ---- TensorState --------------------------------------------------------------


def test_save_restore_replaces_on_device(thvd):
    state = TensorState(_tree(), bcast_object=_bcast_stub, batch=0)
    state.tree = _scaled(state.tree, lambda x: x * 10.0)
    state.batch = 5
    state.restore()
    assert torch.equal(state.tree["w"], torch.arange(8.0))
    assert state.batch == 0
    assert state.tree["w"].device == thvd.mpi_ops._state.device()


def test_commit_then_restore_keeps_committed_point(thvd):
    state = TensorState(_tree(), bcast_object=_bcast_stub, batch=0)
    state.tree = _scaled(state.tree, lambda x: x + 1.0)
    state.batch = 3
    state.commit()
    state.tree = _scaled(state.tree, lambda x: x * 100.0)
    state.batch = 9
    state.restore()
    assert torch.equal(state.tree["w"], torch.arange(8.0) + 1.0)
    assert state.batch == 3


def test_sync_replaces_and_resnapshots(thvd):
    seen = {}

    def bcast(obj, root_rank=0):
        seen.update(obj)
        return obj

    state = TensorState(_tree(), bcast_object=bcast, batch=7)
    live = state.tree["w"]
    state.sync()
    assert "tree" in seen and seen["batch"] == 7
    # The payload is a host copy, not the live tensor.
    assert seen["tree"]["w"].device.type == "cpu"
    assert seen["tree"]["w"] is not live
    state.tree = _scaled(state.tree, lambda x: x * 2.0)
    state.restore()
    assert torch.equal(state.tree["w"], torch.arange(8.0))


def test_sync_broadcasts_live_pair(thvd):
    seen = {}

    def bcast(obj, root_rank=0):
        seen.update(obj)
        return obj

    state = TensorState(_tree(), bcast_object=bcast, batch=0)
    state.commit()
    state.tree = _scaled(state.tree, lambda x: x + 5.0)
    state.batch = 9
    state.sync()
    assert seen["batch"] == 9
    assert torch.equal(seen["tree"]["w"], torch.arange(8.0) + 5.0)
    state.tree = _scaled(state.tree, lambda x: x * 0.0)
    state.batch = 1
    state.restore()
    assert state.batch == 9
    assert torch.equal(state.tree["w"], torch.arange(8.0) + 5.0)


def test_restore_defers_placement_when_world_is_dead(thvd):
    attempts = []

    def flaky_place(host_tree):
        attempts.append(True)
        if len(attempts) == 1:
            raise RuntimeError("device gone")
        return TensorState._to_device(host_tree)

    state = TensorState(_tree(), place=flaky_place,
                        bcast_object=_bcast_stub, batch=0)
    state.restore()
    assert state.tree is None
    state.on_reset()
    assert torch.equal(state.tree["w"], torch.arange(8.0))


def test_restore_defers_placement_while_the_world_is_lost(thvd):
    # A rank was lost (the watch marked the world lost): the default
    # placement defers to on_reset() instead of failing the restore.
    from horovod_tpu_torch.common import state as cstate

    state = TensorState(_tree(), bcast_object=_bcast_stub, batch=0)
    cstate.global_state().world_lost = True
    try:
        state.restore()
    finally:
        cstate.global_state().world_lost = False
    assert state.tree is None
    state.on_reset()
    assert torch.equal(state.tree["w"], torch.arange(8.0))


def test_restore_defers_placement_without_a_world():
    # No world at all (after a shutdown): the default placement defers.
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    state = TensorState(_tree(), bcast_object=_bcast_stub, batch=0)
    hvd.shutdown()
    state.restore()
    assert state.tree is None
    hvd.init(device="cpu")
    try:
        state.on_reset()
        assert torch.equal(state.tree["b"], torch.ones(8))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("leaf", ["meta", "tp_shard"])
def test_save_rejects_cross_process_sharded_leaves(thvd, leaf):
    state = TensorState(_tree(), bcast_object=_bcast_stub)
    if leaf == "meta":
        bad = torch.empty(8, device="meta")
    else:
        bad = torch.nn.Parameter(torch.ones(4))
        setattr(bad, SHARD_ATTR, "tp")
    state.tree = {"w": bad}
    with pytest.raises(NotImplementedError, match="CheckpointManager"):
        state.save()


def test_on_reset_preserves_live_tree(thvd):
    state = TensorState(_tree(), bcast_object=_bcast_stub, batch=0)
    state.commit()
    state.tree = _scaled(state.tree, lambda x: x + 3.0)
    state.batch = 4
    state.on_reset()
    assert torch.equal(state.tree["w"], torch.arange(8.0) + 3.0)
    assert state.batch == 4
    state.sync()
    state.tree = _scaled(state.tree, lambda x: x * 0.0)
    state.restore()
    assert torch.equal(state.tree["w"], torch.arange(8.0) + 3.0)


def test_custom_placement(thvd):
    calls = []

    def place(host_tree):
        calls.append(True)
        return {k: v.to(torch.float64) for k, v in host_tree.items()}

    state = TensorState(_tree(), place=place, bcast_object=_bcast_stub)
    state.restore()
    assert calls
    assert state.tree["w"].dtype == torch.float64


# ---- TorchState and the mailbox -------------------------------------------------


def test_torch_state_snapshots_to_host(thvd):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = thvd.elastic.TorchState(model=model, optimizer=opt, batch=1)
    saved = state._saved_optimizer_state["state"][0]["exp_avg"]
    assert saved.device.type == "cpu"
    assert saved is not opt.state[model.weight]["exp_avg"]
    weight = model.weight.detach().clone()
    exp_avg = opt.state[model.weight]["exp_avg"].clone()
    opt.step()
    state.batch = 2
    assert not torch.equal(model.weight, weight)
    state.restore()
    assert state.batch == 1
    assert torch.equal(model.weight, weight)
    assert torch.equal(opt.state[model.weight]["exp_avg"], exp_avg)


def test_mailbox_raises_at_commit(thvd):
    state = estate.ObjectState(bcast_object=_bcast_stub, batch=0)
    estate.notification_mailbox.post(1.0)
    with pytest.raises(HostsUpdatedInterrupt) as info:
        state.commit()
    assert not isinstance(info.value, PreemptionInterrupt)
    assert info.value.skip_sync is False
    state.commit()   # the mailbox is empty again
    estate.notification_mailbox.post(2.0)
    estate.notification_mailbox.post(drain=True)
    with pytest.raises(PreemptionInterrupt):
        state.commit()


def test_retry_loop_restores_and_reinitializes_on_failure():
    calls = {"reinit": 0, "fn": 0}
    state = estate.ObjectState(bcast_object=_bcast_stub, batch=0)

    def reinit():
        calls["reinit"] += 1

    def train(st):
        calls["fn"] += 1
        st.batch += 1
        if calls["fn"] == 1:
            from horovod_tpu_torch.common.exceptions import \
                HorovodInternalError
            raise HorovodInternalError("peer lost")
        return st.batch

    assert estate.retry_loop(train, reinit)(state) == 1
    assert calls == {"reinit": 1, "fn": 2}


# ---- the frames ------------------------------------------------------------------


def test_frames_cross_between_reference_and_port():
    from horovod_tpu.run.common.util import network as ref_net
    from horovod_tpu.run.elastic import worker as ref_worker
    from horovod_tpu_torch.run.common.util import network as net
    from horovod_tpu_torch.run.elastic import worker

    key = b"k" * 32
    a, b = socket.socketpair()
    with a, b:
        ref_net._send_frame(a, ref_worker.HostsUpdatedRequest(12.5), key)
        got = net._recv_frame(b, key)
        assert type(got) is worker.HostsUpdatedRequest
        assert got.timestamp == 12.5
        ref_net._send_frame(a, ref_net.PingRequest(), key)
        assert type(net._recv_frame(b, key)) is net.PingRequest
        # The port's responses read back as the reference's classes.
        net._send_frame(b, net.PingResponse("svc", "10.0.0.1"), key)
        resp = ref_net._recv_frame(a, key)
        assert type(resp) is ref_net.PingResponse
        assert (resp.service_name, resp.source_address) == ("svc",
                                                            "10.0.0.1")
        net._send_frame(b, net.AckResponse(), key)
        assert type(ref_net._recv_frame(a, key)) is ref_net.AckResponse
        # Any other class is refused, the reference's own included.
        ref_net._send_frame(a, ref_net.BasicClient.__new__(
            ref_net.BasicClient), key)
        with pytest.raises(Exception, match="not a wire class"):
            net._recv_frame(b, key)
        ref_net._send_frame(a, {"x": os.getcwd}, key)
        with pytest.raises(Exception, match="not a wire class"):
            net._recv_frame(b, key)
        # A frame under another key is refused before it is read.
        ref_net._send_frame(a, ref_net.PingRequest(), b"x" * 32)
        with pytest.raises(PermissionError):
            net._recv_frame(b, key)


def test_reference_driver_notifies_a_port_worker(monkeypatch):
    """The reference's notification client (the driver's side) pings the
    port's service and posts a host update into the port's mailbox."""
    import base64

    from horovod_tpu.run.elastic import worker as ref_worker
    from horovod_tpu_torch.run.elastic import worker

    key = os.urandom(32)
    monkeypatch.setenv("HOROVOD_SECRET_KEY", base64.b64encode(key).decode())
    manager = worker.WorkerNotificationManager()
    manager.init()
    try:
        client = ref_worker.WorkerNotificationClient(
            manager._service.addresses(), key)
        estate.notification_mailbox.pending()
        client.notify_hosts_updated(3.0)
        assert estate.notification_mailbox.pending() == "update"
    finally:
        manager.shutdown()


# ---- the retry loop in a world ------------------------------------------------------

RETRY_WORKER = r"""
import json, os, sys
import numpy as np
import torch
rank = int(os.environ["HOROVOD_RANK"])
spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
res = {}
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.common import faults
hvd.init(device="cpu")
torch.manual_seed(5)
model = torch.nn.Linear(6, 3)
opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)
X = torch.from_numpy(inp["X"])
failures = []

armed = []

@hvd.elastic.run
def train(state):
    while state.batch < 6:
        if state.batch == 2 and not armed:
            # Every rank arms the spec between the same two responses
            # (the point is voted); rank 1's first response after it
            # fails.
            hvd.barrier()
            os.environ["HOROVOD_FAULT_SPEC"] = spec["fault"]
            faults.refresh()
            armed.append(True)
        xb = X[state.batch * 4 + rank * 2:state.batch * 4 + rank * 2 + 2]
        opt.zero_grad()
        try:
            model(xb).square().sum().backward()
            opt.step()
        except Exception as e:
            failures.append((state.batch, type(e).__name__))
            raise
        state.batch += 1
        state.commit()
    return state.batch

res["batches"] = np.array(train(state))
res["failures"] = np.array(json.dumps(failures))
res["params"] = torch.cat([p.detach().flatten()
                           for p in model.parameters()]).numpy()
hvd.shutdown()
np.savez(sys.argv[3 + rank], **res)
"""


def test_retry_loop_under_a_voted_fault(tmp_path):
    inputs = {"X": np.random.RandomState(3).randn(24, 6).astype(np.float32)}
    worlds = {}
    for name, fault in (("faulted", "xla.exec:rank=1:step=0"),
                        ("clean", "")):
        d = tmp_path / name
        d.mkdir()
        worlds[name] = torch_worlds.launch(RETRY_WORKER, 2, d,
                                           {"fault": fault}, inputs)
    faulted = worlds["faulted"].results()
    clean = worlds["clean"].results()
    for r in range(2):
        assert int(faulted[r]["batches"]) == 6
        # The fault fails the step of batch 2 on both ranks.
        assert json.loads(str(faulted[r]["failures"])) == \
            [[2, "HorovodInternalError"]]
        assert json.loads(str(clean[r]["failures"])) == []
        np.testing.assert_array_equal(faulted[r]["params"],
                                      clean[r]["params"])
    np.testing.assert_array_equal(faulted[0]["params"],
                                  faulted[1]["params"])


# ---- under the reference launcher ---------------------------------------------------

_TRAIN = textwrap.dedent("""
    import os, sys, time
    import torch
    import horovod_tpu_torch.torch as hvd

    LOG = os.environ.get("CHURN_LOG")
    TARGET = int(os.environ.get("CHURN_TARGET", "6"))
    MARKER = os.environ.get("CHURN_DIE_MARKER")
    PAUSE = float(os.environ.get("CHURN_PAUSE", "0"))

    def log_line(text):
        if LOG:
            with open(LOG, "a") as f:
                f.write(text + "\\n")

    hvd.init(device="cpu")
    model = torch.nn.Linear(4, 1)
    # No broadcast before the loop: state.sync() brings a worker that
    # joins mid-job into line.
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < TARGET:
            x = torch.ones(2, 4) * (hvd.rank() + 1)
            loss = model(x).sum()
            opt.zero_grad()
            loss.backward()
            grad = hvd.allreduce(model.weight.grad, op=hvd.Average,
                                 name=f"grad.b{state.batch}")
            model.weight.grad.copy_(grad)
            opt.step()
            if MARKER and hvd.rank() == 1 and state.batch == 3 \\
                    and not os.path.exists(MARKER):
                open(MARKER, "w").close()
                os._exit(13)
            state.batch += 1
            log_line(f"BATCH {state.batch} RANK {hvd.rank()} "
                     f"SIZE {hvd.size()}")
            time.sleep(PAUSE)
            state.commit()
        return state.batch

    batches = train(state)
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu")]
    log_line(f"DONE RANK {hvd.rank()} BATCHES {batches}")
    print(f"ELASTIC_RANK_{hvd.rank()}_DONE_{batches}")
""")


class _Launcher:
    """``python -m horovod_tpu.run`` (elastic, a discovery script reading
    ``hosts.txt``) over ``_TRAIN``, its output in ``launcher.out``. On
    exit the launcher is interrupted and then killed if it still runs,
    and every worker it started (they run in sessions of their own) is
    killed: a failed test leaves no process behind."""

    def __init__(self, tmp_path, hosts, extra_args=(), extra_env=None):
        script = tmp_path / "train.py"
        script.write_text(_TRAIN)
        self.hosts = tmp_path / "hosts.txt"
        self.hosts.write_text(hosts)
        discover = tmp_path / "discover.sh"
        discover.write_text(f"#!/bin/sh\ncat {self.hosts}\n")
        discover.chmod(0o755)
        self._tag = f"HVD_PORT_ELASTIC_TEST={tmp_path}"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   HVD_PORT_ELASTIC_TEST=str(tmp_path), **(extra_env or {}))
        self.out = tmp_path / "launcher.out"
        self._out_f = open(self.out, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu.run", "-np", "2",
             "--min-np", "2", "--host-discovery-script", str(discover),
             "--cycle-time-ms", "1.0", *extra_args, sys.executable,
             str(script)], env=env, cwd=REPO, stdout=self._out_f,
            stderr=subprocess.STDOUT)

    def wait(self, timeout):
        self.proc.wait(timeout=timeout)
        return self.proc.returncode, self.out.read_text()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        needle = self._tag.encode()
        for entry in os.listdir("/proc"):
            if not entry.isdigit() or int(entry) == os.getpid():
                continue
            try:
                with open(f"/proc/{entry}/environ", "rb") as f:
                    if needle in f.read():
                        os.kill(int(entry), signal.SIGKILL)
            except OSError:
                pass
        self._out_f.close()


def test_port_workers_under_the_reference_launcher(tmp_path):
    with _Launcher(tmp_path, "localhost:2\n") as launcher:
        rc, out = launcher.wait(240)
    assert rc == 0, out
    assert "ELASTIC_RANK_0_DONE_6" in out
    assert "ELASTIC_RANK_1_DONE_6" in out


def test_port_worker_failure_recovery(tmp_path):
    log = tmp_path / "churn.log"
    marker = tmp_path / "died.once"
    with _Launcher(tmp_path, "localhost:2\n",
                   ("--blacklist-cooldown-range", "1", "3"),
                   {"CHURN_LOG": str(log), "CHURN_TARGET": "8",
                    "CHURN_DIE_MARKER": str(marker),
                    "CHURN_PAUSE": "0.25"}) as launcher:
        rc, out = launcher.wait(360)
    assert rc == 0, out
    assert marker.exists(), "the failure never fired"
    text = log.read_text()
    assert "DONE RANK 0 BATCHES 8" in text, text
    assert "DONE RANK 1 BATCHES 8" in text, text


def _wait_for(predicate, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.25)
    raise AssertionError(f"timed out waiting for {what}")


def _read(path):
    try:
        return path.read_text()
    except FileNotFoundError:
        return ""


def test_port_workers_scale_up_then_down(tmp_path):
    log = tmp_path / "churn.log"
    with _Launcher(tmp_path, "localhost:2\n", ("--max-np", "3"),
                   {"CHURN_LOG": str(log), "CHURN_TARGET": "24",
                    "CHURN_PAUSE": "0.25"}) as launcher:
        _wait_for(lambda: "BATCH 3" in _read(log), 120, "training")
        assert "SIZE 2" in _read(log)
        launcher.hosts.write_text("localhost:3\n")
        _wait_for(lambda: "SIZE 3" in _read(log), 120, "size 3")
        mark = len(_read(log))
        launcher.hosts.write_text("localhost:2\n")
        _wait_for(lambda: "SIZE 2" in _read(log)[mark:], 120, "size 2")
        rc, out = launcher.wait(180)
    assert rc == 0, out
    assert "ELASTIC_RANK_0_DONE_24" in out, out


def test_a_new_process_waits_past_an_ended_worlds_store(monkeypatch):
    """A process started in a lost rank's place may reach rank 0's old
    store while the aborted groups keep it alive: it waits there past
    the closed mark and joins rank 0's next store."""
    import gc
    import threading

    import torch.distributed as dist

    from horovod_tpu_torch.common import config, state as cstate

    port = config.free_port_pair()
    monkeypatch.setenv("HOROVOD_CONTROLLER_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(port))
    monkeypatch.setattr(cstate, "_last_token", None)
    old = dist.TCPStore("127.0.0.1", port, world_size=2, is_master=True,
                        wait_for_workers=False)
    old.set(cstate._TOKEN_KEY, cstate._CLOSED)
    got = {}
    joiner = threading.Thread(
        target=lambda: got.update(token=cstate._open_store(2, 1)[1]),
        daemon=True)
    joiner.start()
    time.sleep(1.0)
    assert joiner.is_alive() and not got
    del old
    gc.collect()
    new = dist.TCPStore("127.0.0.1", port, world_size=2, is_master=True,
                        wait_for_workers=False)
    new.set(cstate._TOKEN_KEY, "fresh")
    joiner.join(60)
    assert got == {"token": "fresh"}


def test_rank_zero_holds_its_worlds_ports(monkeypatch):
    """Rank 0 holds its world's store and controller ports: no socket of
    the host binds either without ``SO_REUSEADDR`` (so no ``connect()``
    takes one as its local port), the controller's listener binds beside
    the hold, a re-init opens the store on the same port, and a world on
    other ports lets the old pair go."""
    import errno
    import gc

    from horovod_tpu_torch.common import config, state as cstate

    def plain_bind(port):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError as e:
                return e.errno
            return 0

    monkeypatch.setattr(cstate, "_held_ports", {})
    monkeypatch.setenv("HOROVOD_CONTROLLER_ADDR", "127.0.0.1")
    try:
        port = config.free_port_pair()
        monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(port))
        store, _ = cstate._open_store(1, 0)
        assert plain_bind(port + 1) == errno.EADDRINUSE
        with socket.socket() as listener:
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(("", port + 1))
            listener.listen()
        del store
        gc.collect()
        store, _ = cstate._open_store(1, 0)
        del store
        gc.collect()
        assert plain_bind(port) == plain_bind(port + 1) == errno.EADDRINUSE
        other = config.free_port_pair()
        monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(other))
        store, _ = cstate._open_store(1, 0)
        assert sorted(cstate._held_ports) == [other, other + 1]
        assert plain_bind(port) == plain_bind(port + 1) == 0
        del store
    finally:
        cstate._hold_ports(())


def test_the_watch_reads_the_verdict_when_it_closes(monkeypatch):
    """A collective can raise on the core's own error before the watch's
    next read: closing the watch reads the verdict once more, so the lost
    world is aborted before ``shutdown`` tears its groups down."""
    from horovod_tpu_torch.common import state as cstate

    class Core:
        lost = False

        def world_lost(self):
            return self.lost

    monkeypatch.setattr(cstate, "WATCH_PERIOD_S", 60.0)
    calls = []
    core = Core()
    watch = cstate._CoreWatch(core, lambda: calls.append(1))
    core.lost = True
    watch.close()
    assert calls == [1]
    calls.clear()
    watch = cstate._CoreWatch(Core(), lambda: calls.append(1))
    watch.close()
    assert calls == []


def test_an_engine_whose_core_did_not_start_lets_the_store_go(monkeypatch):
    """The native core keeps the engine's callback for the life of the
    process, also when it did not start: the engine must not keep the
    world's groups (and their store's port), or the retry loop's next
    re-init finds the port taken."""
    import gc

    import torch.distributed as dist

    from horovod_tpu_torch.common import config, state as cstate
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops.eager import EagerEngine

    port = config.free_port_pair()
    monkeypatch.setenv("HOROVOD_CONTROLLER_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(port))
    squatter = socket.socket()     # the controller's port, taken
    squatter.bind(("127.0.0.1", port + 1))
    squatter.listen()
    # Rank 0 of two (the core listens; a local size that does not divide
    # the world makes no host groups), on a world of one process.
    st = cstate._GlobalState()
    st.device, st.size, st.rank = torch.device("cpu"), 2, 0
    st.local_size, st.cross_size = 3, 1
    st.config = config.RuntimeConfig.from_env()
    store = dist.TCPStore("127.0.0.1", port, world_size=1, is_master=True)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(HorovodInternalError, match="did not start"):
            EagerEngine(st)
    finally:
        dist.destroy_process_group()
        squatter.close()
    del store
    gc.collect()
    again = dist.TCPStore("127.0.0.1", port, world_size=1, is_master=True)
    del again
