"""Elastic jobs end to end under the port's launcher
(``python -m horovod_tpu_torch.run``), on the CPU.

- The three runs of ``tests/test_torch_elastic.py`` with the port's
  workers (``torch_worlds.ELASTIC_TRAIN``): 6 committed batches; a
  worker that dies at batch 3 replaced after the blacklist cooldown, both
  ranks finishing 8 batches; the hosts growing from 2 slots to 3 and
  shrinking back, rank 0 finishing past every size.
- The same 6-batch run with the JAX package's workers
  (``horovod_tpu.torch``): the port's driver serves them too.
- A worker that hangs (SIGSTOP, alive and silent) in three settings:
  - ``HOROVOD_HEARTBEAT_MS=100``, ``HOROVOD_LIVENESS_TIMEOUT_MS=2000``:
    the native core evicts the silent rank and the survivor raises
    ``HorovodInternalError`` within ``HANG_BOUND_S`` of the stop (the
    liveness timeout plus the abort), without waiting for the driver's
    SIGKILL; the driver evicts and respawns the slot and the job ends 0;
  - only the stall inspector (``HOROVOD_STALL_CHECK_TIME_SECONDS=1``,
    ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS=2``): the coordinator's gather
    polls while the stopped rank's request is missing, so the stall
    check runs and its shutdown window makes the verdict LOST; the
    survivor raises within ``STALL_BOUND_S`` of the stop (the window,
    the gather's check period and the abort). Without heartbeats the
    driver never evicts the stopped worker, so the job does not re-form;
  - neither: no raise within ``UNBOUNDED_CAP_S``.
  Each prints a ``HANG`` line with its seconds.
- Workers whose teardown outlasts the liveness timeout after their last
  batch (the interpreter's finalization stops the heartbeat thread; the
  rest of the exit goes on silent): with heartbeats armed the job ends 0
  and no worker is evicted, since each marks its exit in the KV first.

All runs start together when the module starts, and the scale run (which
drives its hosts from its test) comes first, so the file takes about as
long as its longest run.
"""

import json
import textwrap
import time

import pytest

import torch_worlds

HANG_TIMEOUT_MS = 2000
HANG_BOUND_S = HANG_TIMEOUT_MS / 1000 + 3.0
STALL_SHUTDOWN_S = 2
STALL_BOUND_S = STALL_SHUTDOWN_S + 3.0
UNBOUNDED_CAP_S = 10.0

# The JAX package's binding in place of the port's.
REFERENCE_TRAIN = torch_worlds.ELASTIC_TRAIN.replace(
    "import horovod_tpu_torch.torch as hvd", "import horovod_tpu.torch as hvd"
).replace('hvd.init(device="cpu")', "hvd.init()").replace(
    """assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu")]
""", "")

# A worker whose every batch ends in a named all-reduce; rank 1 SIGSTOPs
# itself after batch ``HANG_AT`` once (the marker stops its successor),
# and every event is a line of ``HANG_LOG`` with the time.
HANG_TRAIN = r"""
import os, signal, sys, time
import torch
import horovod_tpu_torch.torch as hvd

LOG, MARK = os.environ["HANG_LOG"], os.environ["HANG_MARK"]
TARGET, AT = int(os.environ["HANG_TARGET"]), int(os.environ["HANG_AT"])


def log_line(text):
    with open(LOG, "a") as f:
        f.write(f"{text} {time.time()!r}\n")


hvd.init(device="cpu")
model = torch.nn.Linear(4, 1)
opt = torch.optim.SGD(model.parameters(), lr=0.05)
state = hvd.elastic.TorchState(model=model, optimizer=opt, batch=0)


@hvd.elastic.run
def train(state):
    while state.batch < TARGET:
        try:
            loss = model(torch.ones(2, 4) * (hvd.rank() + 1)).sum()
            opt.zero_grad()
            loss.backward()
            grad = hvd.allreduce(model.weight.grad, op=hvd.Average,
                                 name=f"grad.b{state.batch}")
        except hvd.HorovodInternalError:
            log_line(f"RAISED {hvd.rank()}")
            raise
        model.weight.grad.copy_(grad)
        opt.step()
        state.batch += 1
        log_line(f"BATCH {state.batch} RANK {hvd.rank()} SIZE {hvd.size()}")
        time.sleep(0.1)
        state.commit()
        if hvd.rank() == 1 and state.batch == AT and \
                not os.path.exists(MARK):
            open(MARK, "w").close()
            log_line("STOPPING")
            os.kill(os.getpid(), signal.SIGSTOP)
    return state.batch


batches = train(state)
log_line(f"DONE {hvd.rank()} {batches}")
"""

# A worker that finishes a few batches and then spends ``LINGER_S`` in
# its teardown after the interpreter stopped its threads (a ``__del__``
# run while the main module is cleared), longer than the liveness
# timeout.
LINGER_S = HANG_TIMEOUT_MS / 1000 + 1.5
LINGER_TRAIN = torch_worlds.ELASTIC_TRAIN + textwrap.dedent(f"""

    class _Linger:
        def __del__(self, sleep=time.sleep):
            sleep({LINGER_S})


    _linger = _Linger()
""")

HANG_SETTINGS = {
    "heartbeat": {"HOROVOD_HEARTBEAT_MS": "100",
                  "HOROVOD_LIVENESS_TIMEOUT_MS": str(HANG_TIMEOUT_MS)},
    "stall": {"HOROVOD_STALL_CHECK_TIME_SECONDS": "1",
              "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": str(STALL_SHUTDOWN_S)},
    "neither": {},
}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    started = {}

    def start(name, hosts, args=(), env=None, script=None, log=True):
        tmp = tmp_path_factory.mktemp(name)
        env = dict(env or {})
        if log:
            env["CHURN_LOG"] = str(tmp / "churn.log")
        started[name] = (torch_worlds.ElasticLauncher(
            tmp, hosts, args, env, module="horovod_tpu_torch.run",
            script=script or torch_worlds.ELASTIC_TRAIN), tmp)

    try:
        start("six", "localhost:2\n", log=False)
        start("reference_workers", "localhost:2\n", log=False,
              script=REFERENCE_TRAIN)
        tmp = tmp_path_factory.mktemp("marker")
        start("failure", "localhost:2\n", ("--blacklist-cooldown-range",
                                           "1", "2"),
              {"CHURN_TARGET": "8", "CHURN_DIE_MARKER": str(tmp / "died"),
               "CHURN_PAUSE": "0.25"})
        for setting, env in HANG_SETTINGS.items():
            tmp = tmp_path_factory.mktemp(f"hang_{setting}_files")
            start(f"hang_{setting}", "localhost:1\n127.0.0.1:1\n",
                  ("--blacklist-cooldown-range", "1", "1"),
                  dict(env, HANG_LOG=str(tmp / "hang.log"),
                       HANG_MARK=str(tmp / "stopped"), HANG_TARGET="14",
                       HANG_AT="4"), script=HANG_TRAIN, log=False)
            started[f"hang_{setting}"] += (tmp / "hang.log",)
        start("linger", "localhost:1\n127.0.0.1:1\n",
              env=HANG_SETTINGS["heartbeat"], script=LINGER_TRAIN,
              log=False)
        yield started
    finally:
        for entry in started.values():
            entry[0].stop()


# First, so that the runs started with the module go on beside it.
def test_port_workers_scale_up_then_down_under_the_ports_launcher(tmp_path):
    log = tmp_path / "churn.log"
    with torch_worlds.ElasticLauncher(
            tmp_path, "localhost:2\n", ("--max-np", "3"),
            {"CHURN_LOG": str(log), "CHURN_TARGET": "24",
             "CHURN_PAUSE": "0.25"},
            module="horovod_tpu_torch.run") as launcher:
        torch_worlds.wait_for(lambda: "BATCH 3" in torch_worlds.read(log),
                              120, "training")
        assert "SIZE 2" in torch_worlds.read(log)
        launcher.hosts.write_text("localhost:3\n")
        torch_worlds.wait_for(lambda: "SIZE 3" in torch_worlds.read(log),
                              120, "size 3")
        mark = len(torch_worlds.read(log))
        launcher.hosts.write_text("localhost:2\n")
        torch_worlds.wait_for(
            lambda: "SIZE 2" in torch_worlds.read(log)[mark:], 120,
            "size 2")
        rc, out = launcher.wait(180)
    assert rc == 0, out
    assert "ELASTIC_RANK_0_DONE_24" in out, out


def test_port_workers_under_the_ports_launcher(runs):
    rc, out = runs["six"][0].wait(240)
    assert rc == 0, out
    assert "ELASTIC_RANK_0_DONE_6" in out
    assert "ELASTIC_RANK_1_DONE_6" in out


def test_the_ports_launcher_serves_the_reference_workers(runs):
    rc, out = runs["reference_workers"][0].wait(240)
    assert rc == 0, out
    assert "ELASTIC_RANK_0_DONE_6" in out
    assert "ELASTIC_RANK_1_DONE_6" in out


def test_port_worker_failure_recovery_under_the_ports_launcher(runs):
    launcher, tmp = runs["failure"]
    rc, out = launcher.wait(240)
    assert rc == 0, out
    assert "blacklisted (strike 1/3" in out, out
    text = (tmp / "churn.log").read_text()
    assert "DONE RANK 0 BATCHES 8" in text, text
    assert "DONE RANK 1 BATCHES 8" in text, text


def _events(log):
    """Each line of a hang log as (words, time)."""
    out = []
    for line in torch_worlds.read(log).splitlines():
        *words, t = line.split()
        out.append((words, float(t)))
    return out


def _stop_time(log, timeout=120):
    torch_worlds.wait_for(
        lambda: any(w == ["STOPPING"] for w, _ in _events(log)), timeout,
        "rank 1's SIGSTOP")
    return next(t for w, t in _events(log) if w == ["STOPPING"])


def test_a_hung_worker_is_evicted_within_the_bound(runs):
    launcher, _, log = runs["hang_heartbeat"]
    t_stop = _stop_time(log)
    rc, out = launcher.wait(240)
    events = _events(log)
    assert rc == 0, out
    raised = [t for w, t in events if w == ["RAISED", "0"]]
    assert raised, events
    stop_to_raise = raised[0] - t_stop
    # The first batch of the respawned rank 1 in the re-formed world.
    reformed = next(t for w, t in events if t > t_stop and
                    w[:1] == ["BATCH"] and w[3] == "1")
    print(f"HANG setting=heartbeat timeout_ms={HANG_TIMEOUT_MS} "
          f"stop_to_raise_s={stop_to_raise:.3f} "
          f"stop_to_reformed_s={reformed - t_stop:.3f}")
    assert HANG_TIMEOUT_MS / 1000 * 0.5 <= stop_to_raise <= HANG_BOUND_S, \
        json.dumps(events)
    assert "EVICTED after" in out and "EVICT rank=1" in out, out
    done = sorted(w for w, _ in events if w[:1] == ["DONE"])
    assert done == [["DONE", "0", "14"], ["DONE", "1", "14"]], events


def test_the_stall_inspector_bounds_a_hung_worker(runs):
    _, _, log = runs["hang_stall"]
    t_stop = _stop_time(log)
    torch_worlds.wait_for(
        lambda: any(w == ["RAISED", "0"] for w, _ in _events(log)),
        max(1.0, t_stop + 2 * STALL_BOUND_S - time.time()),
        "rank 0's raise")
    events = _events(log)
    stop_to_raise = next(t for w, t in events if w == ["RAISED", "0"]) - \
        t_stop
    print(f"HANG setting=stall shutdown_s={STALL_SHUTDOWN_S} "
          f"stop_to_raise_s={stop_to_raise:.3f}")
    assert STALL_SHUTDOWN_S * 0.5 <= stop_to_raise <= STALL_BOUND_S, \
        json.dumps(events)


@pytest.mark.parametrize("setting", ["neither"])
def test_without_heartbeats_nothing_bounds_a_hung_worker(runs, setting):
    launcher, _, log = runs[f"hang_{setting}"]
    t_stop = _stop_time(log)
    while time.time() < t_stop + UNBOUNDED_CAP_S:
        time.sleep(0.25)
    events = _events(log)
    print(f"HANG setting={setting} no raise within "
          f"{time.time() - t_stop:.1f} s of the stop")
    assert not [w for w, _ in events if w[:1] == ["RAISED"]], events
    assert launcher.proc.poll() is None


def test_a_finished_worker_whose_exit_outlasts_the_timeout_is_not_evicted(
        runs):
    rc, out = runs["linger"][0].wait(240)
    assert rc == 0, out
    assert "ELASTIC_RANK_0_DONE_6" in out and \
        "ELASTIC_RANK_1_DONE_6" in out, out
    assert "EVICTED" not in out and "blacklisted" not in out, out
