"""A silent peer under the stall inspector, on the port's native core
(``horovod_tpu_torch/csrc/hvd``, through ``common/native.NativeCore``).

A SIGSTOPped rank keeps its connection to the coordinator open and sends
no frame. Without heartbeats the coordinator's gather polls the awaited
sockets while the stall inspector is on
(``TcpController::GatherWithStallChecks``), so the inspector runs every
check period while a frame is missing. Rank 1 stops itself after two
allreduces while the others wait in a third (``f.2``); no heartbeats,
a 0.5 s warning window:

- ``flat`` (2 ranks) and ``hier`` (4 ranks as 2 hosts x 2 under
  ``HOROVOD_HIER_CONTROL=1``; rank 1 is host 1's leader): with a 2 s
  shutdown window every waiting rank that the coordinator reaches (rank
  0, and in ``hier`` rank 2 of host 0 through the ctrl channel) sees its
  wait fail and ``world_lost()`` within ``STALL_BOUND_S`` of the stop,
  and the coordinator's stall report names rank 1 silent;
- ``idle`` (2 ranks): rank 0 submits nothing after the stop (as a rank
  whose card waits for a collective the stopped peer left half done):
  the silence alone ends the world, ``world_lost()`` within the bound;
- ``neither``: no shutdown window, so nothing ends the world within
  ``UNBOUNDED_CAP_S``, and the report still names rank 1 silent;
- ``slow``: rank 1 stopped for ``SLOW_S`` (under the window) and then
  continued: the world goes on, ``f.2`` completes on every rank and no
  rank reads ``world_lost()``.

Every process is killed before a test returns.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from proc_harness import free_port
from torch_worlds import REFUSE_JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STALL_WARNING_S = 0.5
STALL_SHUTDOWN_S = 2.0
# The shutdown window, the gather's check period (0.1 s) and slack for a
# loaded host.
STALL_BOUND_S = STALL_SHUTDOWN_S + 3.0
UNBOUNDED_CAP_S = 2 * STALL_BOUND_S
SLOW_S = 0.5

# case -> (ranks, hier control, shutdown window s)
CASES = {"flat": (2, False, STALL_SHUTDOWN_S),
         "hier": (4, True, STALL_SHUTDOWN_S),
         "idle": (2, False, STALL_SHUTDOWN_S),
         "neither": (2, False, 0.0),
         "slow": (2, False, STALL_SHUTDOWN_S)}

_WORKER = REFUSE_JAX + textwrap.dedent(f"""
    import json, os, signal, sys, time
    import numpy as np
    sys.path.insert(0, {REPO!r})
    from horovod_tpu_torch.common import native as hn

    rank, size, port, hier, shutdown_s, out, case = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        sys.argv[4] == "1", float(sys.argv[5]), sys.argv[6], sys.argv[7])
    if hier:
        os.environ["HOROVOD_HIER_CONTROL"] = "1"
    hosts = 2 if hier else 1
    core = hn.NativeCore()
    assert core.init(rank=rank, size=size, local_rank=rank // hosts,
                     local_size=size // hosts, cross_rank=rank % hosts,
                     cross_size=hosts, coordinator_addr="127.0.0.1",
                     coordinator_port=port, my_host="127.0.0.1",
                     cycle_time_ms=1.0, fusion_threshold=64 << 20,
                     cache_capacity=64,
                     stall_warning_sec={STALL_WARNING_S},
                     stall_shutdown_sec=shutdown_s, stall_check_enabled=True,
                     exec_callback=lambda r, i: core.response_done(
                         i, False, "host-plane only"))

    def allreduce(name):
        x = np.full(64, float(rank + 1), np.float32)
        h = core.enqueue(name, hn.OP_ALLREDUCE, 1, 7, x.shape,
                         data_ptr=x.ctypes.data, output_ptr=x.ctypes.data,
                         plane=hn.PLANE_HOST)
        return core.wait(h) if h >= 0 else (-1, "refused")

    for i in range(2):
        r, err = allreduce(f"f.{{i}}")
        assert r == 1, err
    if rank == 1:
        with open(os.path.join(out, "stop"), "w") as f:
            f.write(repr(time.time()))
        os.kill(os.getpid(), signal.SIGSTOP)
    if case == "idle":
        deadline = time.time() + 60.0
        while not core.world_lost() and time.time() < deadline:
            time.sleep(0.01)
        r, err = 0, "idle"
    else:
        r, err = allreduce("f.2")
    ended = time.time()
    deadline = time.time() + 1.0
    while r == 1 and not core.world_lost() and time.time() < deadline:
        time.sleep(0.01)
    with open(os.path.join(out, "stop")) as f:
        stop = float(f.read())
    report = core.stall_report() if rank == 0 else ""
    path = os.path.join(out, f"{{rank}}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({{"r": r, "err": err, "lost": core.world_lost(),
                   "seconds": ended - stop, "report": report}}, f)
    os.replace(path + ".tmp", path)
    core.shutdown()
    print(f"SILENT_{{rank}}_OK", flush=True)
""")


def _wait_file(path, timeout):
    deadline = time.time() + timeout
    while not path.exists():
        assert time.time() < deadline, f"no {path.name} within {timeout} s"
        time.sleep(0.02)


def run_case(tmp_path, case):
    """Start the case's world; returns ({rank: outcome}, {rank: log}) of
    the ranks that wrote one by the case's end. Every process still
    running, the stopped one included, is killed before it returns."""
    size, hier, shutdown_s = CASES[case]
    script = tmp_path / "silent.py"
    script.write_text(_WORKER)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(size), str(port),
         "1" if hier else "0", str(shutdown_s), str(tmp_path), case],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(size)]
    logs = {}
    try:
        _wait_file(tmp_path / "stop", 60)
        if case == "slow":
            time.sleep(SLOW_S)
            procs[1].send_signal(signal.SIGCONT)
            cap = 60
        elif case == "neither":
            cap = UNBOUNDED_CAP_S
        else:
            cap = 60
        # The ranks the coordinator reaches end (or, for "neither", the
        # cap passes); a member behind the stopped leader waits on it.
        reached = [0] if case == "neither" else \
            [r for r in range(size) if r != 1 and not (hier and r % 2)]
        if case == "slow":
            reached = list(range(size))
        deadline = time.time() + cap
        for r in reached:
            try:
                logs[r] = procs[r].communicate(
                    timeout=max(0.1, deadline - time.time()))[0]
            except subprocess.TimeoutExpired:
                pass
    finally:
        for r, p in enumerate(procs):
            if r in logs:
                continue
            if p.poll() is None:
                p.kill()
            logs[r] = p.communicate()[0]
    got = {r: json.loads((tmp_path / f"{r}.json").read_text())
           for r in range(size) if (tmp_path / f"{r}.json").exists()}
    return got, logs


@pytest.mark.parametrize("case", ["flat", "hier", "idle"])
def test_a_silent_peer_is_lost_within_the_stall_bound(tmp_path, case):
    size, hier, _ = CASES[case]
    got, logs = run_case(tmp_path, case)
    survivors = [r for r in range(size) if r != 1 and not (hier and r % 2)]
    for r in survivors:
        assert r in got, (r, logs)
        o = got[r]
        assert o["r"] != 1 and o["lost"], (r, o, logs[r])
        assert STALL_SHUTDOWN_S * 0.5 <= o["seconds"] <= STALL_BOUND_S, \
            (r, o, STALL_BOUND_S)
    # Rank 0's own f.2 may not have reached the inspector: the cycle
    # that would ingest it waits in the gather. The silence is named.
    report = got[0]["report"]
    assert "Silent ranks [1]" in report, report


def test_without_a_shutdown_window_a_silent_peer_is_only_reported(tmp_path):
    got, logs = run_case(tmp_path, "neither")
    assert not got, (got, logs)
    assert "Silent ranks [1]" in logs[0], logs[0]


def test_a_peer_stopped_under_the_window_is_not_lost(tmp_path):
    got, logs = run_case(tmp_path, "slow")
    assert sorted(got) == [0, 1], logs
    for r, o in got.items():
        assert o["r"] == 1 and not o["lost"], (r, o, logs[r])
