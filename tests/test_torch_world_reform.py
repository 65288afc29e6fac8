"""The re-formed world after a lost one (``common/state.py``): it does not
wait for the lost world's groups to be torn down.

- A stand-in lost group whose teardown takes 60 s (an aborted NCCL
  group's destructor once waited 59.4 s for torch's threads on an H100)
  does not hold the re-init: ``reinitialize`` returns within
  ``TEARDOWN_BOUND_S``, the group is torn down on a thread of its own, and
  past the bound the log names it, and names it again at exit.
- In a world of two, rank 0's store listens on its port again while the
  old world's default group is still alive: the groups hold a client of
  their own, and ``shutdown`` closes the server. The old group, held by
  the caller, is torn down once the caller lets it go. A rank that hangs
  there has its Python stacks dumped (faulthandler on SIGUSR1) into the
  failure, beside both ranks' output.

Each case runs in processes of its own: it changes torch's tables.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from horovod_tpu_torch.common.config import free_port_pair
from proc_harness import REPO
from torch_worlds import REFUSE_JAX

_SLOW_TEARDOWN = REFUSE_JAX + textwrap.dedent("""
    import json, sys, threading, time
    sys.path.insert(0, sys.argv[1])
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    from horovod_tpu_torch.common import state

    state.TEARDOWN_BOUND_S = 1.0

    class StandIn:
        # A lost group as the abort and the teardown see it; its
        # destructor waits as an aborted NCCL group's once did.
        group_desc = "stand-in"

        def abort(self):
            pass

        def __del__(self):
            print("TEARDOWN_STARTED " + threading.current_thread().name,
                  flush=True)
            time.sleep(60.0)

    class LostCore:
        def world_lost(self):
            return True

    state.init(device="cpu")
    pg = StandIn()
    c10d._world.pg_map[pg] = ("stand-in-backend", None)
    c10d._world.pg_names[pg] = "slow_teardown"
    del pg
    # The native core's verdict, read by the binding's watch.
    state.global_state().watch = state._CoreWatch(LostCore(),
                                                  state._on_world_lost)
    while not state.global_state().aborted.is_set():
        time.sleep(0.001)
    t0 = time.monotonic()
    state.reinitialize()
    reinit = time.monotonic() - t0
    t = torch.ones(4)
    dist.all_reduce(t)
    time.sleep(state.TEARDOWN_BOUND_S + 0.5)
    print("RESULT " + json.dumps({
        "reinit_s": reinit, "sum": t.tolist(),
        "teardown": state.teardown_report()}), flush=True)
""")

_OLD_GROUP_ALIVE = REFUSE_JAX + textwrap.dedent("""
    import faulthandler, json, os, signal, sys, time
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    sys.path.insert(0, sys.argv[1])
    import torch
    import torch.distributed as dist
    from horovod_tpu_torch.common import state

    state.TEARDOWN_BOUND_S = 1.0
    state.init(device="cpu")
    old = dist.group.WORLD       # the caller keeps the old default group
    state._on_world_lost()
    t0 = time.monotonic()
    error = None
    try:
        state.reinitialize()
        t = torch.full((4,), float(state.rank() + 1))
        dist.all_reduce(t)
        total = t.tolist()
    except Exception as e:       # the re-init on the same port failed
        error, total = repr(e), None
    reinit = time.monotonic() - t0
    time.sleep(state.TEARDOWN_BOUND_S + 0.5)
    held = state.teardown_report()
    del old
    deadline = time.monotonic() + 10.0
    while any(a["seconds"] is None for a in state.teardown_report()) and \\
            time.monotonic() < deadline:
        time.sleep(0.05)
    print("RESULT " + json.dumps({
        "error": error, "sum": total, "reinit_s": reinit, "held": held,
        "released": state.teardown_report()}), flush=True)
    if error is None:
        state.shutdown()
""")


def _fail_with_stacks(procs):
    """A rank ran past its time: dump the Python stacks of every rank still
    running (SIGUSR1, which the case's faulthandler answers), then fail
    with each rank's exit code and the ends of its output."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGUSR1)
    time.sleep(2.0)
    for p in procs:
        if p.poll() is None:
            p.kill()
    report = []
    for rank, p in enumerate(procs):
        out, err = p.communicate()
        report.append(f"rank {rank} (exit {p.returncode}):\n{out[-3000:]}\n"
                      f"{err[-12000:]}")
    pytest.fail("a rank did not finish within 150 s\n" + "\n".join(report))


def _result(out):
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_a_slow_lost_group_teardown_does_not_hold_the_reinit(tmp_path):
    script = tmp_path / "case.py"
    script.write_text(_SLOW_TEARDOWN)
    r = subprocess.run([sys.executable, str(script), REPO],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    got, log = _result(r.stdout), r.stderr
    assert got["reinit_s"] < 5.0, got
    assert got["sum"] == [1.0] * 4, got
    assert "TEARDOWN_STARTED hvd-teardown-slow_teardown" in r.stdout
    report = {a["name"]: a for a in got["teardown"]}
    assert report["slow_teardown"]["seconds"] is None, report
    assert all(isinstance(a["seconds"], float) for n, a in report.items()
               if n != "slow_teardown"), report
    label = "'slow_teardown' (ranks [], stand-in-backend, stand-in)"
    assert (f"the teardown of lost group {label} did not end within 1.0 s "
            "(thread 0x") in log, log
    assert ("exiting with the teardown of lost groups still out: "
            f"{label}") in log, log


def test_the_new_store_listens_while_the_old_group_is_alive(tmp_path):
    script = tmp_path / "case.py"
    script.write_text(_OLD_GROUP_ALIVE)
    port = free_port_pair()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), REPO], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    except subprocess.TimeoutExpired:
        _fail_with_stacks(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    got = [_result(out) for out, _ in outs]
    for g, (_, err) in zip(got, outs):
        assert g["error"] is None, (g, err)
        assert g["sum"] == [3.0] * 4, g
        # The old world's default group was still alive at the re-init,
        # and held outside torch's tables until the caller let it go.
        held = [a for a in g["held"] if a["seconds"] is None]
        assert [a["ranks"] for a in held] == [[0, 1]], g
        assert "is still held outside torch's tables after 1.0 s" in err
        assert all(isinstance(a["seconds"], float) for a in g["released"])


def test_elastic_nccl_settings_hold_only_in_an_elastic_init(monkeypatch):
    """``TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC`` (torch's watchdog waits that
    long for a dump after it sees a dead peer's error itself, and a lost
    group's destructor waits for the watchdog) joins the other elastic
    settings: set under ``HOROVOD_ELASTIC`` for NCCL groups only, while
    ``init`` makes them, a value the caller set kept."""
    from horovod_tpu_torch.common import state

    keys = ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "TORCH_NCCL_DUMP_ON_TIMEOUT",
            "TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC")
    assert set(state.ELASTIC_NCCL_ENV) == set(keys)
    assert state.ELASTIC_NCCL_ENV["TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC"] \
        == "100"
    for k in keys:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("HOROVOD_ELASTIC", raising=False)
    for backend in ("nccl", "gloo"):
        with state._nccl_error_handling(backend):
            assert not any(k in os.environ for k in keys)
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    with state._nccl_error_handling("gloo"):
        assert not any(k in os.environ for k in keys)
    monkeypatch.setenv("TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC", "7")
    with state._nccl_error_handling("nccl"):
        assert os.environ["TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC"] == "7"
        assert os.environ["TORCH_NCCL_DUMP_ON_TIMEOUT"] == "0"
        assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "0"
    assert os.environ["TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC"] == "7"
    assert "TORCH_NCCL_DUMP_ON_TIMEOUT" not in os.environ
    monkeypatch.delenv("TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC")
    with state._nccl_error_handling("nccl"):
        assert os.environ["TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC"] == "100"
    assert not any(k in os.environ for k in keys)
