"""The binding's abort of a lost world (``common/state._on_world_lost``),
with stand-in groups beside a real gloo world of one.

- A stand-in whose ``abort()`` never returns holds ``check_world`` no
  longer than ``ABORT_GROUP_BOUND_S`` (it raises ``HorovodInternalError``
  within ``ABORT_WAIT_S`` of the verdict); the log names that group, its
  backend and description, and the Python stacks are dumped once.
- A stand-in whose abort returns at once: the raise comes at once, and
  every group's abort seconds are in the log and in ``abort_report()``.
- Either way the groups leave torch's tables without a second abort
  (torch's one call for every group aborts each again): a stand-in
  counts its aborts. The raise does not wait for them to leave: a
  registry that takes 3 s to let go (an aborted NCCL group's destructor
  took 59.4 s there once) is logged, and the raise comes at once.

Each case runs in a process of its own: it changes torch's tables.
"""

import json
import re
import subprocess
import sys
import textwrap

import pytest

from proc_harness import REPO
from torch_worlds import REFUSE_JAX

_CASE = REFUSE_JAX + textwrap.dedent("""
    import json, sys, threading, time
    sys.path.insert(0, sys.argv[1])
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    from horovod_tpu_torch.common import state
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    class StandIn:
        # A group as the abort sees it: abort() and group_desc.
        def __init__(self, blocks):
            self.group_desc = "stand-in"
            self.release = threading.Event()
            self.blocks = blocks
            self.aborts = 0

        def abort(self):
            self.aborts += 1
            if self.blocks:
                self.release.wait()

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    if sys.argv[2] == "slow_forget":
        # A destructor that waits, as an aborted NCCL group's once did
        # when its last reference left torch's registry.
        unregister = c10d._unregister_all_process_groups
        c10d._unregister_all_process_groups = lambda: (time.sleep(3.0),
                                                       unregister())
    pg = StandIn(blocks=sys.argv[2] == "blocks")
    c10d._world.pg_map[pg] = ("stand-in-backend", None)
    c10d._world.pg_names[pg] = "stuck_or_quick"
    t0 = time.monotonic()
    # As the watch does: the abort on a thread, the caller in check_world.
    threading.Thread(target=state._on_world_lost, daemon=True).start()
    while not state.global_state().world_lost:
        time.sleep(0.001)
    try:
        state.check_world()
        raise AssertionError("check_world did not raise")
    except HorovodInternalError:
        raised = time.monotonic() - t0
    time.sleep(0.2 if sys.argv[2] != "slow_forget" else 3.5)
    print("RESULT " + json.dumps({
        "raised_s": raised, "report": state.abort_report(),
        "initialized": dist.is_initialized(),
        "tables": len(c10d._world.pg_map), "aborts": pg.aborts}), flush=True)
    pg.release.set()
""")


def run_case(tmp_path, mode):
    script = tmp_path / "case.py"
    script.write_text(_CASE)
    r = subprocess.run([sys.executable, str(script), REPO, mode],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):]), r.stderr


def test_a_group_whose_abort_never_returns_holds_the_raise_to_the_bound(
        tmp_path):
    from horovod_tpu_torch.common.state import (ABORT_GROUP_BOUND_S,
                                                ABORT_WAIT_S)

    assert ABORT_WAIT_S < 30.0       # chip_smoke (k)'s KILL_BOUND_S
    got, log = run_case(tmp_path, "blocks")
    assert ABORT_GROUP_BOUND_S <= got["raised_s"] < ABORT_WAIT_S, got
    assert ("the abort of group 'stuck_or_quick' (ranks [], "
            "stand-in-backend, stand-in) did not return within "
            f"{ABORT_GROUP_BOUND_S} s") in log, log
    assert "'stuck_or_quick' (ranks [], stand-in-backend, stand-in) " \
        "still out" in log
    # The stacks, dumped once, hold the stuck abort's thread, waiting in
    # the stand-in's abort.
    ident = int(re.search(r"\(thread (0x[0-9a-f]+)\)", log).group(1), 16)
    assert log.count("Current thread") == 1, log
    stack = log.split(f"Thread {ident:#018x} (most recent call first):")[1]
    assert "in abort" in stack.split("\n\n")[0], log
    report = {a["name"]: a for a in got["report"]}
    assert report["stuck_or_quick"]["seconds"] is None, report
    others = [a for a in got["report"] if a["name"] != "stuck_or_quick"]
    assert others and all(a["seconds"] is not None for a in others), others
    assert all(a["backend"] == "gloo" and a["ranks"] == [0]
               for a in others), others
    # The groups left torch's tables without a second abort.
    assert not got["initialized"] and got["tables"] == 0, got
    assert got["aborts"] == 1, got


def test_aborts_that_return_raise_at_once_with_their_times(tmp_path):
    got, log = run_case(tmp_path, "returns")
    assert got["raised_s"] < 1.0, got
    assert all(isinstance(a["seconds"], float) for a in got["report"]), got
    assert {a["name"] for a in got["report"]} >= {"stuck_or_quick"}, got
    assert "the world's aborts: " in log and "did not return" not in log
    assert "Thread 0x" not in log, log
    assert not got["initialized"] and got["tables"] == 0, got
    assert got["aborts"] == 1, got


def test_the_raise_does_not_wait_for_the_groups_to_leave_torchs_tables(
        tmp_path):
    got, log = run_case(tmp_path, "slow_forget")
    assert got["raised_s"] < 1.0, got
    assert "dropping the lost world's groups: the registry took 3." in log
    assert not got["initialized"] and got["tables"] == 0, got
    assert got["aborts"] == 1, got


@pytest.mark.parametrize("seconds", [0.0123, None])
def test_abort_report_reads_the_log(monkeypatch, seconds):
    from horovod_tpu_torch.common import state

    rec = {"name": "g", "backend": "nccl", "desc": "d", "ranks": [0, 2],
           "start": 1.0, "end": None if seconds is None else 1.0 + seconds}
    monkeypatch.setattr(state, "_abort_log", [rec])
    got = state.abort_report()
    assert got == [{"name": "g", "backend": "nccl", "desc": "d",
                    "ranks": [0, 2], "seconds": seconds if seconds is None
                    else pytest.approx(seconds)}]
