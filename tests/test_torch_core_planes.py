"""The data-plane and control-plane worlds of the port's native core
(``horovod_tpu_torch/csrc/hvd`` through ``horovod_tpu_torch.common``).

The JAX package's own worlds for its copy of the core are run on the
port's: each worker of ``tests/test_shm_transport.py``,
``test_stripe_transport.py``, ``test_hier_control.py`` and
``test_selfheal.py`` is taken as it is, its imports of
``horovod_tpu.common`` turned into ``horovod_tpu_torch.common`` and an
import hook in front that refuses ``jax`` and ``horovod_tpu``, so each
world is held to the reference test's closed forms and counters at its
sizes (8 ranks as 2 hosts x 4 for the acceptance worlds):

- shm: byte identity and counters, an attach failure falling back to
  TCP, strict mode's hard error, a killed rank leaving no segment;
- stripes: byte identity and counters, a connect failure falling back to
  one socket;
- hierarchical control: byte identity and the O(hosts) gather;
- self-heal: a cut cross leg healed in place (and, for the port,
  ``world_lost()`` false on every rank after it), a stale-epoch hello
  refused, and ``HOROVOD_LINK_RETRY_ATTEMPTS=0``, run on both packages'
  cores: every rank fails the collective, with the same error on the
  same ranks, and the port's ``world_lost()`` stays false (the cut is a
  data-plane failure the controller never sees).

Then the port's own LOST fan-out (``controller.cc``: the coordinator
answers a lost rank with LOST through the hosts' leaders): 8 ranks as 2
hosts x 4 under ``HOROVOD_HIER_CONTROL=1`` with heartbeats. A SIGKILLed
member or leader makes every survivor read ``world_lost()`` true within
the liveness bound; a rank that leaves by ``shutdown()`` leaves it false
everywhere.
"""

import json
import os
import re
import signal
import subprocess
import sys
import textwrap

import pytest

import test_hier_control as ref_hier
import test_selfheal as ref_heal
import test_shm_transport as ref_shm
import test_stripe_transport as ref_stripe
from proc_harness import free_port, run_world
from torch_worlds import REFUSE_JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_worker(text):
    """A reference worker on the port's core: its ``horovod_tpu.common``
    imports point at ``horovod_tpu_torch.common``, behind a hook that
    refuses ``jax`` and ``horovod_tpu``."""
    out = text.replace("from horovod_tpu.common",
                       "from horovod_tpu_torch.common")
    assert "horovod_tpu." not in out.replace("horovod_tpu_torch.", ""), out
    return REFUSE_JAX + out


def assert_no_segments():
    from conftest import tagged_shm_segments

    leaked = tagged_shm_segments(os.environ.get("HVD_TEST_WORLD_TAG", ""))
    assert not leaked, f"orphaned shm segments: {leaked}"


# ---- the reference's worlds on the port's core ------------------------------

# The heal world's ranks also read the port's verdict after the heal.
_HEAL_WORKER = ref_heal._HEAL_WORKER.replace(
    "core.shutdown()\nprint(f\"HEAL_",
    "assert not core.world_lost(), (rank, 'a healed cut lost the world')\n"
    "core.shutdown()\nprint(f\"HEAL_")
assert _HEAL_WORKER != ref_heal._HEAL_WORKER

# (reference worker, sentinel, ranks, timeout s, leaves shm segments to check)
WORLDS = {
    "shm_acceptance": (ref_shm._ACCEPTANCE_WORKER, "SHMACC", 8, 300, True),
    "shm_attach_failure": (ref_shm._ATTACH_FAULT_WORKER, "SHMAF", 4, 240,
                           True),
    "shm_strict": (ref_shm._STRICT_WORKER, "SHMST", 4, 240, True),
    "shm_killed_rank": (ref_shm._KILL_SWEEP_WORKER, "SHMKS", 4, 120, True),
    "stripe_acceptance": (ref_stripe._ACCEPTANCE_WORKER, "STRACC", 8, 600,
                          False),
    "stripe_connect_failure": (ref_stripe._CONNECT_FAULT_WORKER, "STRCF", 4,
                               240, False),
    "hier_control": (ref_hier._ACCEPTANCE_WORKER, "HCTL", 8, 300, False),
    "selfheal_cross_drop": (_HEAL_WORKER, "HEAL", 8, 300, False),
    "selfheal_stale_epoch": (ref_heal._FENCE_WORKER, "FENCE", 2, 240, False),
}


# The stripe acceptance world's mid-world renegotiation (4 -> 1 -> 4
# stripes) fails on both packages' cores when several 8-rank worlds share
# the host ("horovod_tpu runtime has been shut down" at ``sync.s1``;
# ROADMAP.md section C): slow, so that tier-1's parallel workers do not
# crowd it. The reference's own copy stays where it is.
UNSTEADY = {"stripe_acceptance"}


@pytest.mark.parametrize("world", [
    pytest.param(w, marks=pytest.mark.slow) if w in UNSTEADY else w
    for w in sorted(WORLDS)])
def test_reference_world_on_the_ports_core(tmp_path, world):
    text, sentinel, size, timeout, shm = WORLDS[world]
    run_world(tmp_path, port_worker(text), sentinel, size=size,
              timeout=timeout)
    if shm:
        assert_no_segments()


# ---- the retry-disabled cut, on both cores ----------------------------------

# Each rank also writes what its collective returned, and on the port
# what world_lost() read, to <dir>/<rank>.json.
_ESCALATE_WORKER = ref_heal._ESCALATE_WORKER.replace(
    "r, err = core.wait(h)\n",
    "r, err = core.wait(h)\n"
    "import json\n"
    "lost = core.world_lost() if hasattr(core, 'world_lost') else None\n"
    "with open(os.path.join(sys.argv[3], f'{rank}.json'), 'w') as f:\n"
    "    json.dump({'r': r, 'err': err, 'lost': lost}, f)\n", 1)
assert _ESCALATE_WORKER != ref_heal._ESCALATE_WORKER


def error_class(err):
    """An error's text without its numbers (ranks, ports, byte counts)."""
    return re.sub(r"\d+", "#", err)


def test_retry_disabled_cut_fails_as_on_the_jax_packages_core(tmp_path):
    """``HOROVOD_LINK_RETRY_ATTEMPTS=0`` and a cut cross leg: the same
    worker on both packages' cores. Every rank's collective fails on
    both, with the same error (numbers aside) on the same ranks; the
    port's ``world_lost()`` reads false on every rank: the cut is a
    data-plane failure (``AbortLocalWaiters``), not a lost rank, so the
    binding's watch aborts nothing and the error reaches the caller as
    the collective's own."""
    outcomes = {}
    for name, text in (("jax", _ESCALATE_WORKER),
                       ("port", port_worker(_ESCALATE_WORKER))):
        out = tmp_path / name
        out.mkdir()
        run_world(out, text, "ESC", size=4, timeout=240,
                  args_for_rank=lambda rank, port: [port, out])
        outcomes[name] = [json.loads((out / f"{r}.json").read_text())
                          for r in range(4)]
    jax, port = outcomes["jax"], outcomes["port"]
    assert [o["r"] != 1 for o in jax] == [True] * 4, jax
    assert [(o["r"], error_class(o["err"])) for o in port] == \
        [(o["r"], error_class(o["err"])) for o in jax], (port, jax)
    assert [o["lost"] for o in port] == [False] * 4, port
    assert [o["lost"] for o in jax] == [None] * 4, jax


# ---- the port's LOST fan-out through the hosts' leaders ---------------------

# 8 ranks = 2 hosts x 4 local, round-robin placement (host(r) = r % 2):
# leaders 0 and 1, host 0 = {0, 2, 4, 6}, host 1 = {1, 3, 5, 7}.
SIZE, HOSTS, LOCAL = 8, 2, 4
HEARTBEAT_MS, LIVENESS_TIMEOUT_MS = 20, 1500
# Seconds from the victim's end to every survivor's verdict: the
# liveness timeout and slack for eight processes on a loaded host.
LOST_BOUND_S = LIVENESS_TIMEOUT_MS / 1000 + 5.0
# mode -> (victim rank, how it leaves)
FANOUT = {"member_killed": (2, "kill"), "leader_killed": (1, "kill"),
          "member_leaves": (2, "shutdown")}

_FANOUT_WORKER = REFUSE_JAX + textwrap.dedent(f"""
    import json, os, signal, sys, time
    import numpy as np
    os.environ["HOROVOD_HIER_CONTROL"] = "1"
    os.environ.setdefault("HVD_JOIN_TIMEOUT_MS", "300000")
    sys.path.insert(0, {REPO!r})
    from horovod_tpu_torch.common import native as hn

    rank, port, victim, how, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4],
                                    sys.argv[5])
    SIZE, HOSTS, LOCAL = {SIZE}, {HOSTS}, {LOCAL}
    core = hn.NativeCore()
    assert core.init(rank=rank, size=SIZE, local_rank=rank // HOSTS,
                     local_size=LOCAL, cross_rank=rank % HOSTS,
                     cross_size=HOSTS, coordinator_addr="127.0.0.1",
                     coordinator_port=port, my_host="127.0.0.1",
                     cycle_time_ms=1.0, fusion_threshold=64 << 20,
                     cache_capacity=64, stall_warning_sec=60.0,
                     stall_shutdown_sec=0.0, stall_check_enabled=True,
                     exec_callback=lambda r, i: core.response_done(
                         i, False, "host-plane only"),
                     heartbeat_ms={HEARTBEAT_MS},
                     liveness_timeout_ms={LIVENESS_TIMEOUT_MS})

    def allreduce(name):
        x = np.full(64, float(rank + 1), np.float32)
        h = core.enqueue(name, hn.OP_ALLREDUCE, 1, 7, x.shape,
                         data_ptr=x.ctypes.data, output_ptr=x.ctypes.data,
                         plane=hn.PLANE_HOST)
        return (core.wait(h) if h >= 0 else (-1, "refused")), x

    for i in range(2):
        (r, err), x = allreduce(f"f.{{i}}")
        assert r == 1, err
        assert np.all(x == SIZE * (SIZE + 1) / 2), x
    if rank == victim:
        with open(os.path.join(out, "end"), "w") as f:
            f.write(repr(time.time()))
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        core.shutdown()
        print(f"FANOUT_{{rank}}_OK")
        sys.exit(0)
    (r, err), _ = allreduce("f.2")
    want = how == "kill"
    deadline = time.time() + 30.0
    while core.world_lost() != want and time.time() < deadline:
        time.sleep(0.005)
    seen = time.time()
    lost = core.world_lost()
    if not want:
        time.sleep(0.5)
        lost = lost or core.world_lost()
    with open(os.path.join(out, "end")) as f:
        end = float(f.read())
    with open(os.path.join(out, f"{{rank}}.json"), "w") as f:
        json.dump({{"r": r, "err": err, "lost": lost,
                   "seconds": seen - end}}, f)
    core.shutdown()
    print(f"FANOUT_{{rank}}_OK")
""")


def run_fanout(tmp_path, victim, how, timeout=120):
    """Start the 8 ranks; returns each survivor's outcome. The victim
    ends by SIGKILL (rc -9) or exits 0 after ``shutdown``; every other
    rank exits 0. Every process is stopped before it returns."""
    script = tmp_path / "fanout.py"
    script.write_text(_FANOUT_WORKER)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(victim), how,
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(SIZE)]
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=timeout)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        want = -signal.SIGKILL if (r == victim and how == "kill") else 0
        assert p.returncode == want, f"rank {r} exited {p.returncode}:\n" \
                                     f"{logs.get(r, '')}"
        if want == 0:
            assert f"FANOUT_{r}_OK" in logs[r], logs[r]
    return {r: json.loads((tmp_path / f"{r}.json").read_text())
            for r in range(SIZE) if r != victim}


@pytest.mark.parametrize("mode", sorted(FANOUT))
def test_lost_fans_out_through_the_leaders(tmp_path, mode):
    victim, how = FANOUT[mode]
    got = run_fanout(tmp_path, victim, how)
    for r, o in got.items():
        assert o["r"] != 1, (r, o)        # the world ended under f.2
    if how == "kill":
        late = {r: o for r, o in got.items()
                if not o["lost"] or o["seconds"] > LOST_BOUND_S}
        assert not late, (late, LOST_BOUND_S)
    else:
        assert not any(o["lost"] for o in got.values()), got
