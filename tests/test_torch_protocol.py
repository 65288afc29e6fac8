"""Protocol conformance of the port's native core (``tools/hvdmc``).

- Negotiation ticks (``set_record_negotiation``/``drain_negotiation``)
  from a real 3-rank world of the port's core replay through
  ``check_negotiation_ticks``: in a plain world every group fires with
  all three ranks; in a chaos world where rank 2 dies, every group before
  the death does, and the one in flight stays partial (it never fired).
- The port's ``common/liveness.py`` tracker trace replays against
  ``LivenessMachine``; the ``allow_evict_recover`` mutation rejects it.
- A model of the port's LOST verdict (``controller.cc``: the coordinator
  answers a death with the LOST terminal frame and a departure with
  SHUTDOWN; a member whose leader dies ends on its own verdict): the
  negotiation models of ``tools/hvdmc`` (unchanged) with a ``leave``
  action beside ``die`` and the terminal frame each rank ended on. Its
  safety rule: a survivor ends on LOST if and only if a rank died, flat
  and through the hosts' leaders. Explored exhaustively at 2 and 3 ranks
  (and 2 hosts x 2) with one death or one leave; the reference's
  behaviour, SHUTDOWN after a death (the ``shutdown_after_death``
  mutation), is caught with a counterexample.
"""

import os
import signal
import sys
import textwrap
from collections import namedtuple

import pytest

from proc_harness import REPO, run_world

sys.path.insert(0, REPO)

from tools.hvdmc import trace as mtrace  # noqa: E402
from tools.hvdmc.mc import explore  # noqa: E402
from tools.hvdmc.models.negotiation import (SHUTDOWN, Frame,  # noqa: E402
                                            NegotiationModel, World)
from tools.hvdmc.models.negotiation_hier import Frame as HierFrame  # noqa: E402,E501
from tools.hvdmc.models.negotiation_hier import HierNegotiationModel  # noqa: E402,E501
from tools.hvdmc.models.negotiation_hier import World as HierWorld  # noqa: E402,E501
from torch_worlds import REFUSE_JAX  # noqa: E402

# ---- real traces of the port's core -----------------------------------------

_TICKS_WORKER = REFUSE_JAX + textwrap.dedent("""
    import os, signal, sys
    import numpy as np
    sys.path.insert(0, os.environ["HVD_REPO"])
    from horovod_tpu_torch.common import native as hn

    rank, port, chaos, trace_path = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3] == "chaos", sys.argv[4])
    core = hn.NativeCore()
    assert core.init(rank=rank, size=3, local_rank=0, local_size=1,
                     cross_rank=rank, cross_size=3,
                     coordinator_addr="127.0.0.1", coordinator_port=port,
                     my_host="127.0.0.1", cycle_time_ms=1.0,
                     fusion_threshold=64 << 20, cache_capacity=64,
                     stall_warning_sec=60.0, stall_shutdown_sec=0.0,
                     stall_check_enabled=True,
                     exec_callback=lambda r, i: core.response_done(
                         i, False, "host plane only"))
    core.set_record_negotiation(True)
    # nt.x twice (the second a response-cache hit), nt.y and nt.z once;
    # in the chaos world rank 2 dies before nt.z and nt.z is aborted.
    for name in ("nt.x", "nt.y", "nt.x", "nt.z"):
        if chaos and name == "nt.z" and rank == 2:
            print("NTRACE_2_OK", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        a = np.full(8, float(rank + 1), np.float32)
        h = core.enqueue(name, hn.OP_ALLREDUCE, 1, 7, a.shape,
                         data_ptr=a.ctypes.data, output_ptr=a.ctypes.data,
                         plane=hn.PLANE_HOST)
        r, err = core.wait(h)
        if chaos and name == "nt.z":
            assert r != 1 and core.world_lost(), (r, err)
        else:
            assert r == 1, err
            assert np.allclose(a, 6.0), a[:4]
    if rank == 0:
        with open(trace_path, "w") as f:
            for tick_rank, ns, name in core.drain_negotiation():
                f.write(f"{tick_rank} {ns} {name}\\n")
    core.shutdown()
    print(f"NTRACE_{rank}_OK")
""")


def read_ticks(path):
    ticks = []
    for line in path.read_text().splitlines():
        rank_s, ns_s, name = line.split(" ", 2)
        ticks.append((int(rank_s), int(ns_s), name))
    return ticks


def run_ticks_world(tmp_path, mode):
    trace = tmp_path / "ticks.txt"
    if mode == "chaos":
        # Rank 2 is SIGKILLed on purpose: run_world counts its -9 as a
        # failure, so the world runs here with the same launch.
        import subprocess

        from proc_harness import free_port

        script = tmp_path / "worker.py"
        script.write_text(_TICKS_WORKER)
        port = free_port()
        env = dict(os.environ, HVD_REPO=REPO)
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(port), mode,
             str(trace)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(3)]
        try:
            outs = [p.communicate(timeout=120)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        assert codes == [0, 0, -signal.SIGKILL], (codes, outs)
        for r, out in enumerate(outs):
            assert f"NTRACE_{r}_OK" in out, out
    else:
        run_world(tmp_path, _TICKS_WORKER, "NTRACE", size=3, timeout=120,
                  args_for_rank=lambda rank, port: [port, mode, trace])
    return read_ticks(trace)


def test_negotiation_ticks_of_a_plain_world_conform(tmp_path):
    ticks = run_ticks_world(tmp_path, "plain")
    # 4 rounds x 3 ranks = 12 submissions -> 4 fired groups.
    assert mtrace.check_negotiation_ticks(ticks, world_size=3) == 4, ticks


def test_negotiation_ticks_of_a_chaos_world_conform(tmp_path):
    ticks = run_ticks_world(tmp_path, "chaos")
    before = [t for t in ticks if t[2] != "nt.z"]
    assert mtrace.check_negotiation_ticks(before, world_size=3) == 3, ticks
    # The round in flight at the death: the survivors' submissions only,
    # once each, and the checker sees it never fired.
    aborted = sorted(t[0] for t in ticks if t[2] == "nt.z")
    assert set(aborted) <= {0, 1} and len(aborted) == len(set(aborted))
    if aborted:
        with pytest.raises(mtrace.ConformanceError, match="partial"):
            mtrace.check_negotiation_ticks(ticks, world_size=3)


def tracker_trace():
    """A fake-clock run of the port's ``LivenessTracker``: miss, suspect,
    recover, a bounded drain, and an eviction."""
    from horovod_tpu_torch.common import liveness as tl

    t = [0.0]
    tr = tl.LivenessTracker(heartbeat_ms=100, timeout_ms=1000,
                            drain_grace_ms=500, clock=lambda: t[0])
    events = []
    tr.watch("w0")
    tr.watch("w1")
    t[0] = 0.3
    events += tr.check()            # w0, w1 MISS
    t[0] = 0.6
    events += tr.check()            # SUSPECT both
    ev = tr.beat("w0")              # RECOVER w0
    assert ev is not None
    events.append(ev)
    tr.mark_draining("w0")
    events.append(tl.LivenessEvent(mtrace.DRAIN_BEGIN, "w0", 0.0))
    t[0] = 1.2
    events += tr.check()            # EVICT w1 (w0 DRAINING exempt)
    tr.mark_drained("w0")
    events.append(tl.LivenessEvent(mtrace.DRAIN_DONE, "w0", 0.0))
    assert tr.beat("w1") is None    # no event after an eviction
    return mtrace.tracker_events(events)


def test_liveness_tracker_trace_replays_against_the_machine():
    events = tracker_trace()
    assert ("EVICT", "w1") in events and ("RECOVER", "w0") in events
    final = mtrace.LivenessMachine().replay(events)
    assert final == {"w0": mtrace.DRAINED, "w1": mtrace.EVICTED}


def test_a_mutated_machine_rejects_the_tracker_trace():
    with pytest.raises(mtrace.ConformanceError, match="terminal"):
        mtrace.LivenessMachine(
            mutations=("allow_evict_recover",)).replay(tracker_trace())


# ---- a model of the LOST verdict --------------------------------------------

LOST = "LOST"
LostWorld = namedtuple("LostWorld", World._fields + ("leaving", "terminal"))
LostHierWorld = namedtuple("LostHierWorld",
                           HierWorld._fields + ("leaving", "terminal"))


def _set(t, i, v):
    return t[:i] + (v,) + t[i + 1:]


class _Verdict:
    """What both models add: ``leave`` (a rank's farewell, the departure
    the coordinator answers with SHUTDOWN), the terminal frame each rank
    ended on, and the safety rule on it. ``shutdown_after_death`` answers
    a death with SHUTDOWN too, as the JAX package's core does."""

    def _verdict(self, s):
        died = any(r not in s.leaving for r in s.departed)
        if "shutdown_after_death" in self.mutations:
            return SHUTDOWN
        return LOST if died else SHUTDOWN

    def _ended_on(self, s, r, word):
        return s._replace(terminal=_set(s.terminal, r, word))

    def safety(self, s):
        out = super().safety(s)
        died = any(not rk.alive for rk in s.ranks)
        for r, word in enumerate(s.terminal):
            if word is not None and (word == LOST) != died:
                out.append(f"rank {r} ended on {word} though "
                           + ("a rank died" if died else "no rank died"))
        return out


class LostNegotiationModel(_Verdict, NegotiationModel):
    """The flat negotiation model with the port's terminal frames."""

    def __init__(self, ranks=2, tensors=("a", "b"), steps=1, deaths=0,
                 leaves=0, mutations=()):
        super().__init__(ranks=ranks, tensors=tensors, steps=steps,
                         deaths=deaths, mutations=mutations)
        self.leaves = leaves
        self.name = self.name.replace("negotiation(", "negotiation_lost(") \
            .replace(f"deaths={deaths}", f"deaths={deaths}, leaves={leaves}")

    def initial(self):
        return LostWorld(*super().initial(), leaving=(),
                         terminal=(None,) * self.n)

    def actions(self, s):
        acts = super().actions(s)
        if s.world_ended or len(s.leaving) >= self.leaves:
            return acts
        for r in range(1, self.n):
            rk = s.ranks[r]
            if rk.alive and not rk.ended and not rk.awaiting and \
                    s.inbox[r - 1] is None:
                acts.append((f"leave({r})", self._leave(s, r)))
        return acts

    def _leave(self, s, r):
        # The farewell: one last (empty) frame with the shutdown flag;
        # the rank's loop ends.
        return s._replace(
            ranks=_set(s.ranks, r, s.ranks[r]._replace(ended=True)),
            inbox=_set(s.inbox, r - 1, Frame(full=(), hits=())),
            leaving=tuple(sorted(s.leaving + (r,))))

    def _deliver(self, s, r):
        s2 = super()._deliver(s, r)
        if r in s.leaving:
            s2 = s2._replace(departed=tuple(sorted(s2.departed + (r,))))
        return s2

    def _respond(self, s):
        s2 = super()._respond(s)
        if not s2.world_ended:
            return s2
        word = self._verdict(s)
        s2 = s2._replace(resp=tuple(word if p == SHUTDOWN else p
                                    for p in s2.resp))
        return self._ended_on(s2, 0, word)

    def _recv(self, s, r):
        word = s.resp[r - 1]
        if word not in (LOST, SHUTDOWN):
            return super()._recv(s, r)
        s2 = super()._recv(s._replace(resp=_set(s.resp, r - 1, SHUTDOWN)),
                           r)
        return self._ended_on(s2, r, word)


class LostHierNegotiationModel(_Verdict, HierNegotiationModel):
    """The hierarchical model with the port's terminal frames: LOST or
    SHUTDOWN fans out through the leaders, and a member whose leader
    died ends on LOST (``LEADER_LOST``). Only members leave."""

    def __init__(self, hosts=2, members=2, tensors=("a",), steps=1,
                 deaths=0, leaves=0, mutations=()):
        super().__init__(hosts=hosts, members=members, tensors=tensors,
                         steps=steps, deaths=deaths, mutations=mutations)
        self.leaves = leaves
        self.name = self.name.replace("negotiation_hier(",
                                      "negotiation_hier_lost(") \
            .replace(f"deaths={deaths}", f"deaths={deaths}, leaves={leaves}")

    def initial(self):
        return LostHierWorld(*super().initial(), leaving=(),
                             terminal=(None,) * self.n)

    def actions(self, s):
        acts = super().actions(s)
        if s.world_ended or len(s.leaving) >= self.leaves:
            return acts
        for r in range(self.n):
            rk = s.ranks[r]
            if not self._is_leader(r) and rk.alive and not rk.ended and \
                    not rk.awaiting and s.mframes[r] is None:
                acts.append((f"leave({r})", self._leave(s, r)))
        return acts

    def _leave(self, s, r):
        return s._replace(
            ranks=_set(s.ranks, r, s.ranks[r]._replace(ended=True)),
            mframes=_set(s.mframes, r, HierFrame(full=(), hits=())),
            leaving=tuple(sorted(s.leaving + (r,))))

    def _deliver(self, s, m):
        s2 = super()._deliver(s, m)
        if m in s.leaving:
            s2 = s2._replace(departed=tuple(sorted(s2.departed + (m,))))
        return s2

    def _respond(self, s):
        s2 = super()._respond(s)
        if not s2.world_ended:
            return s2
        word = self._verdict(s)
        s2 = s2._replace(
            fanout=tuple(word if p == SHUTDOWN else p for p in s2.fanout),
            resp=tuple(word if p == SHUTDOWN else p for p in s2.resp))
        return self._ended_on(s2, 0, word)

    def _leader_recv(self, s, h):
        word = s.fanout[h]
        if word not in (LOST, SHUTDOWN):
            return super()._leader_recv(s, h)
        s2 = super()._leader_recv(
            s._replace(fanout=_set(s.fanout, h, SHUTDOWN)), h)
        relayed = [m for m in self._members_of(h) if m not in s.departed]
        resp = s2.resp
        for m in relayed:
            resp = _set(resp, m, word)
        return self._ended_on(s2._replace(resp=resp), self._leader(h), word)

    def _recv(self, s, r):
        word = s.resp[r]
        if word not in (LOST, SHUTDOWN):
            return super()._recv(s, r)
        s2 = super()._recv(s._replace(resp=_set(s.resp, r, SHUTDOWN)), r)
        return self._ended_on(s2, r, word)

    def _leader_lost(self, s, r):
        return self._ended_on(super()._leader_lost(s, r), r, LOST)


def _explored(model):
    res = explore(model)
    assert res.complete, f"{model.name}: exploration must exhaust the graph"
    assert res.ok, "\n".join(v.render() for v in res.violations)
    return res


def _terminals(model):
    """The terminal words the exploration's quiescent states end on."""
    seen = set()
    init = model.initial()
    stack, visited = [init], {init}
    while stack:
        s = stack.pop()
        if model.is_quiescent(s):
            seen.update(w for w in s.terminal if w is not None)
        for _, nxt in model.actions(s):
            if nxt not in visited:
                visited.add(nxt)
                stack.append(nxt)
    return seen


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("event", ["death", "leave"])
def test_lost_verdict_flat_exhaustive(ranks, event):
    deaths, leaves = (1, 0) if event == "death" else (0, 1)
    model = LostNegotiationModel(ranks=ranks, deaths=deaths, leaves=leaves)
    res = _explored(model)
    assert res.quiescent_states > 0
    # Both outcomes of the event are reachable: the world ends on it.
    assert _terminals(model) == {LOST if event == "death" else SHUTDOWN}


@pytest.mark.parametrize("hosts,members,event", [
    (2, 1, "death"), (3, 1, "death"), (2, 2, "death"), (2, 2, "leave")])
def test_lost_verdict_through_the_leaders_exhaustive(hosts, members, event):
    deaths, leaves = (1, 0) if event == "death" else (0, 1)
    model = LostHierNegotiationModel(hosts=hosts, members=members,
                                     deaths=deaths, leaves=leaves)
    _explored(model)
    assert _terminals(model) == {LOST if event == "death" else SHUTDOWN}


@pytest.mark.parametrize("model", [
    LostNegotiationModel(ranks=2, deaths=1,
                         mutations=("shutdown_after_death",)),
    LostHierNegotiationModel(hosts=2, members=2, deaths=1,
                             mutations=("shutdown_after_death",))],
    ids=["flat", "hier"])
def test_shutdown_after_a_death_is_caught(model):
    res = explore(model)
    bad = [v for v in res.violations if v.kind == "safety"
           and "ended on SHUTDOWN though a rank died" in v.message]
    assert bad, res.render()
    assert any(label.startswith("die(") for label in bad[0].schedule), \
        bad[0].render()


def test_a_death_in_a_departures_cycle_ends_on_shutdown():
    """An open fault of the LOST verdict (ROADMAP.md, section C), kept
    visible: a rank whose frame the coordinator already gathered dies in
    the cycle in which another rank leaves. The coordinator ends the
    world on the departure it saw, with SHUTDOWN, and the survivors'
    bindings abort nothing for the dead rank."""
    res = explore(LostNegotiationModel(ranks=3, deaths=1, leaves=1))
    assert res.complete
    bad = [v for v in res.violations
           if "ended on SHUTDOWN though a rank died" in v.message]
    assert bad, res.render()
    assert bad[0].schedule == ("send(1)", "die(1)", "deliver(1)",
                               "leave(2)", "deliver(2)", "respond"), \
        bad[0].render()
