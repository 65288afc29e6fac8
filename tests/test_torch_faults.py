"""The port's fault plane (``common/faults.py`` and the fault-spec grammar
of ``common/config.py``) against the JAX package's on the same inputs.

Single-process: ``parse_fault_spec`` and ``parse_chaos_spec`` give equal
specs and equal errors on a table of valid and invalid strings; the
catalog is equal; a spec fires on the same (rank, hit) calls with the same
kinds; the ``Retrier``'s schedules (backoff, ``call``, ``poll``) are equal
under a fixed seed and a fake clock; the retry policy reads the same env.
Then the port's own seams in one 2-rank gloo world: ``xla.exec`` fired on
rank 1 at its third response, ``zero.gather`` at its second stage-3 step
and ``checkpoint.write`` at the first save raise ``HorovodInternalError``
on both ranks (the collective seams are voted, so no rank is left in a
collective its peer skipped), and the calls around them complete.
Tolerance: exact (specs, schedules and outcomes).
"""

import dataclasses
import os

import numpy as np
import pytest

from horovod_tpu.common import config as jcfg
from horovod_tpu.common import faults as jfaults
from horovod_tpu_torch.common import config as tcfg
from horovod_tpu_torch.common import faults as tfaults

import torch_worlds


@pytest.fixture(autouse=True)
def _clean_fault_env(monkeypatch):
    for name in ("HOROVOD_FAULT_SPEC", "HOROVOD_CHAOS_SPEC"):
        monkeypatch.delenv(name, raising=False)
    jfaults.refresh()
    tfaults.refresh()
    yield
    for name in ("HOROVOD_FAULT_SPEC", "HOROVOD_CHAOS_SPEC"):
        os.environ.pop(name, None)
    jfaults.refresh()
    tfaults.refresh()


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", [dataclasses.astuple(s) for s in fn(*args, **kwargs)])
    except ValueError as e:
        return ("error", str(e))


VALID = [
    "ring.exec:rank=1:step=3:kind=exit",
    "host_world.enqueue; rendezvous.poll:kind=delay_ms:ms=5",
    "xla.exec:rank=1:step=2:kind=raise",
    "zero.gather:kind=drop_conn:times=2",
    "checkpoint.write:step=0:times=3:code=7",
    " ring.exec : rank = 0 ; ; custom.point:step=1",
    "",
]
INVALID = [
    "ring.exec:kind=explode",
    "ring.exec:rank=x",
    "ring.exec:foo=1",
    "ring.exec:rank",
    ":rank=1",
    "ring.exec:ms=fast",
]


@pytest.mark.parametrize("text", VALID + INVALID)
def test_parse_fault_spec_matches_reference(text):
    assert _outcome(tcfg.parse_fault_spec, text) == \
        _outcome(jcfg.parse_fault_spec, text)


@pytest.mark.parametrize("text", [
    "seed=42,n=5",
    "seed=7,n=8,kinds=drop_conn|delay_ms|raise,steps=0-8,ms=20",
    "seed=1,n=3,points=xla.exec|ring.exec,ranks=0|1,code=9",
    "n=3", "seed=1,n=-1", "seed=1,n=2,kinds=nope", "seed=1,n=2,steps=5",
    "seed=1,n=2,steps=4-2", "seed=1,n=2,bogus=1", "seed=1,n=2,oops",
])
def test_parse_chaos_spec_matches_reference(text):
    assert _outcome(tcfg.parse_chaos_spec, text, size=4) == \
        _outcome(jcfg.parse_chaos_spec, text, size=4)


def test_catalog_and_kinds_match_reference():
    assert tfaults.CATALOG == jfaults.CATALOG
    assert tcfg.FAULT_KINDS == jcfg.FAULT_KINDS


def _fired(faults, monkeypatch, spec, calls):
    """The outcome of each (point, rank) call under ``spec``."""
    slept = []
    monkeypatch.setattr(faults, "_sleep", slept.append)
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", spec)
    faults.refresh()
    seen = []
    for name, rank in calls:
        before = len(slept)
        try:
            faults.point(name, rank=rank)
            seen.append("delay" if len(slept) > before else "-")
        except ConnectionResetError:
            seen.append("drop_conn")
        except faults.FaultInjected:
            seen.append("raise")
    return seen, slept, dict(faults._hits)


@pytest.mark.parametrize("spec", [
    "ring.exec:rank=1:step=3",
    "ring.exec:step=2:times=2; host_world.enqueue:rank=0:kind=delay_ms:ms=7",
    "xla.exec:kind=drop_conn:times=3",
    "zero.gather:rank=0:kind=delay_ms:ms=3; zero.gather:rank=1:step=4",
])
def test_firing_sequence_matches_reference(monkeypatch, spec):
    calls = [(name, rank) for _ in range(6)
             for name in ("ring.exec", "host_world.enqueue", "xla.exec",
                          "zero.gather")
             for rank in (0, 1)]
    assert _fired(tfaults, monkeypatch, spec, calls) == \
        _fired(jfaults, monkeypatch, spec, calls)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _schedules(faults, cfg):
    """Backoffs, a failing call's sleeps and a poll's sleeps, under a fake
    clock, for jittered and unjittered policies and two ranks."""
    out = []
    for jitter in (True, False):
        for rank in (0, 3):
            policy = cfg.RetryPolicy(max_attempts=6, base_delay=0.5,
                                     max_delay=4.0, multiplier=3.0,
                                     deadline=30.0, jitter=jitter)
            clock = _FakeClock()
            retries = []
            r = faults.Retrier(policy, "kv.read", clock=clock,
                               sleep=clock.sleep, rank=rank,
                               on_retry=lambda *a: retries.append(a[:2]))
            backoffs = [r.backoff(a) for a in range(6)]
            clock = _FakeClock()
            r = faults.Retrier(policy, "kv.read", clock=clock,
                               sleep=clock.sleep, rank=rank,
                               on_retry=lambda *a: retries.append(a[:2]))
            attempts = []

            def flaky():
                attempts.append(clock.t)
                if len(attempts) < 4:
                    raise OSError("not yet")
                return "value"

            got = r.call(flaky, retry_on=(OSError,))
            clock = _FakeClock()
            r = faults.Retrier(policy, "poll.site", clock=clock,
                               sleep=clock.sleep, rank=rank)
            polls = []
            try:
                r.poll(lambda: polls.append(clock.t))
                exhausted = None
            except faults.RetryExhausted as e:
                exhausted = str(e)
            out.append((backoffs, attempts, got, retries, polls, exhausted))
    return out


def test_retrier_schedules_match_reference():
    assert _schedules(tfaults, tcfg) == _schedules(jfaults, jcfg)


def test_retry_policy_env_matches_reference(monkeypatch):
    monkeypatch.setenv("HOROVOD_RETRY_MAX_ATTEMPTS", "9")
    monkeypatch.setenv("HOROVOD_RETRY_KV_BASE_DELAY", "0.125")
    monkeypatch.setenv("HOROVOD_RETRY_DEADLINE", "bad")
    for scope, pinned in (("KV", ()), ("kv", ("max_attempts",)),
                          ("", ()), ("other.scope", ("deadline",))):
        assert dataclasses.astuple(tcfg.retry_policy_from_env(
            scope, pinned=pinned, deadline=5.0)) == dataclasses.astuple(
            jcfg.retry_policy_from_env(scope, pinned=pinned, deadline=5.0))


def test_voted_point_raises_where_any_rank_fired(monkeypatch):
    votes = []

    def vote_with(peer_ok):
        def vote(ok):
            votes.append(ok)
            return ok and peer_ok
        return vote

    tfaults.voted_point("xla.exec", vote_with(False), rank=0)
    assert votes == []                       # nothing armed: no vote
    monkeypatch.setenv("HOROVOD_FAULT_SPEC", "xla.exec:rank=1:step=1")
    tfaults.refresh()
    tfaults.voted_point("xla.exec", vote_with(True), rank=0)   # hit 0
    with pytest.raises(tfaults.FaultInjected, match="on another rank"):
        tfaults.voted_point("xla.exec", vote_with(False), rank=0)
    assert votes == [True, True]
    tfaults.refresh()                         # now as rank 1
    tfaults.voted_point("xla.exec", vote_with(True), rank=1)   # hit 0
    with pytest.raises(tfaults.FaultInjected, match="rank=1 hit=1"):
        tfaults.voted_point("xla.exec", vote_with(True), rank=1)
    assert votes[2:] == [True, False]


WORKER = torch_worlds.WORLD_PRELUDE + r"""
import functools
import horovod_tpu_torch as hvd
from horovod_tpu_torch import zero
from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.image_bench import ZeroMLP

hvd.init(device="cpu")


def armed(spec, calls):
    hvd.barrier()
    os.environ["HOROVOD_FAULT_SPEC"] = spec
    faults.refresh()
    seen = []
    for i, call in enumerate(calls):
        try:
            call(i)
            seen.append(0)
        except hvd.HorovodInternalError:
            seen.append(1)
    hvd.barrier()
    os.environ.pop("HOROVOD_FAULT_SPEC")
    faults.refresh()
    return np.array(seen)


def allreduce(i):
    got = hvd.allreduce(torch.full((4,), rank + 1.0), name=f"f.{i}",
                        op=hvd.Sum)
    assert torch.equal(got, torch.full((4,), 3.0)), got


res["xla_exec"] = armed("xla.exec:rank=1:step=2:kind=raise", [allreduce] * 4)
model = ZeroMLP(hidden=16, layers=1, device="cpu")
state = zero.init_zero_train_state(
    model, functools.partial(torch.optim.SGD, lr=0.1), zero_stage=3,
    compression="none")
step = zero.make_zero_train_step()
g = torch.Generator().manual_seed(rank)
x, y = torch.randn(4, 16, generator=g), torch.arange(4) % 16
res["zero_gather"] = armed("zero.gather:rank=1:step=1:kind=raise",
                           [lambda i: step(state, x, y)] * 3)
mgr = CheckpointManager(spec["ckpt"])
res["checkpoint"] = armed("checkpoint.write:step=0",
                          [lambda i: mgr.save(i, {"w": torch.ones(2)})] * 2)
res["steps"] = np.array(mgr.all_steps())
res["injected"] = np.array(hvd.metrics()["python"]["faults.injected"])
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


def test_fault_seams_raise_on_every_rank(tmp_path):
    world = torch_worlds.launch(WORKER, 2, tmp_path,
                                {"ckpt": str(tmp_path / "ckpt")},
                                {"unused": np.zeros(1)})
    for r, res in enumerate(world.results()):
        assert res["xla_exec"].tolist() == [0, 0, 1, 0], r
        assert res["zero_gather"].tolist() == [0, 1, 0], r
        assert res["checkpoint"].tolist() == [1, 0], r
        assert res["steps"].tolist() == [1], r
        # Rank 1 fired xla.exec and zero.gather; both fired the save.
        assert int(res["injected"]) == (3 if r == 1 else 1), r
