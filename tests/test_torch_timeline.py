"""The port's timeline (``common/timeline.py``) against the JAX package's.

The same event sequence (spans, per-rank ticks, instants, counters, cycle
marks) written by both writers gives the same Chrome JSON up to the
timestamps, the process id and the execution activity's name, which the
port takes from the backend (``NCCL_*`` on the card, ``GLOO_*`` on the
CPU) where the JAX package wrote ``XLA_*`` (``REFERENCE_NAMES``). Every
other name is the reference's.

Then the eager plane in one 2-rank gloo world with ``HOROVOD_TIMELINE`` on
rank 0, against the JAX package's engine on the same op sequence: per
tensor, ``NEGOTIATE_<KIND>`` then the execution activity, each begun and
ended once, in the same order; the port's trace also holds the
coordinator's ``RANK_READY[r]`` tick of each rank inside each
negotiation, and every span is balanced.
"""

import json

import numpy as np
import pytest

from horovod_tpu.common import timeline as jtl
from horovod_tpu_torch.common import timeline as ttl

import torch_worlds


def _drive(tl_mod, path, execution):
    tl = tl_mod.Timeline(str(path), mark_cycles=True)
    for i, name in enumerate(("grad.a", "grad.b", "grad.a")):
        tl.start_activity(name, tl_mod.NEGOTIATE_ALLREDUCE)
        tl.rank_ready(name, i % 2, mono_ns=tl._start_ns + 1000 * (i + 1))
        tl.end_activity(name, tl_mod.NEGOTIATE_ALLREDUCE)
        tl.start_activity(name, execution)
        tl.end_activity(name, execution)
        tl.mark_cycle()
    tl.instant(tl_mod.RETRY, {"site": "kv.read", "attempt": 1})
    tl.instant(tl_mod.STALL_WARNING, {"report": "grad.c stalled"})
    tl.instant(tl_mod.STRAGGLER_WARNING, {"rank": 1, "lag_ms": 120.5})
    tl.counter("hvd_bytes", {"bytes_sent": 10, "cross_bytes": 0})
    tl.start_activity("compile.key", tl_mod.COMPILE)
    tl.end_activity("compile.key", tl_mod.COMPILE)
    tl.close()
    events = json.loads(path.read_text())
    for ev in events:
        ev.pop("ts", None)
        ev.pop("pid", None)
    return events


@pytest.mark.parametrize("port_name", sorted(ttl.REFERENCE_NAMES))
def test_same_events_give_the_same_trace(tmp_path, port_name):
    ref_name = ttl.REFERENCE_NAMES[port_name]
    port = _drive(ttl, tmp_path / "port.json", port_name)
    ref = _drive(jtl, tmp_path / "ref.json", ref_name)
    for ev in port:
        ev["name"] = ttl.REFERENCE_NAMES.get(ev["name"], ev["name"])
    assert port == ref


def test_names_are_the_references():
    assert ttl.INSTANT_CATALOG == jtl.INSTANT_CATALOG
    shared = [n for n in dir(jtl) if n.isupper() and not n.startswith("XLA_")]
    for n in shared:
        assert getattr(ttl, n) == getattr(jtl, n), n
    # Every execution activity maps to the reference's name for it (the
    # reference declares no alltoall constant; its engine writes
    # XLA_ALLTOALL).
    declared = {getattr(jtl, n) for n in dir(jtl) if n.startswith("XLA_")}
    assert set(ttl.REFERENCE_NAMES.values()) == declared | {"XLA_ALLTOALL"}
    for backend, device in (("NCCL", "cuda"), ("GLOO", "cpu")):
        for kind, op in (("allreduce", "ALLREDUCE"),
                         ("allgather", "ALLGATHER"), ("broadcast", "BCAST"),
                         ("reducescatter", "REDUCESCATTER"),
                         ("alltoall", "ALLTOALL")):
            name = ttl.execution_activity(kind, device)
            assert name == f"{backend}_{op}" == getattr(ttl, name)
            assert ttl.negotiate_activity(kind) == f"NEGOTIATE_{kind.upper()}"


# The op sequence both engines run: (kind, tensor name).
OPS = (("allreduce", "tl.allreduce"), ("allgather", "tl.allgather"),
       ("broadcast", "tl.broadcast"), ("allreduce", "tl.allreduce"))

WORKER = torch_worlds.WORLD_PRELUDE + r"""
if rank == 0:
    os.environ["HOROVOD_TIMELINE"] = spec["path"]
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
x = torch.arange(6.0) + rank
for kind, name in spec["ops"]:
    if kind == "allreduce":
        out = hvd.allreduce(x, name=name, op=hvd.Sum)
        assert torch.equal(out, 2 * torch.arange(6.0) + 1), out
    elif kind == "allgather":
        hvd.allgather(x.reshape(2, 3), name=name)
    else:
        out = hvd.broadcast(x, 1, name=name)
        assert torch.equal(out, torch.arange(6.0) + 1), out
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


def _spans(events):
    """Per tensor: its B/E events' (phase, name), in file order, and its
    RANK_READY ticks."""
    tids = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    spans, ticks = {}, {}
    for e in events:
        name = tids.get(e.get("tid"))
        if name is None:
            continue
        if e["ph"] in ("B", "E"):
            spans.setdefault(name, []).append((e["ph"], e["name"]))
        elif e["name"].startswith("RANK_READY"):
            ticks.setdefault(name, []).append(e["name"])
    return spans, ticks


def _reference_spans(tmp_path, monkeypatch):
    """The JAX package's engine, its native core live, on the same ops (a
    list of one array per device)."""
    import horovod_tpu as jhvd

    path = tmp_path / "reference.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    jhvd.init()
    try:
        n = jhvd.size()
        xs = [np.arange(6.0, dtype=np.float32) + r for r in range(n)]
        for kind, name in OPS:
            if kind == "allreduce":
                jhvd.allreduce(xs, name=name, op=jhvd.Sum)
            elif kind == "allgather":
                jhvd.allgather([x.reshape(2, 3) for x in xs], name=name)
            else:
                jhvd.broadcast(xs, root_rank=1, name=name)
    finally:
        jhvd.shutdown()
    return _spans(json.loads(path.read_text()))[0]


def test_eager_plane_trace_matches_reference(tmp_path, monkeypatch):
    path = tmp_path / "port.json"
    world = torch_worlds.launch(WORKER, 2, tmp_path,
                                {"path": str(path), "ops": OPS},
                                {"unused": np.zeros(1)})
    ref = _reference_spans(tmp_path, monkeypatch)
    world.results()
    spans, ticks = _spans(json.loads(path.read_text()))
    # The reference declares XLA_BCAST but its engine writes
    # f"XLA_{KIND}", so its broadcast span is XLA_BROADCAST.
    written = dict(ttl.REFERENCE_NAMES, GLOO_BCAST="XLA_BROADCAST")
    mapped = {n: [(ph, written.get(a, a)) for ph, a in evs]
              for n, evs in spans.items()}
    names = {name for _, name in OPS}
    assert {n: mapped[n] for n in names} == {n: ref[n] for n in names}
    for kind, name in set(OPS):
        want = [("B", f"NEGOTIATE_{kind.upper()}"),
                ("E", f"NEGOTIATE_{kind.upper()}"),
                ("B", ttl.execution_activity(kind, "cpu")),
                ("E", ttl.execution_activity(kind, "cpu"))]
        runs = sum(1 for _, n in OPS if n == name)
        assert spans[name] == want * runs
        assert sorted(ticks[name]) == sorted(
            ["RANK_READY[0]", "RANK_READY[1]"] * runs)
