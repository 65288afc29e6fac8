"""The port's autotuner (``common/parameter_manager.py``, ``common/optim/``)
against the JAX package's on the same inputs.

The Gaussian process and the Bayesian optimizer give the same posteriors
and suggestions on the same samples (NumPy on both sides: exact). The
``ParameterManager``, given a fake core and a fake clock whose elapsed
time per step is the same function of the applied point, proposes the
same candidates to the core, pins the same point and writes the same log,
with each categorical grid (hierarchical flags, stripes, compression,
ZeRO prefetch) on and off. In one 2-rank gloo world with
``HOROVOD_AUTOTUNE=1``, the tuner runs on rank 0 only, pins, and its cycle
time reaches rank 1 through the response frames, while the bucket plans
of both ranks stay equal: rank 0 publishes no bucket cap in a world of
more than one process.
"""

import numpy as np
import pytest

from horovod_tpu.common import optim as joptim
from horovod_tpu.common import parameter_manager as jpm
from horovod_tpu_torch.common import optim as toptim
from horovod_tpu_torch.common import parameter_manager as tpm

import torch_worlds

MB = 1024 * 1024


def test_gaussian_process_matches_reference():
    rng = np.random.RandomState(3)
    x, y = rng.rand(12, 2) * 10, rng.rand(12)
    xq = rng.rand(7, 2) * 10
    got, want = toptim.GaussianProcessRegressor(1e-4), \
        joptim.GaussianProcessRegressor(1e-4)
    got.fit(x, y)
    want.fit(x, y)
    for a, b in zip(got.predict(xq), want.predict(xq)):
        np.testing.assert_array_equal(a, b)


def test_bayesian_optimization_matches_reference():
    def f(p):
        return -(p[0] - 30.0) ** 2 - (p[1] - 7.0) ** 2

    bounds = [(0.0, 64.0), (1.0, 25.0)]
    got = toptim.BayesianOptimization(bounds, alpha=0.64)
    want = joptim.BayesianOptimization(bounds, alpha=0.64)
    for _ in range(5):
        a, b = got.suggest(), want.suggest()
        np.testing.assert_array_equal(a, b)
        got.add_sample(a, f(a))
        want.add_sample(b, f(b))
    assert [x.tolist() for x in got.best()[:1]] == \
        [x.tolist() for x in want.best()[:1]]


class _FakeCore:
    def __init__(self):
        self.calls = []

    def set_parameters(self, cycle_time_ms=-1.0, fusion_threshold=-1):
        self.calls.append(("params", cycle_time_ms, fusion_threshold))

    def set_hier_flags(self, flags):
        self.calls.append(("hier", flags))

    def set_stripes(self, stripes):
        self.calls.append(("stripes", stripes))


class _FakeTime:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def _tune(pm_mod, tmp_path, monkeypatch, kind, **kw):
    """Drive ``pm_mod.ParameterManager`` until it pins (or 400 steps): the
    step's elapsed time is a smooth function of the applied point, bytes
    are constant. Returns what it applied, published and logged."""
    clock = _FakeTime()
    monkeypatch.setattr(pm_mod, "time", clock)
    core = _FakeCore()
    published = []
    log = tmp_path / f"{kind}.{pm_mod.__name__}.csv"
    setter = "bucket_cap_setter" if pm_mod is tpm else "xla_cap_setter"
    extra = {}
    if kw.pop("compression", False):
        extra.update(compression_setter=lambda m: published.append(m),
                     compression_candidates=("none", "fp16"))
    if kw.pop("prefetch", False):
        extra.update(zero_prefetch_setter=lambda d: published.append(d),
                     zero_prefetch_candidates=(0, 1, 2))
    pm = pm_mod.ParameterManager(
        core, warmup_samples=2, steps_per_sample=3, max_samples=4,
        log_file=str(log), **{setter: published.append}, **extra, **kw)
    for step in range(400):
        if not pm.active:
            break
        fusion_mb, cycle_ms = pm.current
        clock.t += 0.01 * (1.0 + ((fusion_mb - 40.0) / 64.0) ** 2
                           + ((cycle_ms - 8.0) / 25.0) ** 2
                           + 0.001 * (step % 5))
        pm.update(4 * MB)
    return {"calls": core.calls, "published": published,
            "current": pm.current, "active": pm.active,
            "samples": pm.samples_taken, "hier": pm.hier_flags,
            "stripes": pm.stripes, "compression": pm.compression,
            "prefetch": pm.zero_prefetch, "log": log.read_text()}


@pytest.mark.parametrize("kind,kw", [
    ("numeric", {}),
    ("hierarchical", dict(tune_hierarchical=True)),
    ("stripes", dict(tune_hierarchical=True, stripe_candidates=(1, 4))),
    ("compression", dict(compression=True)),
    ("prefetch", dict(prefetch=True, compression=True)),
])
def test_parameter_manager_matches_reference(tmp_path, monkeypatch, kind,
                                             kw):
    got = _tune(tpm, tmp_path, monkeypatch, kind, **dict(kw))
    want = _tune(jpm, tmp_path, monkeypatch, kind, **dict(kw))
    assert got == want
    assert not got["active"] and got["samples"] == 4
    assert got["log"].count("\n") > 4


WORKER = torch_worlds.WORLD_PRELUDE + r"""
os.environ.update(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
                  HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="2",
                  HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="3")
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import fusion
from horovod_tpu_torch.common.state import global_state

hvd.init(device="cpu")
st = global_state()
res["has_tuner"] = np.array(st.autotuner is not None)
for i in range(12):
    hvd.allreduce(torch.ones(256) * (rank + 1), name=f"tune.{i}", op=hvd.Sum)
hvd.barrier()
res["pinned"] = np.array(st.autotuner is not None and not st.autotuner.active)
res["params"] = np.array(st.engine.native_core.get_parameters())
res["published"] = np.array(st.config.fusion_threshold_explicit)
model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Linear(64, 8))
cap = fusion.resolve_bucket_cap("auto")
plan = fusion.describe_plan(fusion.plan_buckets_for(
    list(model.parameters()), cap))
res["plan"] = np.array(json.dumps([cap, plan]))
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


def test_bucket_plans_stay_equal_under_autotune(tmp_path):
    world = torch_worlds.launch(WORKER, 2, tmp_path, {},
                                {"unused": np.zeros(1)})
    r0, r1 = world.results()
    assert bool(r0["has_tuner"]) and not bool(r1["has_tuner"])
    assert bool(r0["pinned"])
    # The pinned cycle time reached rank 1 with the response frames.
    assert r0["params"][0] == r1["params"][0]
    assert not bool(r0["published"]) and not bool(r1["published"])
    assert str(r0["plan"]) == str(r1["plan"])
