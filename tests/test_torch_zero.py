"""The port's ZeRO stages 1-3 (``horovod_tpu_torch/zero.py``) against the
JAX package's ``horovod_tpu.zero`` on the CPU.

Two gloo worlds (subprocesses), of 2 and 4 ranks, run every case of
``CASES`` while the JAX side computes the same runs on a 2- and a
4-device CPU mesh: ResNet18 (``num_filters=8``, fp32, 32 px, global batch
16) and the MLP of ``tests/test_zero.py`` (Dense(32), relu, Dense(10) on
8x8x3 images), both from the JAX model's ``init`` at PRNGKey(0), SGD with
momentum 0.9, 3 steps. The JAX reference of a case is the JAX step with
the case's compression, accumulation and cap (``_ref_key``); the port's
stages 1, 2 and 3 all meet it.

- Every parameter and batch-norm statistic agrees to ``MOVE_TOL`` (1e-3)
  of its tensor's largest move over the steps (``MOVE_TOL`` of
  ``test_torch_image_training.py``: the sides differ in fp32 summation
  order, and under ef16 in which side of an fp16 rounding boundary an
  element falls; a wrong learning rate, momentum, average or residual
  moves a tensor by a factor), and never finer than one fp32 spacing of
  the tensor's largest value (a deep ResNet18 layer at 32 px moves by
  ~3e-6 in three steps, and the sides round its update apart by one
  spacing).
- On the tiled batch (every rank the same rows) stage 1 equals stage 2
  bitwise on the port, the reference's
  ``test_zero_stage2_matches_stage1_bitwise``.
- ef16 at stages 2 and 3, k=2 accumulation at stages 2 and 3, and a
  1 KiB bucket cap at stage 3 with prefetch 0 and 2 follow the same rule;
  the MLP's 6506 elements leave padding in its buckets at d=4.
- The memory gates of ``tests/test_zero_memory.py`` on the port's tensors
  (the 16-64-8 MLP, every leaf a multiple of 8 elements): plain SGD's
  stage 3 / stage 1 state bytes are 1/(d+1) at atol 0.002, stage 3 holds
  no parameter bytes, and its master shard is 1/d of the parameters;
  with momentum (after a step: torch makes the buffer at the first step)
  the ratio is 2/(d+2) at rtol 0.01.
- Every rejection of the reference's step is raised, accumulation
  updates with the mean, and a bucket the forward does not use steps as
  in JAX (a world of one).
"""

import contextlib
import functools

import numpy as np
import pytest

import flax.linen as nn
import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from horovod_tpu.common.state import AXIS_GLOBAL
from horovod_tpu.models import resnet as jr
from horovod_tpu.training import shard_batch as jax_shard_batch
from horovod_tpu.zero import (gather_params as jax_gather_params,
                              init_zero_train_state as jax_init,
                              make_zero_train_step as jax_make_step)
from horovod_tpu_torch.models import image_layers

import torch_worlds

MOVE_TOL = 1e-3
STEPS = 3
WORLDS = (2, 4)
RESNET = dict(num_classes=10, num_filters=8)

# name -> (model, stage, cap, compression, k, prefetch, batch, lr, momentum)
CASES = {}
for _s in (1, 2, 3):
    CASES[f"resnet-s{_s}"] = ("resnet", _s, None, "none", 1, 1, "random",
                              0.01, 0.9)
    CASES[f"mlp-s{_s}"] = ("mlp", _s, None, "none", 1, 1, "random", 0.1, 0.9)
for _s in (1, 2):
    CASES[f"mlp-tiled-s{_s}"] = ("mlp", _s, None, "none", 1, 1, "tiled",
                                 0.1, 0.9)
for _s in (2, 3):
    CASES[f"mlp-ef16-s{_s}"] = ("mlp", _s, None, "ef16", 1, 1, "random",
                                0.1, 0.9)
    CASES[f"mlp-k2-s{_s}"] = ("mlp", _s, None, "none", 2, 1, "random", 0.1,
                              0.9)
CASES["mlp-cap-s2"] = ("mlp", 2, 1024, "none", 1, 1, "random", 0.1, 0.9)
for _pf in (0, 2):
    CASES[f"mlp-cap-s3-pf{_pf}"] = ("mlp", 3, 1024, "none", 1, _pf, "random",
                                    0.1, 0.9)
MEMORY = {f"mem-{opt}-s{s}": ("mem", s, None, "none", 1, 1, "mem", 0.1, m)
          for s in (1, 3) for opt, m in (("sgd", 0.0), ("momentum", 0.9))}


def _ref_key(case):
    """The JAX run a case is held to: its model, compression, k, cap and
    batch, at stage 2 (stage 3 for the bucketed plan, so the JAX side's
    stage 3 is exercised too)."""
    model, stage, cap, comp, k, _, batch, lr, mom = case
    return (model, 3 if cap else 2, cap, comp, k, batch, lr, mom)


WORKER = torch_worlds.WORLD_PRELUDE + r"""
import functools
import torch.nn as nn
import horovod_tpu_torch as hvd
from horovod_tpu_torch import zero
from horovod_tpu_torch.models import image_layers as L
from horovod_tpu_torch.models import resnet

class MLP(nn.Module):
    def __init__(self, din, hidden, classes):
        super().__init__()
        self.Dense_0 = L.Dense(din, hidden, device="cpu")
        self.Dense_1 = L.Dense(hidden, classes, device="cpu")

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))

for n, case in spec["cases"].items():
    model_name, stage, cap, comp, k, pf, batch, lr, mom = case
    hvd.init(device="cpu")
    if model_name == "resnet":
        model = resnet.ResNet18(dtype=torch.float32, device="cpu",
                                **spec["resnet"])
    elif model_name == "mlp":
        model = MLP(192, 32, 10)
    else:
        model = MLP(16, 64, 8)
    pre = f"{model_name}/sd/"
    model.load_state_dict({k_[len(pre):]: torch.from_numpy(inp[k_])
                           for k_ in inp.files if k_.startswith(pre)})
    st = zero.init_zero_train_state(
        model, functools.partial(torch.optim.SGD, lr=lr, momentum=mom),
        accumulate_steps=k, bucket_cap_bytes=cap, compression=comp,
        zero_stage=stage)
    res[f"{n}/bytes0"] = np.array(sorted(zero.state_bytes(st).items()),
                                  dtype=object).astype(str)
    step = zero.make_zero_train_step(
        accumulate_steps=k, bucket_cap_bytes=cap, compression=comp,
        zero_stage=stage, prefetch=pf)
    images, labels = inp[f"{model_name}/{batch}/x"], inp[f"{model_name}/{batch}/y"]
    b = images.shape[0] // size
    x = torch.from_numpy(images[rank * b:(rank + 1) * b])
    y = torch.from_numpy(labels[rank * b:(rank + 1) * b]).long()
    losses = []
    for _ in range(spec["steps"] * k):
        st, loss = step(st, x, y)
        losses.append(loss.item())
    res[f"{n}/losses"] = np.array(losses)
    res[f"{n}/gathers"] = np.array(step.gathers)
    for key, t in zero.gather_params(st).items():
        res[f"{n}/sd/{key}"] = t.numpy()
    for key, t in st.model.named_buffers():
        res[f"{n}/sd/{key}"] = t.numpy()
    res[f"{n}/pshard"] = st.pshard.detach().numpy()
    for part, nb in zero.state_bytes(st).items():
        res[f"{n}/bytes/{part}"] = np.array(nb)
    res[f"{n}/template"] = np.array(zero._params_are_template(st.model))
    hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


class _MLP(nn.Module):
    hidden: int = 32
    classes: int = 10

    @nn.compact
    def __call__(self, x, train=False):
        x = x.reshape((x.shape[0], -1))
        x = nn.relu(nn.Dense(self.hidden)(x))
        return nn.Dense(self.classes)(x)


@contextlib.contextmanager
def _two_pass_variance():
    """flax's batch norm with the two-pass variance the port computes."""
    one_pass = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return one_pass(*args, **kwargs)

    flax_norm._compute_stats = two_pass
    try:
        yield
    finally:
        flax_norm._compute_stats = one_pass


def _jax_model(name):
    if name == "resnet":
        return jr.ResNet18(dtype=jnp.float32, **RESNET), (1, 32, 32, 3)
    if name == "mlp":
        return _MLP(), (1, 8, 8, 3)
    return _MLP(hidden=64, classes=8), (1, 16)


def _batches(d):
    """numpy batches by model and kind: "random" rows, and "tiled" (two
    rows repeated on every rank)."""
    def rand(shape, seed=0):
        return np.random.RandomState(seed).rand(*shape).astype(np.float32)

    def labels(n, classes, seed=1):
        return np.random.RandomState(seed).randint(0, classes, n).astype(
            np.int64)

    out = {"resnet/random/x": rand((16, 32, 32, 3)),
           "resnet/random/y": labels(16, 10),
           "mlp/random/x": rand((16, 8, 8, 3)),
           "mlp/random/y": labels(16, 10),
           "mlp/tiled/x": np.tile(rand((2, 8, 8, 3)), (d, 1, 1, 1)),
           "mlp/tiled/y": np.tile(labels(2, 10), d),
           "mem/mem/x": rand((16, 16)),
           "mem/mem/y": labels(16, 8)}
    return out


def _variables(name):
    model, sample = _jax_model(name)
    return jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.zeros(sample, jnp.float32),
                                     train=False))


def _port_state(variables):
    return {n: t.numpy() for n, t in
            image_layers.params_from_jax(variables).items()}


def _jax_run(d, key, batches):
    """The JAX ZeRO step of ``key`` (``_ref_key``) on a d-device mesh:
    the final parameters and statistics under the port's names."""
    name, stage, cap, comp, k, batch, lr, mom = key
    model, sample = _jax_model(name)
    mesh = Mesh(np.array(jax.devices()[:d]), (AXIS_GLOBAL,))
    opt = optax.sgd(lr, momentum=mom)
    kw = dict(bucket_cap_bytes=cap, compression=comp, accumulate_steps=k,
              zero_stage=stage)
    with _two_pass_variance():
        state = jax_init(model, opt, jax.random.PRNGKey(0),
                         jnp.zeros(sample, jnp.float32), mesh, **kw)
        step = jax_make_step(model, opt, mesh, donate=False, **kw)
        x, y = jax_shard_batch(
            (jnp.asarray(batches[f"{name}/{batch}/x"]),
             jnp.asarray(batches[f"{name}/{batch}/y"].astype(np.int32))),
            mesh)
        for _ in range(STEPS * k):
            state, _ = step(state, x, y)
    variables = {"params": jax.device_get(jax_gather_params(state, mesh))}
    if state.batch_stats is not None:
        variables["batch_stats"] = jax.device_get(state.batch_stats)
    return _port_state(variables)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's rank results and the JAX references, by d."""
    starts = {n: _port_state(_variables(n)) for n in ("resnet", "mlp",
                                                      "mem")}
    worlds = {}
    for d in WORLDS:
        inputs = dict(_batches(d))
        for n, sd in starts.items():
            inputs.update({f"{n}/sd/{k}": v for k, v in sd.items()})
        worlds[d] = torch_worlds.launch(
            WORKER, d, tmp_path_factory.mktemp(f"zero{d}"),
            {"cases": dict(CASES, **MEMORY), "resnet": RESNET,
             "steps": STEPS}, inputs)
    refs = {d: {key: _jax_run(d, key, _batches(d))
                for key in sorted({_ref_key(c) for c in CASES.values()},
                                  key=str)} for d in WORLDS}
    return {d: worlds[d].results() for d in WORLDS}, refs, starts


def _state(res, name):
    pre = f"{name}/sd/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_stage_meets_the_jax_zero_step(runs, d, name):
    results, refs, starts = runs
    case = CASES[name]
    want = refs[d][_ref_key(case)]
    start = starts[case[0]]
    for rank, res in enumerate(results[d]):
        got = _state(res, name)
        assert set(got) == set(want), name
        for n, w in want.items():
            moved = np.abs(w - start[n]).max()
            assert moved > 0, n
            # No finer than one rounding of the stored value: a tensor
            # that barely moves would otherwise be held below fp32.
            floor = np.spacing(np.abs(w).max())
            np.testing.assert_allclose(
                got[n], w, rtol=0, atol=max(MOVE_TOL * moved, floor),
                err_msg=f"{name} at d={d}, rank {rank}: {n}")
        np.testing.assert_array_equal(res[f"{name}/losses"],
                                      results[d][0][f"{name}/losses"])
        assert bool(res[f"{name}/template"]) == (case[1] == 3)
        if case[1] == 3:
            assert int(res[f"{name}/bytes/params"]) == 0
    losses = results[d][0][f"{name}/losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("d", WORLDS)
def test_stage1_equals_stage2_bitwise_on_the_tiled_batch(runs, d):
    results = runs[0][d]
    for res in results:
        np.testing.assert_array_equal(res["mlp-tiled-s1/losses"],
                                      res["mlp-tiled-s2/losses"])
        np.testing.assert_array_equal(res["mlp-tiled-s1/pshard"],
                                      res["mlp-tiled-s2/pshard"])
        s1, s2 = _state(res, "mlp-tiled-s1"), _state(res, "mlp-tiled-s2")
        for n in s1:
            np.testing.assert_array_equal(s1[n], s2[n])


@pytest.mark.parametrize("d", WORLDS)
def test_stage3_gathers_ahead_and_again_in_the_backward(runs, d):
    """Stage 3 gathers each bucket in the forward and gathers again what
    the backward saved: the MLP's second layer weight (the first layer's
    is not saved: its input needs no gradient). Depth changes neither the
    count nor any number."""
    res = runs[0][d][0]
    assert int(res["mlp-s3/gathers"]) == 1 + 1
    for pf in (0, 2):
        assert int(res[f"mlp-cap-s3-pf{pf}/gathers"]) == 4 + 1
    np.testing.assert_array_equal(res["mlp-cap-s3-pf0/pshard"],
                                  res["mlp-cap-s3-pf2/pshard"])
    # Stages 1 and 2 gather the fresh masters once a bucket after the
    # update.
    assert int(res["mlp-cap-s2/gathers"]) == 4


@pytest.mark.parametrize("d", WORLDS)
def test_state_bytes_follow_the_memory_model(runs, d):
    """``tests/test_zero_memory.py``'s gates on the port's tensors."""
    res = runs[0][d][0]

    def total(name, key="bytes"):
        return sum(int(res[k]) for k in res
                   if k.startswith(f"{name}/{key}/"))

    b1, b3 = total("mem-sgd-s1"), total("mem-sgd-s3")
    assert b3 / b1 <= 1.0 / d + 0.02, (b1, b3)
    np.testing.assert_allclose(b3 / b1, 1.0 / (d + 1), atol=0.002)
    assert int(res["mem-sgd-s3/bytes/params"]) == 0
    p_full = int(res["mem-sgd-s1/bytes/params"])
    assert int(res["mem-sgd-s3/bytes/masters"]) * d == p_full
    # Born sharded: before any step the same ratio holds.
    init = {name: dict(res[f"{name}/bytes0"]) for name in ("mem-sgd-s1",
                                                           "mem-sgd-s3")}
    i1, i3 = (sum(int(v) for v in init[n].values()) for n in init)
    np.testing.assert_allclose(i3 / i1, 1.0 / (d + 1), atol=0.002)
    m1, m3 = total("mem-momentum-s1"), total("mem-momentum-s3")
    np.testing.assert_allclose(m3 / m1, 2.0 / (d + 2), rtol=0.01)


# ---- rejections (a world of one) --------------------------------------------


class _TorchMLP(torch.nn.Module):
    def __init__(self, hidden=16):
        super().__init__()
        self.Dense_0 = image_layers.Dense(192, hidden, device="cpu")
        self.Dense_1 = image_layers.Dense(hidden, 10, device="cpu")
        image_layers.reset_parameters(self, torch.Generator().manual_seed(0))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))


@pytest.fixture
def one_rank():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _state_of(stage=2, **kw):
    from horovod_tpu_torch import zero

    return zero.init_zero_train_state(
        _TorchMLP(), functools.partial(torch.optim.SGD, lr=0.1,
                                       momentum=0.9), zero_stage=stage, **kw)


def _batch():
    g = torch.Generator().manual_seed(0)
    return (torch.rand(4, 8, 8, 3, generator=g),
            torch.randint(0, 10, (4,), generator=g))


def test_every_rejection_of_the_reference_is_raised(one_rank, monkeypatch):
    import dataclasses

    from horovod_tpu_torch import zero

    x, y = _batch()
    auto = zero.make_zero_train_step()
    s3 = _state_of(3)
    with pytest.raises(ValueError, match="stage mismatch"):
        zero.make_zero_train_step(zero_stage=2)(s3, x, y)
    with pytest.raises(ValueError, match="stage stamp"):
        auto(dataclasses.replace(_state_of(2), stage=None), x, y)
    with pytest.raises(ValueError, match="bucket_cap stamp"):
        auto(dataclasses.replace(_state_of(2), bucket_cap=None), x, y)
    with pytest.raises(ValueError, match="invalid stage stamp"):
        auto(dataclasses.replace(_state_of(2), stage=4), x, y)
    # Forged stamps: only the physical layout can tell.
    with pytest.raises(ValueError, match="shape template"):
        auto(dataclasses.replace(_state_of(2), stage=3), x, y)
    with pytest.raises(ValueError, match="replicated params"):
        auto(dataclasses.replace(_state_of(3), stage=2), x, y)
    with pytest.raises(ValueError, match="compression mismatch"):
        zero.make_zero_train_step(compression="ef16")(_state_of(2), x, y)
    with pytest.raises(ValueError, match="compression mismatch"):
        zero.make_zero_train_step(compression="none")(
            _state_of(2, compression="ef16"), x, y)
    with pytest.raises(ValueError, match="bucket cap mismatch"):
        zero.make_zero_train_step(bucket_cap_bytes=1024)(_state_of(2), x, y)
    with pytest.raises(ValueError, match="accumulate_steps mismatch"):
        zero.make_zero_train_step(accumulate_steps=2)(_state_of(2), x, y)
    with pytest.raises(ValueError, match="accumulate_steps mismatch"):
        auto(_state_of(2, accumulate_steps=2), x, y)
    # Model surgery after init: the shards no longer fit the tree.
    stale = _state_of(2)
    stale.model.Dense_0 = image_layers.Dense(192, 32, device="cpu")
    stale.model.Dense_1 = image_layers.Dense(32, 10, device="cpu")
    with pytest.raises(ValueError, match="rebuild the state"):
        auto(stale, x, y)
    odd = _state_of(2, compression="ef16")
    odd.residual = odd.residual[:-1]
    with pytest.raises(ValueError, match="residual was built"):
        auto(odd, x, y)
    with pytest.raises(ValueError, match="does not fit int32"):
        _state_of(2, bucket_cap_bytes=2 ** 31)
    with pytest.raises(ValueError, match="zero_stage must be"):
        _state_of(4)
    monkeypatch.setenv("HOROVOD_COMPRESSION", "ef16")
    with pytest.raises(ValueError, match="carries no residual"):
        auto(_state_of(2, compression="none"), x, y)


def test_auto_knobs_follow_the_env(one_rank, monkeypatch):
    from horovod_tpu_torch import zero
    from horovod_tpu_torch.common.fusion import resolve_prefetch_depth

    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "3")
    assert _state_of("auto").stage == 3
    monkeypatch.setenv("HOROVOD_ZERO_STAGE", "9")
    assert _state_of("auto").stage == 3     # clamped
    monkeypatch.delenv("HOROVOD_ZERO_STAGE")
    assert _state_of("auto").stage == 2
    assert resolve_prefetch_depth("auto") == 1
    monkeypatch.setenv("HOROVOD_ZERO_PREFETCH", "20")
    assert resolve_prefetch_depth("auto") == 8
    assert resolve_prefetch_depth(-3) == 0
    with pytest.raises(ValueError):
        resolve_prefetch_depth("deep")
    # A stage-3 state steps, keeps its template and gathers on demand.
    x, y = _batch()
    s3 = _state_of(3)
    s3, loss = zero.make_zero_train_step()(s3, x, y)
    assert s3.step == 1 and np.isfinite(loss.item())
    assert all(p.device.type == "meta" for p in s3.model.parameters())
    full = zero.gather_params(s3)
    assert [tuple(t.shape) for t in full.values()] == [
        tuple(p.shape) for p in s3.model.parameters()]


def test_accumulation_updates_with_the_mean(one_rank):
    """k identical micro-batches land where one plain update lands (the
    mean of k equal gradients), and the micro-steps between updates
    leave the parameters alone."""
    from horovod_tpu_torch import zero

    x, y = _batch()
    for stage in (2, 3):
        a = _state_of(stage, accumulate_steps=3)
        b = _state_of(stage)
        step_a = zero.make_zero_train_step(accumulate_steps=3)
        step_b = zero.make_zero_train_step()
        for _ in range(3):
            a, _ = step_a(a, x, y)
        b, _ = step_b(b, x, y)
        torch.testing.assert_close(a.pshard, b.pshard, rtol=0, atol=1e-6)
        before = a.pshard.detach().clone()
        a, _ = step_a(a, x, y)
        assert torch.equal(a.pshard.detach(), before)


class _Unused(_TorchMLP):
    """The MLP with a layer its forward never calls."""

    def __init__(self):
        super().__init__()
        self.Dense_2 = image_layers.Dense(10, 10, device="cpu")
        image_layers.reset_parameters(self, torch.Generator().manual_seed(0))


def test_a_bucket_the_forward_does_not_use_steps_as_in_jax(one_rank):
    """At stage 3 a bucket no module gathers is gathered anyway and its
    zero cotangent reduce-scattered, as the JAX step does for every
    bucket: with ef16 its residual takes the same update as at stage 2,
    where the unused parameter's gradient is zero."""
    from horovod_tpu_torch import zero

    x, y = _batch()
    out = {}
    for stage in (2, 3):
        st = zero.init_zero_train_state(
            _Unused(), functools.partial(torch.optim.SGD, lr=0.1,
                                         momentum=0.9),
            zero_stage=stage, bucket_cap_bytes=256, compression="ef16")
        st.residual.fill_(1e-4)
        step = zero.make_zero_train_step()
        for _ in range(2):
            st, _ = step(st, x, y)
        out[stage] = st
    torch.testing.assert_close(out[3].pshard, out[2].pshard, rtol=0,
                               atol=1e-7)
    torch.testing.assert_close(out[3].residual, out[2].residual, rtol=0,
                               atol=1e-7)
