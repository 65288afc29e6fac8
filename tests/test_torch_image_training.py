"""The port's image training step, ef16 and image bench against the JAX
package's, on the CPU.

- ``torch.optim.SGD(lr=0.01, momentum=0.9)`` against ``optax.sgd(0.01,
  momentum=0.9)`` on the same gradients (both start the trace at g, no
  dampening, no Nesterov).
- Three steps of the port's ``make_train_step`` (``init_train_state`` with
  SGD-momentum) against the JAX ``make_train_step`` on a 1-device mesh;
  then 2-rank gloo worlds (subprocesses) against a 2-device JAX mesh, each
  rank on its half of the global batch with its own batch-norm
  statistics, uncompressed and with ``compression="ef16"``: parameters and
  the world-averaged running statistics on every rank, and under ef16
  each rank's residuals against its device's.
- ``apply_error_feedback`` against JAX's on the same gradients and
  residuals (normal values and fp16's overflow, underflow and ties); the
  residuals' round trip through ``state_dict`` and the refusal of a state
  whose residuals disagree with the mode.
- ``python -m horovod_tpu_torch.image_bench --device cpu`` prints one line
  with ``bench.py``'s keys.

Model: ResNet18 at ``num_filters=8``, 10 classes, 48 px (at 32 px the
last grid is 1x1, and a rank's batch norm there normalizes two values,
an ill-conditioned step), global batch 4,
with the numpy-drawn variables of ``tests/test_torch_image_models.py``
(and, as there, flax's two-pass batch-norm variance on the JAX side).

Tolerances, fp32 on both sides. Each parameter and running statistic
agrees to 1e-3 of its tensor's largest move over the three steps (the
move, not the value: a wrong learning rate, momentum or averaging moves
it by a factor; the sides differ in fp32 rounding, which the steps
compound to ~2e-4 of the move uncompressed and ~6e-4 under ef16, whose
fp16 rounding the sides may take on either side of a boundary; CPU
measurements). ef16 residuals are the fp16 rounding error of the
corrected gradient: where the two sides' corrected gradients straddle a
rounding boundary the residuals differ by one fp16 step of that entry,
at most 4x the largest residual, which 3 % of the entries do here. So
90 % of the entries agree to atol 1e-7 and every entry to 4x the largest
residual; a residual of the wrong sign, or one not carried from step to
step, differs in nearly every entry.
``apply_error_feedback`` is bitwise, and SGD against optax to rtol 1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh

from horovod_tpu.common import compression as jcomp
from horovod_tpu.models import resnet as jr
from horovod_tpu.opt import DistributedOptimizer as JaxDistributedOptimizer
from horovod_tpu.training import TrainState
from horovod_tpu.training import make_train_step as jax_make_train_step
from horovod_tpu.training import shard_batch as jax_shard_batch
from horovod_tpu_torch.common import compression as tcomp
from horovod_tpu_torch.models import image_layers
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.opt import RESIDUAL_KEY
from horovod_tpu_torch.training import (init_train_state, make_train_step,
                                        shard_batch)

from torch_worlds import free_port_pair
from test_torch_image_models import _fill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, GLOBAL_B, STEPS = 48, 4, 3
KW = dict(num_classes=10, num_filters=8)
MOVE_TOL, RESIDUAL_TOL = 1e-3, 1e-7
MODES = ["none", "ef16"]


@pytest.fixture(autouse=True)
def _two_pass_variance(monkeypatch):
    one_pass = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return one_pass(*args, **kwargs)

    monkeypatch.setattr(flax_norm, "_compute_stats", two_pass)


def _problem():
    """(flax variables, images, labels) from seeds."""
    model = jr.ResNet18(dtype=jnp.float32, **KW)
    rng = np.random.RandomState(5)
    images = rng.randn(GLOBAL_B, SIZE, SIZE, 3).astype(np.float32)
    labels = rng.randint(0, 10, GLOBAL_B).astype(np.int32)
    variables = _fill(jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jnp.asarray(images)))
    return variables, images, labels


def _jax_steps(n_devices, mode):
    """The JAX step on an n-device mesh for STEPS steps: (params and
    statistics as port state-dict entries, [each device's residuals as
    port names] or None)."""
    variables, images, labels = _problem()
    model = jr.ResNet18(dtype=jnp.float32, **KW)
    optimizer = optax.sgd(0.01, momentum=0.9)
    comp = None if mode == "none" else mode
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("hvd",))
    dist = JaxDistributedOptimizer(optimizer, compression=comp,
                                   bucket_cap_bytes=None)
    state = TrainState(variables["params"], dist.init(variables["params"]),
                       variables["batch_stats"], jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, optimizer, mesh, donate=False,
                               bucket_cap_bytes=None, compression=comp)
    x, y = jax_shard_batch((jnp.asarray(images), jnp.asarray(labels)), mesh)
    for _ in range(STEPS):
        state, _ = step(state, x, y)
    want = {n: t.numpy() for n, t in image_layers.params_from_jax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}).items()}
    residuals = None
    if mode == "ef16":
        residuals = [
            {n: t.numpy() for n, t in image_layers.params_from_jax({
                "params": jax.tree_util.tree_map(
                    lambda a: np.asarray(a.addressable_shards[d].data),
                    state.opt_state.residual)}).items()}
            for d in range(n_devices)]
    return want, residuals


def _start(variables):
    return {n: t.numpy() for n, t in
            image_layers.params_from_jax(variables).items()}


def _assert_state(got, want, start, what):
    for n, w in want.items():
        moved = np.abs(w - start[n]).max()
        assert moved > 0, n
        np.testing.assert_allclose(got[n], w, rtol=0, atol=MOVE_TOL * moved,
                                   err_msg=f"{what}: {n}")


def test_sgd_momentum_equals_optax():
    rng = np.random.RandomState(0)
    p0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) for _ in range(4)]
    opt = optax.sgd(0.01, momentum=0.9)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.SGD([tp], lr=0.01, momentum=0.9)
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_three_steps_match_jax_on_one_device():
    import horovod_tpu_torch as hvd

    variables, images, labels = _problem()
    want, _ = _jax_steps(1, "none")
    model = tr.ResNet18(dtype=torch.float32, device="cpu", **KW)
    model.load_state_dict(image_layers.params_from_jax(variables))
    hvd.init(device="cpu")
    try:
        opt = init_train_state(
            model, torch.optim.SGD(model.parameters(), lr=0.01,
                                   momentum=0.9),
            compression="none", bucket_cap_bytes=None)
        step = make_train_step(model, opt)
        x, y = shard_batch((images, labels.astype(np.int64)), 0, 1, "cpu")
        losses = [step(x, y).item() for _ in range(STEPS)]
        assert opt.allreduce_count == STEPS
    finally:
        hvd.shutdown()
    assert losses[-1] < losses[0]
    got = {n: t.numpy() for n, t in model.state_dict().items()}
    _assert_state(got, want, _start(variables), "1 device")


WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.opt import RESIDUAL_KEY
from horovod_tpu_torch.training import (init_train_state, make_train_step,
                                        shard_batch)

spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
rank, size = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
dist.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{os.environ['HOROVOD_CONTROLLER_PORT']}",
    rank=rank, world_size=size)
state = {k[3:]: torch.from_numpy(inp[k]) for k in inp.files
         if k.startswith("sd/")}
res = {}
for mode in spec["modes"]:
    hvd.init(device="cpu")
    model = tr.ResNet18(dtype=torch.float32, device="cpu", **spec["kw"])
    model.load_state_dict(state)
    opt = init_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=mode, bucket_cap_bytes=spec["bucket_cap"])
    step = make_train_step(model, opt)
    x, y = shard_batch((inp["images"], inp["labels"]), rank, size, "cpu")
    losses = [step(x, y).item() for _ in range(spec["steps"])]
    res[f"{mode}/losses"] = np.array(losses)
    for n, t in model.state_dict().items():
        res[f"{mode}/sd/{n}"] = t.numpy()
    if mode == "ef16":
        for (n, _), r in zip(model.named_parameters(),
                             opt.state[RESIDUAL_KEY]):
            res[f"{mode}/residual/{n}"] = r.numpy()
    hvd.shutdown()
np.savez(sys.argv[3 + rank], **res)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 2-rank gloo world that runs every mode; returns each rank's
    results."""
    tmp = tmp_path_factory.mktemp("image_world")
    variables, images, labels = _problem()
    inputs = {f"sd/{n}": t.numpy() for n, t in
              image_layers.params_from_jax(variables).items()}
    inputs.update(images=images, labels=labels.astype(np.int64))
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "spec.json").write_text(json.dumps(
        {"modes": MODES, "kw": KW, "steps": STEPS, "bucket_cap": 65536}))
    outs = [tmp / f"rank{r}.npz" for r in range(2)]
    port = free_port_pair()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "spec.json"),
             str(tmp / "inputs.npz"), *map(str, outs)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("mode", MODES)
def test_two_rank_world_matches_a_two_device_mesh(world, mode):
    want, residuals = _jax_steps(2, mode)
    start = _start(_problem()[0])
    for rank, res in enumerate(world):
        got = {k.split("/", 2)[2]: v for k, v in res.items()
               if k.startswith(f"{mode}/sd/")}
        assert set(got) == set(want)
        _assert_state(got, want, start, f"rank {rank} {mode}")
        np.testing.assert_array_equal(res[f"{mode}/losses"],
                                      world[0][f"{mode}/losses"])
        if residuals is None:
            continue
        diffs = np.concatenate([
            np.abs(res[f"{mode}/residual/{n}"] - w).ravel()
            for n, w in residuals[rank].items()])
        scale = max(np.abs(r).max() for r in residuals[rank].values())
        assert scale > 0
        assert (diffs <= RESIDUAL_TOL).mean() >= 0.9, (rank, diffs.max())
        assert diffs.max() <= 4 * scale, rank
    if residuals is not None:
        # The ranks' residuals are their own (each rank's gradients).
        assert any(not np.array_equal(world[0][k], world[1][k])
                   for k in world[0] if k.startswith("ef16/residual/"))


def test_apply_error_feedback_is_bitwise_jax():
    rng = np.random.RandomState(0)
    g = np.concatenate([rng.randn(500) * 3.0,
                        [70000.0, -1e6, 1e-9, 5.96e-8, 1.0 + 2 ** -11,
                         1.0 + 2 ** -8, 0.0, -0.0]]).astype(np.float32)
    r = (rng.randn(g.size) * 1e-4).astype(np.float32)
    jw, jr_ = jcomp.apply_error_feedback(
        jcomp.Compression.ef16, {"g": jnp.asarray(g)}, {"g": jnp.asarray(r)})
    tw, tr_ = tcomp.apply_error_feedback(
        tcomp.Compression.ef16, torch.from_numpy(g), torch.from_numpy(r))
    assert tw.dtype == torch.float16 and tr_.dtype == torch.float32
    np.testing.assert_array_equal(tw.view(torch.int16).numpy(),
                                  np.asarray(jw["g"]).view(np.int16))
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr_["g"]))
    ints = torch.arange(5, dtype=torch.int32)
    w, new = tcomp.apply_error_feedback(tcomp.Compression.ef16, ints,
                                        torch.ones(5))
    assert w is ints and torch.all(new == 0)


def test_ef16_residuals_ride_the_state_dict():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 3)

        def make(mode):
            return init_train_state(
                model, torch.optim.SGD(model.parameters(), lr=0.1,
                                       momentum=0.9), compression=mode)

        opt = make("ef16")
        model(torch.randn(5, 4)).square().sum().backward()
        opt.step()
        saved = opt.state_dict()
        res = saved["state"][RESIDUAL_KEY]
        assert [r.shape for r in res] == [(3, 4), (3,)]
        assert any(r.abs().max() > 0 for r in res)
        again = make("ef16")
        again.load_state_dict(saved)
        for a, b in zip(again.state[RESIDUAL_KEY], res):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        with pytest.raises(ValueError, match="no residuals"):
            make("ef16").load_state_dict(make("fp16").state_dict())
        with pytest.raises(ValueError, match="without error feedback"):
            make("fp16").load_state_dict(saved)
    finally:
        hvd.shutdown()


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "fusion",
              "compression", "platform", "device_kind", "workload",
              "step_ms", "loss", "peak_mem_bytes"}


def test_image_bench_prints_bench_keys_on_the_cpu(capsys):
    from horovod_tpu_torch import image_bench

    image_bench.main(["--device", "cpu", "--model", "resnet50",
                      "--image-size", "32", "--batch-size", "2",
                      "--num-warmup", "1", "--num-iters", "2",
                      "--fence-each"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) >= BENCH_KEYS | {"steps_per_sec", "steps_per_sec_ci95"}
    assert "mfu" not in line   # not an H100
    assert line["metric"] == "resnet50_images_per_sec_per_chip"
    assert line["platform"] == "cpu" and line["peak_mem_bytes"] is None
    assert line["workload"] == {"model": "resnet50", "batch_size": 2,
                                "image_size": 32, "space_to_depth": False,
                                "fence_each": True, "num_iters": 2}
    assert line["compression"]["mode"] == "none"
    assert line["fusion"]["num_buckets"] == 1
    assert np.isfinite(line["loss"]) and line["vs_baseline"] > 0
