"""The port's sharded checkpoints (``horovod_tpu_torch/checkpoint.py``),
the counterpart of ``tests/test_checkpoint.py``.

One 2-rank gloo world saves, restores into freshly built templates (other
seeds) and steps on, for each state kind:

- a replicated ``DistributedOptimizer`` state with ef16 residuals under
  ``opt.RESIDUAL_KEY`` and ResNet18's batch-norm buffers;
- ZeRO states of stages 1, 2 and 3 (the stage-3 one with ef16 residuals
  and k=2 accumulation, saved between two micro-steps), with their
  stamps;
- the decoder's tp=2 and pp=2 shards with Adam.

Every restored tensor equals the saved one bitwise, and the next step of
the restored state equals the next step of the uninterrupted one bitwise.
Each rank's file holds its own shard only (a ZeRO rank's master shard is
1/d of the padded parameters). A restore into a template of another
stage, cap or world size is refused with a message; retention keeps the
newest ``max_to_keep`` complete steps.
"""

import functools

import numpy as np
import pytest
import torch

import torch_worlds

WORKER = torch_worlds.WORLD_PRELUDE + r"""
import functools
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training, zero
from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.opt import RESIDUAL_KEY

root = spec["dir"]
g = torch.Generator().manual_seed(0)
images = torch.rand(8, 32, 32, 3, generator=g)
labels = torch.randint(0, 10, (8,), generator=g)
x, y = images[rank * 4:(rank + 1) * 4], labels[rank * 4:(rank + 1) * 4]

def flat(obj, out, prefix=""):
    if torch.is_tensor(obj):
        out[prefix] = obj.detach().cpu().clone()
    elif hasattr(obj, "state_dict"):
        flat(obj.state_dict(), out, prefix)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            flat(v, out, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            flat(v, out, f"{prefix}/{i}")
    return out

def same(a, b):
    fa, fb = flat(a, {}), flat(b, {})
    bits = lambda t: t.reshape(-1).view(torch.uint8)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(bits(fa[k]), bits(fb[k]))
        for k in fa)

def replicated(seed):
    model = resnet.ResNet18(num_classes=10, num_filters=8,
                            dtype=torch.float32, device="cpu", seed=seed)
    opt = training.init_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression="ef16", bucket_cap_bytes=None)
    step = training.make_train_step(model, opt)
    return {"model": model, "opt": opt}, lambda: step(x, y).item()

def zero_state(stage, seed, **kw):
    model = resnet.ResNet18(num_classes=10, num_filters=8,
                            dtype=torch.float32, device="cpu", seed=seed)
    st = zero.init_zero_train_state(
        model, functools.partial(torch.optim.SGD, lr=0.01, momentum=0.9),
        zero_stage=stage, **kw)
    step = zero.make_zero_train_step(
        accumulate_steps=kw.get("accumulate_steps", 1))
    return st, lambda: step(st, x, y)[1].item()

def transformer(mesh, seed):
    cfg = tt.TransformerConfig(vocab=64, d_model=32, n_heads=4, d_head=8,
                               d_ff=64, n_layers=4, max_seq=32)
    model = tt.Transformer(cfg, device="cpu", seed=seed,
                           n_microbatches=mesh.get("pp", 1))
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=1e-3),
                                   named_parameters=model.named_parameters())
    step = training.make_train_step(model, opt)
    tok = torch.randint(0, 64, (4, 32), generator=torch.Generator().manual_seed(3))
    b = 4 // hvd.dp_size()
    t = tok[hvd.dp_rank() * b:(hvd.dp_rank() + 1) * b]
    return {"model": model, "opt": opt}, lambda: step(t, torch.roll(t, -1, 1)).item()

CASES = {
    "replicated": ({}, lambda s: replicated(s)),
    "zero1": ({}, lambda s: zero_state(1, s)),
    "zero2": ({}, lambda s: zero_state(2, s, bucket_cap_bytes=4096)),
    "zero3": ({}, lambda s: zero_state(3, s, compression="ef16",
                                       accumulate_steps=2)),
    "tp2": (dict(tp=2), lambda s: transformer(dict(tp=2), s)),
    "pp2": (dict(pp=2), lambda s: transformer(dict(pp=2), s)),
}
for name, (mesh, make) in CASES.items():
    hvd.init(device="cpu", **mesh)
    state, step = make(1)
    step(); step(); step()      # k=2 at zero3: saved between micro-steps
    mgr = CheckpointManager(f"{root}/{name}", max_to_keep=2)
    mgr.save(3, state)
    template, tstep = make(7)
    assert not same(template, state), name
    restored = mgr.restore(template)
    res[f"{name}/restored_equal"] = np.array(same(restored, state))
    res[f"{name}/next"] = np.array([step(), tstep()])
    res[f"{name}/after_equal"] = np.array(same(restored, state))
    if name.startswith("zero"):
        res[f"{name}/shard"] = np.array(state.pshard.numel())
    hvd.shutdown()

# Refusals: another stage, another cap.
hvd.init(device="cpu")
mgr = CheckpointManager(f"{root}/zero2")
for what, make in (("ZeRO stage", lambda: zero_state(3, 7)[0]),
                   ("bucket cap", lambda: zero_state(2, 7)[0])):
    try:
        mgr.restore(make())
        res[f"refused/{what}"] = np.array("")
    except ValueError as e:
        res[f"refused/{what}"] = np.array(str(e))
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE

KINDS = ["replicated", "zero1", "zero2", "zero3", "tp2", "pp2"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    results = torch_worlds.launch(WORKER, 2, tmp, {"dir": str(tmp / "c")},
                                  {"unused": np.zeros(1)}).results()
    return tmp / "c", results


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_is_bitwise_and_the_next_step_matches(world, kind):
    _, results = world
    for res in results:
        assert bool(res[f"{kind}/restored_equal"]), kind
        a, b = res[f"{kind}/next"]
        assert a == b and np.isfinite(a), (kind, a, b)
        assert bool(res[f"{kind}/after_equal"]), kind


def test_each_rank_writes_its_own_shard(world):
    directory, results = world
    for r in range(2):
        saved = torch.load(directory / "zero3" / "3" / f"rank{r}.pt",
                           weights_only=True)
        assert saved["rank"] == r and saved["world_size"] == 2
        assert saved["state"]["__state_dict__"]["pshard"].numel() == \
            int(results[r]["zero3/shard"])
        assert saved["state"]["__state_dict__"]["stage"] == 3
    # Stage-3 states hold no parameter bytes to write.
    model = saved["state"]["__state_dict__"]["model"]
    assert all("running" in k or "batch" in k for k in model), sorted(model)


@pytest.mark.parametrize("what", ["ZeRO stage", "bucket cap"])
def test_a_template_of_another_mode_is_refused(world, what):
    for res in world[1]:
        msg = str(res[f"refused/{what}"])
        assert "mismatch" in msg and what in msg, msg


def _zero_state(seed=0):
    from horovod_tpu_torch import zero
    from horovod_tpu_torch.models import image_layers

    model = torch.nn.Sequential(image_layers.Dense(6, 4, device="cpu"))
    image_layers.reset_parameters(model, torch.Generator().manual_seed(seed))
    return zero.init_zero_train_state(
        model, functools.partial(torch.optim.SGD, lr=0.1), zero_stage=2)


def test_another_world_size_is_refused(world):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import CheckpointManager

    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="world size mismatch"):
            CheckpointManager(str(world[0] / "zero1")).restore(
                {"unused": torch.zeros(1)})
    finally:
        hvd.shutdown()


def test_retention_latest_and_background_writes(tmp_path):
    from horovod_tpu_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "r"), max_to_keep=2)
    x = {"w": torch.arange(8.0), "n": 5}
    for s in (1, 2, 3):
        mgr.save(s, {"w": x["w"] * s, "n": s})
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]
    mgr.save(4, {"w": x["w"] * 4, "n": 4}, wait=False)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [3, 4]
    template = {"w": torch.zeros(8), "n": 0}
    out = mgr.restore(template, step=3)
    assert out["n"] == 3 and out["w"] is template["w"]
    assert torch.equal(template["w"], torch.arange(8.0) * 3)
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"w": torch.zeros(9), "n": 0})
    with pytest.raises(ValueError, match="keys"):
        mgr.restore({"v": torch.zeros(8), "n": 0})
    mgr.close()
    empty = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        empty.restore(template)
    # A ZeRO state round-trips on one rank too (no process group).
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        st = _zero_state()
        mgr = CheckpointManager(str(tmp_path / "z"))
        mgr.save(1, st)
        fresh = _zero_state(seed=5)
        mgr.restore(fresh)
        assert torch.equal(fresh.pshard, st.pshard)
        assert fresh.stage == 2 and fresh.bucket_cap == -1
    finally:
        hvd.shutdown()
