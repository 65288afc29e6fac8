"""The torch binding of the port (``horovod_tpu_torch.torch``) against the
JAX package's (``horovod_tpu.torch``) and against dense oracles, on the
CPU.

- Size 1 (``device="cpu"``): the semantics of the reference binding's
  single-process tests (identity collectives, poll and synchronize, the
  autograd path, fp16 compression, refused dtypes and devices, the
  optimizer, objects, ``SyncBatchNorm``'s fallback, ``TorchState``).
- Two ranks, one gloo world of the port and one world of the reference
  binding (its native ring) at the same time, on the same numpy inputs:
  - in the port's world, the reference's worker checks (Sum, Average,
    int64 in place, Min and Max, broadcast from rank 1, a ragged
    allgather, autograd through allreduce, bf16, Adasum against
    ``ops/adasum.adasum_reference``, ``broadcast_object`` and
    ``allgather_object``, ``backward_passes_per_step=2``);
  - both worlds: a small MLP from per-rank seeds brought into line by
    ``broadcast_parameters`` and ``broadcast_optimizer_state`` (SGD with
    momentum, whose state does not exist yet), then four
    ``DistributedOptimizer`` steps on per-rank shards: every step's
    parameters and the momentum held port against reference at atol 1e-6;
  - both worlds: ``SyncBatchNorm`` (momentum 0.5) on each rank's half
    of a batch, against ``nn.BatchNorm1d`` over the whole batch (forward
    1e-4, running mean 1e-5, running variance 1e-4, the input gradient
    1e-5) and port against reference (1e-6);
  - in the port's world, ResNet18 (``num_filters=8``, 32 px, 10 classes,
    fp32) from flax's init, each rank 2 images whose means differ by 3
    (``tests/test_models.py``'s shifted shards): with ``sync_bn_axis="dp"``
    the world's mean loss is within rel 1e-4 of the flax model's
    full-batch loss (flax's one-pass variance, as the port computes it);
    with per-shard statistics it misses by more than 1e-3 (the positive
    control).
"""

import numpy as np
import pytest
import torch

import torch_worlds

WORKER = r"""
import json, os, sys
import numpy as np
import torch
rank = int(os.environ["HOROVOD_RANK"])
spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
res = {}
port = spec["binding"] == "port"
if port:
    import horovod_tpu_torch.torch as hvd
    hvd.init(device="cpu")
else:
    import horovod_tpu.torch as hvd
    hvd.init()
size = hvd.size()
assert size == 2

# broadcast_parameters + broadcast_optimizer_state, then the optimizer.
torch.manual_seed(1234 + rank)
model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                            torch.nn.Linear(8, 1))
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
    named_parameters=model.named_parameters())
hvd.broadcast_optimizer_state(opt, root_rank=0)
X = torch.from_numpy(inp["X"])
Y = X.sum(dim=1, keepdim=True)
for step in range(4):
    opt.zero_grad()
    sl = slice(rank * 8, (rank + 1) * 8)
    torch.nn.functional.mse_loss(model(X[sl]), Y[sl]).backward()
    opt.step()
    res[f"traj{step}"] = torch.cat(
        [p.detach().flatten() for p in model.parameters()]).numpy()
res["momentum"] = torch.cat([opt.state[p]["momentum_buffer"].flatten()
                             for p in model.parameters()]).numpy()

# SyncBatchNorm on this rank's half of a batch of 8.
full = torch.from_numpy(inp["bn_x"])
sl = slice(rank * 4, (rank + 1) * 4)
local = full[sl].clone().requires_grad_()
sbn = hvd.SyncBatchNorm(3, momentum=0.5)
sbn.train()
out = sbn(local)
(out * torch.from_numpy(inp["bn_g"])[sl]).sum().backward()
res["bn_out"] = out.detach().numpy()
res["bn_grad"] = local.grad.numpy()
res["bn_mean"] = sbn.running_mean.numpy()
res["bn_var"] = sbn.running_var.numpy()
res["bn_wgrad"] = sbn.weight.grad.numpy()
res["bn_bgrad"] = sbn.bias.grad.numpy()

if port:
    # The reference binding's worker checks.
    x = torch.arange(10, dtype=torch.float32) * (rank + 1)
    expect = torch.arange(10, dtype=torch.float32) * 3
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, name="w.ar.sum"), expect)
    assert torch.equal(hvd.allreduce(x, name="w.ar.avg"), expect / 2)
    assert torch.equal(hvd.allreduce(x, average=True), expect / 2)
    xi = torch.full((6,), 2 ** 40 + rank, dtype=torch.int64)
    hvd.allreduce_(xi, op=hvd.Sum, name="w.ar.int")
    assert (xi == 2 ** 41 + 1).all(), xi
    xm = torch.full((3,), float(rank))
    assert (hvd.allreduce(xm, op=hvd.Max) == 1).all()
    assert (hvd.allreduce(xm, op=hvd.Min) == 0).all()
    b = torch.full((5,), float(rank * 100))
    assert torch.equal(hvd.broadcast(b, 1, name="w.bc"),
                       torch.full((5,), 100.0))
    hvd.broadcast_(b, 0)
    assert torch.equal(b, torch.zeros(5))
    g = hvd.allgather(torch.full((rank + 1, 2), float(rank)), name="w.ag")
    assert torch.equal(g, torch.tensor([[0.0, 0], [1, 1], [1, 1]])), g
    t = torch.randn(4, requires_grad=True)
    hvd.allreduce(t, op=hvd.Average, name="w.grad").sum().backward()
    assert torch.equal(t.grad, torch.ones(4)), t.grad
    t = torch.ones(2, 3, requires_grad=True)
    gathered = hvd.allgather(t * (rank + 1))
    (gathered * torch.arange(4.0)[:, None]).sum().backward()
    # Rows 2r and 2r+1 are this rank's; each rank's loss weighs them.
    want = 2 * (rank + 1) * torch.arange(4.0)[2 * rank:2 * rank + 2]
    assert torch.equal(t.grad, want[:, None].expand(2, 3)), t.grad
    t = torch.ones(3, requires_grad=True)
    hvd.broadcast(t * (rank + 1), 1).sum().backward()
    assert torch.equal(t.grad, torch.full((3,), 2.0 * rank * 2)), t.grad
    bf = torch.full((8,), 1 + 2 ** -7, dtype=torch.bfloat16) * (rank + 1)
    sbf = hvd.allreduce(bf, op=hvd.Sum, name="w.bf16")
    assert sbf.dtype == torch.bfloat16
    assert torch.equal(sbf, (torch.full((8,), 1 + 2 ** -7) * 3).bfloat16())
    from horovod_tpu_torch.ops.adasum import adasum_reference
    vecs = [inp["adasum0"], inp["adasum1"]]
    combined = hvd.allreduce(torch.from_numpy(vecs[rank]), op=hvd.Adasum,
                             name="w.adasum")
    np.testing.assert_allclose(combined.numpy(), adasum_reference(vecs),
                               rtol=1e-5)
    obj = {"rank": rank, "data": list(range(rank + 1))}
    assert hvd.broadcast_object(obj, root_rank=1) == \
        {"rank": 1, "data": [0, 1]}
    assert [o["rank"] for o in hvd.allgather_object(obj)] == [0, 1]
    h = hvd.allreduce_async(torch.ones(3), op=hvd.Sum, name="w.async")
    while not hvd.poll(h):
        pass
    assert torch.equal(hvd.synchronize(h), torch.full((3,), 2.0))
    hvd.barrier()
    try:
        hvd.allreduce(torch.ones(2, dtype=torch.complex64))
        raise AssertionError("a complex tensor was taken")
    except ValueError:
        pass
    # backward_passes_per_step=2: the sum of the two passes' gradients,
    # averaged over the ranks.
    model2 = torch.nn.Linear(4, 1, bias=False)
    torch.nn.init.zeros_(model2.weight)
    opt2 = hvd.DistributedOptimizer(
        torch.optim.SGD(model2.parameters(), lr=1.0),
        named_parameters=model2.named_parameters(),
        backward_passes_per_step=2)
    for micro in range(2):
        model2(torch.ones(2, 4) * (rank + micro + 1)).sum().backward()
    opt2.step()
    # Passes sum 2 * (rank + 1 + rank + 2) a column; the mean over ranks
    # is 2 * 4 = 8.
    assert torch.equal(model2.weight, torch.full((1, 4), -8.0)), \
        model2.weight
    opt2.zero_grad()

    # ResNet18 with the batch statistics over dp, and without.
    from horovod_tpu_torch.models.resnet import ResNet18
    from horovod_tpu_torch.training import cross_entropy_loss
    state = torch.load(spec["resnet_state"])
    rx = torch.from_numpy(inp["rx"])[rank * 2:(rank + 1) * 2]
    ry = torch.from_numpy(inp["ry"])[rank * 2:(rank + 1) * 2]
    for axis in ("dp", None):
        m = ResNet18(num_classes=10, dtype=torch.float32, num_filters=8,
                     sync_bn_axis=axis, device="cpu")
        m.load_state_dict(state)
        m.train()
        loss = cross_entropy_loss(m(rx), ry).detach()
        res[f"resnet_{axis}"] = hvd.allreduce(loss, op=hvd.Average).numpy()

hvd.shutdown()
np.savez(sys.argv[3 + rank], **res)
"""


def _dense_resnet(x, y):
    """flax's ResNet18 (PRNGKey(0)) full-batch training-mode loss and its
    variables, the oracle of ``tests/test_models.py``."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.resnet import ResNet18
    from horovod_tpu.training import cross_entropy_loss

    model = ResNet18(num_classes=10, dtype=jnp.float32, num_filters=8)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                   train=False)
    logits, _ = model.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    return float(cross_entropy_loss(logits, jnp.asarray(y))), \
        jax.device_get(v)


def test_two_rank_binding_against_reference_and_oracles(tmp_path):
    from horovod_tpu_torch.models.image_layers import params_from_jax

    rng = np.random.RandomState(0)
    rx = np.concatenate([rng.rand(2, 32, 32, 3).astype(np.float32) + 3.0 * d
                         for d in range(2)])
    ry = rng.randint(0, 10, size=(4,)).astype(np.int64)
    expected, variables = _dense_resnet(rx, ry.astype(np.int32))
    state_path = tmp_path / "resnet18.pt"
    torch.save(params_from_jax(variables), state_path)
    inputs = {"X": rng.randn(16, 6).astype(np.float32),
              "bn_x": rng.randn(8, 3, 5).astype(np.float32),
              "bn_g": rng.randn(8, 3, 5).astype(np.float32),
              "adasum0": rng.randn(17).astype(np.float32),
              "adasum1": rng.randn(17).astype(np.float32),
              "rx": rx, "ry": ry}
    worlds = {}
    for binding in ("port", "reference"):
        d = tmp_path / binding
        d.mkdir()
        worlds[binding] = torch_worlds.launch(
            WORKER, 2, d, {"binding": binding,
                           "resnet_state": str(state_path)}, inputs)
    port = worlds["port"].results()
    ref = worlds["reference"].results()

    # The optimizer's trajectory and state, port against reference.
    for r in range(2):
        for step in range(4):
            np.testing.assert_allclose(port[r][f"traj{step}"],
                                       ref[r][f"traj{step}"], atol=1e-6)
        np.testing.assert_allclose(port[r]["momentum"], ref[r]["momentum"],
                                   atol=1e-6)
        np.testing.assert_array_equal(port[r]["traj3"], port[0]["traj3"])

    # SyncBatchNorm against full-batch batch norm and the reference's.
    full = torch.from_numpy(inputs["bn_x"]).requires_grad_()
    bn = torch.nn.BatchNorm1d(3, momentum=0.5)
    out = bn(full)
    (out * torch.from_numpy(inputs["bn_g"])).sum().backward()
    for r in range(2):
        sl = slice(r * 4, (r + 1) * 4)
        p = port[r]
        np.testing.assert_allclose(p["bn_out"], out.detach()[sl].numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(p["bn_mean"], bn.running_mean.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(p["bn_var"], bn.running_var.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(p["bn_grad"], full.grad[sl].numpy(),
                                   atol=1e-5)
        for key in ("bn_out", "bn_grad", "bn_mean", "bn_var", "bn_wgrad",
                    "bn_bgrad"):
            np.testing.assert_allclose(p[key], ref[r][key], atol=1e-6)

    # sync_bn_axis against the dense full-batch oracle, and the control.
    synced = float(port[0]["resnet_dp"])
    local = float(port[0]["resnet_None"])
    assert synced == float(port[1]["resnet_dp"])
    assert synced == pytest.approx(expected, rel=1e-4), (synced, expected)
    assert abs(local - expected) > 1e-3, (local, expected)


# ---- size 1 ---------------------------------------------------------------


@pytest.fixture
def thvd():
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_init_rank_size(thvd):
    assert (thvd.rank(), thvd.size(), thvd.local_rank()) == (0, 1, 0)
    assert (thvd.cross_rank(), thvd.cross_size()) == (0, 1)
    assert thvd.is_initialized()


def test_allreduce_size1(thvd):
    x = torch.arange(10, dtype=torch.float32)
    assert torch.equal(thvd.allreduce(x, op=thvd.Average), x)
    assert torch.equal(thvd.allreduce(x, op=thvd.Sum, prescale_factor=2.0),
                       2 * x)


def test_allreduce_inplace_size1(thvd):
    x = torch.ones(5)
    out = thvd.allreduce_(x, op=thvd.Sum)
    assert out is x and torch.equal(x, torch.ones(5))


def test_allgather_size1(thvd):
    x = torch.randn(4, 3)
    assert torch.equal(thvd.allgather(x), x)


def test_broadcast_size1(thvd):
    x = torch.randn(7)
    assert torch.equal(thvd.broadcast(x, 0), x)
    with pytest.raises(ValueError):
        thvd.broadcast(x, 3)


def test_async_poll_synchronize(thvd):
    x = torch.ones(4)
    h = thvd.allreduce_async(x, op=thvd.Sum)
    while not thvd.poll(h):
        pass
    assert torch.equal(thvd.synchronize(h), x)
    with pytest.raises(ValueError):
        thvd.synchronize(h)


def test_allreduce_grad(thvd):
    x = torch.randn(6, requires_grad=True)
    thvd.allreduce(x, op=thvd.Average).sum().backward()
    assert torch.equal(x.grad, torch.ones(6))


def test_compression_fp16_roundtrip(thvd):
    from horovod_tpu_torch.torch.compression import Compression

    x = torch.randn(32)
    c, ctx = Compression.fp16.compress(x)
    assert c.dtype == torch.float16
    out = Compression.fp16.decompress(c, ctx)
    assert out.dtype == torch.float32
    assert torch.allclose(out, x, atol=1e-2)
    y = thvd.allreduce(x, op=thvd.Sum, compression=Compression.fp16)
    assert y.dtype == torch.float32 and torch.equal(y, out)


def test_unsupported_device_and_dtype(thvd):
    with pytest.raises(ValueError, match="dtype"):
        thvd.allreduce(torch.ones(3, dtype=torch.complex64))
    # A tensor never moves to the world's device.
    with pytest.raises(ValueError, match="meta"):
        thvd.allreduce(torch.ones(3, device="meta"))


def test_distributed_optimizer_trains(thvd):
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 1))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    x = torch.randn(32, 8)
    y = x.sum(dim=1, keepdim=True)
    losses = []
    for _ in range(12):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.7


def test_optimizer_zero_grad_guard(thvd):
    model = torch.nn.Linear(4, 1)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    model(torch.randn(2, 4)).sum().backward()
    opt.zero_grad()
    with pytest.raises(ValueError, match="not named"):
        thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[("w", model.weight)])


def test_broadcast_object_size1(thvd):
    obj = {"a": 1, "b": [2, 3]}
    assert thvd.broadcast_object(obj, 0) == obj
    assert thvd.allgather_object(obj) == [obj]


def test_broadcast_parameters_size1(thvd):
    model = torch.nn.Linear(4, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.Adam(model.parameters())
    thvd.broadcast_optimizer_state(opt, root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(ValueError, match="LBFGS"):
        thvd.broadcast_optimizer_state(
            torch.optim.LBFGS(model.parameters()), root_rank=0)


def test_sync_batch_norm_size1_falls_back(thvd):
    bn = thvd.SyncBatchNorm(3)
    ref = torch.nn.BatchNorm1d(3)
    x = torch.randn(4, 3, 5)
    assert torch.allclose(bn(x), ref(x), atol=1e-5)
    assert torch.allclose(bn.running_var, ref.running_var)


def test_elastic_torch_state_commit_restore(thvd):
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(1, 2)).sum().backward()
    opt.step()
    state = thvd.elastic.TorchState(model=model, optimizer=opt, batch=5)
    weight = model.weight.detach().clone()
    buf = opt.state[model.weight]["momentum_buffer"].clone()
    state.commit()
    assert state._saved_model_state["weight"].device.type == "cpu"
    with torch.no_grad():
        model.weight.add_(1.0)
        opt.state[model.weight]["momentum_buffer"].add_(1.0)
    state.batch = 99
    state.restore()
    assert state.batch == 5
    assert torch.equal(model.weight, weight)
    assert torch.equal(opt.state[model.weight]["momentum_buffer"], buf)


EXAMPLE_WORKER = r"""
import os, sys
import numpy as np
from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as ex
rank = int(os.environ["HOROVOD_RANK"])
img = ex.main(["--no-cuda", "--batch-size", "2", "--image-size", "32",
               "--num-classes", "10", "--num-warmup-batches", "1",
               "--num-batches-per-iter", "1", "--num-iters", "2"])
np.savez(sys.argv[3 + rank], img=np.array(img))
"""


def test_synthetic_benchmark_example_at_two_ranks(tmp_path):
    """The port's copy of the example, ``--no-cuda``, in a 2-rank gloo
    world: both ranks finish and report a rate."""
    res = torch_worlds.launch(EXAMPLE_WORKER, 2, tmp_path, {}, {}).results()
    for r in res:
        assert r["img"].shape == (2,) and np.all(r["img"] > 0)
