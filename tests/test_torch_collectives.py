"""The port's collectives and DistributedOptimizer.

A 2-rank gloo world (two subprocesses) runs ``grouped_allreduce`` on
per-rank inputs made from a numpy seed; the JAX package's
``ops/xla.grouped_allreduce`` runs under ``shard_map`` on 2 of the 8 CPU
devices with the same inputs. Two-rank sums round once on both sides, so
the results must be bitwise equal. The optimizer tests run in a size-1
gloo world inside the test process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.ops import xla
from horovod_tpu_torch.ops import collectives as coll

from torch_worlds import free_port_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(5, 3), (7,), (4, 4)]
CASES = [
    dict(op=coll.Sum, dtype="float32", pre=0.5, post=3.0, cap=None,
         comp=None),
    dict(op=coll.Average, dtype="bfloat16", pre=1.0, post=1.0, cap=64,
         comp=None),
    dict(op=coll.Average, dtype="float32", pre=2.0, post=1.0, cap=None,
         comp="fp16"),
    dict(op=coll.Sum, dtype="float32", pre=1.0, post=0.25, cap=100,
         comp="bf16"),
    dict(op=coll.Average, dtype="float16", pre=1.0, post=1.0, cap=None,
         comp=None),
    dict(op=coll.Average, dtype="bfloat16", pre=0.5, post=4.0, cap=None,
         comp="bf16"),
    dict(op=coll.Max, dtype="float32", pre=1.0, post=1.0, cap=None,
         comp=None),
    dict(op=coll.Sum, dtype="int32", pre=1.0, post=1.0, cap=48, comp=None),
]
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16, "int32": jnp.int32}

WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collectives

cases = json.loads(sys.argv[1])
inputs = np.load(sys.argv[2])
hvd.init(device="cpu")
r = hvd.rank()
res = {}
for ci, c in enumerate(cases):
    ts = [torch.from_numpy(inputs[f"r{r}_{i}"]).to(getattr(torch, c["dtype"]))
          for i in range(len(inputs.files) // 2)]
    outs = collectives.grouped_allreduce(
        ts, op=c["op"], prescale_factor=c["pre"], postscale_factor=c["post"],
        bucket_cap_bytes=c["cap"], compression=c["comp"])
    for i, o in enumerate(outs):
        assert o.dtype == ts[i].dtype and o.shape == ts[i].shape
        res[f"c{ci}_{i}"] = o.double().numpy()
    assert all(torch.equal(t, torch.from_numpy(inputs[f"r{r}_{i}"]).to(
        t.dtype)) for i, t in enumerate(ts)), "input modified"
res["bcast"] = collectives.broadcast(torch.full((3,), float(r)),
                                    root_rank=1).numpy()
model = torch.nn.Linear(3, 2)
with torch.no_grad():
    for p in model.parameters():
        p.fill_(float(r + 1))
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
res["bparams"] = torch.cat([p.detach().reshape(-1)
                            for p in model.parameters()]).numpy()
res["single"] = collectives.allreduce(torch.tensor([r + 1.0])).numpy()
lin = torch.nn.Linear(4, 3)
with torch.no_grad():
    for p in lin.parameters():
        p.fill_(1.0)
opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                               named_parameters=lin.named_parameters(),
                               bucket_cap_bytes=16)
lin(torch.full((1, 4), float(r + 1))).sum().backward()
opt.step()
res["opt"] = torch.cat([p.detach().reshape(-1)
                        for p in lin.parameters()]).numpy()
res["opt_buckets"] = np.array([opt.allreduce_count])
np.savez(sys.argv[3 + r], **res)
hvd.shutdown()
"""


def _inputs():
    rng = np.random.RandomState(0)
    return {f"r{r}_{i}": (rng.randn(*s) * 3).astype(np.float32)
            for r in range(2) for i, s in enumerate(SHAPES)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the 2-rank gloo world once; returns each rank's results."""
    tmp = tmp_path_factory.mktemp("torch_world")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **_inputs())
    outs = [tmp / f"rank{r}.npz" for r in range(2)]
    port = free_port_pair()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(CASES), str(inputs),
             *map(str, outs)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs]


def _jax_grouped(case):
    """The JAX package's grouped_allreduce on 2 CPU devices."""
    inputs = _inputs()
    n = len(SHAPES)
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    dt = _JDT[case["dtype"]]
    stacked = [jax.device_put(
        jnp.stack([jnp.asarray(inputs[f"r{r}_{i}"], dt) for r in range(2)]),
        NamedSharding(mesh, P("hvd"))) for i in range(n)]

    def fn(*xs):
        outs = xla.grouped_allreduce(
            [x[0] for x in xs], axis_name="hvd", op=case["op"],
            prescale_factor=case["pre"], postscale_factor=case["post"],
            bucket_cap_bytes=case["cap"], compression=case["comp"])
        return tuple(o[None] for o in outs)

    prog = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("hvd"),) * n,
                                 out_specs=(P("hvd"),) * n, check_vma=False))
    return [np.asarray(o, np.float64) for o in prog(*stacked)]


@pytest.mark.parametrize("ci", range(len(CASES)),
                         ids=[f"{c['op']}-{c['dtype']}-{c['comp']}-"
                              f"cap{c['cap']}" for c in CASES])
def test_grouped_allreduce_matches_jax(world, ci):
    want = _jax_grouped(CASES[ci])
    for r in range(2):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(
                world[r][f"c{ci}_{i}"], w[r],
                err_msg=f"case {CASES[ci]} rank {r} tensor {i}")


def test_broadcast_and_single_allreduce(world):
    """broadcast, broadcast_parameters (in place, from root 0) and the
    default Average of a single tensor."""
    for r in range(2):
        np.testing.assert_array_equal(world[r]["bcast"], np.ones(3))
        np.testing.assert_array_equal(world[r]["single"], [1.5])
        np.testing.assert_array_equal(world[r]["bparams"], np.ones(8))


def test_optimizer_averages_gradients_across_ranks(world):
    """SGD(lr=1) through DistributedOptimizer on 2 ranks: rank r's weight
    gradient is r + 1 everywhere and its bias gradient 1, so every rank
    steps by the mean, 1.5 and 1; a 16-byte cap gives W and b a bucket
    each."""
    for r in range(2):
        np.testing.assert_array_equal(world[r]["opt"],
                                      [-0.5] * 12 + [0.0] * 3)
        assert world[r]["opt_buckets"][0] == 2


# ---- size-1 world in this process ------------------------------------------


@pytest.fixture
def hvd_cpu():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _model(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return model


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(6, 8, generator=g), torch.randn(6, 4, generator=g)


@pytest.mark.parametrize("cap", [None, 64])
def test_optimizer_matches_plain_adamw_at_size_one(hvd_cpu, cap):
    ref, dist_model = _model(), _model()
    x, y = _batch()
    plain = torch.optim.AdamW(ref.parameters(), lr=1e-2, weight_decay=1e-4)
    opt = hvd_cpu.DistributedOptimizer(
        torch.optim.AdamW(dist_model.parameters(), lr=1e-2,
                          weight_decay=1e-4),
        named_parameters=dist_model.named_parameters(), bucket_cap_bytes=cap)
    for _ in range(3):
        for model, o in ((ref, plain), (dist_model, opt)):
            o.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            o.step()
    for a, b in zip(ref.parameters(), dist_model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert opt.allreduce_count == 3 * len(opt._buckets)


def test_buckets_launch_during_backward(hvd_cpu):
    """With a small cap every bucket's all-reduce is launched from the
    gradient hooks, before step() is called."""
    model = _model()
    opt = hvd_cpu.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), bucket_cap_bytes=64)
    x, y = _batch()
    torch.nn.functional.mse_loss(model(x), y).backward()
    assert len(opt._buckets) > 1
    assert opt.allreduce_count == len(opt._buckets)
    with pytest.raises(RuntimeError, match="zero_grad"):
        opt.zero_grad()
    opt.step()
    opt.zero_grad()


def test_unused_parameter_gets_a_zero_gradient(hvd_cpu):
    model = _model()
    extra = torch.nn.Parameter(torch.ones(3))
    opt = hvd_cpu.DistributedOptimizer(
        torch.optim.SGD([*model.parameters(), extra], lr=0.1))
    x, y = _batch()
    torch.nn.functional.mse_loss(model(x), y).backward()
    opt.step()
    assert torch.equal(extra.grad, torch.zeros(3))
    assert torch.equal(extra.data, torch.ones(3))


def test_later_slice_options_raise(hvd_cpu):
    model = _model()
    # op=Adasum is the delta optimizer now; the options it cannot take
    # still raise.
    with pytest.raises(ValueError, match="gradient_predivide_factor"):
        hvd_cpu.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), op=hvd_cpu.Adasum,
            gradient_predivide_factor=2.0)
    with pytest.raises(ValueError, match="error-feedback"):
        hvd_cpu.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), op=hvd_cpu.Adasum,
            compression="ef16")
    with pytest.raises(ValueError, match="op=Adasum"):
        hvd_cpu.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), op=hvd_cpu.Max)
    with pytest.raises(ValueError, match="not named"):
        hvd_cpu.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=list(model.named_parameters())[:1])
