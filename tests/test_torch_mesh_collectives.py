"""The rest of the port's collectives, its local/cross topology and its
optimizer's options, against the JAX package.

- A 4-rank gloo world laid out as 2 hosts of 2 (``HOROVOD_LOCAL_SIZE=2``):
  the local and cross groups follow ``rank = cross * 2 + local``, the
  rows and columns of JAX's hierarchical ``(dcn, ici)`` mesh; ``allgather``,
  ``reducescatter`` (Sum and Average), ``alltoall`` and ``barrier``
  against ``ops/xla`` on a 4-device ``hvd`` mesh; ``hierarchical_allreduce``
  (Sum, Average, pre/postscale, bf16, fp16 and bf16 wire compression, a
  tensor padded to the local size), ``grouped_hierarchical_allreduce``
  and ``hierarchical_allgather`` against ``ops/xla`` on the 2x2 ``(dcn,
  ici)`` mesh of CPU devices.
- A 2-rank world: ``DistributedOptimizer(backward_passes_per_step=2)``,
  plain and ef16, against JAX's ``DistributedOptimizer`` with the same k
  on a 2-device mesh (the port reduces the sum of the k gradients, as the
  torch binding does, and JAX their mean, so the port's loss is scaled by
  1/k); ``gradient_predivide_factor``; ``skip_synchronize`` and the
  warning for a step after a manual ``synchronize``; the torch binding's
  optimizer tests (``tests/test_torch.py``) re-run on the port; and
  ``transformer_bench --tp 2`` (dp=1).
- In the test process: ``transformer_bench --remat`` at width 1.

Tolerances. Hierarchical legs add two values at a time on both sides, so
they must agree bitwise; the 4-rank reductions may add in another order:
fp32 1e-6. The optimizer: 1e-6 after 2 SGD steps at lr 0.1 (the two
sides form the k-step gradient in a different order; ef16 casts it to
fp16, which can move an element by one fp16 step, 1e-5 of the param). The
bench at tp=2 against tp=1 on the same weights and batch runs in bf16,
where a tp rank's partial sums round apart: step-0 loss rel 1e-2.
"""

import json
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import opt as jopt
from horovod_tpu.ops import xla

import torch_worlds

SHAPE = (8, 3)                 # per-rank input of the flat collectives
HIER = {
    "sum-f32": dict(op=1, dtype="float32", pre=1.0, post=1.0, comp=None),
    "avg-f32-scaled": dict(op=0, dtype="float32", pre=0.5, post=3.0,
                           comp=None),
    "avg-bf16": dict(op=0, dtype="bfloat16", pre=1.0, post=1.0, comp=None),
    "sum-f32-fp16wire": dict(op=1, dtype="float32", pre=1.0, post=1.0,
                             comp="fp16"),
    "avg-bf16-bf16wire": dict(op=0, dtype="bfloat16", pre=2.0, post=1.0,
                              comp="bf16"),
}
HSHAPE = (5, 3)                # 15 elements: padded to a multiple of 2
GROUPED = [(5, 3), (7,), (4, 4)]
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

WORKER4 = torch_worlds.WORLD_PRELUDE + r"""
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collectives

hvd.init(device="cpu")
res["topo"] = np.array([hvd.rank(), hvd.local_rank(), hvd.local_size(),
                        hvd.cross_rank(), hvd.cross_size()])
res["local"] = np.array(hvd.axis_group("local").ranks)
res["cross"] = np.array(hvd.axis_group("cross").ranks)
x = torch.from_numpy(inp[f"x{rank}"])
res["allgather"] = collectives.allgather(x).numpy()
res["reducescatter-sum"] = collectives.reducescatter(x, op=hvd.Sum).numpy()
res["reducescatter-avg"] = collectives.reducescatter(x, op=hvd.Average).numpy()
res["alltoall"] = collectives.alltoall(x).numpy()
res["barrier"] = collectives.barrier().numpy()
res["hier-allgather"] = hvd.hierarchical_allgather(x).numpy()
for n, c in spec["hier"].items():
    t = torch.from_numpy(inp[f"h{rank}"]).to(getattr(torch, c["dtype"]))
    out = hvd.hierarchical_allreduce(t, op=c["op"], prescale_factor=c["pre"],
                                     postscale_factor=c["post"],
                                     compression=c["comp"])
    assert out.dtype == t.dtype and out.shape == t.shape
    res[f"hier/{n}"] = out.double().numpy()
for comp in (None, "fp16"):
    ts = [torch.from_numpy(inp[f"g{rank}_{i}"]) for i in range(3)]
    outs = hvd.grouped_hierarchical_allreduce(ts, op=hvd.Average,
                                              bucket_cap_bytes=64,
                                              compression=comp)
    for i, o in enumerate(outs):
        res[f"grouped/{comp}/{i}"] = o.numpy()
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE

WORKER2 = torch_worlds.WORLD_PRELUDE + r"""
import warnings
import horovod_tpu_torch as hvd
from horovod_tpu_torch import transformer_bench

hvd.init(device="cpu")


def mlp():
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(inp[f"param/{name}"]))
    return model


def flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def data(step, micro):
    return (torch.from_numpy(inp[f"x/{rank}/{step}/{micro}"]),
            torch.from_numpy(inp[f"y/{rank}/{step}/{micro}"]))


mse = torch.nn.functional.mse_loss
for mode in ("none", "ef16"):
    model = mlp()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), compression=mode,
        backward_passes_per_step=2)
    launched = []
    for step in range(2):
        for micro in range(2):
            x, y = data(step, micro)
            (mse(model(x), y) / 2).backward()
            launched.append(opt.allreduce_count)
        opt.step()
        opt.zero_grad()
    res[f"k2/{mode}"] = flat(model).numpy()
    res[f"k2/{mode}/launched"] = np.array(launched)

# A third backward before step() is refused.
model = mlp()
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               backward_passes_per_step=2)
x, y = data(0, 0)
for i in range(3):
    try:
        mse(model(x), y).backward()
    except RuntimeError as e:
        res["k2/refused"] = np.array([i, "backward_passes_per_step" in str(e)])
        break
opt.synchronize()

# Predivide moves the division around the sum; the result is the average.
grads = {}
for f in (1.0, 4.0):
    model = mlp()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        gradient_predivide_factor=f)
    mse(model(x), y).backward()
    opt.synchronize()
    grads[f] = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
res["predivide"] = torch.stack([grads[1.0], grads[4.0]]).numpy()
try:
    hvd.DistributedOptimizer(torch.optim.SGD(mlp().parameters(), lr=0.1),
                             op=hvd.Sum, gradient_predivide_factor=2.0)
except ValueError as e:
    res["predivide/refused"] = np.array(str(e))

# skip_synchronize: a manual synchronize, then step() inside the context,
# reduces once and warns not; a bare step() after it warns.
model = mlp()
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
caught = []
for skip in (True, False):
    opt.zero_grad()
    mse(model(x), y).backward()
    opt.synchronize()
    before = opt.allreduce_count
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        if skip:
            with opt.skip_synchronize():
                opt.step()
        else:
            opt.step()
    caught.append([len(w), opt.allreduce_count - before])
res["skip"] = np.array(caught)

# tests/test_torch.py::test_distributed_optimizer_trains on the port.
torch.manual_seed(rank)
model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 1))
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
xs = torch.randn(32, 8)
ys = xs.sum(dim=1, keepdim=True)
losses = []
for _ in range(12):
    opt.zero_grad()
    loss = mse(model(xs), ys)
    loss.backward()
    opt.step()
    losses.append(float(loss))
res["trains"] = np.array(losses)
res["trains/params"] = flat(model).numpy()

# tests/test_torch.py::test_optimizer_zero_grad_guard on the port: the
# guard is armed once a bucket is in flight (at every size on the port).
model = torch.nn.Linear(4, 1)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
model(torch.randn(2, 4)).sum().backward()
try:
    opt.zero_grad()
    res["guard"] = np.array("no error")
except RuntimeError as e:
    res["guard"] = np.array(str(e))
opt.step()
opt.zero_grad()
hvd.shutdown()

run = transformer_bench.run(transformer_bench.parse_args(spec["bench"]))
res["bench/result"] = np.array(json.dumps(run.result))
res["bench/losses"] = np.array(run.losses)
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE

BENCH = ["--device", "cpu", "--d-model", "32", "--n-heads", "2",
         "--n-layers", "2", "--vocab", "64", "--seq-len", "16",
         "--num-warmup", "1", "--num-iters", "2"]


def _inputs4():
    rng = np.random.RandomState(11)
    out = {f"x{r}": rng.randn(*SHAPE).astype(np.float32) for r in range(4)}
    out.update({f"h{r}": (rng.randn(*HSHAPE) * 3).astype(np.float32)
                for r in range(4)})
    out.update({f"g{r}_{i}": rng.randn(*s).astype(np.float32)
                for r in range(4) for i, s in enumerate(GROUPED)})
    return out


def _inputs2():
    rng = np.random.RandomState(12)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    out = {f"param/{n}": rng.randn(*p.shape).astype(np.float32) * 0.5
           for n, p in model.named_parameters()}
    for r in range(2):
        for step in range(2):
            for micro in range(2):
                out[f"x/{r}/{step}/{micro}"] = rng.randn(6, 8).astype(
                    np.float32)
                out[f"y/{r}/{step}/{micro}"] = rng.randn(6, 4).astype(
                    np.float32)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w4 = torch_worlds.launch(WORKER4, 4, tmp_path_factory.mktemp("w4"),
                             {"hier": HIER}, _inputs4(), local_size=2)
    w2 = torch_worlds.launch(WORKER2, 2, tmp_path_factory.mktemp("w2"),
                             {"bench": BENCH + ["--tp", "2"]}, _inputs2())
    return {4: w4.results(), 2: w2.results()}


def _stacked(names, dtype=jnp.float32):
    x = _inputs4()
    return jnp.stack([jnp.asarray(x[n], dtype) for n in names])


def _flat_mesh():
    return Mesh(np.array(jax.devices()[:4]), ("hvd",))


def _hier_mesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                (xla.AXIS_CROSS, xla.AXIS_LOCAL))


def _per_device(fn, mesh, spec, *stacked):
    """``fn`` on each device's row of the stacked inputs; returns the
    stacked per-device outputs."""
    wrapped = jax.shard_map(lambda *xs: fn(*(x[0] for x in xs))[None],
                            mesh=mesh, in_specs=(spec,) * len(stacked),
                            out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(wrapped)(*stacked))


def test_local_and_cross_groups_are_cross_major(worlds):
    """Each rank's local group is its row of JAX's (dcn, ici) mesh and its
    cross group its column; local and cross ranks are the indices there."""
    ids = np.vectorize(lambda d: d.id)(_hier_mesh().devices)
    for r, res in enumerate(worlds[4]):
        c, l = divmod(r, 2)
        np.testing.assert_array_equal(res["topo"], [r, l, 2, c, 2])
        np.testing.assert_array_equal(res["local"], ids[c])
        np.testing.assert_array_equal(res["cross"], ids[:, l])


@pytest.mark.parametrize("name", ["allgather", "alltoall", "barrier"])
def test_flat_collective_matches_jax(worlds, name):
    fns = {"allgather": lambda x: xla.allgather(x, "hvd"),
           "alltoall": lambda x: xla.alltoall(x, "hvd"),
           "barrier": lambda x: xla.barrier("hvd")}
    want = _per_device(fns[name], _flat_mesh(), P("hvd"),
                       _stacked([f"x{r}" for r in range(4)]))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_array_equal(res[name], want[r], err_msg=name)


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_reducescatter_matches_jax(worlds, op):
    jop = xla.ReduceOp.SUM if op == "sum" else xla.ReduceOp.AVERAGE
    want = _per_device(lambda x: xla.reducescatter(x, "hvd", op=jop),
                       _flat_mesh(), P("hvd"),
                       _stacked([f"x{r}" for r in range(4)]))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_allclose(res[f"reducescatter-{op}"], want[r],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(HIER))
def test_hierarchical_allreduce_matches_jax(worlds, name):
    c = HIER[name]
    spec = P((xla.AXIS_CROSS, xla.AXIS_LOCAL))
    want = _per_device(
        lambda x: xla.hierarchical_allreduce(
            x, op=c["op"], prescale_factor=c["pre"],
            postscale_factor=c["post"], compression=c["comp"]),
        _hier_mesh(), spec, _stacked([f"h{r}" for r in range(4)],
                                     _JDT[c["dtype"]]))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_array_equal(res[f"hier/{name}"],
                                      want[r].astype(np.float64),
                                      err_msg=f"{name} rank {r}")


def test_hierarchical_allgather_matches_jax(worlds):
    want = _per_device(xla.hierarchical_allgather, _hier_mesh(),
                       P((xla.AXIS_CROSS, xla.AXIS_LOCAL)),
                       _stacked([f"x{r}" for r in range(4)]))
    for r, res in enumerate(worlds[4]):
        np.testing.assert_array_equal(res["hier-allgather"], want[r])
    # The cross-major layout: the hierarchical gather is the flat one.
    np.testing.assert_array_equal(worlds[4][0]["hier-allgather"],
                                  worlds[4][0]["allgather"])


@pytest.mark.parametrize("comp", [None, "fp16"])
def test_grouped_hierarchical_allreduce_matches_jax(worlds, comp):
    x = _inputs4()
    spec = P((xla.AXIS_CROSS, xla.AXIS_LOCAL))
    stacked = [jnp.stack([jnp.asarray(x[f"g{r}_{i}"]) for r in range(4)])
               for i in range(len(GROUPED))]

    def fn(*xs):
        outs = xla.grouped_hierarchical_allreduce(
            [t[0] for t in xs], op=xla.ReduceOp.AVERAGE, bucket_cap_bytes=64,
            compression=comp)
        return tuple(o[None] for o in outs)

    prog = jax.jit(jax.shard_map(fn, mesh=_hier_mesh(),
                                 in_specs=(spec,) * len(stacked),
                                 out_specs=(spec,) * len(stacked),
                                 check_vma=False))
    want = [np.asarray(o) for o in prog(*stacked)]
    for r, res in enumerate(worlds[4]):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(res[f"grouped/{comp}/{i}"], w[r])


def _jax_k2(mode):
    """JAX's DistributedOptimizer(backward_passes_per_step=2) over SGD(0.1)
    on a 2-device mesh, the same MLP and micro-batches: 4 micro-steps."""
    x = _inputs2()
    params = {n: jnp.asarray(x[f"param/{n}"])
              for n in ("0.weight", "0.bias", "2.weight", "2.bias")}
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    tx = jopt.DistributedOptimizer(
        optax.sgd(0.1), axis_name="hvd", backward_passes_per_step=2,
        compression=None if mode == "none" else mode, bucket_cap_bytes=None)

    def loss(p, xb, yb):
        h = jnp.tanh(xb @ p["0.weight"].T + p["0.bias"])
        return jnp.mean((h @ p["2.weight"].T + p["2.bias"] - yb) ** 2)

    def micro(p, state, xb, yb):
        state = jax.tree_util.tree_map(lambda a: a[0], state)
        g = jax.grad(loss)(p, xb[0], yb[0])
        upd, state = tx.update(g, state, p)
        return (optax.apply_updates(p, upd),
                jax.tree_util.tree_map(lambda a: a[None], state))

    step = jax.jit(jax.shard_map(
        micro, mesh=mesh, in_specs=(P(), P("hvd"), P("hvd"), P("hvd")),
        out_specs=(P(), P("hvd")), check_vma=False))
    state = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]),
                                   tx.init(params))
    for s in range(2):
        for m in range(2):
            xb = jnp.stack([jnp.asarray(x[f"x/{r}/{s}/{m}"]) for r in (0, 1)])
            yb = jnp.stack([jnp.asarray(x[f"y/{r}/{s}/{m}"]) for r in (0, 1)])
            params, state = step(params, state, xb, yb)
    return np.concatenate([np.asarray(params[n]).reshape(-1) for n in
                           ("0.weight", "0.bias", "2.weight", "2.bias")])


@pytest.mark.parametrize("mode", ["none", "ef16"])
def test_backward_passes_per_step_matches_jax(worlds, mode):
    """k=2: the buckets launch on the second backward only, and after two
    steps the parameters are JAX's."""
    want = _jax_k2(mode)
    for res in worlds[2]:
        np.testing.assert_array_equal(res[f"k2/{mode}/launched"],
                                      [0, 1, 1, 2])
        np.testing.assert_allclose(res[f"k2/{mode}"], want, rtol=0,
                                   atol=1e-6 if mode == "none" else 1e-5)


def test_third_backward_pass_is_refused(worlds):
    for res in worlds[2]:
        assert res["k2/refused"].tolist() == [2, 1]   # [pass, named]


def test_gradient_predivide_factor(worlds):
    for res in worlds[2]:
        plain, pre = res["predivide"]
        np.testing.assert_allclose(pre, plain, rtol=1e-6, atol=1e-7)
        assert "predivide" in str(res["predivide/refused"])


def test_skip_synchronize(worlds):
    """[warnings, buckets launched by step()]: inside skip_synchronize
    none of either; a bare step() after a manual synchronize warns and
    reduces again."""
    for res in worlds[2]:
        np.testing.assert_array_equal(res["skip"], [[0, 0], [1, 1]])


def test_distributed_optimizer_trains(worlds):
    losses = [res["trains"] for res in worlds[2]]
    for ls in losses:
        assert ls[-1] < ls[0] * 0.7
    np.testing.assert_array_equal(worlds[2][0]["trains/params"],
                                  worlds[2][1]["trains/params"])


def test_optimizer_zero_grad_guard(worlds):
    for res in worlds[2]:
        assert "before optimizer.step()" in str(res["guard"])


def test_bench_runs_tensor_parallel(worlds):
    """--tp 2 over the 2-rank world (dp=1): both ranks hold the same
    losses, and step 0's is the tp=1 model's on the same weights (the
    seed draws every leaf whole) and batch."""
    from horovod_tpu_torch import transformer_bench

    lines = [json.loads(str(r["bench/result"])) for r in worlds[2]]
    for line in lines:
        assert line["mesh"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 2}
        assert line["global_batch"] == 8
    np.testing.assert_array_equal(worlds[2][0]["bench/losses"],
                                  worlds[2][1]["bench/losses"])
    try:
        run = transformer_bench.run(transformer_bench.parse_args(
            BENCH + ["--batch-size", "8"]))
    finally:
        import horovod_tpu_torch as hvd
        hvd.shutdown()
    assert lines[0]["n_params"] == run.result["n_params"]
    assert worlds[2][0]["bench/losses"][0] == pytest.approx(
        run.losses[0], rel=1e-2)


def test_bench_runs_remat():
    """--remat recomputes every layer in the backward: the same losses,
    step by step, as without it."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import transformer_bench

    losses = {}
    for flags in ([], ["--remat"]):
        try:
            losses[bool(flags)] = transformer_bench.run(
                transformer_bench.parse_args(BENCH + flags)).losses
        finally:
            hvd.shutdown()
    assert losses[True] == losses[False]
    assert all(np.isfinite(losses[True]))


def test_optimizer_scales_are_placement_aware():
    """At size 1 every group is the rank itself; an expert-like parameter
    on the "sp" group and an embedding-like one on "stages" are planned
    into buckets of their own, and the "stages" bucket waits for
    synchronize()."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import REDUCE_ATTR

    hvd.init(device="cpu")
    try:
        a, b, c = (torch.nn.Parameter(torch.ones(3)) for _ in range(3))
        setattr(b, REDUCE_ATTR, "sp")
        setattr(c, REDUCE_ATTR, "stages")
        opt = hvd.DistributedOptimizer(torch.optim.SGD([a, b, c], lr=1.0))
        assert len(opt._buckets) == 3
        (a.sum() + b.sum() + c.sum()).backward()
        assert opt.allreduce_count == 2      # the "stages" bucket waits
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            opt.step()
        assert opt.allreduce_count == 3
        for p in (a, b, c):
            assert torch.equal(p.detach(), torch.zeros(3))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("name", ["data", "stages"])
@pytest.mark.parametrize("sizes", [
    dict(dp=2, pp=2, sp=1, tp=2), dict(dp=2, pp=2, sp=2, tp=1),
    dict(dp=1, pp=2, sp=2, tp=2), dict(dp=2, pp=1, sp=2, tp=2)],
    ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_multi_axis_groups_follow_the_jax_mesh(sizes, name):
    """A data group holds the ranks of one (pp, tp) coordinate of JAX's
    (dp, pp, sp, tp) mesh of CPU devices — the devices ``P("dp", "sp")``
    shards a batch over — and a stages group those of one tp coordinate."""
    from horovod_tpu.parallel.mesh import build_parallel_mesh
    from horovod_tpu_torch.parallel import mesh as tmesh

    axes = tmesh.GROUPS[name]
    ids = np.vectorize(lambda d: d.id)(
        build_parallel_mesh(jax.devices()[:8], **sizes).devices)
    names = ("dp", "pp", "sp", "tp")
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(4) if i not in keep]
    lines = np.transpose(ids, rest + keep).reshape(
        -1, int(np.prod([sizes[a] for a in axes])))
    assert tmesh.axis_ranks(sizes, axes) == [tuple(map(int, l))
                                             for l in lines]
