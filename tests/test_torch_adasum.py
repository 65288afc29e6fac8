"""The port's Adasum (``horovod_tpu_torch/ops/adasum.py``, the Adasum
branches of the collectives and ``DistributedOptimizer(op=Adasum)``)
against the NumPy oracles and the JAX package's ``ops/adasum`` on a CPU
mesh.

One 4-rank gloo world, laid out as 2 hosts of 2 (cross-major), runs:

- flat Adasum over the world of fp32 vectors (and of bf16 ones, combined
  in fp32) and grouped Adasum of three tensors of different shapes, each
  with its own coefficients, directly and through ``allreduce`` /
  ``grouped_allreduce`` (``op=Adasum``, with a cap that splits the group
  and scale factors);
- hierarchical Adasum (plain sum within a host, Adasum across) of one
  tensor and of a group whose fused length leaves padding, directly and
  through ``grouped_hierarchical_allreduce``;
- two steps of ``DistributedOptimizer(SGD(lr=0.1, momentum=0.9),
  op=Adasum)`` on a small linear model, each rank on its own batch.

Tolerances: fp32 against the float64 oracles and against JAX at rtol 1e-6
(atol 1e-7 of the output's scale: elements near zero carry the
summation-order rounding of the large ones); the bf16 input at one bf16
rounding of the output (rtol 2**-8, and atol 2**-8 of its largest
element), against the oracle on the bf16-rounded inputs. The delta optimizer is held to the
reference's torch binding semantics (``horovod_tpu/torch/optimizer.py``:
each rank's optimizer steps on its own gradients, the deltas are
Adasum-combined, the result added to the start) emulated here rank by
rank with ``adasum_reference``. Every rank ends bitwise equal to the
others. A non-power-of-two size raises before any exchange, as the
reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common.state import AXIS_CROSS, AXIS_LOCAL
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu_torch.ops import adasum as tadasum

import torch_worlds

SIZE, LOCAL = 4, 2
SHAPES = [(7,), (3, 5), (2, 2, 3)]   # 34 elements: padding at local 2 is 0
HSHAPES = [(5,), (2, 3)]             # 11 elements: one element of padding
RTOL = 1e-6
LR, STEPS = 0.1, 2

WORKER = torch_worlds.WORLD_PRELUDE + r"""
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum, collectives

hvd.init(device="cpu")
t = lambda k: torch.from_numpy(inp[k])
v = t(f"v{rank}")
res["flat"] = adasum.adasum_allreduce(v).numpy()
res["flat-bf16"] = adasum.adasum_allreduce(v.bfloat16()).float().numpy()
res["op-flat"] = collectives.allreduce(v, op=hvd.Adasum).numpy()
group = [t(f"g{rank}_{i}") for i in range(spec["n_group"])]
for i, o in enumerate(adasum.grouped_adasum_allreduce(group)):
    res[f"grouped/{i}"] = o.numpy()
for i, o in enumerate(collectives.grouped_allreduce(
        group, op=hvd.Adasum, bucket_cap_bytes=64, prescale_factor=0.5,
        postscale_factor=3.0)):
    res[f"op-grouped/{i}"] = o.numpy()
res["hier"] = adasum.hierarchical_adasum_allreduce(v).numpy()
hgroup = [t(f"h{rank}_{i}") for i in range(spec["n_hgroup"])]
for i, o in enumerate(adasum.grouped_hierarchical_adasum_allreduce(hgroup)):
    res[f"hgrouped/{i}"] = o.numpy()
for i, o in enumerate(hvd.grouped_hierarchical_allreduce(hgroup,
                                                         op=hvd.Adasum)):
    res[f"op-hgrouped/{i}"] = o.numpy()

model = torch.nn.Linear(6, 3)
with torch.no_grad():
    model.weight.copy_(t("w0"))
    model.bias.copy_(t("b0"))
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=spec["lr"], momentum=0.9),
    op=hvd.Adasum, compression="none")
for s in range(spec["steps"]):
    opt.zero_grad()
    loss = ((model(t(f"x{rank}_{s}")) - t(f"y{rank}_{s}")) ** 2).mean()
    loss.backward()
    opt.step()
res["opt/weight"] = model.weight.detach().numpy()
res["opt/bias"] = model.bias.detach().numpy()
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


def _inputs():
    rng = np.random.RandomState(0)
    x = {}
    for r in range(SIZE):
        x[f"v{r}"] = rng.randn(37).astype(np.float32)
        for i, s in enumerate(SHAPES):
            x[f"g{r}_{i}"] = (rng.randn(*s) * (i + 1)).astype(np.float32)
        for i, s in enumerate(HSHAPES):
            x[f"h{r}_{i}"] = rng.randn(*s).astype(np.float32)
        for s in range(STEPS):
            x[f"x{r}_{s}"] = rng.randn(5, 6).astype(np.float32)
            x[f"y{r}_{s}"] = rng.randn(5, 3).astype(np.float32)
    x["w0"] = (rng.randn(3, 6) * 0.3).astype(np.float32)
    x["b0"] = (rng.randn(3) * 0.1).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.launch(
        WORKER, SIZE, tmp_path_factory.mktemp("adasum"),
        {"n_group": len(SHAPES), "n_hgroup": len(HSHAPES), "lr": LR,
         "steps": STEPS}, _inputs(), local_size=LOCAL).results()


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-7 * np.abs(want).max(), err_msg=what)


def _same_on_every_rank(world, key):
    for res in world[1:]:
        np.testing.assert_array_equal(res[key], world[0][key], err_msg=key)


def _per_device(fn, mesh, spec, *stacked):
    wrapped = jax.shard_map(
        lambda *xs: tuple(o[None] for o in fn(*(x[0] for x in xs))),
        mesh=mesh, in_specs=(spec,) * len(stacked), out_specs=spec,
        check_vma=False)
    return [np.asarray(o) for o in jax.jit(wrapped)(*stacked)]


def _stack(x, fmt, n=SIZE):
    return jnp.stack([jnp.asarray(x[fmt.format(r)]) for r in range(n)])


def test_flat_matches_the_oracle_and_jax(world):
    x = _inputs()
    vs = [x[f"v{r}"] for r in range(SIZE)]
    want = tadasum.adasum_reference(vs)
    np.testing.assert_array_equal(want, jadasum.adasum_reference(vs))
    want16 = tadasum.adasum_reference([
        torch.from_numpy(v).bfloat16().float().numpy() for v in vs])
    mesh = Mesh(np.array(jax.devices()[:SIZE]), ("hvd",))
    (jax_out,) = _per_device(
        lambda v: (jadasum.adasum_allreduce(v, "hvd"),), mesh, P("hvd"),
        _stack(x, "v{}"))
    for r, res in enumerate(world):
        _close(res["flat"], want, what=f"rank {r}")
        _close(res["flat"], jax_out[r], what=f"rank {r} vs jax")
        np.testing.assert_array_equal(res["op-flat"], res["flat"])
        np.testing.assert_allclose(
            res["flat-bf16"], want16, rtol=2 ** -8,
            atol=2 ** -8 * np.abs(want16).max(), err_msg=f"bf16 rank {r}")
    _same_on_every_rank(world, "flat")


def test_grouped_keeps_per_tensor_coefficients(world):
    x = _inputs()
    mesh = Mesh(np.array(jax.devices()[:SIZE]), ("hvd",))
    jax_out = _per_device(
        lambda *ts: jadasum.grouped_adasum_allreduce(list(ts), "hvd"), mesh,
        P("hvd"), *[_stack(x, "g{}_" + str(i)) for i in range(len(SHAPES))])
    for i in range(len(SHAPES)):
        group = [x[f"g{r}_{i}"] for r in range(SIZE)]
        want = tadasum.adasum_reference(group)
        # Scaled before and after, per tensor; Adasum is scale-invariant
        # in the coefficients, linear in the result.
        scaled = tadasum.adasum_reference([g * 0.5 for g in group]) * 3.0
        for r, res in enumerate(world):
            _close(res[f"grouped/{i}"], want, what=f"tensor {i} rank {r}")
            _close(res[f"grouped/{i}"], jax_out[i][r],
                   what=f"tensor {i} rank {r} vs jax")
            _close(res[f"op-grouped/{i}"], scaled,
                   what=f"op tensor {i} rank {r}")
        _same_on_every_rank(world, f"grouped/{i}")
    # The coefficients are the tensor's own: the fused vector's would
    # give another result.
    fused = tadasum.adasum_reference([
        np.concatenate([x[f"g{r}_{i}"].ravel() for i in range(len(SHAPES))])
        for r in range(SIZE)])
    assert not np.allclose(fused[:7], world[0]["grouped/0"], rtol=1e-3)


def test_hierarchical_sums_each_host_then_adasums_across(world):
    x = _inputs()
    mesh = Mesh(np.array(jax.devices()[:SIZE]).reshape(2, 2),
                (AXIS_CROSS, AXIS_LOCAL))
    spec = P((AXIS_CROSS, AXIS_LOCAL))
    (jax_one,) = _per_device(
        lambda v: (jadasum.hierarchical_adasum_allreduce(v),), mesh, spec,
        _stack(x, "v{}"))
    jax_group = _per_device(
        lambda *ts: jadasum.grouped_hierarchical_adasum_allreduce(list(ts)),
        mesh, spec, *[_stack(x, "h{}_" + str(i))
                      for i in range(len(HSHAPES))])
    want = tadasum.hierarchical_adasum_reference(
        [x[f"v{r}"] for r in range(SIZE)], LOCAL)
    assert not np.allclose(want, tadasum.adasum_reference(
        [x[f"v{r}"] for r in range(SIZE)]), rtol=1e-2)
    for r, res in enumerate(world):
        _close(res["hier"], want, what=f"rank {r}")
        _close(res["hier"], jax_one[r], what=f"rank {r} vs jax")
        for i in range(len(HSHAPES)):
            w = tadasum.hierarchical_adasum_reference(
                [x[f"h{q}_{i}"] for q in range(SIZE)], LOCAL)
            _close(res[f"hgrouped/{i}"], w, what=f"tensor {i} rank {r}")
            _close(res[f"hgrouped/{i}"], jax_group[i][r],
                   what=f"tensor {i} rank {r} vs jax")
            np.testing.assert_array_equal(res[f"op-hgrouped/{i}"],
                                          res[f"hgrouped/{i}"])
    _same_on_every_rank(world, "hier")


def test_delta_optimizer_follows_the_torch_binding(world):
    """Each rank's SGD-momentum steps on its own batch; the deltas are
    combined by Adasum per tensor and added to the start."""
    x = _inputs()
    models, opts = [], []
    for r in range(SIZE):
        m = torch.nn.Linear(6, 3)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(x["w0"]))
            m.bias.copy_(torch.from_numpy(x["b0"]))
        models.append(m)
        opts.append(torch.optim.SGD(m.parameters(), lr=LR, momentum=0.9))
    for s in range(STEPS):
        starts = [[p.detach().clone() for p in m.parameters()]
                  for m in models]
        for r, (m, o) in enumerate(zip(models, opts)):
            o.zero_grad()
            loss = ((m(torch.from_numpy(x[f"x{r}_{s}"]))
                     - torch.from_numpy(x[f"y{r}_{s}"])) ** 2).mean()
            loss.backward()
            o.step()
        for i in range(2):
            deltas = [(list(m.parameters())[i] - starts[r][i]).detach()
                      .numpy() for r, m in enumerate(models)]
            combined = tadasum.adasum_reference(deltas)
            for r, m in enumerate(models):
                with torch.no_grad():
                    list(m.parameters())[i].copy_(torch.from_numpy(
                        (starts[r][i].numpy() + combined).astype(
                            np.float32)))
    for r, res in enumerate(world):
        _close(res["opt/weight"], models[0].weight.detach().numpy(),
               rtol=1e-5, what=f"weight rank {r}")
        _close(res["opt/bias"], models[0].bias.detach().numpy(),
               rtol=1e-5, what=f"bias rank {r}")
    _same_on_every_rank(world, "opt/weight")
    assert not np.allclose(world[0]["opt/weight"], x["w0"])


def test_a_non_power_of_two_size_raises():
    from horovod_tpu_torch.parallel.mesh import AxisGroup

    three = AxisGroup(None, (0, 1, 2), 0)
    v = torch.ones(4)
    with pytest.raises(ValueError, match="power-of-two"):
        tadasum.adasum_allreduce(v, three)
    with pytest.raises(ValueError, match="power-of-two"):
        tadasum.grouped_adasum_allreduce([v], three)
    mesh = Mesh(np.array(jax.devices()[:3]), ("hvd",))
    with pytest.raises(ValueError, match="power-of-two"):
        _per_device(lambda t: (jadasum.adasum_allreduce(t, "hvd"),), mesh,
                    P("hvd"), jnp.ones((3, 4)))
    with pytest.raises(AssertionError):
        tadasum.adasum_reference([v.numpy()] * 3)
