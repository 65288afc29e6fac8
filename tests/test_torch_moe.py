"""The port's ``moe_layer`` against the JAX package's, experts over 2 ranks.

A 2-rank gloo world runs ``parallel/moe.moe_layer`` with the expert
group spanning both ranks (2 of 4 experts each); JAX runs its
``moe_layer`` under ``shard_map`` on 2 CPU devices (axis "dp") with the
same numpy inputs. At ``capacity_factor`` 1.0 the capacity is
``int(k * T / E)`` slots, so tokens ARE dropped (the test checks that
some are), and at 8.0 none is. Compared: the output, the aux loss, and
the gradients of ``sum(y * ct) + aux`` (the aux term from rank 0 only,
as JAX takes the replicated output from device 0) with respect to the
tokens, the gate and each rank's experts. The gate is replicated, so its
gradient is the sum of the ranks' (the JAX transpose of a replicated
input); an expert's gradient already holds both ranks' tokens through the
all-to-all's backward.

Tolerance: fp32 on both sides, the same routing (no ties at these
inputs), so 1e-5 abs and rel; summation order is what differs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel.moe import moe_layer as jax_moe

import torch_worlds

T, D, F_, E = 16, 8, 12, 4          # tokens per rank, width, expert width
CASES = {f"top{k}-cf{cf:g}": (k, cf) for k in (1, 2) for cf in (1.0, 8.0)}

WORKER = torch_worlds.WORLD_PRELUDE + r"""
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.moe import moe_layer

hvd.init(device="cpu")
ax = hvd.axis_group("dp")
e = spec["E"] // 2
for n, (k, cf) in spec["cases"].items():
    sl = slice(rank * spec["T"], (rank + 1) * spec["T"])
    x = torch.from_numpy(inp["x"][sl]).requires_grad_()
    params = {"gate": torch.from_numpy(inp["gate"]).requires_grad_(),
              "w_in": torch.from_numpy(inp["w_in"][rank * e:(rank + 1) * e])
              .requires_grad_(),
              "w_out": torch.from_numpy(inp["w_out"][rank * e:(rank + 1) * e])
              .requires_grad_()}
    y, aux = moe_layer(x, params, ax, capacity_factor=cf, top_k=k,
                       return_aux=True)
    # Rank 1 weighs aux by 0: the mean's backward is a collective, so
    # it must be on both ranks' graphs.
    loss = (y * torch.from_numpy(inp["ct"][sl])).sum() + aux * (rank == 0)
    loss.backward()
    res[f"{n}/y"] = y.detach().numpy()
    res[f"{n}/aux"] = aux.detach().numpy()
    res[f"{n}/dx"] = x.grad.numpy()
    for name, p in params.items():
        res[f"{n}/d{name}"] = p.grad.numpy()
hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


def _inputs():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(2 * T, D).astype(np.float32),
            "gate": rng.randn(D, E).astype(np.float32),
            "w_in": (rng.randn(E, D, F_) / np.sqrt(D)).astype(np.float32),
            "w_out": (rng.randn(E, F_, D) / np.sqrt(F_)).astype(np.float32),
            "ct": rng.randn(2 * T, D).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = torch_worlds.launch(WORKER, 2, tmp_path_factory.mktemp("moe"),
                            {"T": T, "E": E, "cases": CASES}, _inputs())
    return w.results()


def _jax(top_k, cf):
    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))

    def layer(xs, gate, w_in, w_out):
        y, aux = jax_moe(xs, {"gate": gate, "w_in": w_in, "w_out": w_out},
                         "dp", capacity_factor=cf, top_k=top_k,
                         return_aux=True)
        return y, aux[None]

    fn = jax.shard_map(layer, mesh=mesh,
                       in_specs=(P("dp"), P(), P("dp"), P("dp")),
                       out_specs=(P("dp"), P("dp")), check_vma=False)

    def loss(xs, gate, w_in, w_out):
        y, aux = fn(xs, gate, w_in, w_out)
        return jnp.sum(y * x["ct"]) + aux[0], (y, aux[0])

    grads, (y, aux) = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3),
                                       has_aux=True))(
        x["x"], x["gate"], x["w_in"], x["w_out"])
    return y, aux, dict(zip(("dx", "dgate", "dw_in", "dw_out"), grads))


def _dropped(top_k, cf):
    """Tokens past their expert's capacity on each rank (routing by
    numpy, as both sides route)."""
    x = _inputs()
    cap = max(1, int(cf * top_k * T / E))
    n = 0
    for r in range(2):
        logits = x["x"][r * T:(r + 1) * T] @ x["gate"]
        order = np.argsort(-logits, axis=1)[:, :top_k].T.reshape(-1)
        counts = np.zeros(E, int)
        for e in order:
            counts[e] += 1
            n += counts[e] > cap
    return n


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_layer_matches_jax(world, name):
    top_k, cf = CASES[name]
    y, aux, grads = _jax(top_k, cf)
    assert (_dropped(top_k, cf) > 0) == (cf == 1.0), name
    tol = dict(rtol=1e-5, atol=1e-5)
    got_y = np.concatenate([r[f"{name}/y"] for r in world])
    np.testing.assert_allclose(got_y, np.asarray(y), **tol, err_msg=name)
    for r in world:
        assert float(r[f"{name}/aux"]) == pytest.approx(float(aux), rel=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r[f"{name}/dx"] for r in world]),
        np.asarray(grads["dx"]), **tol, err_msg=f"{name}: dx")
    np.testing.assert_allclose(
        sum(r[f"{name}/dgate"] for r in world), np.asarray(grads["dgate"]),
        **tol, err_msg=f"{name}: dgate")
    for w in ("w_in", "w_out"):
        np.testing.assert_allclose(
            np.concatenate([r[f"{name}/d{w}"] for r in world]),
            np.asarray(grads[f"d{w}"]), **tol, err_msg=f"{name}: d{w}")
