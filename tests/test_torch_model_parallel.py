"""The port's tensor, pipeline and expert parallelism and remat against the
JAX package's transformer.

One 8-rank gloo world (subprocesses) runs every case of ``CASES``: each
initializes its mesh (``hvd.init(sp=, tp=, pp=)``), builds its shard of
the model from the JAX package's ``init_params(cfg, key, n_stages=pp)``
through ``params_from_jax``, and takes one training step on its
``[B/dp, T/sp]`` shard (SGD at lr 0, so ``.grad`` keeps the gradients
``DistributedOptimizer`` reduced, each over its placement group). The
test joins the ranks' gradients (``join_shards``) and holds loss and every
leaf against the dense single-device oracle ``dense_reference_loss``, as
``tests/test_transformer.py`` does for the JAX model, on the same meshes
and configurations: the three ``MESHES`` rows, MoE top-1 and top-2 with
ample capacity (also at sp=2), remat, GQA with RoPE at tp=2, and packed
segment ids through pp=2. On the ``MESHES`` rows it also holds them
against JAX's ``make_loss_fn`` on the same mesh, Pallas in interpret mode.
Inputs are made with numpy from the seeds of the JAX tests.

Tolerances (fp32 on both sides; summation order differs): loss rel 1e-5;
gradients rtol 1e-4 with atol 1e-6 of the leaf's largest entry, the
port's trainer tolerances (tests/test_torch_transformer.py). Every rank
must hold the slice of the joined gradients that its coordinates name,
to 1e-6 of the leaf's largest entry (replicas are reduced in separate
groups, whose sums may round apart).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.mesh import build_parallel_mesh
from horovod_tpu_torch.models import transformer as tt

import torch_worlds

SIZE = 8
BASE = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=4,
            max_seq=64)
MOE = dict(vocab=64, d_model=32, n_heads=4, d_head=8, n_layers=2,
           max_seq=64, use_moe=True, n_experts=4, d_expert=64,
           capacity_factor=8.0)
MESHES = [dict(dp=2, pp=2, sp=1, tp=2), dict(dp=2, pp=2, sp=2, tp=1),
          dict(dp=1, pp=2, sp=2, tp=2)]
D221 = MESHES[1]


def _mesh_id(m):
    return "x".join(f"{k}{v}" for k, v in m.items())


# name -> (model kwargs, mesh, packed segment ids)
CASES = {f"dense-{_mesh_id(m)}": (BASE, m, False) for m in MESHES}
CASES.update({
    "remat": (dict(BASE, remat=True), D221, False),
    "ulysses-dp1xpp2xsp2xtp2": (dict(BASE, sp_strategy="ulysses"),
                                MESHES[2], False),
    "packed-ring": (BASE, D221, True),
    "packed-ulysses": (dict(BASE, sp_strategy="ulysses"), D221, True),
    "moe-top1": (MOE, MESHES[0], False),
    "moe-top2": (dict(MOE, moe_top_k=2), MESHES[0], False),
    "moe-sp2": (MOE, D221, False),
})
GQA = dict(BASE, n_kv_heads=2, rope=True)
for m in (MESHES[0], dict(dp=2, pp=1, sp=2, tp=2)):
    CASES[f"gqa-rope-{_mesh_id(m)}"] = (GQA, m, False)

WORKER = torch_worlds.WORLD_PRELUDE + r"""
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import transformer as tt

for n, case in spec.items():
    m = case["mesh"]
    hvd.init(device="cpu", sp=m["sp"], tp=m["tp"], pp=m["pp"])
    cfg = tt.TransformerConfig(**case["cfg"])
    model = tt.Transformer(cfg, device="cpu", n_microbatches=2)
    coords = model.shard_coords()
    prefix = f"{n}/param/"
    params = {k[len(prefix):]: inp[k] for k in inp.files
              if k.startswith(prefix)}
    model.load_state_dict(tt.params_from_jax(params, cfg, **coords))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.0),
                                   named_parameters=model.named_parameters())
    B, T = inp[f"{n}/tokens"].shape
    b, t = B // hvd.dp_size(), T // hvd.sp_size()
    rows = slice(hvd.dp_rank() * b, (hvd.dp_rank() + 1) * b)
    cols = slice(hvd.sp_rank() * t, (hvd.sp_rank() + 1) * t)
    shard = lambda key: torch.from_numpy(inp[key][rows, cols]).long()
    seg = shard(f"{n}/seg") if f"{n}/seg" in inp else None
    loss = training.make_train_step(model, opt)(
        shard(f"{n}/tokens"), shard(f"{n}/labels"), seg)
    res[f"{n}/loss"] = loss.numpy()
    res[f"{n}/coords"] = np.array(json.dumps(coords))
    for key, p in model.named_parameters():
        res[f"{n}/grad/{key}"] = p.grad.numpy()
    hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


def _configs(name):
    kw, _, _ = CASES[name]
    return jt.TransformerConfig(dtype=jnp.float32, **kw), kw


def _inputs(name):
    """The JAX tests' inputs (tests/test_transformer.py ``_setup`` and the
    packed test's segments): params from PRNGKey(0) at n_stages = pp,
    tokens and labels from RandomState(0), segments from RandomState(9)."""
    jcfg, _ = _configs(name)
    _, mesh, packed = CASES[name]
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0),
                                           mesh["pp"]))
    rng = np.random.RandomState(0)
    B, T = 4 * mesh["dp"], 8 * mesh["sp"]
    out = {"tokens": rng.randint(0, jcfg.vocab, (B, T)).astype(np.int32),
           "labels": rng.randint(0, jcfg.vocab, (B, T)).astype(np.int32)}
    if packed:
        rng = np.random.RandomState(9)
        seg = np.zeros((B, T), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(1, T), size=3, replace=False))
            seg[b] = np.searchsorted(cuts, np.arange(T), side="right")
        out["seg"] = seg
    out.update({f"param/{k}": np.asarray(v) for k, v in params.items()})
    return out


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world, started once; tests compute the JAX side while
    it runs and then wait on it."""
    inputs = {}
    for name in CASES:
        inputs.update({f"{name}/{k}": v for k, v in _inputs(name).items()})
    spec = {name: dict(cfg=kw, mesh=mesh)
            for name, (kw, mesh, _) in CASES.items()}
    w = torch_worlds.launch(WORKER, SIZE, tmp_path_factory.mktemp("mp"),
                            spec, inputs)
    yield w
    w.results()   # never leave the ranks running


def _dense(name):
    jcfg, _ = _configs(name)
    x = _inputs(name)
    params = {k[6:]: v for k, v in x.items() if k.startswith("param/")}
    seg = jnp.asarray(x["seg"]) if "seg" in x else None
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.dense_reference_loss(jcfg, p, jnp.asarray(x["tokens"]),
                                          jnp.asarray(x["labels"]),
                                          segment_ids=seg)))(params)
    return float(loss), jax.device_get(grads)


def _joined(world, name):
    """(each rank's loss, the joined gradients, [(coords, grads)])."""
    ranks = []
    for r in world.results():
        coords = json.loads(str(r[f"{name}/coords"]))
        coords = dict(coords, tp=tuple(coords["tp"]), dp=tuple(coords["dp"]))
        prefix = f"{name}/grad/"
        ranks.append((coords, {k[len(prefix):]: v for k, v in r.items()
                               if k.startswith(prefix)}))
    losses = [float(r[f"{name}/loss"]) for r in world.results()]
    _, kw = _configs(name)
    return losses, tt.join_shards(ranks, tt.TransformerConfig(**kw)), ranks


def _check(world, name, want_loss, want_grads):
    losses, joined, ranks = _joined(world, name)
    for loss in losses:
        assert loss == pytest.approx(want_loss, rel=1e-5), name
    assert set(joined) == set(want_grads), name
    for leaf, want in want_grads.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(joined[leaf], want, rtol=1e-4,
                                   atol=1e-6 * scale,
                                   err_msg=f"{name}: grad {leaf}")
    _, kw = _configs(name)
    cfg = tt.TransformerConfig(**kw)
    for coords, grads in ranks:
        mine = tt.params_from_jax(joined, cfg, **coords)
        for key, g in grads.items():
            scale = np.abs(joined[key.split(".")[-1]]).max()
            np.testing.assert_allclose(
                g, mine[key].numpy(), rtol=0, atol=1e-6 * scale,
                err_msg=f"{name}: rank {coords} {key} off its replicas")


@pytest.mark.parametrize("sizes", MESHES, ids=_mesh_id)
def test_loss_matches_dense(world, sizes):
    name = f"dense-{_mesh_id(sizes)}"
    want, _ = _dense(name)
    losses, _, _ = _joined(world, name)
    for loss in losses:
        assert loss == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("sizes", MESHES, ids=_mesh_id)
def test_grads_match_dense(world, sizes):
    name = f"dense-{_mesh_id(sizes)}"
    _check(world, name, *_dense(name))


@pytest.mark.parametrize("sizes", MESHES, ids=_mesh_id)
def test_loss_and_grads_match_jax_mesh(world, sizes):
    """Against JAX's ``make_loss_fn`` (M=2) on the same mesh of CPU
    devices: its loss and its gradients, leaf by leaf."""
    name = f"dense-{_mesh_id(sizes)}"
    jcfg, _ = _configs(name)
    x = _inputs(name)
    params = {k[6:]: v for k, v in x.items() if k.startswith("param/")}
    mesh = build_parallel_mesh(jax.devices()[:SIZE], **sizes)
    data = NamedSharding(mesh, P("dp", "sp"))
    loss_fn = jt.make_loss_fn(jcfg, mesh, n_microbatches=2)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jt.shard_params(params, jcfg, mesh),
        jax.device_put(jnp.asarray(x["tokens"]), data),
        jax.device_put(jnp.asarray(x["labels"]), data))
    _check(world, name, float(loss), jax.device_get(grads))


def test_remat_matches_dense(world):
    _check(world, "remat", *_dense("remat"))


def test_ulysses_under_tp_matches_dense(world):
    """Ulysses at tp=2, sp=2: each tp rank's 2 heads split over sp (the
    strategy is resolved on the tp shard's heads)."""
    _check(world, "ulysses-dp1xpp2xsp2xtp2",
           *_dense("ulysses-dp1xpp2xsp2xtp2"))


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_packed_sequences_match_dense(world, strategy):
    """Segment ids ride the pipeline ring with the microbatches (pp=2,
    sp=2); the masked loss differs from the unpacked one."""
    name = f"packed-{strategy}"
    want_loss, want_grads = _dense(name)
    _check(world, name, want_loss, want_grads)
    jcfg, _ = _configs(name)
    x = _inputs(name)
    params = {k[6:]: v for k, v in x.items() if k.startswith("param/")}
    unpacked = float(jt.dense_reference_loss(
        jcfg, params, jnp.asarray(x["tokens"]), jnp.asarray(x["labels"])))
    assert abs(unpacked - want_loss) > 1e-4


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_loss_matches_dense(world, top_k):
    name = f"moe-top{top_k}"
    want, _ = _dense(name)
    losses, _, _ = _joined(world, name)
    for loss in losses:
        assert loss == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_grads_match_dense(world, top_k):
    """Experts sharded over dp=2 (2 of 4 per rank), tp=2, pp=2: the
    expert gradients come back through the all-to-all's backward and are
    reduced over sp only."""
    name = f"moe-top{top_k}"
    _check(world, name, *_dense(name))


def test_moe_sp2_grads_match_dense(world):
    _check(world, "moe-sp2", *_dense("moe-sp2"))


@pytest.mark.parametrize("sizes", [MESHES[0], dict(dp=2, pp=1, sp=2, tp=2)],
                         ids=_mesh_id)
def test_gqa_rope_matches_dense(world, sizes):
    """2 KV heads for 4 query heads, each sharded over tp=2 at its own
    width, with rotary positions."""
    name = f"gqa-rope-{_mesh_id(sizes)}"
    _check(world, name, *_dense(name))
