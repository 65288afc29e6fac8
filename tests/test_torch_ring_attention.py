"""The port's sequence parallelism against the JAX package's.

- Block kernels: ``flash_attention_block`` (the forward's state mode) and
  ``flash_attention_block_grads`` (the backward kernels' fp32 outputs) on
  the CPU, where the port computes their plain versions, against the JAX
  package's with ``use_pallas=True`` (Pallas in interpret mode), at past,
  diagonal and future block offsets.
- Ring and Ulysses attention in 2- and 4-rank gloo worlds (subprocesses)
  against JAX's ``context_parallel_attention`` under ``shard_map`` on 2
  and 4 of the 8 CPU devices (Pallas in interpret mode): forward and
  q/k/v gradients, MHA and GQA, with and without a window and segment ids.
- The sp trainer: loss and gradients at dp=1/sp=2 and dp=2/sp=2 against
  JAX's ``make_loss_fn`` on the same mesh, weights carried over by
  ``params_from_jax``.
- The bench's mesh, world-averaged loss and dp batch split, and the
  mesh's axis sizes and rank order.

Each world runs once per module, every case inside it; inputs are made
with numpy from a seed and written to a file both sides read.

Tolerances. fp32 on both sides, differing in summation order only:
2e-5 abs and rel (the reference's own, tests/test_pallas_attention.py:45).
bf16 block kernels: 2e-2, where the two round P and the products at other
places (tests/test_pallas_attention.py:238). The trainer: loss rel 1e-5,
gradients rtol 1e-4 with atol 1e-6 of the largest entry, as the
data-parallel trainer's test (tests/test_torch_transformer.py).
"""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import pallas_attention as ref
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel.ulysses import \
    context_parallel_attention as jax_context_parallel
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import ulysses as tul

from torch_worlds import free_port_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS_INTERPRET", "1")


# ---- block kernels ----------------------------------------------------------

BT, BH, BD = 32, 2, 16   # block length, heads, head dim
OFFSETS = {"past": (BT, 0), "diagonal": (BT, BT), "future": (0, BT)}
MASKS = {"causal": dict(causal=True), "non-causal": dict(causal=False),
         "window": dict(causal=True, window=24),
         "segments": dict(causal=True, seg=True)}


def _block_inputs(offsets, mask, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(2, BT, BH, BD).astype(np.float32)
                   for _ in range(4))
    q_off, k_off = OFFSETS[offsets]
    kw = dict(MASKS[mask])
    segs = None
    if kw.pop("seg", False):
        ids = np.sort(rng.randint(0, 5, (2, 2 * BT)), axis=1).astype(np.int32)
        segs = (ids[:, q_off:q_off + BT], ids[:, k_off:k_off + BT])
    return q, k, v, do, q_off, k_off, kw, segs


def _seg_kw(segs, conv):
    if segs is None:
        return {}
    return dict(q_segment_ids=conv(segs[0]), k_segment_ids=conv(segs[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
def test_block_state_matches_jax(offsets, mask, dtype):
    q, k, v, _, q_off, k_off, kw, segs = _block_inputs(offsets, mask)
    want = ref.flash_attention_block(
        *(jnp.asarray(x, _JDT[dtype]) for x in (q, k, v)), q_off, k_off,
        use_pallas=True, **kw, **_seg_kw(segs, jnp.asarray))
    got = fa.flash_attention_block(
        *(torch.tensor(x).to(_TDT[dtype]) for x in (q, k, v)), q_off, k_off,
        **kw, **_seg_kw(segs, torch.tensor))
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL[dtype],
                                   atol=TOL[dtype],
                                   err_msg=f"{offsets} {mask} {dtype}: {name}")
    if offsets == "future" and kw["causal"]:
        # Every tile culled: the empty state the ring merge expects.
        acc, m, l = got
        assert torch.all(acc == 0) and torch.all(l == 0)
        assert torch.all(m == fa.NEG_INF)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("offsets", sorted(OFFSETS))
def test_block_grads_match_jax(offsets, mask, dtype):
    q, k, v, do, q_off, k_off, kw, segs = _block_inputs(offsets, mask, 1)
    tq, tk, tv, tdo = (torch.tensor(x).to(_TDT[dtype]) for x in (q, k, v, do))
    segs_t = _seg_kw(segs, torch.tensor)
    # Row statistics as a global softmax would give them: this block's
    # lse raised by 0.3 (other blocks' mass), +1e30 on rows with no key.
    _, lse = fa.flash_fwd_plain(tq, tk, tv, q_off=q_off, k_off=k_off,
                                q_seg=segs_t.get("q_segment_ids"),
                                k_seg=segs_t.get("k_segment_ids"),
                                with_lse=True, **kw)
    lse = (lse + 0.3).numpy()
    delta = np.random.RandomState(2).randn(2, BH, BT).astype(np.float32)
    want = ref.flash_attention_block_grads(
        *(jnp.asarray(x, _JDT[dtype]) for x in (q, k, v, do)),
        jnp.asarray(lse), jnp.asarray(delta), q_off, k_off, use_pallas=True,
        **kw, **_seg_kw(segs, jnp.asarray))
    got = fa.flash_attention_block_grads(
        tq, tk, tv, tdo, torch.tensor(lse), torch.tensor(delta), q_off,
        k_off, **kw, **segs_t)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL[dtype],
                                   atol=TOL[dtype],
                                   err_msg=f"{offsets} {mask} {dtype}: {name}")


# ---- the worlds -------------------------------------------------------------

T = 32                  # global sequence of every world case
AB, AD = 2, 16           # attention cases: batch, head dim
HEADS = {"mha": (4, 4), "gqa": (8, 4)}
AMASKS = {"plain": (False, None), "window": (False, 8),
          "segments-window": (True, 8)}
ATTENTION = [dict(name=f"{s}-{h}-{m}", strategy=s, heads=h, mask=m)
             for s in ("ring", "ulysses") for h in sorted(HEADS)
             for m in sorted(AMASKS)]

TB = 4                   # trainer: global batch
MODEL = dict(vocab=256, d_model=64, n_heads=4, d_head=16, d_ff=256,
             n_layers=2, max_seq=T)
TRAINERS = {
    "ring-packed": (dict(sp_strategy="ring"), True),
    "ulysses-gqa-rope-window": (dict(sp_strategy="ulysses", n_kv_heads=2,
                                     rope=True, attention_window=8), False),
}
LAYOUTS = {2: [(1, 2)], 4: [(2, 2)]}  # world size -> (dp, sp) trainer runs

WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training, transformer_bench
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel.ulysses import context_parallel_attention

spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
rank, size = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
dist.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{os.environ['HOROVOD_CONTROLLER_PORT']}",
    rank=rank, world_size=size)
res = {}

hvd.init(device="cpu", sp=size)
ax = hvd.axis_group("sp")
for case in spec["attention"]:
    n = case["name"]
    tl = spec["T"] // size
    sl = slice(ax.rank * tl, (ax.rank + 1) * tl)
    q, k, v = (torch.from_numpy(inp[f"{n}/{x}"][:, sl]).requires_grad_()
               for x in "qkv")
    seg = torch.from_numpy(inp[f"{n}/seg"][:, sl]) if f"{n}/seg" in inp else None
    out = context_parallel_attention(q, k, v, ax, strategy=case["strategy"],
                                     segment_ids=seg, window=case["window"])
    out.backward(torch.from_numpy(inp[f"{n}/do"][:, sl]))
    for key, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        res[f"{n}/{key}"] = t.detach().numpy()
hvd.shutdown()

for case in spec["trainer"]:
    n = case["name"]
    hvd.init(device="cpu", sp=case["sp"])
    cfg = tt.TransformerConfig(**case["cfg"])
    model = tt.Transformer(cfg, device="cpu")
    prefix = f"{n}/param/"
    params = {key[len(prefix):]: inp[key] for key in inp.files
              if key.startswith(prefix)}
    model.load_state_dict(tt.params_from_jax(params, cfg))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.0),
                                   named_parameters=model.named_parameters())
    b, t = spec["B"] // hvd.dp_size(), spec["T"] // hvd.sp_size()
    rows = slice(hvd.dp_rank() * b, (hvd.dp_rank() + 1) * b)
    cols = slice(hvd.sp_rank() * t, (hvd.sp_rank() + 1) * t)
    shard = lambda key: torch.from_numpy(inp[key][rows, cols]).long()
    seg = shard(f"{n}/seg") if f"{n}/seg" in inp else None
    loss = training.make_train_step(model, opt)(
        shard(f"{n}/tokens"), shard(f"{n}/labels"), seg)
    res[f"{n}/loss"] = loss.numpy()
    for key, p in model.named_parameters():
        res[f"{n}/grad/{key}"] = p.grad.numpy()
    hvd.shutdown()

orig_loss = training.cross_entropy_loss
for sp in spec["bench"]:
    local = []
    training.cross_entropy_loss = lambda lg, lb: (
        local.append(orig_loss(lg, lb)) or local[-1])
    run = transformer_bench.run(transformer_bench.parse_args([
        "--device", "cpu", "--d-model", "32", "--n-heads", "2",
        "--n-layers", "1", "--vocab", "64", "--seq-len", "16",
        "--num-warmup", "1", "--num-iters", "1", "--sp", str(sp)]))
    training.cross_entropy_loss = orig_loss
    res[f"bench{sp}/result"] = np.array(json.dumps(run.result))
    res[f"bench{sp}/losses"] = np.array(run.losses)
    res[f"bench{sp}/local"] = np.array([float(x) for x in local])
    res[f"bench{sp}/tokens"] = run.tokens.numpy()
    hvd.shutdown()

np.savez(sys.argv[3 + rank], **res)
"""


def _attention_inputs(case):
    H, Hkv = HEADS[case["heads"]]
    seg, _ = AMASKS[case["mask"]]
    rng = np.random.RandomState(zlib.crc32(case["name"].encode()))
    out = {x: rng.randn(AB, T, h, AD).astype(np.float32)
           for x, h in (("q", H), ("k", Hkv), ("v", Hkv), ("do", H))}
    if seg:
        out["seg"] = np.sort(rng.randint(0, 3, (AB, T)), axis=1).astype(
            np.int32)
    return out


def _trainer_configs(name):
    kw, _ = TRAINERS[name]
    return (jt.TransformerConfig(dtype=jnp.float32, **MODEL, **kw),
            dict(MODEL, **kw))


def _trainer_inputs(name):
    jcfg, _ = _trainer_configs(name)
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, MODEL["vocab"], (TB, T)).astype(np.int32)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if TRAINERS[name][1]:
        out["seg"] = np.sort(rng.randint(0, 3, (TB, T)), axis=1).astype(
            np.int32)
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0), 1))
    out.update({f"param/{k}": np.asarray(v) for k, v in params.items()})
    return out


def _spec(size):
    return {
        "T": T, "B": TB,
        "attention": [dict(name=c["name"], strategy=c["strategy"],
                           window=AMASKS[c["mask"]][1]) for c in ATTENTION],
        "trainer": [dict(name=f"{n}-dp{dp}", sp=sp,
                         cfg=_trainer_configs(n)[1])
                    for n in sorted(TRAINERS) for dp, sp in LAYOUTS[size]],
        "bench": [2, 1] if size == 2 else [],
    }


def _launch(size, tmp):
    inputs = {}
    for c in ATTENTION:
        inputs.update({f"{c['name']}/{k}": v
                       for k, v in _attention_inputs(c).items()})
    for n in sorted(TRAINERS):
        for dp, _ in LAYOUTS[size]:
            inputs.update({f"{n}-dp{dp}/{k}": v
                           for k, v in _trainer_inputs(n).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "spec.json").write_text(json.dumps(_spec(size)))
    outs = [tmp / f"rank{r}.npz" for r in range(size)]
    port = free_port_pair()
    procs = []
    for r in range(size):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(size),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(size),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "spec.json"),
             str(tmp / "inputs.npz"), *map(str, outs)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 2- and 4-rank gloo worlds, run side by side once; returns
    {size: [each rank's results]}."""
    launched = {size: _launch(size, tmp_path_factory.mktemp(f"sp{size}"))
                for size in (2, 4)}
    logs = {}
    try:
        for size, (procs, _) in launched.items():
            logs[size] = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for procs, _ in launched.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for size, (procs, outs) in launched.items():
        for p, log in zip(procs, logs[size]):
            assert p.returncode == 0, log
    return {size: [dict(np.load(o)) for o in outs]
            for size, (_, outs) in launched.items()}


def _gather_t(ranks, key):
    """The sp shards of every rank joined along T in rank order."""
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("ci", range(len(ATTENTION)),
                         ids=[c["name"] for c in ATTENTION])
def test_context_parallel_attention_matches_jax(worlds, sp, ci):
    case = ATTENTION[ci]
    x = _attention_inputs(case)
    window = AMASKS[case["mask"]][1]
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    seg = x.get("seg")
    n_in = 3 if seg is None else 4

    def attn(q, k, v, *s):
        return jax_context_parallel(q, k, v, "sp", causal=True,
                                    strategy=case["strategy"],
                                    segment_ids=s[0] if s else None,
                                    window=window)

    fn = jax.jit(jax.shard_map(attn, mesh=mesh,
                               in_specs=(P(None, "sp"),) * n_in,
                               out_specs=P(None, "sp"), check_vma=False))
    extra = () if seg is None else (jnp.asarray(seg),)
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, *extra),
                       *(jnp.asarray(x[n]) for n in "qkv"))
    want = [out, *vjp(jnp.asarray(x["do"]))]
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        got = _gather_t(worlds[sp], f"{case['name']}/{name}")
        np.testing.assert_allclose(got, np.asarray(w), rtol=TOL["float32"],
                                   atol=TOL["float32"],
                                   err_msg=f"sp={sp} {case['name']}: {name}")


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sp_trainer_matches_jax(worlds, size, name):
    (dp, sp), = LAYOUTS[size]
    jcfg, tkw = _trainer_configs(name)
    x = _trainer_inputs(name)
    params = {k[len("param/"):]: v for k, v in x.items()
              if k.startswith("param/")}
    mesh = jmesh.build_parallel_mesh(jax.devices()[:dp * sp], dp=dp, pp=1,
                                     sp=sp, tp=1)
    packed = "seg" in x
    loss_fn = jt.make_loss_fn(jcfg, mesh, n_microbatches=1, packed=packed)
    args = [jnp.asarray(x[k]) for k in ("tokens", "labels", "seg")
            if k in x]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jt.shard_params(params, jcfg, mesh), *args)
    jgrads = jax.device_get(jgrads)
    key = f"{name}-dp{dp}"
    for r in worlds[size]:
        assert float(r[f"{key}/loss"]) == pytest.approx(float(jloss),
                                                        rel=1e-5)
        for pname in (k for k in r if k.startswith(f"{key}/grad/")):
            leaf = pname.split("/")[-1]
            if leaf.startswith("layers."):
                _, i, leaf = leaf.split(".")
                want = np.asarray(jgrads[leaf])[0, int(i)]
            else:
                want = np.asarray(jgrads[leaf])
            np.testing.assert_allclose(
                r[pname], want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                err_msg=f"{key}: {pname}")


# ---- the bench in the 2-rank world ------------------------------------------


@pytest.mark.parametrize("sp", [1, 2])
def test_bench_mesh_reports_dp_and_sp(worlds, sp):
    for r in worlds[2]:
        line = json.loads(str(r[f"bench{sp}/result"]))
        assert line["mesh"] == {"dp": 2 // sp, "pp": 1, "sp": sp, "tp": 1}


@pytest.mark.parametrize("sp", [1, 2])
def test_bench_loss_is_the_world_average(worlds, sp):
    """Every step's loss is the mean of the ranks' local losses, the same
    on both ranks (the ranks' own losses differ)."""
    ranks = worlds[2]
    local = np.stack([r[f"bench{sp}/local"] for r in ranks])
    assert not np.allclose(local[0], local[1])
    for r in ranks:
        np.testing.assert_allclose(r[f"bench{sp}/losses"], local.mean(0),
                                   rtol=1e-6)
        line = json.loads(str(r[f"bench{sp}/result"]))
        assert line["loss"] == pytest.approx(local.mean(0)[-1], abs=1e-4)


@pytest.mark.parametrize("sp", [1, 2])
def test_bench_global_batch_splits_over_dp(worlds, sp):
    """Global batch 8 per dp shard, split over dp; the sequence over sp;
    each rank's tokens are its [rows, cols] block of the global array."""
    dp = 2 // sp
    batch = 8 * dp
    tokens = np.random.RandomState(0).randint(0, 64, (batch, 16))
    for rank, r in enumerate(worlds[2]):
        line = json.loads(str(r[f"bench{sp}/result"]))
        assert line["global_batch"] == batch
        d, s = divmod(rank, sp)
        want = tokens[d * 8:(d + 1) * 8, s * (16 // sp):(s + 1) * (16 // sp)]
        np.testing.assert_array_equal(r[f"bench{sp}/tokens"], want)


# ---- mesh and dispatch ------------------------------------------------------


@pytest.mark.parametrize("n, kw", [
    (8, {}), (8, dict(sp=4, tp=1, pp=1)), (8, dict(tp=2, pp=2, sp=1, dp=2)),
    (6, dict(tp=1, pp=1)), (4, dict(sp=2)), (1, {})])
def test_factor_devices_matches_jax(n, kw):
    assert tmesh.factor_devices(n, **kw) == jmesh.factor_devices(n, **kw)


def test_factor_devices_errors_match_jax():
    for fn in (tmesh.factor_devices, jmesh.factor_devices):
        with pytest.raises(ValueError, match="does not divide"):
            fn(8, tp=3)


@pytest.mark.parametrize("axis", ["dp", "sp"])
@pytest.mark.parametrize("sizes", [
    dict(dp=1, pp=1, sp=8, tp=1), dict(dp=2, pp=1, sp=4, tp=1),
    dict(dp=4, pp=1, sp=2, tp=1), dict(dp=2, pp=1, sp=2, tp=2)],
    ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_axis_ranks_follow_the_jax_mesh_order(sizes, axis):
    """Each group of the port's axis holds the global ranks that one line
    of the JAX mesh along that axis holds (CPU device ids 0..7)."""
    mesh = jmesh.build_parallel_mesh(jax.devices()[:8], **sizes)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    i = jmesh.AXES.index(axis)
    want = [tuple(int(r) for r in line) for line in
            np.moveaxis(ids, i, -1).reshape(-1, sizes[axis])]
    assert tmesh.axis_ranks(sizes, axis) == want


def test_ulysses_indivisible_heads_raise():
    axis = tmesh.AxisGroup(None, (0, 1), 0)
    x = torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError, match="heads divisible by the sp axis"):
        tul.ulysses_attention(x, x, x, axis)


@pytest.mark.parametrize("heads, kv, sp, want", [
    (4, 4, 2, "ulysses"), (4, 2, 4, "ring"), (3, 3, 2, "ring"),
    (8, 4, 4, "ulysses")])
def test_auto_strategy_matches_jax_rule(heads, kv, sp, want):
    assert tul.resolve_strategy("auto", heads, kv, sp) == want
    with pytest.raises(ValueError, match="unknown sequence-parallel"):
        tul.resolve_strategy("tree", heads, kv, sp)


def test_model_rejects_positions_past_max_seq():
    """Learned positions are sliced at the rank's global offset; a shard
    that runs past the table raises rather than reading garbage."""
    model = tt.Transformer(tt.TransformerConfig(n_layers=1, max_seq=8),
                           device="cpu")
    with pytest.raises(ValueError, match="exceed max_seq"):
        model(torch.zeros((1, 9), dtype=torch.long))


def test_model_rejects_inputs_off_the_sp_worlds_device(monkeypatch):
    """At sp > 1 the model reads its input as this rank's shard of the
    sequence; an input on another device than the world's raises rather
    than running the ring on it."""
    from horovod_tpu_torch.common import state as tstate

    model = tt.Transformer(tt.TransformerConfig(n_layers=1), device="cpu")
    monkeypatch.setattr(tstate, "is_initialized", lambda: True)
    monkeypatch.setattr(tstate, "axis_group",
                        lambda axis: tmesh.AxisGroup(None, (0, 1), 0))
    monkeypatch.setattr(tstate, "device", lambda: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="outside the sp world"):
        model(torch.zeros((1, 8), dtype=torch.long))
