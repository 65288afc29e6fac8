"""``chip_smoke.py``'s references, held against the JAX package on the CPU.

``rounded_plain`` is the reference that the fp32 outputs of bf16 inputs
meet on the card at ``chip_smoke.ROUNDED_LIMIT``: for the state mode it
walks the keys in tiles, rounds P = exp(S - running max) to bf16 per tile
and rescales the fp32 accumulator. Where P is rounded depends on the
tile, so the reference takes the kernel's tile as an argument. Here it
runs with the Pallas kernel's own tile (``bk`` = 512 keys at T = 1024)
against ``_pallas_block_state`` in interpret mode on the same numpy
inputs, and must agree at ROUNDED_LIMIT, while a 64-key tile must not:
the limit can tell one tile from another. Its dQ branch (dS rounded to
bf16 before dS.K) is held in the same way against the Pallas dQ kernel
(``_pallas_bwd`` with an fp32 output, interpret mode), and the same
reference rounded through bf16 must be refused.

The tolerance is ROUNDED_LIMIT (2e-4, normwise), the limit the card's
comparison uses: the two sides round P (dS) at the same places and differ
only by fp32 summation order and exp, which moved the comparison by
1.4e-5 to 3.3e-5 on the CPU, while rounding P per 64 keys instead of 512,
or the dQ output through bf16, moves it by ~1e-3.

Phase (g)'s CPU-side helpers: ``gather_dense`` must put every rank's
shard of a dense model back exactly (and notice a missing one), and
``expected_launches`` must equal the plain-path calls counted over one
training step on the CPU, where remat recomputes the forward.

Phase (k)'s: ``tensor_digest`` tells a one-ulp change apart,
``swap_sync_bn`` replaces all 53 batch norms of the example's ResNet-50,
and ``kill_and_respawn`` runs its own ``--elastic-worker`` on gloo: the
SIGKILLed rank's peer raises within ``KILL_BOUND_S`` and the respawned
rank rejoins and ends with rank 0's parameters.

Phase (o) runs whole on the CPU (``CHIP_SMOKE_DEVICE=cpu``), ~10 s.

Phase (m)'s: where TensorFlow or Keras is not installed it prints one
line and starts nothing; where both are (here), the whole phase runs on
the CPU (``CHIP_SMOKE_DEVICE=cpu``: staging on gloo), a rehearsal of
about a minute marked ``slow``.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops import pallas_attention as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(BH, T, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(BH, T, D).astype(np.float32) for _ in range(3)]


def _pallas_state_acc(q, k, v, causal):
    """acc [BH, T, D] of the Pallas block-state kernel (interpret mode),
    bf16 inputs, and its key tile."""
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    acc, _, _ = ref._pallas_block_state(
        *args, jnp.asarray([0, 0], jnp.int32), causal, interpret=True)
    return np.asarray(acc, np.float32), ref._pick_block(q.shape[1],
                                                        ref.BLOCK_K)


def _rounded_acc(cs, q, k, v, causal, tile):
    """rounded_plain's state acc for the same inputs as [BH, T, D]: the
    BH rows are the heads of one batch entry ([1, T, BH, D])."""
    q_t, k_t, v_t = (torch.tensor(x).to(torch.bfloat16).permute(1, 0, 2)[None]
                     for x in (q, k, v))
    kw = dict(causal=causal, q_off=0, k_off=0, window=None)
    (acc,) = cs.rounded_plain("flash_fwd_state", q_t, k_t, v_t, None, None,
                              None, kw, tile)
    return acc[0].permute(1, 0, 2)


@pytest.mark.parametrize("causal", [True, False])
def test_rounded_plain_follows_the_tile(causal):
    cs = _chip_smoke()
    q, k, v = _inputs(2, 1024, 64, seed=5)
    want, bk = _pallas_state_acc(q, k, v, causal)
    assert bk == 512
    want = torch.tensor(want)
    same = cs.rel_err(_rounded_acc(cs, q, k, v, causal, bk), want)
    other = cs.rel_err(_rounded_acc(cs, q, k, v, causal, 64), want)
    assert same <= cs.ROUNDED_LIMIT, (same, other)
    assert other > cs.ROUNDED_LIMIT, (same, other)


def _bwd_inputs(BH, T, D, seed, causal):
    """bf16 q/k/v/dO as [1, T, BH, D] torch tensors (the BH rows are the
    heads of one batch entry) with fp32 lse and delta [1, BH, T] from the
    plain forward, as the trainer's backward receives them."""
    from horovod_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(1, T, BH, D).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, causal, with_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _pallas_dq(q, k, v, do, lse, delta, causal):
    """fp32 dQ of the Pallas backward (interpret mode) on the same inputs,
    as [1, T, BH, D]."""
    merged = [jnp.asarray(x[0].permute(1, 0, 2).float().numpy(), jnp.bfloat16)
              for x in (q, k, v, do)]
    rows = [jnp.asarray(x[0, ..., None].numpy()) for x in (lse, delta)]
    dq, _, _ = ref._pallas_bwd(*merged, *rows, jnp.asarray([0, 0], jnp.int32),
                               causal, True, out_dtype=jnp.float32)
    return torch.tensor(np.asarray(dq, np.float32)).permute(1, 0, 2)[None]


@pytest.mark.parametrize("causal", [True, False])
def test_rounded_plain_dq_matches_the_pallas_dq_kernel(causal):
    """rounded_plain's dQ branch (dS rounded to bf16 before dS.K, as the
    Pallas kernel rounds it) is the reference the fp32 dQ of bf16 inputs
    meets on the card: it agrees with the Pallas dQ kernel at
    ROUNDED_LIMIT, and the same reference rounded through bf16 does not."""
    cs = _chip_smoke()
    args = _bwd_inputs(4, 1024, 64, seed=7, causal=causal)
    want = _pallas_dq(*args, causal)
    kw = dict(causal=causal, q_off=0, k_off=0, window=None)
    (dq,) = cs.rounded_plain("flash_bwd_dq_f32", *args, kw, None)
    same = cs.rel_err(dq, want)
    rounded = cs.rel_err(dq.to(torch.bfloat16).float(), want)
    assert same <= cs.ROUNDED_LIMIT, (same, rounded)
    assert rounded > cs.ROUNDED_LIMIT, (same, rounded)


def test_rounded_plain_tile_comes_from_the_wrapper():
    """chip_smoke takes the tile from the wrapper module's FWD_KEY_TILE,
    which names a tile for every (dtype, head dim) the kernels take."""
    from horovod_tpu_torch.ops import flash_attention as fa

    assert set(fa.FWD_KEY_TILE) == {(dt, d) for dt in (torch.bfloat16,
                                                       torch.float32)
                                    for d in fa.HEAD_DIMS}
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "fa.FWD_KEY_TILE[" in src


_PURITY = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import horovod_tpu_torch.ops.flash_attention
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                           "horovod_tpu"))
assert not bad, bad
"""


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "HVD_PALLAS_INTERPRET")}
    proc = subprocess.run([sys.executable, "-c", _PURITY], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- (g)'s helpers ------------------------------------------------------------


def _coords(stage=0, n_stages=1, tp=(0, 1), dp=(0, 1)):
    return dict(stage=stage, n_stages=n_stages, tp=tp, dp=dp)


MESH_SHARDS = {
    "tp2": [_coords(tp=(t, 2)) for t in range(2)],
    "pp2": [_coords(stage=s, n_stages=2) for s in range(2)],
    "ep2": [_coords(dp=(d, 2)) for d in range(2)],
    "tp2xpp2": [_coords(stage=s, n_stages=2, tp=(t, 2)) for s in range(2)
                for t in range(2)],
}


@pytest.mark.parametrize("mesh", sorted(MESH_SHARDS))
def test_gather_dense_puts_the_shards_back(mesh):
    """Every rank's slice of a dense model (``params_from_jax`` of its
    global leaves), joined by ``gather_dense``, is the dense model's
    tensors, leaf by leaf, exactly; with one rank's slice missing it is
    not."""
    from horovod_tpu_torch.models import transformer as tt

    cs = _chip_smoke()
    kw = dict(cs.SMALL, d_model=32, d_ff=64, vocab=64, n_heads=4, d_head=8)
    if mesh == "ep2":
        kw.update(use_moe=True, n_experts=4, d_expert=16)
    cfg = tt.TransformerConfig(**kw)
    dense = tt.Transformer(cfg, device="cpu", seed=3)
    want = cs.gather_dense([(dense.shard_coords(),
                             dict(dense.named_parameters()))], cfg)
    coords = MESH_SHARDS[mesh]
    leaves = cs.global_leaves(dense, coords[0]["n_stages"])
    shards = [(c, tt.params_from_jax(leaves, cfg, **c)) for c in coords]
    got = cs.gather_dense(shards, cfg)
    assert set(got) == set(want)
    for leaf, w in want.items():
        np.testing.assert_array_equal(got[leaf], w, err_msg=leaf)
    partial = cs.gather_dense(shards[:-1], cfg)
    assert any(not np.array_equal(partial[k], want[k]) for k in want)


@pytest.mark.parametrize("remat, microbatches", [(False, 1), (True, 1),
                                                 (True, 2)])
def test_expected_launches_counts_the_remat_recompute(monkeypatch, remat,
                                                      microbatches):
    """On the CPU the wrappers run the plain versions: counting those
    calls over one training step of a 3-layer model gives what
    ``expected_launches`` says the kernels launch — under remat the
    forward's train mode twice per layer (the backward recomputes it)."""
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.training import cross_entropy_loss

    cs = _chip_smoke()
    calls = dict.fromkeys(("flash_fwd", "flash_fwd_train", "flash_bwd_dq",
                           "flash_bwd_dkv"), 0)

    def counted(fn, name_of):
        def wrapper(*args, **kwargs):
            calls[name_of(args, kwargs)] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(fa, "flash_fwd_plain", counted(
        fa.flash_fwd_plain, lambda a, kw: "flash_fwd_train" if (
            kw.get("with_lse", a[9] if len(a) > 9 else False))
        else "flash_fwd"))
    monkeypatch.setattr(fa, "flash_bwd_dq_plain", counted(
        fa.flash_bwd_dq_plain, lambda a, kw: "flash_bwd_dq"))
    monkeypatch.setattr(fa, "flash_bwd_dkv_plain", counted(
        fa.flash_bwd_dkv_plain, lambda a, kw: "flash_bwd_dkv"))
    cfg = tt.TransformerConfig(n_layers=3, remat=remat)
    model = tt.Transformer(cfg, device="cpu", n_microbatches=microbatches)
    tokens = torch.zeros((2, 16), dtype=torch.long)
    cross_entropy_loss(model(tokens), tokens).backward()
    assert calls == cs.expected_launches(3, 1, remat=remat,
                                         microbatches=microbatches)


def _losses(remat, drop_last_layer=False, steps=8):
    """A small fp32 decoder's losses over ``steps`` AdamW steps on one
    batch; with ``drop_last_layer`` its last layer gets no gradient (what
    a recompute cut off from the graph would give)."""
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.training import cross_entropy_loss

    cfg = tt.TransformerConfig(n_layers=2, remat=remat, vocab=256,
                               d_model=64, n_heads=2, d_head=32, d_ff=128,
                               max_seq=32, dtype=torch.float32)
    model = tt.Transformer(cfg, device="cpu", seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3)
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (4, 32)))
    labels = torch.roll(tokens, -1, 1)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = cross_entropy_loss(model(tokens), labels)
        loss.backward()
        if drop_last_layer:
            for p in model.layers[-1].parameters():
                p.grad.zero_()
        opt.step()
        losses.append(loss.item())
    return losses


def test_loss_drift_holds_remat_to_the_plain_curve():
    """chip_smoke's remat check: the remat run's losses stay within
    ``loss_drift``'s tolerance of the plain run's, and a run whose last
    layer got no gradient, equal at step 0, leaves it."""
    cs = _chip_smoke()
    plain = _losses(remat=False)
    drift, tol = cs.loss_drift(_losses(remat=True), plain)
    assert drift <= tol
    broken = _losses(remat=True, drop_last_layer=True)
    assert broken[0] == plain[0]
    drift, tol = cs.loss_drift(broken, plain)
    assert drift > 2 * tol


# ---- phase (k)'s helpers --------------------------------------------------------


def test_tensor_digest_is_bitwise():
    cs = _chip_smoke()
    a = [torch.arange(6.0), torch.ones(2, 3, dtype=torch.bfloat16)]
    b = [t.clone() for t in a]
    assert cs.tensor_digest(a) == cs.tensor_digest(b)
    b[0][3] = torch.nextafter(b[0][3], torch.tensor(10.0))
    assert cs.tensor_digest(a) != cs.tensor_digest(b)


def test_swap_sync_bn_keeps_every_batch_norm():
    """The example's ResNet-50 gets a SyncBatchNorm in place of each of
    its 53 BatchNorm2d, with the same statistics and parameters."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.examples import pytorch_synthetic_benchmark as ex

    cs = _chip_smoke()
    model = ex.resnet50(num_classes=10)
    with torch.no_grad():
        model[0][1].running_mean.fill_(0.25)
    swapped = cs.swap_sync_bn(model, hvd)
    sbns = [m for m in swapped.modules() if isinstance(m, hvd.SyncBatchNorm)]
    assert len(sbns) == 53
    assert not any(type(m) is torch.nn.BatchNorm2d
                   for m in swapped.modules())
    assert torch.all(swapped[0][1].running_mean == 0.25)


def test_kill_and_respawn_on_the_cpu():
    """(k)(2)'s driver with its own worker on gloo: rank 1 is SIGKILLed
    inside its allreduces, rank 0 raises within the bound, the respawned
    rank 1 rejoins, and both end with rank 0's parameters."""
    cs = _chip_smoke()
    seconds, res = cs.kill_and_respawn(
        2, {"CHIP_SMOKE_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}, 240)
    assert 0 <= seconds <= cs.KILL_BOUND_S
    assert [r["rank"] for r in res] == [0, 1]
    assert res[0]["resets"] and not res[0]["respawned"]
    assert res[1]["respawned"] and not res[1]["resets"]
    assert res[0]["batches"] == res[1]["batches"] == cs.KILL_TARGET
    assert res[0]["digest"] == res[1]["digest"]


def test_kill_and_respawn_with_sync_batch_norm_on_the_cpu():
    """The same with a model of two ``SyncBatchNorm`` and no other
    collective: rank 0 meets the dead peer in a batch norm's direct
    all-reduce, raises ``HorovodInternalError`` there, restores, and
    finishes beside the respawned rank 1."""
    cs = _chip_smoke()
    seconds, res = cs.kill_and_respawn(
        2, {"CHIP_SMOKE_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
            "CHIP_SMOKE_KILL_SYNC_BN": "1"}, 240)
    assert 0 <= seconds <= cs.KILL_BOUND_S
    assert res[0]["resets"] and not res[0]["respawned"]
    assert "sync_batch_norm.py" in res[0]["raised_in"][0]
    assert res[1]["respawned"] and not res[1]["resets"]
    assert res[0]["batches"] == res[1]["batches"] == cs.KILL_TARGET
    assert res[0]["digest"] == res[1]["digest"]


def test_negotiated_statistics_patches_the_sums_for_its_block_alone():
    """(k)'s A/B routes ``SyncBatchNorm``'s sums through the named plane
    inside its block and puts the direct path back after it."""
    from horovod_tpu_torch.torch import sync_batch_norm

    cs = _chip_smoke()
    calls = []

    class Hvd:
        Sum = "sum"

        @staticmethod
        def allreduce_async(t, op, name):
            calls.append((op, name))
            return t

        @staticmethod
        def synchronize(h):
            return h

    direct = sync_batch_norm._world_sum
    with cs.negotiated_statistics(Hvd):
        out = sync_batch_norm._world_sum(torch.ones(3), "sync_batch_norm.fwd")
    assert sync_batch_norm._world_sum is direct
    assert calls == [("sum", "sync_batch_norm.fwd")]
    assert torch.equal(out, torch.ones(3))


def test_tf_keras_phase_without_tensorflow_runs_nothing(monkeypatch, capsys):
    cs = _chip_smoke()
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "tensorflow" else real(name, *a)))

    def refuse(*args, **kwargs):
        raise AssertionError("(m) started a process without TensorFlow")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    cs.tf_keras_phase("no card")
    assert capsys.readouterr().out.splitlines() == [
        "    (m) tf/keras: tensorflow not installed on this machine; "
        "phase not run"]


@pytest.mark.slow
def test_tf_keras_phase_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("CHIP_SMOKE_DEVICE", "cpu")
    _chip_smoke().tf_keras_phase("cpu")
    out = capsys.readouterr().out
    assert "tf_ring: every check" in out and "tf_staged: every check" in out
    assert "keras_mnist at two ranks" in out


def test_spark_probe_reads_the_installed_set(monkeypatch):
    """(n)'s probe line: one entry a package, from ``find_spec`` alone."""
    cs = _chip_smoke()
    assert list(cs.probe_packages()) == list(cs.PROBED)
    real = {m: importlib.util.find_spec(m) is not None for m in cs.PROBED}
    assert cs.probe_packages() == real
    present = ("pandas", "cloudpickle")
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        object() if name in present else None))
    assert cs.probe_packages() == {m: m in present for m in cs.PROBED}


def test_spark_task_fn_holds_a_world_of_one(monkeypatch):
    """(n)'s task function on the CPU at one rank: the allreduce is exact
    and the MLP's losses are finite (the parameters' digest is the one
    of a fresh run)."""
    monkeypatch.setenv("CHIP_SMOKE_DEVICE", "cpu")
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "0")
    cs = _chip_smoke()
    a = cs.spark_task_fn(2)
    b = cs.spark_task_fn(2)
    assert (a["rank"], a["size"], a["allreduce_err"]) == (0, 1, 0.0)
    assert len(a["losses"]) == 2 and all(np.isfinite(a["losses"]))
    assert a["digest"] == b["digest"]
    with pytest.raises(RuntimeError, match="planted failure"):
        cs.spark_failing_fn()


@pytest.mark.slow
def test_spark_mxnet_phase_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("CHIP_SMOKE_DEVICE", "cpu")
    _chip_smoke().spark_mxnet_phase("cpu")
    out = capsys.readouterr().out
    assert "(n) installed: pyspark " in out
    assert "results in rank order, parameters equal bitwise" in out
    assert "the raising function: reported" in out
    assert "registered after its driver gave up: refused" in out
    assert "(n) mxnet: not installed" in out


def test_core_phase_on_the_cpu(monkeypatch, capsys):
    """Phase (o) on the CPU (``CHIP_SMOKE_DEVICE=cpu``: staging and the
    binding's groups on gloo): the probe line, the healed cut with its
    counters and verdicts, every survivor's raise with each group's abort
    seconds, and the stress harness (under TSan here)."""
    monkeypatch.setenv("CHIP_SMOKE_DEVICE", "cpu")
    _chip_smoke().core_phase("cpu")
    out = capsys.readouterr().out
    assert "(o) probe: " in out and "TSan sound" in out, out
    for rank, reconnects in ((0, 1), (1, 0), (2, 1), (3, 0)):
        assert (f"heal rank {rank}: allreduces bitwise the closed form "
                f"[True, True, True, True, True, True, True, True]") in out
        assert f"link.reconnects {reconnects}, stale epochs 0" in out
    assert out.count("world_lost False") == 4, out
    for rank in (0, 2, 3):
        assert f"lost member: rank {rank} raised HorovodInternalError" in out
    assert "group aborts 0 [0, 1, 2, 3] (gloo)" in out, out
    assert "stress harness (TSan): exit 0, 0 TSan reports" in out, out
    assert "STRESS_OK" in out
