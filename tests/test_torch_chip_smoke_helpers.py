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
