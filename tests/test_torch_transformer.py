"""The port's data-parallel transformer against the JAX package's.

Small config (vocab 256, d_model 64, 4 heads of 16, 2 layers, T 64,
B 2, fp32). The JAX parameters from ``init_params(cfg, key, n_stages=1)``
reach the port through ``params_from_jax``; the same numpy tokens feed
both. The JAX side is ``make_loss_fn`` on a 1-device mesh with the Pallas
kernels in interpret mode (HVD_PALLAS_INTERPRET=1), and the dense
single-device oracle ``dense_reference_loss``.

Tolerances (fp32 on both sides; the two differ only in summation order
and in where fp32 rounds): loss rel 1e-5; gradients rtol 1e-4 with atol
1e-6 of the largest gradient entry, tighter than the reference's own
sharded-vs-dense 5e-3 (tests/test_transformer.py). Parameters after 3
AdamW steps: each step moves a parameter by about lr (3e-4), and Adam's
normalisation turns a relative gradient error e into a
relative step error of about e. The exception is an entry whose gradient
sits at fp32's summation-noise floor: there the two Adam steps may differ
by up to a step. So after 3 steps every entry agrees to 1e-5 (1/30 of
one step) and all but one in 10^4 entries of each parameter to 1e-6; a
wrong learning rate, beta, epsilon, weight decay (torch's default 1e-2 in
place of optax's 1e-4 moves the unit layer-norm scales by ~9e-6) or bias
correction breaks the second bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.mesh import build_parallel_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.training import cross_entropy_loss, make_train_step

VARIANTS = {
    "mha": {},
    "gqa-rope": dict(n_kv_heads=2, rope=True),
    "window": dict(attention_window=16),
}
B, T = 2, 64


def _configs(variant):
    kw = dict(vocab=256, d_model=64, n_heads=4, d_head=16, d_ff=256,
              n_layers=2, max_seq=T, **VARIANTS[variant])
    return (jt.TransformerConfig(dtype=jnp.float32, **kw),
            tt.TransformerConfig(dtype=torch.float32, **kw))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 256, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _setup(variant, monkeypatch):
    monkeypatch.setenv("HVD_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _configs(variant)
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0), 1))
    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, tcfg))
    mesh = build_parallel_mesh(jax.devices()[:1], dp=1, pp=1, sp=1, tp=1)
    return jcfg, tcfg, params, model, mesh


def _torch_grads(model, tokens, labels):
    loss = cross_entropy_loss(model(torch.as_tensor(tokens, dtype=torch.long)),
                              torch.as_tensor(labels, dtype=torch.long))
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


def _per_layer(tree, name, i):
    return np.asarray(tree[name])[0, i]


def _assert_grads(tgrads, jgrads, n_layers, what):
    for name, g in tgrads.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".")
            want = _per_layer(jgrads, leaf, int(i))
        else:
            want = np.asarray(jgrads[name])
        scale = np.abs(want).max()
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f"{what}: grad {name}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax_kernels(variant, monkeypatch):
    jcfg, tcfg, params, model, mesh = _setup(variant, monkeypatch)
    tokens, labels = _data()
    sharded = jt.shard_params(params, jcfg, mesh)
    loss_fn = jt.make_loss_fn(jcfg, mesh, n_microbatches=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        sharded, jnp.asarray(tokens), jnp.asarray(labels))
    tloss, tgrads = _torch_grads(model, tokens, labels)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads(tgrads, jax.device_get(jgrads), tcfg.n_layers, variant)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_dense_reference(variant, monkeypatch):
    jcfg, tcfg, params, model, _ = _setup(variant, monkeypatch)
    tokens, labels = _data(1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.dense_reference_loss(jcfg, p, jnp.asarray(tokens),
                                          jnp.asarray(labels))))(params)
    tloss, tgrads = _torch_grads(model, tokens, labels)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads(tgrads, jax.device_get(jgrads), tcfg.n_layers, variant)


def test_params_after_three_adamw_steps_match_jax(monkeypatch):
    import horovod_tpu_torch as hvd

    jcfg, tcfg, params, model, mesh = _setup("mha", monkeypatch)
    tokens, labels = _data(2)
    optimizer = optax.adamw(3e-4)
    step = jt.make_train_step(jcfg, optimizer, mesh, n_microbatches=1)
    jparams = jt.shard_params(params, jcfg, mesh)
    opt_state = optimizer.init(jparams)
    for _ in range(3):
        jparams, opt_state, _ = step(jparams, opt_state, jnp.asarray(tokens),
                                     jnp.asarray(labels))
    jparams = jax.device_get(jparams)

    hvd.init(device="cpu")
    try:
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        tstep = make_train_step(model, opt)
        for _ in range(3):
            tstep(torch.as_tensor(tokens, dtype=torch.long),
                  torch.as_tensor(labels, dtype=torch.long))
        assert opt.allreduce_count == 3 * len(opt._buckets)
    finally:
        hvd.shutdown()
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            _, i, leaf = name.split(".")
            want = _per_layer(jparams, leaf, int(i))
        else:
            want = np.asarray(jparams[name])
        diff = np.abs(p.detach().numpy() - want)
        assert diff.max() <= 1e-5, (name, diff.max())
        assert (diff > 1e-6).mean() <= 1e-4, (name, (diff > 1e-6).sum())


def test_params_from_jax_round_trip_keeps_layouts():
    jcfg, tcfg = _configs("gqa-rope")
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(3), 1))
    state = tt.params_from_jax(params, tcfg)
    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(state)
    assert model.layers[1].wq.shape == (64, 4, 16)
    assert model.layers[1].wkv.shape == (64, 2, 2, 16)
    np.testing.assert_array_equal(model.layers[1].wkv.detach().numpy(),
                                  np.asarray(params["wkv"])[0, 1])
    assert "pos" not in state


@pytest.mark.parametrize("n_stages, tp", [(1, 2), (2, 1), (2, 2)])
def test_params_from_jax_slices_and_join_shards_restores(n_stages, tp):
    """Each rank's slice of an ``init_params(n_stages)`` tree (its stage's
    layers, its tp share of the heads and hidden units) joins back into
    the same tree; a tree of another stage count is refused."""
    jcfg, tcfg = _configs("gqa-rope")
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(5),
                                           n_stages))
    coords = [dict(stage=s, n_stages=n_stages, tp=(t, tp), dp=(0, 1))
              for s in range(n_stages) for t in range(tp)]
    shards = [(c, {k: v.numpy() for k, v in
                   tt.params_from_jax(params, tcfg, **c).items()})
              for c in coords]
    assert shards[-1][1]["layers.0.wq"].shape == (64, 4 // tp, 16)
    joined = tt.join_shards(shards, tcfg)
    assert set(joined) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(joined[k], np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="pipeline stages"):
        tt.params_from_jax(params, tcfg, n_stages=n_stages + 1)


@pytest.mark.parametrize("kwargs, match", [
    (dict(use_moe=True), "MoE"), (dict(remat=True), "remat")])
def test_later_slice_configs_raise(kwargs, match, monkeypatch):
    """MoE and remat were refused until the slice that ported them; the
    test keeps its name and now runs each configuration on one rank: loss
    and every gradient against the JAX package's dense oracle (MoE top-2
    with ample capacity, 4 experts; remat recomputing both layers)."""
    monkeypatch.setenv("HVD_PALLAS_INTERPRET", "1")
    if match == "MoE":
        kwargs = dict(kwargs, n_experts=4, d_expert=32, moe_top_k=2,
                      capacity_factor=8.0)
    kw = dict(vocab=256, d_model=64, n_heads=4, d_head=16, d_ff=256,
              n_layers=2, max_seq=T, **kwargs)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(4), 1))
    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, tcfg))
    tokens, labels = _data(3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.dense_reference_loss(jcfg, p, jnp.asarray(tokens),
                                          jnp.asarray(labels))))(params)
    tloss, tgrads = _torch_grads(model, tokens, labels)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads(tgrads, jax.device_get(jgrads), tcfg.n_layers, match)


def test_later_slice_inputs_raise():
    """tp and pp were refused until the slice that ported them; the test
    keeps its name: both are accepted now, a model whose heads do not
    split over tp still raises (the JAX package's message), and packed
    segment ids run (a size-1 run here; tests/test_torch_ring_attention.py
    runs sp = 2 and 4, tests/test_torch_model_parallel.py pp = 2)."""
    for kwargs in (dict(tp=2), dict(pp=2), dict(tp=2, pp=2, sp=2)):
        tt.check_parallelism(**kwargs)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        tt.check_parallelism(tp=0)
    with pytest.raises(ValueError, match="n_heads.*tp"):
        tt.validate_mesh(tt.TransformerConfig(n_heads=6), tp=4)
    with pytest.raises(ValueError, match="kv_heads.*tp"):
        tt.validate_mesh(tt.TransformerConfig(n_heads=8, n_kv_heads=2), tp=4)
    model = tt.Transformer(tt.TransformerConfig(n_layers=1), device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1]])
    logits = model(tokens, segment_ids=seg)
    assert logits.shape == (1, 8, 256) and torch.isfinite(logits).all()


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_check_parallelism_accepts_sp(sp):
    tt.check_parallelism(sp=sp)
    with pytest.raises(ValueError, match="sp must be >= 1"):
        tt.check_parallelism(sp=0)
