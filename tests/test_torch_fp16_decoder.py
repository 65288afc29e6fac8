"""The port's decoder in fp16 and at a head dim past 256, against the JAX
package's.

The JAX ``TransformerConfig`` takes any float ``dtype`` and any
``d_head``, and its attention any float dtype and head dim; the port's
kernels take fp16 and D > 256 too. On the CPU the port's attention is its
plain version; the JAX side is ``make_loss_fn`` on a 1-device mesh with
the Pallas kernels in interpret mode (HVD_PALLAS_INTERPRET=1). Both sides
start from the same ``init_params`` tree (``params_from_jax``) and the
same numpy tokens, and one training step's loss and gradients are held
against each other:

- fp16 at Pythia-2.8B's head dim (2 layers, d_model 160 over 2 heads of
  80, RoPE, T 64, B 2). Both sides keep the weights and the activations in
  fp16 and take the layer norms, the softmax and the logits in fp32, but
  round at other places: the Pallas kernels round P and dS to fp16 before
  their products, the plain versions keep them in fp32, and the two
  frameworks' fp16 matmuls accumulate in other orders. The loss agrees to
  rel 1e-4 (it read 3e-6 here) and each gradient to 1 % of its largest
  entry (it read 0.06 % to 0.18 %); a gradient of the wrong layer, sign or
  scale misses by 100 %.
- fp32 at d_head 320 (2 layers, d_model 320 over 1 head, RoPE): loss rel
  1e-5, gradients rtol 1e-4 with atol 1e-6 of the largest entry, as
  ``tests/test_torch_head_dims.py``'s decoder at D 80 and 256.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.mesh import build_parallel_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.training import cross_entropy_loss

B, T = 2, 64
CASES = {
    "fp16-d80": (dict(d_model=160, n_heads=2), jnp.float16, torch.float16),
    "fp32-d320": (dict(d_model=320, n_heads=1), jnp.float32, torch.float32),
}
# (loss rel, gradient rtol, gradient atol as a share of the largest entry)
TOL = {"fp16-d80": (1e-4, 0.0, 1e-2), "fp32-d320": (1e-5, 1e-4, 1e-6)}


def _step(case, monkeypatch):
    """(JAX loss, JAX gradients, the port's model after one backward, its
    loss, the JAX parameter tree) of one step of ``case``."""
    monkeypatch.setenv("HVD_PALLAS_INTERPRET", "1")
    w, jdt, tdt = CASES[case]
    kw = dict(vocab=256, d_model=w["d_model"], n_heads=w["n_heads"],
              d_head=w["d_model"] // w["n_heads"], d_ff=4 * w["d_model"],
              n_layers=2, max_seq=T, rope=True)
    jcfg = jt.TransformerConfig(dtype=jdt, **kw)
    tcfg = tt.TransformerConfig(dtype=tdt, **kw)
    params = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0), 1))
    model = tt.Transformer(tcfg, device="cpu")
    model.load_state_dict(tt.params_from_jax(params, tcfg))
    mesh = build_parallel_mesh(jax.devices()[:1], dp=1, pp=1, sp=1, tp=1)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (B, T)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    loss_fn = jt.make_loss_fn(jcfg, mesh, n_microbatches=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jt.shard_params(params, jcfg, mesh), jnp.asarray(tokens),
        jnp.asarray(labels))
    loss = cross_entropy_loss(model(torch.as_tensor(tokens, dtype=torch.long)),
                              torch.as_tensor(labels, dtype=torch.long))
    loss.backward()
    return float(jloss), jax.device_get(jgrads), model, loss.item(), params


def _leaf(tree, name):
    if name.startswith("layers."):
        _, i, leaf = name.split(".")
        return np.asarray(tree[leaf])[0, int(i)]
    return np.asarray(tree[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_step_matches_jax(case, monkeypatch):
    jloss, jgrads, model, loss, _ = _step(case, monkeypatch)
    loss_rel, rtol, atol = TOL[case]
    assert np.isfinite(loss)
    assert loss == pytest.approx(jloss, rel=loss_rel)
    for name, p in model.named_parameters():
        want = _leaf(jgrads, name).astype(np.float32)
        got = p.grad.float().numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol * np.abs(want).max(),
                                   err_msg=f"{case}: grad {name}")


def test_params_from_jax_keeps_fp16(monkeypatch):
    """A JAX float16 leaf becomes a torch float16 parameter with the same
    bits; the layer norms' scales stay fp32 on both sides."""
    _, _, model, _, params = _step("fp16-d80", monkeypatch)
    for name, p in model.named_parameters():
        want = _leaf(params, name)
        assert p.dtype == (torch.float32 if want.dtype == np.float32
                           else torch.float16), name
        np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=name)
        assert p.grad.dtype == p.dtype, name
    assert model.layers[0].wqkv.dtype == torch.float16
