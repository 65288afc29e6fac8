"""The port's flash attention (horovod_tpu_torch/ops/flash_attention.py)
against the JAX package's (horovod_tpu/ops/pallas_attention.py).

On the CPU the port computes its kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode (``use_pallas=True``). The same
numpy inputs feed both. Tolerances are the reference's own: 2e-5 in fp32
(tests/test_pallas_attention.py:45) and 2e-2 in bf16 (:238), the latter
for bf16 rounding at different places in the two computations.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.ops import pallas_attention as ref
from horovod_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(B, Tq, Tk, H, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Tq, H, D).astype(np.float32),
            rng.randn(B, Tk, H, D).astype(np.float32),
            rng.randn(B, Tk, H, D).astype(np.float32),
            rng.randn(B, Tq, H, D).astype(np.float32))


def _jax_side(q, k, v, do, dtype, seg=None, **kw):
    """(out, dq, dk, dv) from the JAX package, Pallas in interpret mode."""
    args = [jnp.asarray(x, _JDT[dtype]) for x in (q, k, v)]
    segs = {}
    if seg is not None:
        segs = dict(q_segment_ids=jnp.asarray(seg[0]),
                    k_segment_ids=jnp.asarray(seg[1]))
    out, vjp = jax.vjp(lambda *a: ref.flash_attention(
        *a, use_pallas=True, **segs, **kw), *args)
    grads = vjp(jnp.asarray(do, _JDT[dtype]))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _torch_side(q, k, v, do, dtype, seg=None, **kw):
    """(out, dq, dk, dv) from the port through torch.autograd."""
    args = [torch.tensor(x).to(_TDT[dtype]).requires_grad_()
            for x in (q, k, v)]
    segs = {}
    if seg is not None:
        segs = dict(q_segment_ids=torch.tensor(seg[0]),
                    k_segment_ids=torch.tensor(seg[1]))
    out = fa.flash_attention(*args, **segs, **kw)
    out.backward(torch.tensor(do).to(_TDT[dtype]))
    return [x.detach().float().numpy() for x in (out, *(a.grad for a in args))]


def _assert_match(got, want, tol, what):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what}: {name}")


CASES = {
    "causal": dict(B=2, Tq=32, Tk=32, H=2, D=16, kw=dict(causal=True)),
    "non-causal": dict(B=2, Tq=32, Tk=32, H=2, D=16, kw=dict(causal=False)),
    "offsets": dict(B=1, Tq=16, Tk=32, H=2, D=16,
                    kw=dict(causal=True, q_off=16, k_off=0)),
    "window": dict(B=1, Tq=64, Tk=64, H=2, D=8,
                   kw=dict(causal=True, window=8)),
    "ragged": dict(B=2, Tq=20, Tk=20, H=2, D=16, kw=dict(causal=True)),
    "multi-tile": dict(B=1, Tq=1024, Tk=1024, H=1, D=8,
                       kw=dict(causal=True, window=600)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case, dtype):
    c = CASES[case]
    q, k, v, do = _arrays(c["B"], c["Tq"], c["Tk"], c["H"], c["D"], seed=1)
    want = _jax_side(q, k, v, do, dtype, **c["kw"])
    got = _torch_side(q, k, v, do, dtype, **c["kw"])
    _assert_match(got, want, TOL[dtype], f"{case} {dtype}")


@pytest.mark.parametrize("causal", [True, False])
def test_segment_ids_match_jax(causal):
    q, k, v, do = _arrays(2, 32, 32, 2, 16, seed=2)
    seg = np.array([[0] * 12 + [1] * 20, [0] * 5 + [1] * 27], np.int32)
    want = _jax_side(q, k, v, do, "float32", seg=(seg, seg), causal=causal)
    got = _torch_side(q, k, v, do, "float32", seg=(seg, seg), causal=causal)
    _assert_match(got, want, TOL["float32"], f"segments causal={causal}")


@pytest.mark.parametrize("window", [None, 8])
def test_lse_matches_jax_train_kernel(window):
    """The train-mode lse against the Pallas train kernel's residual."""
    q, k, v, _ = _arrays(2, 64, 64, 2, 16, seed=3)
    offs = jnp.asarray([0, 0], jnp.int32)
    _, lse_ref = ref._pallas_attention_fwd_train(
        *(ref._merge_heads(jnp.asarray(x)) for x in (q, k, v)), offs,
        causal=True, interpret=True, window=window)
    _, lse = fa.flash_fwd(*(torch.tensor(x) for x in (q, k, v)),
                          causal=True, window=window, with_lse=True)
    np.testing.assert_allclose(lse.numpy().reshape(-1),
                               np.asarray(lse_ref).reshape(-1),
                               rtol=2e-5, atol=2e-5)


def test_rows_without_keys_give_zero_and_large_lse():
    """q_off < k_off leaves the first rows with no visible key: O = 0 and
    lse = +1e30 (the Pallas kernel's convention, pallas_attention.py:139),
    and the gradients stay finite."""
    q, k, v, do = _arrays(1, 16, 16, 1, 16, seed=4)
    o, lse = fa.flash_fwd(*(torch.tensor(x) for x in (q, k, v)),
                          causal=True, q_off=0, k_off=8, with_lse=True)
    assert torch.all(o[0, :8] == 0)
    assert torch.all(lse[0, 0, :8] == 1e30)
    want = _jax_side(q, k, v, do, "float32", causal=True, q_off=0, k_off=8)
    got = _torch_side(q, k, v, do, "float32", causal=True, q_off=0, k_off=8)
    _assert_match(got, want, TOL["float32"], "rows without keys")
    assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("kwargs, match", [
    (dict(causal=False, window=4), "sliding-window attention is defined"),
    (dict(causal=True, window=0), "window must be >= 1"),
    (dict(causal=True, q_segment_ids=np.zeros((1, 8), np.int32)),
     "pass both q_segment_ids and k_segment_ids"),
])
def test_errors_match_jax(kwargs, match):
    x = np.zeros((1, 8, 1, 16), np.float32)
    with pytest.raises(ValueError, match=match):
        ref.flash_attention(*(jnp.asarray(x),) * 3, use_pallas=True,
                            **kwargs)
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(*(torch.tensor(x),) * 3, **tkw)


def test_plain_versions_match_block_grads():
    """The plain backward pair against the JAX package's
    ``_xla_block_grads`` on the same lse/delta residuals."""
    q, k, v, do = _arrays(1, 32, 32, 2, 16, seed=5)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = fa.flash_fwd_plain(tq, tk, tv, causal=True, with_lse=True)
    delta = (tdo * o).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, causal=True)
    dk, dv = fa.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, causal=True)
    m = [ref._merge_heads(jnp.asarray(x)) for x in (q, k, v, do)]
    want = ref._xla_block_grads(
        *m, jnp.asarray(lse.numpy()).reshape(2, 32, 1),
        jnp.asarray(delta.numpy()).reshape(2, 32, 1),
        jnp.asarray([0, 0], jnp.int32), True)
    for got, w in zip((dq, dk, dv), want):
        w = np.asarray(w).reshape(1, 2, 32, 16).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-5, atol=2e-5)


def test_no_grad_call_counts_nothing_on_cpu():
    """On CPU tensors the wrappers compute the plain versions: no kernel
    launch is counted, in either forward mode."""
    q, k, v, do = (torch.tensor(x) for x in _arrays(1, 16, 16, 1, 16, 6))
    fa.reset_launches()
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    q.requires_grad_()
    fa.flash_attention(q, k, v).backward(do)
    assert set(fa.LAUNCHES.values()) == {0}


def test_device_without_a_kernel_raises():
    """Neither CPU nor CUDA: the wrapper raises rather than computing
    somewhere else."""
    q = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_fwd(q, q, q)
