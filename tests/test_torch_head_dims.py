"""The port's attention at head dims other than 64 and 128 and in fp16,
against the JAX package's.

The JAX attention takes any float dtype and any head dim (its tiling
constraint is on T only); the port's kernels run fp32, bf16 and fp16 at
every D >= 1, up to 256 at three tile widths and past it in chunks of 256
output columns (``ops/flash_attention.kernel_layout``). On the CPU the
wrappers compute their plain versions, which take any D: each is held
here against the Pallas kernel it replaces, in interpret mode, on the
same numpy inputs, at D 16, 20, 80, 96, 256, 320 and 512 in fp32, bf16
and fp16, in every mode (the forward's plain, train and state outputs; dQ
and dK/dV with fp32 outputs), causal with a window and offsets, and
causal with segment ids. Then the decoder at D 80 and 256 (``d_model``
160 over 2 heads, 256 over 1) against the JAX model, and the wrapper's
layout rule as a function.

Tolerances are ``tests/test_torch_flash_attention.py``'s (the reference's
own): 2e-5 in fp32 and 2e-2 in bf16, the latter for bf16 rounding at
other places in the two computations (the Pallas kernels round P and dS
to the inputs' dtype before their products; the plain versions do not).
fp16 keeps 3 more bits than bf16, so the same rounding moves the outputs
~8 times less: 5e-3 (at D 512 the two sides differ by at most 2e-3 on
outputs of magnitude 1 to 5). The decoder's are
``tests/test_torch_transformer.py``'s: loss rel 1e-5, gradients rtol 1e-4
with atol 1e-6 of the largest entry, fp32 on both sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import pallas_attention as ref
from horovod_tpu.parallel.mesh import build_parallel_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.training import cross_entropy_loss

TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16}
B, H, T = 2, 2, 64
# Masks: queries at global positions 32..95 against keys 0..63 under a
# causal window of 24 (rows 32..55 see a partial window, the rest none
# past key 63); and causal attention within three packed segments a row,
# the second row's first segment shorter than a 16-token tile.
MASKS = {
    "window-offsets": dict(causal=True, q_off=32, k_off=0, window=24),
    "segments": dict(causal=True, q_off=0, k_off=0, window=None),
}
SEGMENTS = np.array([[1] * 20 + [2] * 30 + [3] * 14,
                     [4] * 9 + [5] * 40 + [6] * 15], np.int32)


def _inputs(D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(4)]


def _merged(x, dtype):
    """[B, T, H, D] numpy -> the JAX kernels' [B*H, T, D] in ``dtype``."""
    return ref._merge_heads(jnp.asarray(x, _JDT[dtype]))


def _split(x, D=None):
    """The JAX kernels' [B*H, T, D] (or [B*H, T, 1]) -> numpy [B, T, H, D]
    (or [B, H, T])."""
    x = np.asarray(x, np.float32)
    if D is None:
        return x.reshape(B, H, T)
    return x.reshape(B, H, T, D).transpose(0, 2, 1, 3)


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [16, 20, 80, 96, 256, 320, 512])
def test_every_mode_matches_the_pallas_kernels(D, dtype, mask):
    kw = MASKS[mask]
    q, k, v, do = _inputs(D, seed=D)
    jq, jk, jv, jdo = (_merged(x, dtype) for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.tensor(x).to(_TDT[dtype]) for x in (q, k, v, do))
    jseg, tseg = {}, {}
    if mask == "segments":
        ids = jnp.asarray(np.repeat(SEGMENTS, H, axis=0))
        jseg = dict(q_seg=ids, k_seg=ids)
        tseg = dict(q_seg=torch.tensor(SEGMENTS), k_seg=torch.tensor(SEGMENTS))
    offs = jnp.asarray([kw["q_off"], kw["k_off"]], jnp.int32)
    tkw = dict(kw, **tseg)
    tol = TOL[dtype]

    o = ref._pallas_attention_fwd(jq, jk, jv, kw["q_off"], kw["k_off"],
                                  True, True, window=kw["window"], **jseg)
    _close(fa.flash_fwd(tq, tk, tv, **tkw)[0], _split(o, D), tol, "fwd O")

    o, lse = ref._pallas_attention_fwd_train(jq, jk, jv, offs, True, True,
                                             window=kw["window"], **jseg)
    to, tlse = fa.flash_fwd(tq, tk, tv, with_lse=True, **tkw)
    _close(to, _split(o, D), tol, "train O")
    _close(tlse, _split(lse), tol, "train lse")

    acc, m, l = ref._pallas_block_state(jq, jk, jv, offs, True, True,
                                        window=kw["window"], **jseg)
    tacc, tm, tl = fa.flash_fwd_state(tq, tk, tv, **tkw)
    _close(tacc, _split(acc, D), tol, "state acc")
    _close(tm, _split(m), tol, "state m")
    _close(tl, _split(l), tol, "state l")

    # The backward on the Pallas forward's lse and delta = rowsum(dO * O).
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32), -1,
                    keepdims=True)
    dq, dk, dv = ref._pallas_bwd(jq, jk, jv, jdo, lse, delta, offs, True,
                                 True, out_dtype=jnp.float32,
                                 window=kw["window"], **jseg)
    rows = [torch.tensor(_split(x)) for x in (lse, delta)]
    f32 = dict(tkw, out_dtype=torch.float32)
    tdq = fa.flash_bwd_dq(tq, tk, tv, tdo, *rows, **f32)
    tdk, tdv = fa.flash_bwd_dkv(tq, tk, tv, tdo, *rows, **f32)
    assert {x.dtype for x in (tdq, tdk, tdv)} == {torch.float32}
    for name, got, want in (("dQ", tdq, dq), ("dK", tdk, dk), ("dV", tdv, dv)):
        _close(got, _split(want, D), tol, f"fp32 {name}")


DECODERS = {"d80": dict(d_model=160, n_heads=2), "d256": dict(d_model=256,
                                                             n_heads=1)}


@pytest.mark.parametrize("width", sorted(DECODERS))
def test_decoder_matches_jax_at_wide_heads(width, monkeypatch):
    """The decoder (2 layers, T 64, B 2, fp32, RoPE) at head dims 80 and
    256: the step-0 loss and every gradient against the JAX model on the
    same parameters (``params_from_jax``), its Pallas kernels in interpret
    mode."""
    monkeypatch.setenv("HVD_PALLAS_INTERPRET", "1")
    w = DECODERS[width]
    kw = dict(vocab=256, d_model=w["d_model"], n_heads=w["n_heads"],
              d_head=w["d_model"] // w["n_heads"], d_ff=4 * w["d_model"],
              n_layers=2, max_seq=T, rope=True)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **kw)
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
    jgrads = jax.device_get(jgrads)
    loss = cross_entropy_loss(model(torch.as_tensor(tokens, dtype=torch.long)),
                              torch.as_tensor(labels, dtype=torch.long))
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            _, i, leaf = name.split(".")
            want = np.asarray(jgrads[leaf])[0, int(i)]
        else:
            want = np.asarray(jgrads[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"{width}: grad {name}")


@pytest.mark.parametrize("D, dtype, layout", [
    (1, torch.bfloat16, (64, 8)), (16, torch.bfloat16, (64, 16)),
    (20, torch.bfloat16, (64, 24)), (20, torch.float32, (64, 20)),
    (18, torch.float32, (64, 24)), (64, torch.bfloat16, (64, 64)),
    (65, torch.float32, (128, 72)), (80, torch.bfloat16, (128, 80)),
    (96, torch.float32, (128, 96)), (128, torch.bfloat16, (128, 128)),
    (129, torch.bfloat16, (256, 136)), (160, torch.bfloat16, (256, 160)),
    (256, torch.float32, (256, 256)), (257, torch.bfloat16, (256, 264)),
    (320, torch.float32, (256, 320)), (64, torch.float16, (64, 64)),
    (20, torch.float16, (64, 24)), (1024, torch.float16, (256, 1024)),
])
def test_kernel_layout_picks_the_tile_and_the_padded_dim(D, dtype, layout):
    """D runs at the smallest tile width of 64, 128 and 256 that holds it,
    and past 256 at 256 in chunks of 256 output columns; the kernels read D
    itself when its row is whole 16-byte words, else D padded to a multiple
    of 8."""
    assert fa.kernel_layout(D, dtype) == layout
    assert layout[0] in fa.D_TILES
    assert fa.chunks(D, dtype) == -(-layout[1] // layout[0])
    assert (fa.chunks(D, dtype) > 1) == (D > fa.D_TILES[-1])


@pytest.mark.parametrize("D, dtype, match", [
    (0, torch.bfloat16, "head dim 0"), (-1, torch.float16, "head dim -1"),
    (64, torch.float64, "float64"), (64, torch.int32, "int32"),
])
def test_kernel_layout_refuses_what_is_queued(D, dtype, match):
    """What has no kernel raises: D below 1, and dtypes other than fp32,
    bf16 and fp16 (the message names the three)."""
    with pytest.raises(ValueError, match=match) as e:
        fa.kernel_layout(D, dtype)
    if "dtype" in str(e.value):
        assert "float32, bfloat16, float16" in str(e.value)


def _view(shape, spare, dtype, offset=0):
    """A [B, T, H, D] view of a [B, T, H, D + spare] buffer, starting
    ``offset`` elements into it."""
    buf = torch.zeros(int(np.prod(shape[:3])) * (shape[3] + spare) + offset,
                      dtype=dtype)
    return buf[offset:].view(*shape[:3], shape[3] + spare)[..., :shape[3]]


@pytest.mark.parametrize("case, copied", [
    ("contiguous-d80", False), ("view-d80-of-d88", False),
    ("contiguous-d20", True), ("view-off-by-one-element", True),
    ("head-dim-not-contiguous", True), ("fp32-d20", False),
])
def test_needs_copy_follows_the_kernels_reads(case, copied):
    """An operand is copied when its head dim is not the kernels' (padded)
    one or when its pointer or b/t/h strides are not 16-byte multiples."""
    bf16, shape = torch.bfloat16, (2, 8, 2, 80)
    t = {"contiguous-d80": lambda: torch.zeros(shape, dtype=bf16),
         "view-d80-of-d88": lambda: _view(shape, 8, bf16),
         "contiguous-d20": lambda: torch.zeros((2, 8, 2, 20), dtype=bf16),
         "view-off-by-one-element": lambda: _view(shape, 8, bf16, offset=1),
         "head-dim-not-contiguous": lambda: torch.zeros(
             (2, 8, 80, 2), dtype=bf16).transpose(2, 3),
         "fp32-d20": lambda: torch.zeros((2, 8, 2, 20))}[case]()
    Dk = fa.kernel_layout(t.shape[-1], t.dtype)[1]
    assert fa.needs_copy(t, Dk) is copied


def test_kernel_operands_pads_with_zeros_and_counts():
    """The copy the wrapper hands the kernels: contiguous, the caller's
    values in the first D columns and zeros up to the padded dim, one
    count per operand copied; an operand the kernels read in place is
    passed as it is."""
    fa.reset_launches()
    x = torch.randn(2, 8, 2, 20).to(torch.bfloat16)
    y = torch.zeros(2, 8, 2, 24, dtype=torch.bfloat16)
    cx, cy = fa._kernel_operands("flash_bwd_dq", 24, x, y)
    assert cy is y
    assert cx.shape == (2, 8, 2, 24) and cx.is_contiguous()
    assert torch.equal(cx[..., :20], x) and not cx[..., 20:].any()
    assert fa.LAYOUT_COPIES == {"flash_fwd": 0, "flash_fwd_state": 0,
                                "flash_bwd_dq": 1, "flash_bwd_dkv": 0}
    fa.reset_launches()
    assert not any(fa.LAYOUT_COPIES.values())
