"""The port's image models against the JAX package's, on the CPU.

Variables in flax's layout, drawn with numpy from a seed to the shapes of
``jax.eval_shape(model.init)`` (kernels normal with std sqrt(1/fan_in);
biases, batch-norm scales, offsets and running statistics away from their
init values, so that every one of them shows; the scale of a residual
block's last batch norm, zero at init, at 0.1 +- 0.02, so that every conv
of the block has a live gradient while the residual stream stays as well
conditioned as near init: at 0.5 the sides part by ~1e-5 in the logits,
at 1 by ~1e-4, rounding amplified through 16 blocks), reach the port
through ``params_from_jax``; the same numpy images and labels feed both sides.
Models, cut to size (the widths are the only cut): ResNet18 and ResNet50
at ``num_filters=8``, 10 classes, batch 2, at 64 and 48 px (a ReLU
network's gradient jumps where a ReLU input or a max-pool pair sits
within rounding of a tie; at 64 or 32 px ResNet50 has such an element,
and both sides' fp32 gradients stand ~4e-3 from the float64 one there,
a CPU measurement; at 48 px it has none); VGG16 at filters
(8, 8, 16, 16, 16), ``dense_width=32``, 64 px (at 32 px the last grid is
1x1 and both flatten orders agree, so the NCHW control could not be
refused); InceptionV3 at 75 px, batch 2. Images are standard normal.

The JAX side runs flax's batch norm with its two-pass variance
(``use_fast_variance=False``, set in flax's ``_compute_stats`` for this
module): the default one-pass E[x^2] - E[x]^2 loses relative precision
where mean^2 >> var, which reaches ~2e-4 in batch-norm gradients here,
while the port's statistics are two-pass. One test holds the port to the
default one-pass reference at the logits.

Tolerances, fp32 on both sides (the sides differ in summation order):

- logits: max |port - jax| <= 1e-5 max |jax| (train and eval mode); the
  loss rel 1e-5; against the one-pass reference 1e-5 at the logits and
  loss;
- gradients: rtol 1e-4, atol 3e-6 of the largest entry over the whole
  model (an entry of the stem's gradient sums ~2e3 products, whose fp32
  sum carries ~1e-6 of the largest entry; a batch-norm bias whose
  gradient is zero up to rounding, ~1e-7, cannot take a per-tensor
  scale);
- updated running statistics: atol 2e-6 (values of order 0.1 to 1:
  momentum 0.9 keeps a tenth of the batch's statistics, whose rounding
  the deeper layers amplify to ~1e-5 relative).

InceptionV3 at 75 px normalizes two values per channel in its last blocks
(a 1x1 grid at batch 2): there a training-mode forward amplifies each
rounding by its condition number and the two sides part by percents (a
CPU measurement, not a fault of either side). So its logits and
gradients are compared in eval mode (the running statistics normalize,
every conv, pad, pool, concatenation and the 1e-3 epsilon take part) at
the limits above; in training mode the stem's statistics (grids of 7x7
and up) are compared at the statistics' limit.

bf16 ResNet18 (JAX bf16 against the port's bf16): logits and loss rel
3e-2, where the sides round convolution outputs and batch-norm inputs at
different places.

Controls the comparisons must refuse: the stem or the max pool padded
symmetrically (PyTorch's ``padding=3`` / ``MaxPool2d(3, 2, 1)``), the
running variance from the unbiased batch variance (``F.batch_norm``'s own
update), and VGG's features flattened in NCHW order.
"""

import functools

import numpy as np
import pytest

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from horovod_tpu.models import inception as ji
from horovod_tpu.models import resnet as jr
from horovod_tpu.models import vgg as jv
from horovod_tpu.training import cross_entropy_loss as jax_loss
from horovod_tpu_torch.models import image_layers
from horovod_tpu_torch.models import inception as ti
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.models import vgg as tv
from horovod_tpu_torch.training import cross_entropy_loss

B = 2
VGG_KW = dict(num_classes=10, num_filters=(8, 8, 16, 16, 16), dense_width=32)
CASES = {   # name: (jax ctor, port ctor, kwargs, image size)
    "resnet18": (jr.ResNet18, tr.ResNet18,
                 dict(num_classes=10, num_filters=8), 64),
    "resnet50": (jr.ResNet50, tr.ResNet50,
                 dict(num_classes=10, num_filters=8), 48),
    "vgg16": (jv.VGG16, functools.partial(tv.VGG16, image_size=64), VGG_KW,
              64),
    "inception3": (ji.InceptionV3, ti.InceptionV3, dict(num_classes=10), 75),
}
LOGIT_TOL, LOSS_TOL, GRAD_RTOL, GRAD_ATOL, STAT_TOL = 1e-5, 1e-5, 1e-4, \
    3e-6, 2e-6
BF16_TOL = 3e-2
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _two_pass_variance(monkeypatch, request):
    if "one_pass_variance" in request.node.name:
        return
    one_pass = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return one_pass(*args, **kwargs)

    monkeypatch.setattr(flax_norm, "_compute_stats", two_pass)


# A residual block's last batch norm, whose scale flax initializes to 0.
_LAST_BN = {"BottleneckBlock": "BatchNorm_2", "BasicBlock": "BatchNorm_1"}


def _fill(shapes, seed=1):
    """numpy values for a flax variables tree of ShapeDtypeStructs."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            block = str(path[-3].key).rsplit("_", 1)[0] if len(path) > 2 \
                else None
            gain = 0.1 if _LAST_BN.get(block) == path[-2].key else 1.0
            return (gain * (1.0 + 0.2 * rng.randn(*s.shape))).astype(
                np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _data(size, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, size, size, 3).astype(np.float32),
            rng.randint(0, 10, B).astype(np.int32))


_JAX = {}


def jax_reference(name, dtype="float32", train=True, grads=True,
                  with_eval=True):
    """JAX's variables, loss, logits, gradients (with ``grads``) and
    updated statistics (the last two as port state-dict entries), and
    (with ``with_eval``) the eval-mode logits under the updated
    statistics; cached per arguments and variance formula."""
    key = (name, dtype, train, grads, with_eval,
           flax_norm._compute_stats.__name__)
    if key in _JAX:
        return _JAX[key]
    jctor, _, kw, size = CASES[name]
    model = jctor(dtype=_JDT[dtype], **kw)
    x, y = (jnp.asarray(a) for a in _data(size))
    variables = _fill(jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False), x))
    stats = variables.get("batch_stats", {})

    def loss_fn(params):
        out = model.apply({"params": params, "batch_stats": stats}, x,
                          train=train, mutable=["batch_stats"])
        logits, new = out
        return jax_loss(logits, y), (logits, new.get("batch_stats", {}))

    if grads:
        (loss, (logits, new_stats)), g = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    else:
        loss, (logits, new_stats) = jax.jit(loss_fn)(variables["params"])
        g = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    new_stats = jax.device_get(new_stats) if train else stats
    eval_logits = jax.jit(lambda v: model.apply(v, x, train=False))(
        {"params": variables["params"], "batch_stats": new_stats}) \
        if with_eval else np.zeros(0)
    grads = {n: t.numpy() for n, t in image_layers.params_from_jax(
        {"params": jax.device_get(g), "batch_stats": new_stats}).items()}
    _JAX[key] = dict(variables=variables, loss=float(loss),
                     logits=np.asarray(logits, np.float32),
                     eval_logits=np.asarray(eval_logits, np.float32),
                     grads=grads)
    return _JAX[key]


def port_run(name, ref, dtype="float32", train=True):
    """The port's model with JAX's variables through one forward and
    backward: (loss, logits, {name: grad or buffer}, eval-mode logits
    after the update, model)."""
    _, tctor, kw, size = CASES[name]
    x, y = (torch.from_numpy(a) for a in _data(size))
    model = tctor(dtype=_TDT[dtype], device="cpu", **kw)
    model.load_state_dict(image_layers.params_from_jax(ref["variables"]))
    model.train(train)
    logits = model(x)
    loss = cross_entropy_loss(logits, y.long())
    loss.backward()
    out = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
    out.update({n: b.numpy() for n, b in model.named_buffers()})
    model.eval()
    with torch.no_grad():
        eval_logits = model(x).float().numpy()
    return loss.item(), logits.detach().float().numpy(), out, eval_logits, \
        model


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_grads(got, ref, names=None):
    grads = {n: g for n, g in ref["grads"].items() if "running" not in n}
    scale = max(np.abs(g).max() for g in grads.values())
    for n, want in grads.items():
        np.testing.assert_allclose(got[n], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale,
                                   err_msg=f"grad {n}")


def _assert_stats(got, ref, keep=lambda n: True):
    stats = {n: s for n, s in ref["grads"].items() if "running" in n}
    assert stats
    for n, want in stats.items():
        if keep(n):
            np.testing.assert_allclose(got[n], want, rtol=0, atol=STAT_TOL,
                                       err_msg=f"stat {n}")


# ---- space-to-depth ---------------------------------------------------------

def test_space_to_depth_equals_jax():
    x = np.random.RandomState(0).randn(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jr.space_to_depth(jnp.asarray(x), 2))
    got = tr.space_to_depth(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    w = np.random.RandomState(1).randn(7, 7, 3, 5).astype(np.float32)
    want = jr.stem_weights_to_s2d(w)                   # HWIO
    got = tr.stem_weights_to_s2d(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="7x7"):
        tr.stem_weights_to_s2d(torch.zeros(5, 3, 3, 3))


def test_s2d_stem_gives_the_7x7_model():
    """At one seed the s2d model is the 7x7 model (its stem re-tiled), and
    with the 7x7 model's JAX weights carried over its logits are JAX's."""
    ref = jax_reference("resnet18")
    x = torch.from_numpy(_data(64)[0])
    kw = dict(num_classes=10, num_filters=8, dtype=torch.float32,
              device="cpu")
    plain = tr.ResNet18(seed=3, **kw).eval()
    s2d = tr.ResNet18(seed=3, space_to_depth_stem=True, **kw).eval()
    with torch.no_grad():
        np.testing.assert_allclose(s2d(x).numpy(), plain(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
    state = image_layers.params_from_jax(ref["variables"])
    state["conv_init_s2d.weight"] = tr.stem_weights_to_s2d(
        state.pop("conv_init.weight"))
    s2d.load_state_dict(state)
    with torch.no_grad():
        got = s2d(x).numpy()
    jm = jr.ResNet18(dtype=jnp.float32, num_classes=10, num_filters=8)
    want = np.asarray(jm.apply(ref["variables"], jnp.asarray(x.numpy()),
                               train=False))
    assert _rel(got, want) <= LOGIT_TOL


# ---- ResNet -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_train_step_matches_jax(name):
    ref = jax_reference(name)
    loss, logits, got, eval_logits, _ = port_run(name, ref)
    assert _rel(logits, ref["logits"]) <= LOGIT_TOL
    assert loss == pytest.approx(ref["loss"], rel=LOSS_TOL)
    _assert_grads(got, ref)
    _assert_stats(got, ref)
    assert _rel(eval_logits, ref["eval_logits"]) <= LOGIT_TOL


def _symmetric_stem(monkeypatch):
    """The 7x7/stride-2 stem padded (3, 3), PyTorch's ``padding=3``."""
    orig = image_layers.Conv.forward

    def forward(self, x):
        if self.kernel == (7, 7):
            return F.conv2d(x, self.weight.to(self.dtype), None,
                            self.strides, 3)
        return orig(self, x)

    monkeypatch.setattr(image_layers.Conv, "forward", forward)


def _symmetric_max_pool(monkeypatch):
    """``MaxPool2d(3, 2, 1)``: (1, 1) where XLA's "SAME" pads (0, 1)."""
    monkeypatch.setattr(tr, "max_pool",
                        lambda x, k, s, p: F.max_pool2d(x, k, s, 1))


@pytest.mark.parametrize("variant", [_symmetric_stem, _symmetric_max_pool],
                         ids=["stem", "max-pool"])
def test_symmetric_padding_is_refused(monkeypatch, variant):
    ref = jax_reference("resnet18")
    variant(monkeypatch)
    _, logits, _, _, _ = port_run("resnet18", ref)
    assert _rel(logits, ref["logits"]) > 100 * LOGIT_TOL


def test_unbiased_running_variance_is_refused(monkeypatch):
    ref = jax_reference("resnet18")
    monkeypatch.setattr(
        image_layers, "flax_running_var",
        lambda rv, updated, n, m: rv.copy_(updated))
    _, _, got, _, _ = port_run("resnet18", ref)
    worst = max(np.abs(got[n] - w).max() for n, w in ref["grads"].items()
                if n.endswith("running_var"))
    assert worst > 10 * STAT_TOL
    # The running means are not touched by the correction.
    _assert_stats(got, ref, keep=lambda n: n.endswith("running_mean"))


def test_resnet_matches_the_default_one_pass_variance():
    ref = jax_reference("resnet18", grads=False, with_eval=False)
    loss, logits, _, _, _ = port_run("resnet18", ref)
    assert _rel(logits, ref["logits"]) <= LOGIT_TOL
    assert loss == pytest.approx(ref["loss"], rel=LOSS_TOL)


def test_resnet_bf16_matches_jax_bf16():
    ref = jax_reference("resnet18", "bfloat16", grads=False)
    loss, logits, _, eval_logits, model = port_run("resnet18", ref,
                                                   "bfloat16")
    assert model.conv_init.weight.dtype == torch.float32
    assert _rel(logits, ref["logits"]) <= BF16_TOL
    assert loss == pytest.approx(ref["loss"], rel=BF16_TOL)
    assert _rel(eval_logits, ref["eval_logits"]) <= BF16_TOL


def test_resnet_layout_and_names():
    model = tr.ResNet50(num_classes=10, num_filters=8, dtype=torch.float32,
                        device="cpu")
    names = dict(model.named_parameters())
    assert image_layers.memory_format("cuda") == torch.channels_last
    assert image_layers.memory_format("cpu") == torch.contiguous_format
    assert "BottleneckBlock_15.Conv_2.weight" in names
    assert "BottleneckBlock_0.conv_proj.weight" in names
    assert "BottleneckBlock_1.conv_proj.weight" not in names
    assert "Dense_0.weight" in names
    # The block's last batch norm starts at scale 0, the others at 1.
    assert torch.all(model.BottleneckBlock_0.BatchNorm_2.weight == 0)
    assert torch.all(model.BottleneckBlock_0.BatchNorm_1.weight == 1)
    # sync_bn_axis names the axis of every batch norm (the statistics'
    # average over it is held in tests/test_torch_binding.py).
    synced = tr.ResNet18(sync_bn_axis="dp", device="cpu")
    assert {m.axis_name for m in synced.modules()
            if isinstance(m, image_layers.BatchNorm)} == {"dp"}
    assert {m.axis_name for m in model.modules()
            if isinstance(m, image_layers.BatchNorm)} == {None}


def test_init_is_lecun_normal():
    """Every conv and dense kernel: truncated normal at two std, std
    sqrt(1/fan_in); biases zero."""
    model = tr.ResNet50(dtype=torch.float32, device="cpu")
    w = model.BottleneckBlock_3.Conv_1.weight.detach()   # fan_in 128 * 9
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(model.Dense_0.bias == 0)


# ---- VGG and Inception ------------------------------------------------------

def test_vgg_matches_jax():
    ref = jax_reference("vgg16")
    loss, logits, got, _, _ = port_run("vgg16", ref)
    assert _rel(logits, ref["logits"]) <= LOGIT_TOL
    assert loss == pytest.approx(ref["loss"], rel=LOSS_TOL)
    _assert_grads(got, ref)


def test_vgg_nchw_flatten_is_refused(monkeypatch):
    ref = jax_reference("vgg16")
    monkeypatch.setattr(tv, "flatten_hwc",
                        lambda x: x.reshape(x.shape[0], -1))
    _, logits, _, _, _ = port_run("vgg16", ref)
    assert _rel(logits, ref["logits"]) > 100 * LOGIT_TOL


def test_inception_matches_jax_in_eval_mode():
    ref = jax_reference("inception3", train=False)
    loss, logits, got, _, _ = port_run("inception3", ref, train=False)
    assert _rel(logits, ref["logits"]) <= LOGIT_TOL
    assert loss == pytest.approx(ref["loss"], rel=LOSS_TOL)
    _assert_grads(got, ref)


def test_inception_stem_statistics_match_jax():
    ref = jax_reference("inception3", grads=False, with_eval=False)
    _, _, got, _, _ = port_run("inception3", ref)
    stem = [f"ConvBN_{i}." for i in range(5)]
    _assert_stats(got, ref, keep=lambda n: n.startswith(tuple(stem)))
