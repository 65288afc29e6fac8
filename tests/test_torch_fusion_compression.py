"""The port's fusion planner and compressors against the JAX package's:
identical bucket plans for the same shapes, dtypes and environment, and
bitwise-equal wire tensors."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.common import compression as jcomp
from horovod_tpu.common import fusion as jfusion
from horovod_tpu_torch.common import compression as tcomp
from horovod_tpu_torch.common import fusion as tfusion

# (shape, dtype name): a model-like mix, with dtype runs that break buckets.
LEAVES = [((64, 32), "float32"), ((32,), "float32"), ((16, 16), "bfloat16"),
          ((7,), "bfloat16"), ((128,), "float32"), ((3, 5), "float16"),
          ((9,), "int32"), ((40, 2), "float32"), ((1,), "float32"),
          ((200,), "bfloat16")]
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16, "int32": jnp.int32}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16, "int32": torch.int32}


def _jax_leaves():
    return [jnp.zeros(s, _JDT[d]) for s, d in LEAVES]


def _torch_leaves():
    return [torch.zeros(s, dtype=_TDT[d]) for s, d in LEAVES]


def _plans_equal(jplan, tplan):
    assert [b.indices for b in tplan] == [b.indices for b in jplan]
    assert tfusion.describe_plan(tplan) == jfusion.describe_plan(jplan)
    assert tfusion.forward_bucket_order(tplan) == \
        jfusion.forward_bucket_order(jplan)


@pytest.mark.parametrize("cap", [None, 0, 64, 300, 1000, 4096, 1 << 20])
@pytest.mark.parametrize("mode", ["none", "fp16", "bf16"])
def test_plans_match_jax(cap, mode):
    jc = None if mode == "none" else getattr(jcomp.Compression, mode)
    tc = None if mode == "none" else getattr(tcomp.Compression, mode)
    _plans_equal(jfusion.plan_buckets_for(_jax_leaves(), cap, jc),
                 tfusion.plan_buckets_for(_torch_leaves(), cap, tc))


def test_leaf_nbytes_match_jax():
    for j, t in zip(_jax_leaves(), _torch_leaves()):
        assert tfusion.leaf_nbytes(t) == jfusion.leaf_nbytes(j)
        assert tfusion.leaf_wire_nbytes(t) == jfusion.leaf_wire_nbytes(j)


@pytest.mark.parametrize("env, knob", [
    (None, "auto"), ("1000", "auto"), ("0", "auto"), ("-5", "auto"),
    ("not-a-number", "auto"), ("1000", None), ("1000", 0), (None, 256),
])
def test_resolve_bucket_cap_matches_jax(monkeypatch, env, knob):
    if env is None:
        monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", env)
    assert tfusion.resolve_bucket_cap(knob) == jfusion.resolve_bucket_cap(knob)


def test_resolve_bucket_cap_rejects_unknown_string():
    for mod in (jfusion, tfusion):
        with pytest.raises(ValueError, match="bucket_cap_bytes"):
            mod.resolve_bucket_cap("big")


@pytest.mark.parametrize("env", [None, "none", "fp16", "bf16", "FP16 ",
                                 "zstd"])
def test_resolve_compression_env_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("HOROVOD_COMPRESSION", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_COMPRESSION", env)
    j = jcomp.resolve_compression("auto")
    t = tcomp.resolve_compression("auto")
    assert (t is None and j is None) or t.name == j.name


def test_ef16_waits_for_a_later_slice(monkeypatch):
    monkeypatch.setenv("HOROVOD_COMPRESSION", "ef16")
    assert jcomp.resolve_compression("auto").name == "ef16"
    with pytest.raises(NotImplementedError, match="ef16"):
        tcomp.resolve_compression("auto")


def _bits(x):
    """The raw bits of a numpy or torch array, as numpy unsigned ints."""
    if isinstance(x, torch.Tensor):
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        x = x.view(ints[x.element_size()]).numpy()
    else:
        x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}")


@pytest.mark.parametrize("mode", ["none", "fp16", "bf16"])
@pytest.mark.parametrize("src", ["float32", "bfloat16", "float16", "int32"])
def test_wire_tensors_bitwise_equal(mode, src):
    rng = np.random.RandomState(0)
    # Normal values plus the edges: fp16 overflow and underflow, ties.
    x = np.concatenate([rng.randn(512) * 3.0,
                        [70000.0, -1e6, 1e-9, 5.96e-8, 1.0 + 2 ** -11,
                         1.0 + 2 ** -8, 0.0, -0.0]]).astype(np.float32)
    if src == "int32":
        x = (x * 100).astype(np.int32)
    jx = jnp.asarray(x, _JDT[src])
    tx = torch.tensor(x).to(_TDT[src])
    jw, jctx = getattr(jcomp.Compression, mode).compress(jx)
    tw, tctx = getattr(tcomp.Compression, mode).compress(tx)
    assert str(tw.dtype).replace("torch.", "") == str(jw.dtype)
    np.testing.assert_array_equal(_bits(tw), _bits(jw))
    back_j = getattr(jcomp.Compression, mode).decompress(jw, jctx)
    back_t = getattr(tcomp.Compression, mode).decompress(tw, tctx)
    np.testing.assert_array_equal(_bits(back_t), _bits(back_j))
