"""The port's long-context example against ``examples/jax_long_context.py``.

Each case runs the JAX example as a subprocess (its 8-device virtual
mesh: dp = 4 at sp = 2) and the port's ``examples/long_context.run`` in
an sp = 2 gloo world of two processes (dp = 1) on the same global batch
(``--batch-size 4``, so both see the same ``RandomState(0)`` tokens),
with the JAX example's ``init_params(cfg, PRNGKey(0))`` carried across by
``params_from_jax``. Their printed step-0 and final losses agree within
rel 2e-2 (bf16 model and AdamW). That alone cannot see a mask: packing
moves the printed loss by little at random weights. So each rank also
checks the example's shards of tokens and ids against the JAX example's
global batch and, in fp32 through the same strategy, takes the step-0
loss and world-averaged gradients, which the test holds against the JAX
model's dense oracle (``dense_reference_loss``, an explicit mask) at the
trainer's fp32 tolerances; packing moves those gradients by ~100 %.
``--packed 3`` at T = 96 puts a document across the sp shard boundary
(tokens 32..63 are document 1), where ``--packed 4`` at T = 64 splits
the shards on a document boundary. Every world and every JAX run starts
at once, in one fixture.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_worlds
from conftest import subprocess_cpu_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--sp", "2", "--seq-len", "64", "--d-model", "32", "--n-heads", "4",
        "--n-layers", "2", "--steps", "2", "--batch-size", "4"]
CASES = {
    "ring": ["--strategy", "ring"],
    "ulysses": ["--strategy", "ulysses"],
    "packed4": ["--packed", "4"],
    "packed3-t96": ["--seq-len", "96", "--packed", "3"],
}
REL = 2e-2   # bf16 model and optimizer state, two orders of summation

WORKER = torch_worlds.REFUSE_JAX + r"""
import contextlib, inspect, io, json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import long_context as lc
from horovod_tpu_torch.models.transformer import Transformer, params_from_jax
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.training import cross_entropy_loss


def count(fn, mode_of):
    # On the CPU each wrapper calls its plain version in place of its
    # kernel: count those calls as the card's wrappers count launches.
    sig = inspect.signature(fn)

    def counted(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        fa._launched(mode_of(bound.arguments), bound.arguments["q_seg"])
        return fn(*a, **k)
    return counted


def f32(name):
    return lambda a: name + ("_f32" if a["out_dtype"] == torch.float32
                             else "")


fa.flash_fwd_plain = count(fa.flash_fwd_plain, lambda a: (
    "flash_fwd_train" if a["with_lse"] else "flash_fwd"))
fa.flash_fwd_state_plain = count(fa.flash_fwd_state_plain,
                                 lambda a: "flash_fwd_state")
fa.flash_bwd_dq_plain = count(fa.flash_bwd_dq_plain, f32("flash_bwd_dq"))
fa.flash_bwd_dkv_plain = count(fa.flash_bwd_dkv_plain, f32("flash_bwd_dkv"))

spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
args = lc.parse_args(spec["argv"] + ["--device", "cpu"])
hvd.init(device="cpu", sp=args.sp)
rank = hvd.rank()
model = Transformer(lc.model_config(args), device="cpu", seed=1)
model.load_state_dict(params_from_jax({k: inp[k] for k in inp.files},
                                      model.cfg))
out = io.StringIO()
fa.reset_launches()
with contextlib.redirect_stdout(out):
    res = lc.run(args, model=model)
launches = dict(fa.LAUNCHES)

# The example's shards of the tokens and ids are this rank's columns of
# the JAX example's global batch.
t_local = args.seq_len // args.sp
cols = slice(hvd.sp_rank() * t_local, (hvd.sp_rank() + 1) * t_local)
tokens_all = np.random.RandomState(0).randint(
    0, lc.VOCAB, (args.batch_size, args.seq_len))
np.testing.assert_array_equal(res.tokens.numpy(), tokens_all[:, cols])
if args.packed:
    ids = np.minimum(np.arange(args.seq_len) // (args.seq_len // args.packed),
                     args.packed - 1)
    np.testing.assert_array_equal(res.segment_ids.numpy(),
                                  np.tile(ids[cols], (args.batch_size, 1)))
else:
    assert res.segment_ids is None

# The step-0 loss and gradients in fp32 through the same strategy, on the
# example's shards, averaged over the world as the optimizer averages
# them: what the test holds against the JAX model's dense oracle.
f32 = Transformer(lc.model_config(args, torch.float32), device="cpu", seed=1)
f32.load_state_dict(params_from_jax({k: inp[k] for k in inp.files}, f32.cfg))
labels = torch.as_tensor(np.roll(tokens_all, -1, axis=1)[:, cols])
seg = () if res.segment_ids is None else (res.segment_ids,)
loss = cross_entropy_loss(f32(res.tokens, *seg), labels)
loss.backward()
world = torch.distributed.get_world_size()
summed = [loss.detach()] + [p.grad for p in f32.parameters()]
for t in summed:
    torch.distributed.all_reduce(t)
    t /= world
grads = {f"grad/{n}": p.grad.numpy() for n, p in f32.named_parameters()}
hvd.shutdown()
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "horovod_tpu")]
np.savez(sys.argv[3 + rank], losses=np.asarray(res.losses),
         out=np.asarray(out.getvalue()),
         launches=np.asarray(json.dumps(launches)),
         loss32=np.asarray(float(summed[0])), **grads)
"""


def _argv(case):
    # A later flag wins in argparse, as in the JAX example.
    return BASE + CASES[case]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(argv):
    """The JAX example's ``init_params`` for these flags, as float32."""
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import TransformerConfig, init_params

    flags = dict(zip(argv[::2], argv[1::2]))
    d, h = int(flags["--d-model"]), int(flags["--n-heads"])
    cfg = TransformerConfig(
        vocab=1024, d_model=d, n_heads=h, d_head=d // h, d_ff=4 * d,
        n_layers=int(flags["--n-layers"]), max_seq=int(flags["--seq-len"]),
        dtype=jnp.bfloat16)
    params = init_params(cfg, jax.random.PRNGKey(0), n_stages=1)
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def _flags(case):
    argv = _argv(case)
    return dict(zip(argv[::2], argv[1::2]))


def _dense(case, packed=None):
    """The JAX model's dense fp32 oracle (``dense_reference_loss``, an
    explicit mask) on the example's global batch and ids, from the same
    ``init_params``: (loss, gradients as the port's state-dict names).
    ``packed`` overrides the case's document count (0: one document)."""
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import (TransformerConfig,
                                                dense_reference_loss)
    from horovod_tpu_torch.examples import long_context as lc
    from horovod_tpu_torch.models.transformer import params_from_jax

    flags = _flags(case)
    t, b = int(flags["--seq-len"]), int(flags["--batch-size"])
    d, h = int(flags["--d-model"]), int(flags["--n-heads"])
    n = int(flags.get("--packed", 0)) if packed is None else packed
    cfg = TransformerConfig(
        vocab=1024, d_model=d, n_heads=h, d_head=d // h, d_ff=4 * d,
        n_layers=int(flags["--n-layers"]), max_seq=t, dtype=jnp.float32)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab, (b, t))
    ids = (np.minimum(np.arange(t) // (t // n), n - 1) if n
           else np.zeros(t, np.int64))
    params = _jax_params(_argv(case))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: dense_reference_loss(
            cfg, p, jnp.asarray(tokens), jnp.asarray(np.roll(tokens, -1, 1)),
            segment_ids=jnp.asarray(np.tile(ids, (b, 1))))))(params)
    port_cfg = lc.model_config(lc.parse_args(_argv(case)), torch.float32)
    return float(loss), {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(grads), port_cfg).items()}


def _losses(text):
    step0 = re.search(r"step 0 \(compile\): loss=([0-9.]+)", text)
    final = re.search(r"^loss=([0-9.]+) +[0-9.]+ ms/step", text, re.M)
    assert step0 and final, text
    return float(step0.group(1)), float(final.group(1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_procs = {
        case: subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples",
                                          "jax_long_context.py"),
             *_argv(case)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env=subprocess_cpu_env(PYTHONPATH=REPO + os.pathsep +
                                   os.environ.get("PYTHONPATH", "")))
        for case in CASES}
    worlds = {}
    try:
        for case in CASES:
            tmp = tmp_path_factory.mktemp(case)
            worlds[case] = torch_worlds.launch(
                WORKER, 2, tmp, {"argv": _argv(case)},
                _jax_params(_argv(case)))
        jax_out = {}
        for case, p in jax_procs.items():
            jax_out[case] = p.communicate(timeout=420)[0]
            assert p.returncode == 0, jax_out[case][-3000:]
        return {case: (jax_out[case], world.results(timeout=420))
                for case, world in worlds.items()}
    finally:
        for p in jax_procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for world in worlds.values():
            for p in world.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match_the_jax_example(runs, case):
    jax_text, ranks = runs[case]
    port_text = str(ranks[0]["out"])
    want, got = _losses(jax_text), _losses(port_text)
    for w, g in zip(want, got):
        assert abs(g - w) <= REL * abs(w), (case, want, got)
    # The world-averaged losses are the same on both ranks, and rank 1
    # prints nothing.
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    assert str(ranks[1]["out"]) == ""
    t = int(dict(zip(_argv(case)[::2], _argv(case)[1::2]))["--seq-len"])
    assert f"T_global={t} -> T_local={t // 2}" in port_text
    assert "mesh: {'dp': 1, 'pp': 1, 'sp': 2, 'tp': 1}" in port_text
    assert "tokens/s" in port_text
    if "--packed" in CASES[case]:
        n = CASES[case][CASES[case].index("--packed") + 1]
        assert f"packed: {n} docs/row" in port_text
        assert f"packed: {n} docs/row" in jax_text


@pytest.mark.parametrize("case", sorted(CASES))
def test_launches_are_the_counted_ones(runs, case):
    """Each rank called each attention mode as often as chip_smoke's
    ``packed_launches`` says the card's kernels launch (phase (p)): the
    same count for the plain versions here, by layer, step and ring
    block, under the ``_seg`` names with packed ids."""
    argv = _argv(case)
    strategy = "ulysses" if "ulysses" in argv else "ring"
    want = _chip_smoke().packed_launches(
        layers=2, steps=3, strategy=strategy, sp=2,
        packed="--packed" in argv)
    for rank in runs[case][1]:
        assert json.loads(str(rank["launches"])) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_loss_and_grads_match_the_dense_oracle(runs, case):
    """The example's shards of tokens and ids (each rank checks them
    against the JAX example's global batch), through the case's strategy
    in fp32: the step-0 loss and the world-averaged gradients of every
    parameter against ``dense_reference_loss``'s on the whole batch.
    Every attention mask, forward and backward, and each document that
    crosses the shard boundary (``packed3-t96``) is in these numbers;
    fp32 on both sides, so the tolerances are the port's trainer's
    (loss rel 1e-5; gradients rtol 1e-4, atol 1e-6 of the leaf's largest
    entry), far below what packing moves (the next test)."""
    want_loss, want = _dense(case)
    for rank in runs[case][1]:
        assert float(rank["loss32"]) == pytest.approx(want_loss, rel=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(
                rank[f"grad/{name}"], w, rtol=1e-4,
                atol=1e-6 * np.abs(w).max(), err_msg=f"{case}: {name}")


def _grad_rel(a, b):
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    return (num / sum(float(np.sum(b[k] ** 2)) for k in b)) ** 0.5


@pytest.mark.parametrize("case", ["packed3-t96", "packed4"])
def test_packed_ids_change_the_loss(runs, case):
    """The ids are not ignored, and the oracle check above can tell: on
    the dense oracle, packing moves the gradients by far more than the
    port's distance from the packed oracle, and the port's packed-minus-
    unpacked fp32 loss (``packed4`` against ``ring``, the same weights and
    tokens) is the oracle's within 1 % of itself."""
    packed_loss, packed = _dense(case)
    plain_loss, plain = _dense(case, packed=0)
    moved = _grad_rel(plain, packed)
    for rank in runs[case][1]:
        port = {k: rank[f"grad/{k}"] for k in packed}
        assert _grad_rel(port, packed) * 100 < moved, (case, moved)
    if case == "packed4":
        want = packed_loss - plain_loss
        assert abs(want) > 1e-3 * abs(plain_loss)
        for got_p, got_u in zip(runs["packed4"][1], runs["ring"][1]):
            got = float(got_p["loss32"]) - float(got_u["loss32"])
            assert abs(got - want) <= 1e-2 * abs(want), (got, want)
        # The bf16 runs' printed step-0 losses move too, on both sides.
        for text in (runs[case][0], str(runs[case][1][0]["out"])):
            assert _losses(text)[0] != _losses(runs["ring"][0])[0]


def test_packed_segment_ids_match_the_jax_example():
    from horovod_tpu_torch.examples.long_context import packed_segment_ids

    for t, n in ((64, 4), (96, 3), (8192, 3), (100, 7)):
        doc_len = t // n
        want = np.minimum(np.arange(t) // doc_len, n - 1)
        np.testing.assert_array_equal(packed_segment_ids(t, n), want)
    ids = packed_segment_ids(96, 3)
    # One document crosses the two shards of T = 96 at sp = 2.
    assert ids[47] == ids[48] == 1


def test_bad_flags_are_refused():
    from horovod_tpu_torch.examples.long_context import parse_args

    with pytest.raises(SystemExit):
        parse_args(["--seq-len", "8", "--packed", "9"])
    with pytest.raises(SystemExit):
        parse_args(["--steps", "0"])
    args = parse_args([])
    assert (args.sp, args.seq_len, args.d_model, args.n_heads,
            args.n_layers, args.steps, args.strategy) == (
        4, 2048, 128, 8, 4, 5, "ring")
    assert json.dumps(vars(args))
