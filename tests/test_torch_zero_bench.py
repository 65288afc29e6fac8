"""ZeRO-1 over dp for the transformer (``DistributedOptimizer(zero_axis=
"dp")``, ``transformer_bench --zero``) and ``image_bench --workload zero``
on the CPU.

- The setting of the JAX package's
  ``test_zero_over_dp_composes_with_model_parallelism``: the decoder
  (vocab 64, d_model 32, 4 heads of 8, d_ff 64, 4 layers) from the JAX
  ``init_params`` at PRNGKey(0), Adam 1e-2, on dp=2 x tp=2 and dp=2 x pp=2
  (two microbatches) in one 4-rank gloo world. Two steps with the
  optimizer state partitioned over dp against the same steps with it
  whole: every loss to rel 1e-6 and every parameter to rtol 1e-5 / atol
  1e-6 (the JAX test's tolerances), and each rank's optimizer state about
  half the whole one's (1/dp, plus padding and the scalar step counts).
- ``transformer_bench --zero --tp 2 --remat`` in the same world prints
  its line, its losses equal to the run without ``--zero`` at the same
  tolerance, with half the optimizer-state bytes.
- ``image_bench --workload zero --zero-devices 2`` prints
  ``bench.py``'s keys, and stage 3 / stage 1 state bytes come to 1/(d+1).
"""

import json
import subprocess
import sys

import numpy as np
import pytest

import jax

from horovod_tpu.models import transformer as jt

import torch_worlds

BASE = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=64, n_layers=4,
            max_seq=64)
MESHES = {"dp2xtp2": dict(tp=2, pp=1, M=1), "dp2xpp2": dict(tp=1, pp=2, M=2)}
STEPS = 2
TINY = ["--device", "cpu", "--d-model", "32", "--n-heads", "4",
        "--n-layers", "2", "--vocab", "64", "--seq-len", "32",
        "--num-warmup", "1", "--num-iters", "1"]

WORKER = torch_worlds.WORLD_PRELUDE + r"""
import horovod_tpu_torch as hvd
from horovod_tpu_torch import training, transformer_bench
from horovod_tpu_torch.models import transformer as tt

def opt_bytes(opt):
    return sum(v.numel() * v.element_size() for s in opt.state.values()
               if isinstance(s, dict) for v in s.values() if torch.is_tensor(v))

for name, m in spec["meshes"].items():
    for zero in (False, True):
        key = f"{name}/{'zero' if zero else 'plain'}"
        hvd.init(device="cpu", tp=m["tp"], pp=m["pp"])
        cfg = tt.TransformerConfig(**spec["cfg"])
        model = tt.Transformer(cfg, device="cpu", n_microbatches=m["M"])
        coords = model.shard_coords()
        pre = f"pp{m['pp']}/"
        leaves = {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}
        model.load_state_dict(tt.params_from_jax(leaves, cfg, **coords))
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(),
            zero_axis="dp" if zero else None)
        step = training.make_train_step(model, opt)
        b = inp["tokens"].shape[0] // hvd.dp_size()
        rows = slice(hvd.dp_rank() * b, (hvd.dp_rank() + 1) * b)
        x = torch.from_numpy(inp["tokens"][rows]).long()
        y = torch.from_numpy(inp["labels"][rows]).long()
        res[f"{key}/losses"] = np.array([step(x, y).item()
                                         for _ in range(spec["steps"])])
        for k, p in model.named_parameters():
            res[f"{key}/param/{k}"] = p.detach().numpy()
        res[f"{key}/opt_bytes"] = np.array(opt_bytes(opt))
        hvd.shutdown()
for zero in (False, True):
    run = transformer_bench.run(transformer_bench.parse_args(
        spec["bench"] + ["--tp", "2", "--remat"] + (["--zero"] if zero else [])))
    key = f"bench/{'zero' if zero else 'plain'}"
    res[f"{key}/line"] = np.array(json.dumps(run.result))
    res[f"{key}/losses"] = np.array(run.losses)
    hvd.shutdown()
""" + torch_worlds.WORLD_EPILOGUE


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax.numpy as jnp

    cfg = jt.TransformerConfig(dtype=jnp.float32, **BASE)
    inputs = {}
    for pp in (1, 2):
        params = jax.device_get(jt.init_params(cfg, jax.random.PRNGKey(0),
                                               pp))
        inputs.update({f"pp{pp}/{k}": np.asarray(v)
                       for k, v in params.items()})
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (8, 64))
    inputs.update(tokens=tokens, labels=np.roll(tokens, -1, 1))
    return torch_worlds.launch(
        WORKER, 4, tmp_path_factory.mktemp("zero_dp"),
        {"meshes": MESHES, "cfg": BASE, "steps": STEPS, "bench": TINY},
        inputs).results()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_zero_over_dp_equals_the_whole_optimizer(world, mesh):
    for rank, res in enumerate(world):
        plain, zero = f"{mesh}/plain", f"{mesh}/zero"
        np.testing.assert_allclose(res[f"{zero}/losses"],
                                   res[f"{plain}/losses"], rtol=1e-6)
        names = [k[len(plain) + 7:] for k in res
                 if k.startswith(f"{plain}/param/")]
        assert names
        for n in names:
            np.testing.assert_allclose(
                res[f"{zero}/param/{n}"], res[f"{plain}/param/{n}"],
                rtol=1e-5, atol=1e-6, err_msg=f"rank {rank} {mesh}: {n}")
        whole = int(res[f"{plain}/opt_bytes"])
        part = int(res[f"{zero}/opt_bytes"])
        assert 0.45 * whole <= part <= 0.55 * whole, (part, whole)
    assert world[0][f"{mesh}/zero/losses"][-1] < \
        world[0][f"{mesh}/zero/losses"][0]


def test_transformer_bench_zero_composes_with_tp_and_remat(world):
    for res in world:
        lines = {z: json.loads(str(res[f"bench/{z}/line"]))
                 for z in ("plain", "zero")}
        assert lines["zero"]["zero"] and not lines["plain"]["zero"]
        assert lines["zero"]["mesh"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
        np.testing.assert_allclose(res["bench/zero/losses"],
                                   res["bench/plain/losses"], rtol=1e-6)
        ratio = (lines["zero"]["opt_state_bytes"]
                 / lines["plain"]["opt_state_bytes"])
        assert 0.45 <= ratio <= 0.55, ratio


def test_image_bench_zero_workload_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.image_bench", "--workload",
         "zero", "--device", "cpu", "--zero-devices", "2",
         "--num-warmup", "1", "--num-iters", "1"],
        cwd=torch_worlds.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "zero_stage3_vs_stage1_state_bytes"
    assert line["expected_ratio"] == round(1 / 3, 4)
    assert abs(line["value"] - 1 / 3) <= 0.002
    assert [r["stage"] for r in line["stages"]] == [1, 2, 3]
    for row in line["stages"]:
        assert set(row) == {"stage", "live_bytes_per_device_peak",
                            "state_bytes_per_device",
                            "transient_full_grad_bytes",
                            "wire_bytes_per_step_per_device",
                            "steps_per_sec", "params_padded_elems", "loss"}
        assert row["live_bytes_per_device_peak"] is None   # the CPU
        assert np.isfinite(row["loss"])
    # One batch, one model: every stage's loss is the same.
    assert len({r["loss"] for r in line["stages"]}) == 1
