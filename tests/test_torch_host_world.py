"""The port's host world (``common/host_world.py``) and host staging
(``common/host_staging.py``) in one 2-rank world, without ``hvd.init``
or a ``torch.distributed`` world.

- ``HOROVOD_ELASTIC=1`` without the elastic driver's rendezvous in the
  environment: ``init`` refuses (``HorovodInternalError``): a fixed world
  must not run in place of an elastic one.
- A world with ``HOROVOD_HOST_VIA_XLA=1`` (threshold 1 KiB) and
  ``device="cpu"`` (staging through gloo): the numpy helpers against
  numpy, while ``host_world.enqueue`` fires on both ranks at its third
  hit (the call raises before anything is submitted; the next ones
  complete); fp32 Sum and Average, bf16, fp16, int32 and a broadcast
  staged, each against the same tensors on the ring (``ring_only``): fp32
  within 1e-6 relative, the rest exact; int64 and the tensors under 1 KiB
  stay on the ring. Rank 0's timeline has ``GLOO_*`` spans for exactly the
  staged tensors.
- The unanimity vote: rank 1 asks to stage on a CUDA device that is not
  there, rank 0 on the CPU: both raise ``HorovodInternalError`` after the
  vote, and neither world is left up.
- Without the knob no rank stages.
"""

import json

import numpy as np

import torch_worlds

# No torch.distributed world here: each host world, one after the other,
# takes the launcher's pair of ports (staging's store on the base port,
# the native core on base + 1).
WORKER = r"""
import json, os, sys
import numpy as np
import torch
rank = int(os.environ["HOROVOD_RANK"])
spec = json.load(open(sys.argv[1]))
inp = np.load(sys.argv[2])
res = {}
from horovod_tpu_torch.common import faults, host_world, native
from horovod_tpu_torch.common.exceptions import HorovodInternalError

w = host_world.world()
os.environ["HOROVOD_ELASTIC"] = "1"
try:
    w.init()
    res["elastic_refused"] = np.array(False)
except HorovodInternalError as e:
    res["elastic_refused"] = np.array("rendezvous" in str(e))
os.environ.pop("HOROVOD_ELASTIC")


def op(kind, x, name, root=-1, reduce_op=1):
    out = torch.empty((2 * x.shape[0],) if kind == native.OP_ALLGATHER
                      else x.shape, dtype=x.dtype)
    h = w.enqueue(name, kind, reduce_op, host_world.dtype_code(x.dtype),
                  tuple(x.shape), x.data_ptr(), out.data_ptr(),
                  root_rank=root)
    r, err = w.wait(h)
    assert r == 1, err
    return out


os.environ.update(HOROVOD_HOST_VIA_XLA="1",
                  HOROVOD_HOST_VIA_XLA_THRESHOLD="1024",
                  HOROVOD_FAULT_SPEC="host_world.enqueue:step=2:kind=raise")
if rank == 0:
    os.environ["HOROVOD_TIMELINE"] = spec["timeline"]
faults.refresh()
w.init(device="cpu")
res["staging_on"] = np.array(w.staging is not None)
x = inp[f"x{rank}"]
res["gather"] = w.allgather_np(x, "np.gather")
res["bcast"] = w.broadcast_np(x, 1, "np.bcast")
try:
    w.allgather_np(x, "np.faulted")
    res["faulted"] = np.array(False)
except faults.FaultInjected:
    res["faulted"] = np.array(True)
res["gatherv"], res["dims"] = w.allgatherv_np(x[:rank + 1], "np.gatherv")
os.environ.pop("HOROVOD_FAULT_SPEC")
faults.refresh()

big = torch.from_numpy(inp[f"big{rank}"])
ints = torch.arange(4096, dtype=torch.int32) % 11 + rank
halves = (torch.arange(4096) % 9 + rank) * 0.5
cases = {"fp32": (big, 1), "avg": (big, 0), "int32": (ints, 1),
         "int32avg": (ints, 0), "bf16": (halves.bfloat16(), 1),
         "fp16": (halves.half(), 1)}
for k, (t, red) in cases.items():
    res[f"staged.{k}"] = op(native.OP_ALLREDUCE, t, f"stage.{k}",
                            reduce_op=red).float().numpy()
res["staged.bcast"] = op(native.OP_BROADCAST, big, "stage.bcast",
                         root=1).numpy()
res["ring.int64"] = op(native.OP_ALLREDUCE, ints.long() + (1 << 40),
                       "ring.int64").numpy()
res["ring.small"] = op(native.OP_ALLREDUCE, halves[:16], "ring.small").numpy()
with w.ring_only():
    for k, (t, red) in cases.items():
        res[f"ring.{k}"] = op(native.OP_ALLREDUCE, t, f"ring.{k}",
                              reduce_op=red).float().numpy()
res["staged_kinds"] = np.array(json.dumps(list(w.staging.staged)))
w.shutdown()
os.environ.pop("HOROVOD_TIMELINE", None)

# The vote: rank 1 cannot stage.
try:
    w.init(device="cuda:0" if rank == 1 else "cpu")
    res["vote_refused"] = np.array("")
except HorovodInternalError as e:
    res["vote_refused"] = np.array(str(e))
res["left_up"] = np.array(w.initialized)
os.environ.pop("HOROVOD_HOST_VIA_XLA")

# Without the knob nobody stages.
w.init()
res["plain_staging"] = np.array(w.staging is not None)
res["plain_sum"] = op(native.OP_ALLREDUCE, big, "plain.sum").numpy()
w.shutdown()
np.savez(sys.argv[3 + rank], **res)
"""


def test_host_world_and_staging(tmp_path):
    rng = np.random.RandomState(0)
    inputs = {f"x{r}": rng.randint(0, 9, (3, 4)).astype(np.float32)
              for r in range(2)}
    inputs.update({f"big{r}": rng.randn(50_000).astype(np.float32)
                   for r in range(2)})
    timeline = tmp_path / "host_timeline.json"
    world = torch_worlds.launch(WORKER, 2, tmp_path,
                                {"timeline": str(timeline)}, inputs)
    xs = [inputs["x0"], inputs["x1"]]
    total = (inputs["big0"].astype(np.float64) + inputs["big1"])
    for r, res in enumerate(world.results()):
        assert bool(res["elastic_refused"]), r
        assert bool(res["staging_on"]), r
        np.testing.assert_array_equal(res["gather"], np.stack(xs))
        np.testing.assert_array_equal(res["bcast"], xs[1])
        assert bool(res["faulted"]), r
        np.testing.assert_array_equal(res["gatherv"],
                                      np.concatenate([xs[0][:1], xs[1][:2]]))
        assert res["dims"].tolist() == [1, 2]
        for k in ("fp32", "avg"):
            got, ring = res[f"staged.{k}"], res[f"ring.{k}"]
            assert np.linalg.norm(got - ring) <= 1e-6 * np.linalg.norm(ring)
            want = total / (2 if k == "avg" else 1)
            assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
        for k in ("int32", "int32avg", "bf16", "fp16"):
            np.testing.assert_array_equal(res[f"staged.{k}"], res[f"ring.{k}"])
        # The ring (and so staging) does not scale integers: an int
        # Average is the Sum.
        np.testing.assert_array_equal(res["staged.int32avg"],
                                      res["staged.int32"])
        np.testing.assert_array_equal(res["staged.bcast"], inputs["big1"])
        np.testing.assert_array_equal(
            res["ring.int64"],
            2 * ((np.arange(4096) % 11) + (1 << 40)) + 1)
        assert json.loads(str(res["staged_kinds"])) == \
            [["allreduce", 1]] * 6 + [["broadcast", 1]]
        assert "unanimity" in str(res["vote_refused"]), r
        assert not bool(res["left_up"]), r
        assert not bool(res["plain_staging"]), r
        np.testing.assert_allclose(res["plain_sum"], total, rtol=1e-6)
    events = json.loads(timeline.read_text())
    tids = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    spans = {}
    for e in events:
        if e["ph"] in ("B", "E"):
            spans.setdefault(tids[e["tid"]], set()).add(e["name"])
    staged = {f"stage.{k}" for k in ("fp32", "avg", "int32", "int32avg",
                                     "bf16", "fp16")}
    assert spans == {**{n: {"GLOO_ALLREDUCE"} for n in staged},
                     "stage.bcast": {"GLOO_BCAST"}}
