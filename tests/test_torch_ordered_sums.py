"""Batch norm's world sums beside the eager engine's executor, in a
2-rank gloo world of the port's binding.

The binding's per-parameter ``DistributedOptimizer`` submits each
gradient by name from a backward hook, and the engine's executor runs
it on a communicator of its own while the caller's thread goes on. A
sum that the caller's thread needs at once (``SyncBatchNorm``'s two a
layer, the image models' ``mean_over`` under ``sync_bn_axis``) is then
negotiated too, so that every rank runs it in the coordinator's order
with the gradients (``ops/collectives.ordered_allreduce``); a bucketed
train step (``training.make_train_step`` with ``opt.py``'s optimizer),
whose collectives all leave the caller's thread, keeps the direct
all-reduce. Each rank records the names it submitted and the direct
all-reduces it ran:

- with the binding's optimizer live, a model of two ``SyncBatchNorm``
  submits ``sync_batch_norm.fwd.*`` and ``.bwd.*`` once a layer and a
  pass, and ResNet18 with ``sync_bn_axis="dp"`` ``mean_over.fwd.*`` and
  ``.bwd.*`` once a batch norm and a pass, with no direct all-reduce;
- ResNet18's bucketed step submits none and runs them all directly;
- the world-mean loss of ResNet18's first forward is the same to the
  bit on both paths, and equal on both ranks.
"""

import numpy as np
import pytest
import torch

import torch_worlds

WORKER = r"""
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import image_layers
from horovod_tpu_torch.models.resnet import ResNet18
from horovod_tpu_torch.ops import collectives, eager

rank = int(os.environ["HOROVOD_RANK"])
inp = np.load(sys.argv[2])
res = {}
hvd.init(device="cpu")

# Each rank's record: the names it submitted and its direct all-reduces.
submitted, direct = [], [0]
submit = eager.EagerEngine._submit
def recorded_submit(self, kind, name, *a, **k):
    submitted.append(str(name))
    return submit(self, kind, name, *a, **k)
eager.EagerEngine._submit = recorded_submit
guarded = collectives.guarded_allreduce
def recorded_guarded(*a, **k):
    direct[0] += 1
    return guarded(*a, **k)
collectives.guarded_allreduce = recorded_guarded

def take(prefix):
    names = [n for n in submitted if n.startswith(prefix)]
    submitted.clear()
    d, direct[0] = direct[0], 0
    return names, d

# SyncBatchNorm beside the binding's optimizer.
torch.manual_seed(0)
model = torch.nn.Sequential(
    torch.nn.Linear(6, 8), hvd.SyncBatchNorm(8), torch.nn.ReLU(),
    torch.nn.Linear(8, 8), hvd.SyncBatchNorm(8))
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
x = torch.from_numpy(inp["x"])[rank * 4:(rank + 1) * 4]
take("")
opt.zero_grad()
model(x).square().mean().backward()
opt.step()
names, d = take("sync_batch_norm.")
res["sbn_fwd"] = sum(n.startswith("sync_batch_norm.fwd.") for n in names)
res["sbn_bwd"] = sum(n.startswith("sync_batch_norm.bwd.") for n in names)
res["sbn_direct"] = d

# ResNet18 with sync_bn_axis="dp" beside the binding's optimizer.
state = {k: torch.from_numpy(inp[f"w.{k}"]) for k in inp["keys"]}
rx = torch.from_numpy(inp["rx"])[rank * 2:(rank + 1) * 2]
ry = torch.from_numpy(inp["ry"])[rank * 2:(rank + 1) * 2]

def resnet():
    m = ResNet18(num_classes=10, dtype=torch.float32, num_filters=8,
                 sync_bn_axis="dp", device="cpu")
    m.load_state_dict(state)
    return m

m = resnet()
res["norms"] = sum(isinstance(b, image_layers.BatchNorm) and
                   b.axis_name is not None for b in m.modules())
opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                               named_parameters=m.named_parameters())
take("")
opt.zero_grad()
m.train()
loss = training.cross_entropy_loss(m(rx), ry)
loss.backward()
opt.step()
names, d = take("mean_over.")
res["axis_fwd"] = sum(n.startswith("mean_over.fwd.") for n in names)
res["axis_bwd"] = sum(n.startswith("mean_over.bwd.") for n in names)
res["axis_direct"] = d
res["loss_ordered"] = collectives.allreduce(loss.detach()).numpy()

# The same model's bucketed step.
m = resnet()
step = training.make_train_step(
    m, training.init_train_state(m, torch.optim.SGD(m.parameters(), lr=0.1),
                                 compression="none", bucket_cap_bytes=None))
take("")
res["loss_direct"] = step(rx, ry).numpy()
names, d = take("mean_over.")
res["bucketed_named"] = len(names)
res["bucketed_direct"] = d
hvd.shutdown()
np.savez(sys.argv[3 + rank], **res)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from horovod_tpu_torch.models.resnet import ResNet18

    rng = np.random.RandomState(0)
    rx = np.concatenate([rng.rand(2, 32, 32, 3).astype(np.float32) + 3.0 * d
                         for d in range(2)])
    state = ResNet18(num_classes=10, dtype=torch.float32, num_filters=8,
                     sync_bn_axis="dp", device="cpu").state_dict()
    inputs = {"x": rng.randn(8, 6).astype(np.float32), "rx": rx,
              "ry": rng.randint(0, 10, size=(4,)).astype(np.int64),
              "keys": np.array(list(state))}
    inputs.update({f"w.{k}": v.numpy() for k, v in state.items()})
    tmp = tmp_path_factory.mktemp("ordered_sums")
    return torch_worlds.launch(WORKER, 2, tmp, {}, inputs).results()


def test_sync_batch_norm_sums_are_negotiated_beside_the_binding_optimizer(
        ranks):
    for r, got in enumerate(ranks):
        assert (int(got["sbn_fwd"]), int(got["sbn_bwd"]),
                int(got["sbn_direct"])) == (2, 2, 0), r


def test_sync_bn_axis_sums_are_negotiated_beside_the_binding_optimizer(
        ranks):
    for r, got in enumerate(ranks):
        n = int(got["norms"])
        assert n > 0
        assert (int(got["axis_fwd"]), int(got["axis_bwd"]),
                int(got["axis_direct"])) == (n, n, 0), r


def test_a_bucketed_train_step_keeps_the_direct_sums(ranks):
    for r, got in enumerate(ranks):
        assert int(got["bucketed_named"]) == 0, r
        # Each batch norm's sum forward and backward, then the step's own
        # two (the running statistics and the loss) through allreduce.
        assert int(got["bucketed_direct"]) == 2 * int(got["norms"]), r


def test_both_paths_give_the_same_world_loss(ranks):
    ordered = [float(got["loss_ordered"]) for got in ranks]
    direct = [float(got["loss_direct"]) for got in ranks]
    assert ordered[0] == ordered[1] == direct[0] == direct[1], \
        (ordered, direct)
