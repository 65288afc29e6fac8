"""The port's MXNet binding (``horovod_tpu_torch.mxnet``) against the JAX
package's (``horovod_tpu.mxnet``), on ``tests/fake_mxnet.py`` (a
numpy-backed NDArray: mxnet is not installed): ``tests/test_mxnet.py``'s
cases on each binding at one rank, then the port's binding in a world of
two processes on its host world, each collective held to numpy on inputs
every rank draws from the same seeds. Those processes refuse
``tensorflow`` (and ``jax``, ``jaxlib`` and ``horovod_tpu``) at import:
the JAX package's binding sends every NDArray through its TensorFlow
binding's numpy collectives, the port's through ``common/host_ops.py``.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import fake_mxnet
import torch_worlds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOTS = ("horovod_tpu", "horovod_tpu_torch")


@pytest.fixture(params=ROOTS)
def hvd_mx(request):
    """A binding bound to the fake mxnet (reloaded: each module records
    at import whether mxnet is there)."""
    fake_mxnet.install()
    mod = importlib.reload(importlib.import_module(f"{request.param}.mxnet"))
    mod.init()
    try:
        yield mod
    finally:
        mod.shutdown()
        fake_mxnet.uninstall()
        importlib.reload(mod)


def test_topology_and_allreduce(hvd_mx):
    import mxnet as mx

    assert hvd_mx.size() == 1 and hvd_mx.rank() == 0
    assert (hvd_mx.local_rank(), hvd_mx.local_size()) == (0, 1)
    assert (hvd_mx.cross_rank(), hvd_mx.cross_size()) == (0, 1)
    assert hvd_mx.is_initialized()
    x = mx.nd.array([1.0, 2.0, 3.0], dtype="float32")
    out = hvd_mx.allreduce(x, average=True)
    np.testing.assert_array_equal(out.asnumpy(), [1.0, 2.0, 3.0])
    assert out.dtype == np.float32
    i = mx.nd.array(np.arange(5, dtype=np.int64) * (2 ** 40))
    got = hvd_mx.allreduce(i, average=False, name="ints")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got.asnumpy(), i.asnumpy())


def test_inplace_ops_and_allgather(hvd_mx):
    import mxnet as mx

    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    hvd_mx.allreduce_(x, average=False)
    np.testing.assert_array_equal(
        x.asnumpy(), np.arange(6, dtype=np.float32).reshape(2, 3))
    g = hvd_mx.allgather(x)
    assert g.shape == (2, 3)
    b = hvd_mx.broadcast(x, root_rank=0)
    np.testing.assert_array_equal(b.asnumpy(), x.asnumpy())
    hvd_mx.broadcast_(x, root_rank=0)


def test_broadcast_parameters_and_object(hvd_mx):
    import mxnet as mx

    params = {
        "w": mx.gluon.Parameter("w", np.ones((2, 2), np.float32)),
        "b": mx.gluon.Parameter("b", np.zeros((2,), np.float32)),
    }
    hvd_mx.broadcast_parameters(params, root_rank=0)
    np.testing.assert_array_equal(params["w"].data().asnumpy(), 1.0)
    assert hvd_mx.broadcast_object({"epoch": 3}, root_rank=0) == \
        {"epoch": 3}


def test_distributed_optimizer_updates(hvd_mx):
    import mxnet as mx

    opt = hvd_mx.DistributedOptimizer(mx.optimizer.SGD(learning_rate=0.5))
    w = mx.nd.array([1.0, 1.0], dtype="float32")
    g = mx.nd.array([0.2, 0.4], dtype="float32")
    opt.update(0, w, g, None)
    np.testing.assert_allclose(w.asnumpy(), [0.9, 0.8], rtol=1e-7)
    w2 = mx.nd.array([1.0], dtype="float32")
    opt.update_multi_precision([1], [w2], [mx.nd.array([1.0])], [None])
    np.testing.assert_array_equal(w2.asnumpy(), [0.5])
    assert opt.learning_rate == 0.5


def test_distributed_trainer_steps(hvd_mx):
    import mxnet as mx

    p = mx.gluon.Parameter("w", np.ones((3,), np.float32))
    p._grad._np[:] = 3.0
    trainer = hvd_mx.DistributedTrainer(
        {"w": p}, "sgd", optimizer_params={"learning_rate": 1.0})
    trainer.step(batch_size=1)
    np.testing.assert_array_equal(p.data().asnumpy(), 1.0 - 3.0)


@pytest.mark.parametrize("root", ROOTS)
def test_the_gate_without_mxnet(root, monkeypatch):
    """Without mxnet each binding imports, its world and
    ``broadcast_object`` work, and its NDArray entry points raise
    ``ImportError`` with the JAX package's wording."""
    monkeypatch.setitem(sys.modules, "mxnet", None)
    mod = importlib.reload(importlib.import_module(f"{root}.mxnet"))
    try:
        assert not mod._MXNET_AVAILABLE
        with pytest.raises(ImportError, match=f"{root}.mxnet requires the "
                           "mxnet package, which is not installed"):
            mod.broadcast_parameters({})
        with pytest.raises(ImportError):
            mod.DistributedOptimizer(object())
        mod.init()
        assert mod.broadcast_object([1, "a"]) == [1, "a"]
        mod.shutdown()
    finally:
        monkeypatch.delitem(sys.modules, "mxnet")
        importlib.reload(mod)


_WORKER = torch_worlds.REFUSE_JAX.replace(
    '("jax", "jaxlib", "horovod_tpu")',
    '("jax", "jaxlib", "horovod_tpu", "tensorflow")') + textwrap.dedent(r"""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, os.environ["HVD_TESTS"])
    import fake_mxnet
    fake_mxnet.install()
    import mxnet as mx
    import horovod_tpu_torch.mxnet as hvd

    hvd.init()
    rank, size = hvd.rank(), hvd.size()
    rngs = [np.random.RandomState(10 + r) for r in range(size)]
    xs = np.stack([g.standard_normal(1000).astype(np.float32) for g in rngs])
    out = {}

    def err(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, (got.shape, want.shape)
        return float(np.max(np.abs(got - want)))

    x = mx.nd.array(xs[rank])
    out["average"] = err(hvd.allreduce(x, average=True, name="avg")
                         .asnumpy(), xs.astype(np.float64).mean(0))
    s = hvd.allreduce(x, average=False, name="sum")
    assert s.dtype == np.float32
    out["sum"] = err(s.asnumpy(), xs.astype(np.float64).sum(0))
    ints = mx.nd.array(np.arange(7, dtype=np.int32) * (rank + 1))
    out["int_sum"] = err(hvd.allreduce_(ints, average=False, name="i")
                         .asnumpy(), np.arange(7) * 3)
    rows = [g.standard_normal((r + 1, 3)) for r, g in enumerate(rngs)]
    out["allgather"] = err(hvd.allgather(mx.nd.array(rows[rank]),
                                         name="ag").asnumpy(),
                           np.concatenate(rows))
    b = mx.nd.array(xs[rank])
    hvd.broadcast_(b, root_rank=1, name="b")
    out["broadcast"] = err(b.asnumpy(), xs[1])
    p = mx.gluon.Parameter("w", np.full((2, 2), float(rank), np.float32))
    hvd.broadcast_parameters({"w": p}, root_rank=0)
    out["broadcast_parameters"] = err(p.data().asnumpy(), np.zeros((2, 2)))
    obj = hvd.broadcast_object({"from": rank, "xs": xs[rank].tolist()[:3]},
                               root_rank=1)
    assert obj == {"from": 1, "xs": xs[1].tolist()[:3]}, obj
    # The optimizer applies the world's mean gradient.
    opt = hvd.DistributedOptimizer(mx.optimizer.SGD(learning_rate=0.5))
    w = mx.nd.array(np.ones(1000, np.float32))
    opt.update(0, w, mx.nd.array(xs[rank]), None)
    out["optimizer"] = err(w.asnumpy(), 1.0 - 0.5 * xs.astype(
        np.float64).mean(0))
    # The trainer sums the gradients and its scale divides by the size.
    tp = mx.gluon.Parameter("t", np.ones(1000, np.float32))
    tp._grad._np[:] = xs[rank]
    trainer = hvd.DistributedTrainer({"t": tp}, "sgd",
                                     optimizer_params={"learning_rate": 1.0})
    trainer.step(batch_size=1)
    out["trainer"] = err(tp.data().asnumpy(),
                         1.0 - xs.astype(np.float64).mean(0))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (
        "tensorflow", "jax", "jaxlib", "horovod_tpu"))
    hvd.shutdown()
    print("RESULT " + json.dumps({"rank": rank, "errors": out,
                                  "bad": bad}))
""")


def test_two_ranks_on_the_host_world_without_tensorflow(tmp_path):
    from horovod_tpu_torch.common.config import free_port_pair

    port = free_port_pair()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HVD_TESTS=os.path.join(REPO, "tests"), PYTHONPATH=REPO)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], cwd=str(tmp_path), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, out + err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res = json.loads(line[-1][len("RESULT "):])
        assert res["rank"] == rank and res["bad"] == []
        tol = {"average": 1e-6, "sum": 1e-6, "optimizer": 1e-6,
               "trainer": 1e-6}
        for name, e in res["errors"].items():
            assert e <= tol.get(name, 0.0), (rank, name, e)
