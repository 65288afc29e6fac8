"""The port's eager plane (``ops/eager.py`` on the native core) against the
JAX package's ``EagerEngine``.

One 4-rank gloo world laid out as 2 hosts of 2 (``HOROVOD_LOCAL_SIZE=2``,
so the hierarchical cases have local and cross groups) runs every case of
``tests/torch_eager_cases.py``: the cases of ``tests/test_ops_eager.py``
that exist at one device a process. It runs them with the native core live,
then again after an ``hvd.init`` with ``HOROVOD_NATIVE=0`` (direct mode);
the hierarchical cases after an ``hvd.init`` with
``HOROVOD_HIERARCHICAL_ALLREDUCE/ALLGATHER=1``. While the world runs, this
process runs the JAX package's ``EagerEngine`` on a 4-device CPU mesh with
the same numpy inputs, one per device (its direct mode: its native core
would only add negotiation to the same programs).

Tolerance: the inputs are small integers and halves, so every result is
exact; a bf16 result may differ by one bf16 ulp, and Adasum's (its dot
products and norms round) by fp32 rel 1e-6. JAX runs without 64-bit
types, so its int64 results come back as int32: the port's int64 is held
to them by value.

Also here, in the native world: 12 submissions inside one cycle form fewer
responses than tensors; a second identical round is served from the
response cache; a reducescatter whose shapes differ across the ranks
raises ``HorovodInternalError`` at ``synchronize`` on every rank.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_eager_cases as cases
import torch_worlds

MODES = ("native", "direct")
# The dtype JAX gives back without 64-bit types enabled.
_JAX_CANON = {"int64": "int32", "float64": "float32"}
NAMES = list(cases.FLAT) + list(cases.HIER)

WORKER = torch_worlds.WORLD_PRELUDE + r"""
sys.path.insert(0, "tests")
import horovod_tpu_torch as hvd
import torch_eager_cases as cases
from horovod_tpu_torch.common import config
from horovod_tpu_torch.common.state import global_state


class Api:
    hvd = hvd
    DuplicateTensorNameError = hvd.DuplicateTensorNameError
    rank = rank

    def x(self, key):
        return inp[f"{key}/{rank}"]

    def bf16(self, key):
        return torch.from_numpy(self.x(key)).bfloat16()

    def native(self, key):
        return torch.from_numpy(self.x(key))

    def each(self, out):
        return out

    def same(self, v):
        return v

    def is_native(self, v):
        return isinstance(v, torch.Tensor)

    def is_numpy(self, v):
        return isinstance(v, np.ndarray)

    def has_hier(self):
        return {"local", "cross"} <= set(global_state().groups)


def extras(res):
    # 12 submissions inside one cycle, then the same round again.
    eng = global_state().engine
    for rnd in ("fusion", "cache"):
        hvd.barrier()
        before, hits = len(eng.response_sizes), eng.native_core.cache_hits()
        hs = [hvd.allreduce_async(np.full((32,), rank * (i + 1), np.float32),
                                  name=f"fuse.{i}", op=hvd.Sum)
              for i in range(12)]
        res[f"{rnd}/out"] = np.stack([hvd.synchronize(h) for h in hs])
        sizes = list(eng.response_sizes)[before:]
        res[f"{rnd}/responses"] = np.array(len(sizes))
        res[f"{rnd}/tensors"] = np.array(sum(n for _, n in sizes))
        res[f"{rnd}/hits"] = np.array(eng.native_core.cache_hits() - hits)
    try:
        hvd.reducescatter(np.ones((4 if rank == 0 else 8, 2), np.float32),
                          name="rs.bad")
        res["mismatch"] = np.array("no error")
    except hvd.HorovodInternalError as e:
        res["mismatch"] = np.array(str(e))
    res["after-mismatch"] = hvd.allreduce(np.full(2, rank, np.float32),
                                          op=hvd.Sum, name="after")


def hier_extras(res):
    # The executor's hierarchical legs run on local and cross groups of
    # the engine's own: a direct hierarchical all-reduce on this thread
    # while an eager one is in flight shares no communicator with it.
    eng, groups = global_state().engine, global_state().groups
    own = eng._hosts
    res["hosts/ranks-match"] = np.array(
        [own[0].ranks == groups["local"].ranks,
         own[1].ranks == groups["cross"].ranks])
    res["hosts/shared"] = np.array(
        [g.group in (groups["local"].group, groups["cross"].group, None)
         for g in own if g.size > 1])
    outs = []
    for i in range(3):
        h = hvd.allreduce_async(torch.full((64,), float(rank + i)),
                                name=f"overlap.{i}", op=hvd.Sum)
        direct = hvd.ops.collectives.hierarchical_allreduce(
            torch.full((64,), float(10 * rank + i)), op=hvd.Sum)
        outs.append(torch.stack([hvd.synchronize(h), direct]))
    res["hosts/overlap"] = torch.stack(outs).numpy()


def leftovers(res):
    # Nothing of the engine outlives hvd.shutdown: no executor thread, no
    # listener on the native controller's port.
    import socket
    import threading

    res["executor-threads"] = np.array(sum(
        t.name == "hvd-eager-executor" for t in threading.enumerate()))
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", config.native_controller_port()))
        s.listen()
    res["port-free"] = np.array(1)


api = Api()
for mode in spec["modes"]:
    os.environ["HOROVOD_NATIVE"] = "1" if mode == "native" else "0"
    for group, env in (("flat", {}), ("hier", cases.HIER_ENV)):
        os.environ.update(env)
        hvd.init(device="cpu")
        live = global_state().engine.native_core is not None
        assert live == (mode == "native"), (mode, live)
        for name, case in (cases.FLAT if group == "flat"
                           else cases.HIER).items():
            for k, v in cases.collect(name, case(api), False).items():
                res[f"{mode}/{k}"] = v
        if live and group == "flat":
            extras(res)
        if live and group == "hier":
            hier_extras(res)
        hvd.shutdown()
        for k in env:
            del os.environ[k]
leftovers(res)
""" + torch_worlds.WORLD_EPILOGUE


class _RefApi:
    """The JAX package's side: every rank's input as a list, one device
    each."""

    rank = None

    def __init__(self, hvd, inp):
        from horovod_tpu.common.exceptions import DuplicateTensorNameError

        self.hvd, self._inp = hvd, inp
        self.DuplicateTensorNameError = DuplicateTensorNameError

    def x(self, key):
        return self._inp[key]

    def bf16(self, key):
        return [jnp.asarray(a, jnp.bfloat16) for a in self._inp[key]]

    def native(self, key):
        return [jnp.asarray(a) for a in self._inp[key]]

    def each(self, out):
        return list(out) if isinstance(out, list) else [out] * cases.SIZE

    def same(self, v):
        return [v] * cases.SIZE

    def is_native(self, v):
        return all(isinstance(a, jax.Array) for a in
                   (v if isinstance(v, list) else [v]))

    def is_numpy(self, v):
        return all(isinstance(a, np.ndarray) for a in
                   (v if isinstance(v, list) else [v]))

    def has_hier(self):
        from horovod_tpu.common.state import global_state

        return global_state().hier_mesh is not None


def _reference(inp, monkeypatch):
    """Every case on the JAX package's engine: one dict a rank."""
    import horovod_tpu as jhvd

    monkeypatch.setenv("HOROVOD_NATIVE", "0")
    api = _RefApi(jhvd, inp)
    per_rank = [{} for _ in range(cases.SIZE)]
    for group, env in (("flat", {}), ("hier", cases.HIER_ENV)):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jhvd.init(devices=jax.devices("cpu")[:cases.SIZE])
        try:
            for name, case in (cases.FLAT if group == "flat"
                               else cases.HIER).items():
                for r, d in enumerate(cases.collect(name, case(api), True)):
                    per_rank[r].update(d)
        finally:
            jhvd.shutdown()
        for k in env:
            monkeypatch.delenv(k)
    return per_rank


@pytest.fixture(scope="module")
def eager_world(tmp_path_factory):
    inp = cases.inputs()
    flat_inputs = {f"{k}/{r}": a[r] for k, a in inp.items()
                   for r in range(cases.SIZE)}
    world = torch_worlds.launch(WORKER, cases.SIZE,
                                tmp_path_factory.mktemp("eager"),
                                {"modes": list(MODES)}, flat_inputs,
                                local_size=cases.LOCAL)
    with pytest.MonkeyPatch.context() as mp:
        ref = _reference(inp, mp)
    return world.results(), ref


def _ulp_bf16(x):
    """One bf16 ulp at each element's magnitude."""
    x = np.abs(np.asarray(x, np.float64))
    exp = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    return 2.0 ** (exp - 7)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_case_matches_the_jax_engine(eager_world, mode, name):
    port, ref = eager_world
    keys = sorted(k for k in ref[0] if k.startswith(f"{name}/")
                  and not k.endswith("#dtype"))
    assert keys, name
    for r in range(cases.SIZE):
        for k in keys:
            got, want = port[r][f"{mode}/{k}"], ref[r][k]
            dtype = str(ref[r][k + "#dtype"])
            got_dtype = str(port[r][f"{mode}/{k}#dtype"])
            assert dtype in (got_dtype, _JAX_CANON.get(got_dtype)), \
                (r, k, got_dtype, dtype)
            assert got.shape == want.shape, (r, k, got.shape, want.shape)
            if "~" in k:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{r} {k}")
            elif dtype == "bfloat16":
                assert np.all(np.abs(got - want) <= _ulp_bf16(want)), \
                    (r, k, got, want)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{r} {k}")


def test_submissions_in_one_cycle_fuse(eager_world):
    port, _ = eager_world
    want = sum(range(cases.SIZE)) * np.arange(1, 13)[:, None]
    for r in range(cases.SIZE):
        assert int(port[r]["fusion/tensors"]) == 12
        assert 1 <= int(port[r]["fusion/responses"]) < 12, \
            int(port[r]["fusion/responses"])
        np.testing.assert_array_equal(port[r]["fusion/out"],
                                      np.broadcast_to(want, (12, 32)))


def test_a_repeated_round_hits_the_response_cache(eager_world):
    # A worker sends a tensor it submitted before as a 4-byte cache id;
    # the coordinator (rank 0) sends no request frame, so counts none.
    port, _ = eager_world
    for r in range(cases.SIZE):
        assert int(port[r]["fusion/hits"]) == 0
        assert int(port[r]["cache/hits"]) == (12 if r else 0), \
            (r, int(port[r]["cache/hits"]))
        np.testing.assert_array_equal(port[r]["cache/out"],
                                      port[r]["fusion/out"])


def test_mismatched_reducescatter_raises_on_every_rank(eager_world):
    port, _ = eager_world
    for r in range(cases.SIZE):
        assert "Mismatched shapes" in str(port[r]["mismatch"]), \
            port[r]["mismatch"]
        np.testing.assert_array_equal(port[r]["after-mismatch"],
                                      np.full(2, 6.0))


def test_executor_hierarchy_runs_on_the_engines_own_groups(eager_world):
    port, _ = eager_world
    n = cases.SIZE
    for r in range(n):
        assert port[r]["hosts/ranks-match"].all()
        assert port[r]["hosts/shared"].size and \
            not port[r]["hosts/shared"].any()
        want = np.stack([np.stack([np.full(64, n * (n - 1) / 2 + n * i),
                                   np.full(64, 10 * n * (n - 1) / 2 + n * i)])
                         for i in range(3)])
        np.testing.assert_array_equal(port[r]["hosts/overlap"], want)


def test_shutdown_leaves_no_executor_or_listener(eager_world):
    port, _ = eager_world
    for r in range(cases.SIZE):
        assert int(port[r]["executor-threads"]) == 0
        assert int(port[r]["port-free"]) == 1
