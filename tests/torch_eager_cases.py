"""The cases of ``tests/test_ops_eager.py`` that exist at one device a
process, written once for both engines.

A case is a function of an ``Api``: ``api.hvd`` is the package
(``horovod_tpu_torch`` on a rank of the port's world, ``horovod_tpu`` on
the reference's 4-device mesh), ``api.x(key)`` the input (this rank's
array, or the list of every rank's), and ``api.each(out)`` turns an
output into what each rank holds. A case returns ``{key: per-rank value}``;
``collect`` turns that into numpy arrays, one set per rank. The inputs
are small integers and halves, made from a seed, so every result is exact
(bf16 results within one bf16 ulp).

This module imports neither ``jax`` nor the JAX package: the port's ranks
import it too.
"""

import os
import time

import numpy as np

SIZE, LOCAL = 4, 2


def inputs(seed=0) -> dict:
    """Every rank's inputs, ``{key: [array of rank 0, ..., rank 3]}``."""
    rng = np.random.RandomState(seed)

    def halves(shape):
        return [rng.randint(-8, 9, size=shape).astype(np.float32) / 2
                for _ in range(SIZE)]

    def ints(shape, dtype, lo=-50, hi=51):
        return [rng.randint(lo, hi, size=shape).astype(dtype)
                for _ in range(SIZE)]

    return {
        "a": halves((4, 5)), "b": halves((3,)), "c": halves((2, 2)),
        "d": halves((4,)), "e": halves((16,)), "f": halves((37,)),
        "g": halves((5,)), "h": halves((2, 3)),
        "i32": ints((4,), np.int32), "i16": ints((4,), np.int16),
        "u16": ints((4,), np.uint16, 0, 1000),
        "i64": ints((3,), np.int64),
        "bf": halves((8,)),
        "bf_exact": [np.full((8,), 1 + 2 ** -7, np.float32)] * SIZE,
        "ga": halves((3,)), "gb": halves((2, 2)), "gc": ints((5,), np.int32),
        "ag": halves((2, 3)),
        "ragged": [np.full((r + 1, 3), r, np.float32) for r in range(SIZE)],
        "ragged_async": [np.full((2 if r % 2 else 1,), r, np.float32)
                         for r in range(SIZE)],
        "rs": halves((2 * SIZE, 3)),
        "a2a": [np.arange(SIZE, dtype=np.float32) + 100 * r
                for r in range(SIZE)],
        "pw": halves((2, 2)), "pb": halves((3,)),
        "hier_i32": ints((4,), np.int32),
        "hier_bf": halves((8,)),
        # Exact in fp32, rounded away on an fp16 wire.
        "fine": [a + 2.0 ** -12 for a in halves((6,))],
        "adasum": halves((7,)),
    }


def _allreduce_sum(api):
    h = api.hvd
    return {"out": api.each(h.allreduce(api.x("a"), op=h.Sum))}


def _allreduce_average_default(api):
    return {"out": api.each(api.hvd.allreduce(api.x("b")))}


def _allreduce_min_max(api):
    h = api.hvd
    return {"min": api.each(h.allreduce(api.x("c"), op=h.Min, name="armin")),
            "max": api.each(h.allreduce(api.x("c"), op=h.Max, name="armax"))}


def _allreduce_prescale_postscale(api):
    h = api.hvd
    return {"out": api.each(h.allreduce(api.x("d"), op=h.Sum,
                                        prescale_factor=2.0,
                                        postscale_factor=0.5))}


def _allreduce_int32(api):
    h = api.hvd
    return {"out": api.each(h.allreduce(api.x("i32"), op=h.Sum))}


def _allreduce_int16_uint16(api):
    h = api.hvd
    return {"i16": api.each(h.allreduce(api.x("i16"), op=h.Sum)),
            "u16": api.each(h.allreduce(api.x("u16"), op=h.Sum)),
            "i16-max": api.each(h.allreduce(api.x("i16"), op=h.Max))}


def _allreduce_bf16_fp32_accumulation(api):
    h = api.hvd
    return {"exact": api.each(h.allreduce(api.bf16("bf_exact"), op=h.Sum)),
            "avg": api.each(h.allreduce(api.bf16("bf"), op=h.Average))}


def _allreduce_compressed(api):
    """``HOROVOD_COMPRESSION`` read when the collective runs: fp16 on the
    wire, and ef16 on its fp16 wire (the eager API keeps no residuals)."""
    h = api.hvd
    old = os.environ.get("HOROVOD_COMPRESSION")
    out = {}
    try:
        for mode in ("fp16", "ef16"):
            os.environ["HOROVOD_COMPRESSION"] = mode
            out[mode] = api.each(h.allreduce(api.x("fine"), op=h.Sum,
                                             name=f"comp.{mode}"))
    finally:
        if old is None:
            del os.environ["HOROVOD_COMPRESSION"]
        else:
            os.environ["HOROVOD_COMPRESSION"] = old
    return out


def _allreduce_adasum(api):
    """Adasum over the world (4 ranks, a power of two); its dot products
    and norms round, so this key is held at fp32 rel 1e-6 (``~``)."""
    h = api.hvd
    return {"out~": api.each(h.allreduce(api.x("adasum"), op=h.Adasum,
                                         name="adasum"))}


def _allreduce_async_poll_synchronize(api):
    h = api.hvd
    handle = h.allreduce_async(api.x("e"), op=h.Sum, name="async1")
    polled = h.poll(handle)
    out = h.synchronize(handle)
    try:
        h.synchronize(handle)
        again = 0
    except ValueError:
        again = 1
    return {"out": api.each(out), "double-sync-raises": api.same(again),
            "poll-is-bool": api.same(int(polled in (True, False)))}


def _allreduce_duplicate_name(api):
    h = api.hvd
    first = h.allreduce_async(api.x("b"), name="dup")
    try:
        h.allreduce_async(api.x("b"), name="dup")
        refused = 0
    except api.DuplicateTensorNameError:
        refused = 1
    a = h.synchronize(first)
    # The name is free again once its collective completed.
    b = h.synchronize(h.allreduce_async(api.x("b"), name="dup"))
    return {"refused": api.same(refused), "first": api.each(a),
            "reused": api.each(b)}


def _grouped_mixed_shapes_and_dtypes(api):
    h = api.hvd
    outs = h.grouped_allreduce([api.x("ga"), api.x("gb"), api.x("gc")],
                               op=h.Sum)
    return {f"t{i}": api.each(o) for i, o in enumerate(outs)}


def _allgather_equal(api):
    return {"out": api.each(api.hvd.allgather(api.x("ag")))}


def _allgather_ragged(api):
    return {"out": api.each(api.hvd.allgather(api.x("ragged"),
                                              name="ragged.eager"))}


def _allgather_ragged_async(api):
    h = api.hvd
    return {"out": api.each(h.synchronize(h.allgather_async(
        api.x("ragged_async"), name="ragged.async")))}


def _broadcast_every_root(api):
    h = api.hvd
    return {f"root{r}": api.each(h.broadcast(api.x("d"), root_rank=r))
            for r in range(SIZE)}


def _broadcast_int64(api):
    h = api.hvd
    return {"out": api.each(h.broadcast(api.x("i64"), root_rank=SIZE - 1))}


def _reducescatter_sum(api):
    h = api.hvd
    return {"out": api.each(h.reducescatter(api.x("rs"), op=h.Sum))}


def _alltoall_exchange(api):
    return {"out": api.each(api.hvd.alltoall(api.x("a2a")))}


def _barrier(api):
    return {"out": api.same(int(api.hvd.barrier() is None))}


def _join(api):
    # The last rank joins last, so every rank reports it.
    if api.rank == SIZE - 1:
        time.sleep(0.5)
    return {"last": api.same(api.hvd.join())}


def _broadcast_parameters(api):
    h = api.hvd
    w, b = api.x("pw"), api.x("pb")
    if api.rank is None:       # the JAX package: a stacked pytree in and out
        out = h.broadcast_parameters({"w": np.stack(w),
                                      "b": {"x": np.stack(b)}}, root_rank=0)
        return {"w": list(out["w"]), "b": list(out["b"]["x"])}
    import torch               # the port: a state_dict, in place

    model = torch.nn.Linear(2, 2)
    model.weight.data.copy_(torch.from_numpy(w))
    state = {"w": model.weight, "b": torch.from_numpy(b.copy())}
    h.broadcast_parameters(state, root_rank=0)
    return {"w": state["w"], "b": state["b"]}


def _broadcast_object(api):
    obj = {"epoch": 3, "lr": 0.5, "rank": api.rank or 0}
    got = api.hvd.broadcast_object(obj, root_rank=0)
    return {"epoch": api.same(got["epoch"]), "lr": api.same(got["lr"]),
            "from-root": api.same(got["rank"])}


def _device_resident_results(api):
    h = api.hvd
    s1 = h.allreduce(api.native("g"), op=h.Sum, name="chain.1")
    s2 = h.allreduce(s1, op=h.Average, name="chain.2")
    g = h.allgather(api.native("g"), name="dev.ag")
    return {"kept": api.same(int(api.is_native(s2) and api.is_native(g))),
            "numpy-kept": api.same(int(api.is_numpy(h.allreduce(
                api.x("g"), op=h.Sum, name="np.ar")))),
            "chain": api.each(s2), "gather": api.each(g)}


def _hier_groups_exist(api):
    return {"out": api.same(int(api.has_hier()))}


def _hier_allreduce_matches_flat(api):
    h = api.hvd
    return {"out": api.each(h.allreduce(api.x("f"), op=h.Sum,
                                        name="hier.ar"))}


def _hier_allreduce_average(api):
    h = api.hvd
    return {"out": api.each(h.allreduce(api.x("g"), op=h.Average,
                                        name="hier.avg"))}


def _hier_allgather_matches_flat(api):
    return {"out": api.each(api.hvd.allgather(api.x("h"), name="hier.ag"))}


def _hier_min_falls_back_to_flat(api):
    h = api.hvd
    return {"out": api.each(h.allreduce(api.x("g"), op=h.Min,
                                        name="hier.min"))}


def _hier_dtype_contract_matches_flat(api):
    h = api.hvd
    return {"int-avg": api.each(h.allreduce(api.x("hier_i32"),
                                            op=h.Average, name="hier.iavg")),
            "bf16-sum": api.each(h.allreduce(api.bf16("hier_bf"), op=h.Sum,
                                             name="hier.bf16"))}


# name -> case; the flat ones run on a plain init, the hier ones with
# HOROVOD_HIERARCHICAL_ALLREDUCE/ALLGATHER=1. Both engines run them in
# this order.
FLAT = {
    "allreduce.sum": _allreduce_sum,
    "allreduce.average_default": _allreduce_average_default,
    "allreduce.min_max": _allreduce_min_max,
    "allreduce.prescale_postscale": _allreduce_prescale_postscale,
    "allreduce.int32": _allreduce_int32,
    "allreduce.int16_uint16": _allreduce_int16_uint16,
    "allreduce.bf16_fp32_accumulation": _allreduce_bf16_fp32_accumulation,
    "allreduce.compressed": _allreduce_compressed,
    "allreduce.adasum": _allreduce_adasum,
    "allreduce.async_poll_synchronize": _allreduce_async_poll_synchronize,
    "allreduce.duplicate_name": _allreduce_duplicate_name,
    "grouped.mixed_shapes_and_dtypes": _grouped_mixed_shapes_and_dtypes,
    "allgather.equal": _allgather_equal,
    "allgather.ragged": _allgather_ragged,
    "allgather.ragged_async": _allgather_ragged_async,
    "broadcast.every_root": _broadcast_every_root,
    "broadcast.int64": _broadcast_int64,
    "reducescatter.sum": _reducescatter_sum,
    "alltoall.exchange": _alltoall_exchange,
    "barrier": _barrier,
    "join": _join,
    "helpers.broadcast_parameters": _broadcast_parameters,
    "helpers.broadcast_object": _broadcast_object,
    "device_resident_results": _device_resident_results,
}
HIER = {
    "hier.groups_exist": _hier_groups_exist,
    "hier.allreduce_matches_flat": _hier_allreduce_matches_flat,
    "hier.allreduce_average": _hier_allreduce_average,
    "hier.allgather_matches_flat": _hier_allgather_matches_flat,
    "hier.min_falls_back_to_flat": _hier_min_falls_back_to_flat,
    "hier.dtype_contract_matches_flat": _hier_dtype_contract_matches_flat,
}
HIER_ENV = {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
            "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}


def to_numpy(v):
    """(values as float64, dtype name) of a torch, jax or numpy value."""
    if hasattr(v, "detach"):                      # torch
        name = str(v.dtype).replace("torch.", "")
        v = v.detach().cpu()
        arr = (v.float() if name == "bfloat16" else v).numpy()
    else:
        name = str(np.asarray(v).dtype) if not hasattr(v, "dtype") \
            else str(v.dtype)
        arr = np.asarray(v, dtype=np.float32 if name == "bfloat16" else None)
    return arr.astype(np.float64), name


def collect(case, out: dict, per_rank: bool) -> list:
    """``out`` of a case as ``{case/key: array, case/key#dtype: name}``:
    one dict (``per_rank=False``, a rank of the port) or one for each rank
    (the reference's lists)."""
    ranks = range(SIZE) if per_rank else [None]
    res = [{} for _ in ranks]
    for key, value in out.items():
        for i, r in enumerate(ranks):
            arr, dtype = to_numpy(value if r is None else value[r])
            res[i][f"{case}/{key}"] = arr
            res[i][f"{case}/{key}#dtype"] = np.array(dtype)
    return res if per_rank else res[0]
