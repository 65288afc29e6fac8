"""Control-plane latency microbench on the port: enqueue -> response
round-trip.

The port of ``tools/controller_bench.py`` over the port's native core
(``horovod_tpu_torch.common.native.NativeCore``, built from
``horovod_tpu_torch/csrc/hvd``). The reference's background loop budgets
a 5 ms cycle (``operations.cc:431``, the default ``HOROVOD_CYCLE_TIME``)
and its response cache lets repeat submissions skip the full
negotiation (``response_cache.h:45-167``). This bench measures, over a
REAL multi-process TCP-star controller + ring world, the wall clock from
``enqueue`` to completion of a 16-byte host-plane allreduce (the core's
own ring carries it; the exec callback, which would hand a device-plane
response to NCCL, completes without a collective): negotiation and the
host ring, no NCCL and no device. Two series:

- **miss**: first-ever tensor names — full negotiation every time
  (request gather, validation, response broadcast).
- **hit**: the same tensor name resubmitted each step (the training-loop
  shape) — requests travel as 4-byte cache ids.

One JSON line on stdout:
``{"metric": "controller_cached_rtt_ms", "value": <worst cached p50
across sizes>, ..., "sizes": {...}}``.

Usage: python -m horovod_tpu_torch.tools.controller_bench
       [--sizes 2,4,8,32] [--iters 200] [--hier-control] [--soak-iters N]
       [--out FILE]

Rows above size 8 are controller scale soaks: N ranks timeshare the
host's cores, so their RTT includes that oversubscription; the headline
``value`` stays the worst cached p50 across sizes <=
``--headline-max-size`` (default 8). Soak rungs above 32 ranks scale
their iteration count (~iters*32/size, floor 30, or ``--soak-iters``)
and their timeout, and export a widened ``HVD_JOIN_TIMEOUT_MS``.

``--hier-control`` runs every rung under ``HOROVOD_HIER_CONTROL=1``
(ranks paired into 2-member host groups, round-robin placement) and
records the leader-side split histograms (leader_agg_ms / fanout_ms)
beside gather_wait_ms in each rank-0 row. ``--hier`` dispatches the
two-level allreduce (2 simulated hosts); ``--stripes N`` with it stripes
the cross-host leader leg and adds 256 KiB bulk allreduces.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# The checkout's root: the workers import the package from it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _stats(samples_ms):
    xs = sorted(samples_ms)
    n = len(xs)
    return {
        "p50": round(xs[n // 2], 4),
        "p90": round(xs[min(n - 1, (9 * n) // 10)], 4),
        "p99": round(xs[min(n - 1, (99 * n) // 100)], 4),
        "mean": round(sum(xs) / n, 4),
        "n": n,
    }


def worker(rank: int, size: int, port: int, iters: int,
           cycle_ms: float, hier: bool = False,
           stripes: int = 0, hier_control: bool = False) -> int:
    import numpy as np

    from horovod_tpu_torch.common import native as hn

    if stripes > 0:
        os.environ["HOROVOD_STRIPES"] = str(stripes)
    if hier:
        # The two-level allreduce dispatched from the env: the RTT rows
        # then include the intra-host legs, whose transport (loopback
        # TCP vs shm when HOROVOD_SHM=1 is exported to this bench) is
        # recorded per rank — the local-leg proof surface
        # (docs/shm-transport.md).
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    if hier_control:
        # Two-level negotiation (docs/control-plane.md): members speak
        # delta-first frames to their host leader over the LOCAL_CTRL
        # registry leg, leaders aggregate for the coordinator — the
        # O(hosts) coordinator cost the 64/128/256 ladder rungs gate.
        os.environ["HOROVOD_HIER_CONTROL"] = "1"
    if size > 32:
        # The big rungs serialize `size` interpreter startups on however
        # many cores this box has; the default 120 s world-join deadline
        # is a startup-speed assumption, not a protocol bound.
        os.environ.setdefault("HVD_JOIN_TIMEOUT_MS",
                              str(max(120000, size * 4000)))
    if hier or hier_control:
        # 2 simulated hosts x size/2 local, round-robin placement.
        local_rank, local_size = rank // 2, size // 2
        cross_rank, cross_size = rank % 2, 2
    else:
        local_rank, local_size = 0, 1
        cross_rank, cross_size = rank, size
    core = hn.NativeCore()
    assert core.available, "native core unavailable"
    ok = core.init(rank=rank, size=size, local_rank=local_rank,
                   local_size=local_size, cross_rank=cross_rank,
                   cross_size=cross_size,
                   coordinator_addr="127.0.0.1", coordinator_port=port,
                   my_host="127.0.0.1", cycle_time_ms=cycle_ms,
                   fusion_threshold=64 << 20, cache_capacity=1024,
                   stall_warning_sec=60.0, stall_shutdown_sec=0.0,
                   stall_check_enabled=True,
                   exec_callback=lambda resp, rid: core.response_done(
                       rid, False, "host-plane only bench"))
    assert ok, "native init failed"

    F32 = hn.DTYPE_CODES["float32"]
    buf = np.ones(4, np.float32)

    def rtt(name):
        t0 = time.perf_counter()
        h = core.enqueue(name, hn.OP_ALLREDUCE, 1, F32, buf.shape,
                         data_ptr=buf.ctypes.data,
                         output_ptr=buf.ctypes.data, plane=hn.PLANE_HOST)
        r, err = core.wait(h)
        assert r == 1, err
        return (time.perf_counter() - t0) * 1e3

    # Warm the world (connections, first negotiation) before timing.
    for i in range(3):
        rtt(f"warm.{i}")

    miss = [rtt(f"miss.{i}") for i in range(iters)]

    # Same name every step: after the first submission the request rides
    # the response cache's id fast path.
    hit_all = [rtt("hit") for _ in range(iters + 1)]
    hit = hit_all[1:]
    # The coordinator (rank 0) never puts its own requests on the wire,
    # so id-fast-path hits are counted on worker ranks only.
    hits_seen = core.cache_hits()

    # --stripes soak rows: a few bulk allreduces above the tree cutoff
    # so the striped leader leg actually engages (the latency rows' tiny
    # tensors stay on the binomial tree in every mode) — the scale soaks
    # then cover the new cross path without bloating the fast profile.
    bulk = []
    if stripes > 0 and hier:
        big = np.ones(1 << 16, np.float32)

        def bulk_rtt(name):
            t0 = time.perf_counter()
            h = core.enqueue(name, hn.OP_ALLREDUCE, 1, F32, big.shape,
                             data_ptr=big.ctypes.data,
                             output_ptr=big.ctypes.data,
                             plane=hn.PLANE_HOST)
            r, err = core.wait(h)
            assert r == 1, err
            return (time.perf_counter() - t0) * 1e3

        bulk = [bulk_rtt(f"bulk.{i}") for i in range(10)]

    traffic = {"local_bytes": core.ring_local_bytes(),
               "cross_bytes": core.ring_cross_bytes(),
               "shm_bytes": core.ring_shm_bytes(),
               "shm": core.shm_active(),
               "stripe_bytes": core.ring_stripe_bytes(),
               "stripes": core.ring_stripe_count()}
    # Coordinator-side gather-wait distribution (docs/metrics.md): how
    # long each cycle's gather waited per worker frame — the O(N)
    # coordinator cost of a scale-out, measured per world size instead of
    # inferred from RTTs.
    gather_wait = None
    hier_hists = None
    if rank == 0:
        from horovod_tpu_torch.common.metrics import percentiles

        def _hist_row(h):
            return {
                "n": int(h.get("count", 0)),
                **{k: round(v / 1000.0, 3)
                   for k, v in percentiles(h, (50, 90, 99)).items()},
            }

        hists = core.metrics_snapshot().get("histograms", {})
        gather_wait = _hist_row(hists.get("gather_wait_us", {}))
        if hier_control:
            # The hierarchical control plane's own latency split
            # (docs/control-plane.md): leader-side member aggregation
            # and response fan-out, recorded by the coordinator for its
            # host-0 group.
            hier_hists = {
                "leader_agg_ms": _hist_row(hists.get("leader_agg_us",
                                                     {})),
                "fanout_ms": _hist_row(hists.get("fanout_us", {})),
            }
    core.shutdown()
    print(f"WORKER_CACHE {rank} {int(hits_seen)}", flush=True)
    print("WORKER_TRAFFIC " + json.dumps({"rank": rank, **traffic}),
          flush=True)
    if rank == 0:
        row = {
            "size": size,
            "cycle_time_ms": cycle_ms,
            "miss_ms": _stats(miss),
            "hit_ms": _stats(hit),
        }
        if gather_wait is not None:
            # Approximate percentiles (log2-bucket upper bounds, ms):
            # the per-rank gather-wait histogram from the metrics
            # snapshot, the coordinator-scaling row. Under
            # --hier-control its `n` also proves the
            # O(hosts) claim: ~1 awaited frame per cycle instead of
            # size-1.
            row["gather_wait_ms"] = gather_wait
        if hier_hists is not None:
            row.update(hier_hists)
        if bulk:
            row["bulk_ms"] = _stats(bulk)
            row["bulk_payload_bytes"] = int(big.nbytes)
        print("WORKER_RESULT " + json.dumps(row), flush=True)
    return 0


# Port-clash signatures (same contract as tests/proc_harness.py, which
# documents free_port()'s TOCTOU window): ONLY these retry.
_PORT_CLASH_MARKERS = (
    "world join failed",
    "Address already in use",
    "EADDRINUSE",
)


def run_size(size: int, iters: int, cycle_ms: float, timeout: float,
             attempts: int = 3, hier: bool = False, stripes: int = 0,
             hier_control: bool = False):
    from horovod_tpu_torch.common.config import free_port_pair

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    last_blob = ""
    for attempt in range(attempts):
        port = free_port_pair()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.tools.controller_bench",
             "--worker",
             str(r), str(size), str(port), str(iters), str(cycle_ms),
             "1" if hier else "0", str(stripes),
             "1" if hier_control else "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=env) for r in range(size)]
        result = None
        cache_hits = 0
        traffic = {"local_bytes": 0, "cross_bytes": 0, "shm_bytes": 0,
                   "stripe_bytes": 0}
        stripe_ranks = 0
        shm_ranks = 0
        failed = None
        try:
            for r, p in enumerate(procs):
                out, _ = p.communicate(timeout=timeout)
                last_blob += out
                if p.returncode != 0 and failed is None:
                    failed = (r, out)
                for line in out.splitlines():
                    if line.startswith("WORKER_RESULT "):
                        result = json.loads(line[len("WORKER_RESULT "):])
                    elif line.startswith("WORKER_CACHE "):
                        cache_hits += int(line.split()[2])
                    elif line.startswith("WORKER_TRAFFIC "):
                        t = json.loads(line[len("WORKER_TRAFFIC "):])
                        for k in traffic:
                            traffic[k] += t.get(k, 0)
                        shm_ranks += 1 if t["shm"] else 0
                        stripe_ranks += 1 if t.get("stripes") else 0
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed is None and result is not None:
            # Worker ranks resubmitting "hit" rode the id fast path.
            result["cache_hits_worker_ranks"] = cache_hits
            # World-aggregate data-plane split: with --hier (and
            # HOROVOD_SHM exported) this is the local-leg proof line;
            # with --stripes the stripe column is the cross-leg one.
            result["traffic"] = {**traffic, "shm_active_ranks": shm_ranks,
                                 "stripe_active_ranks": stripe_ranks}
            return result
        if attempt + 1 < attempts and any(
                m in last_blob for m in _PORT_CLASH_MARKERS):
            print(f"controller_bench: suspected port clash on {port} "
                  f"(attempt {attempt + 1}/{attempts}); retrying",
                  file=sys.stderr)
            continue
        if failed is not None:
            raise RuntimeError(
                f"controller_bench rank {failed[0]} failed:\n"
                f"{failed[1][-2000:]}")
        raise RuntimeError("rank 0 produced no result line")
    raise RuntimeError(
        f"controller_bench: no clean world in {attempts} attempts")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="2,4,8,32")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--headline-max-size", type=int, default=8,
                   help="sizes above this are scale-soak rows: recorded "
                        "in the JSON (and gated at 2x budget by the CI "
                        "schema test) but excluded from the headline "
                        "`value`, which tracks the like-for-like ladder "
                        "the 5 ms budget was defined for")
    p.add_argument("--cycle-ms", default="1.0",
                   help="comma list of controller cycle times to sweep. "
                        "5.0 is both the reference's and this repo's "
                        "default (operations.cc:431 / config.py); at "
                        "that setting the RTT is dominated by the cycle "
                        "sleep itself, so 1.0 isolates the actual "
                        "negotiation+wire work")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--hier", action="store_true",
                   help="shape each world as 2 simulated hosts x size/2 "
                        "with the two-level allreduce dispatched, so "
                        "the rows include the intra-host legs and the "
                        "aggregated `traffic` split records which "
                        "transport carried them (export HOROVOD_SHM=1 "
                        "for the shm-vs-loopback line; "
                        "docs/shm-transport.md)")
    p.add_argument("--stripes", type=int, default=0,
                   help="with --hier: stripe the cross-host leader leg "
                        "with this many connections per pair "
                        "(HOROVOD_STRIPES) and add a bulk_ms column of "
                        "256 KiB allreduces so the scale soaks cover "
                        "the striped path; the traffic split gains "
                        "stripe_bytes/stripe_active_ranks "
                        "(docs/cross-transport.md)")
    p.add_argument("--hier-control", action="store_true",
                   help="run the two-level control plane "
                        "(HOROVOD_HIER_CONTROL=1, 2 simulated hosts): "
                        "members negotiate delta-first through their "
                        "host leader, the coordinator awaits leaders "
                        "only — rank-0 rows gain leader_agg_ms and "
                        "fanout_ms and gather_wait_ms.n drops to "
                        "~1/cycle (docs/control-plane.md)")
    p.add_argument("--soak-iters", type=int, default=0,
                   help="iteration count for scale-soak rungs above 32 "
                        "ranks (0 = auto: iters scaled down by 32/size, "
                        "floor 30). The big rungs oversubscribe this "
                        "machine's cores by the full world size, so "
                        "full-length runs measure nothing extra — only "
                        "the percentile n shrinks")
    p.add_argument("--out", default=None,
                   help="also write the JSON to this path")
    args = p.parse_args(argv)

    sizes = [int(s) for s in args.sizes.split(",") if s]
    # Every worker loads the core: build it once, before they start.
    from horovod_tpu_torch.common import native

    native.build()
    cycles = [float(c) for c in str(args.cycle_ms).split(",") if c]
    by_cycle = {}
    for cycle_ms in cycles:
        per_size = {}
        for size in sizes:
            if size > 32:
                size_iters = args.soak_iters or max(
                    30, (args.iters * 32) // size)
                # Startup alone is O(size) serialized on an
                # oversubscribed box; give the big rungs room.
                size_timeout = args.timeout * max(1, size // 16)
            else:
                size_iters, size_timeout = args.iters, args.timeout
            per_size[str(size)] = run_size(size, size_iters, cycle_ms,
                                           size_timeout, hier=args.hier,
                                           stripes=args.stripes,
                                           hier_control=args.hier_control)
            row = per_size[str(size)]
            print(f"controller_bench: cycle {cycle_ms} ms, size {size} "
                  f"done (hit p50 {row['hit_ms']['p50']} ms p99 "
                  f"{row['hit_ms']['p99']} ms, miss p50 "
                  f"{row['miss_ms']['p50']} ms p99 {row['miss_ms']['p99']} "
                  f"ms)", file=sys.stderr)
        by_cycle[str(cycle_ms)] = per_size

    # Headline: the tightest-cycle sweep isolates negotiation+wire work;
    # it must fit within the reference's 5 ms cycle budget. Scale-soak
    # rows (size > --headline-max-size) ride the JSON but not the
    # headline — on this machine they oversubscribe the cores by the
    # world size, which measures the scheduler, not the protocol.
    tightest = by_cycle[str(min(cycles))]
    headline = {k: v for k, v in tightest.items()
                if v["size"] <= args.headline_max_size} or tightest
    worst_hit_p50 = max(v["hit_ms"]["p50"] for v in headline.values())
    result = {
        "metric": "controller_cached_rtt_ms",
        "value": worst_hit_p50,
        "unit": "ms (worst cached p50 across sizes, tightest cycle)",
        "vs_baseline": round(5.0 / worst_hit_p50, 3) if worst_hit_p50
        else None,
        "baseline": "reference 5 ms cycle budget (operations.cc:431)",
        "note": ("RTT at a given --cycle-ms includes waiting for the "
                 "next controller tick; the tightest-cycle row bounds "
                 "the per-round negotiation+wire work itself"),
        "iters": args.iters,
        "hier_control": bool(args.hier_control),
        "by_cycle_ms": by_cycle,
        "sizes": tightest,
    }
    # A chaos soak must be reproducible from the artifact alone: log the
    # spec AND the concrete schedule its seed draws (docs/self-healing.md).
    chaos = os.environ.get("HOROVOD_CHAOS_SPEC", "")
    if chaos:
        from horovod_tpu_torch.tools import chaos_sched
        result["chaos"] = chaos_sched.schedule_record(chaos,
                                                      size=max(sizes))
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]),
                        int(sys.argv[4]), int(sys.argv[5]),
                        float(sys.argv[6]),
                        len(sys.argv) > 7 and sys.argv[7] == "1",
                        int(sys.argv[8]) if len(sys.argv) > 8 else 0,
                        len(sys.argv) > 9 and sys.argv[9] == "1"))
    sys.exit(main())
