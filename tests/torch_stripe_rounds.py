"""Rounds of the port's 8-rank stripe acceptance world, several at once.

``tests/test_torch_core_planes.py`` runs the JAX package's stripe
acceptance worker on the port's core (8 ranks as 2 hosts x 4, the
4 -> 1 -> 4 stripe renegotiation). This runs ``--worlds`` copies of that
world at once, ``--rounds`` times, each through the checkout's own
``proc_harness.run_world`` (which retries a port clash), and prints one
line a world and the count of failures; each failure's message goes to
``--out``. ``--tree`` names another checkout to run instead of this one
(its own tests, package and core):

    python tests/torch_stripe_rounds.py --worlds 4 --rounds 5
    python tests/torch_stripe_rounds.py --tree DIR --worlds 4 --rounds 5

Exits 1 when a world failed.
"""

import argparse
import os
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--worlds", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "tests"), tree]
    import test_stripe_transport as ref_stripe
    from proc_harness import run_world
    from test_torch_core_planes import port_worker

    out = Path(args.out or tempfile.mkdtemp(prefix="stripe_rounds_"))
    out.mkdir(parents=True, exist_ok=True)
    text = port_worker(ref_stripe._ACCEPTANCE_WORKER)
    failed = 0
    for rnd in range(args.rounds):
        res = {}

        def one(w):
            tmp = Path(tempfile.mkdtemp(dir=out, prefix=f"r{rnd}w{w}_"))
            t0 = time.perf_counter()
            try:
                run_world(tmp, text, "STRACC", size=8, timeout=600)
                res[w] = (None, time.perf_counter() - t0)
            except BaseException as e:
                res[w] = ("".join(traceback.format_exception(e)),
                          time.perf_counter() - t0)

        threads = [threading.Thread(target=one, args=(w,))
                   for w in range(args.worlds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for w in range(args.worlds):
            err, seconds = res[w]
            print(f"round {rnd} world {w} {'FAIL' if err else 'ok'} "
                  f"{seconds:.1f} s", flush=True)
            if err:
                failed += 1
                (out / f"fail_r{rnd}_w{w}.txt").write_text(err)
    print(f"{failed} of {args.worlds * args.rounds} worlds failed "
          f"({tree}; messages under {out})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
