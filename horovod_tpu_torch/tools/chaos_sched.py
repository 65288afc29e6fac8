"""Seeded multi-fault chaos scheduler — compile and inspect a
``HOROVOD_CHAOS_SPEC`` schedule.

The port of ``tools/chaos_sched.py`` over the port's own compiler,
``horovod_tpu_torch.common.config.parse_chaos_spec`` (so the runtime's
fault plane never imports this tool); this CLI is the operator-facing
surface around it:

- **inspect**: print the concrete fault schedule a spec compiles to —
  ``--format json`` (one object: spec, seed-derived fault list) or
  ``--format fault-spec`` (the equivalent ``HOROVOD_FAULT_SPEC`` string,
  replayable through the plain fault plane without the chaos compiler).
- **bench logging**: benches call :func:`schedule_record` to embed the
  spec *and* its compiled schedule in their JSON artifact, so a soak
  result is reproducible from the artifact alone.

The schedule is a pure function of (spec, size): ``random.Random(seed)``
with a fixed draw order, the same on every machine and Python version,
so a chaos failure is re-runnable from the one-line spec in the log.

Usage:
  python -m horovod_tpu_torch.tools.chaos_sched --spec "seed=7,n=4" --size 8
  python -m horovod_tpu_torch.tools.chaos_sched \\
      --spec "seed=7,n=4,kinds=drop_conn" --size 8 --format fault-spec
  HOROVOD_CHAOS_SPEC=seed=7,n=4 python -m horovod_tpu_torch.tools.chaos_sched --size 8
"""

import argparse
import json
import sys

from ..common import config as _config


def compile_spec(spec_text: str, size: int = 0) -> tuple:
    """The concrete ``FaultSpec`` tuple a chaos spec compiles to."""
    return _config.parse_chaos_spec(spec_text, size=size)


def schedule_record(spec_text: str, size: int = 0) -> dict:
    """The JSON-able record benches embed in their artifacts: the spec
    string plus every compiled fault (point/rank/step/kind/arg)."""
    faults = []
    for f in compile_spec(spec_text, size=size):
        row = {"point": f.point, "rank": f.rank, "step": f.step,
               "kind": f.kind}
        if f.kind == "delay_ms":
            row["ms"] = f.ms
        elif f.kind == "exit":
            row["code"] = f.code
        faults.append(row)
    return {"spec": spec_text, "size": size, "n": len(faults),
            "faults": faults}


def to_fault_spec(spec_text: str, size: int = 0) -> str:
    """Render a chaos schedule in ``HOROVOD_FAULT_SPEC`` grammar, so the
    exact drawn schedule replays through the plain fault plane (no chaos
    compiler in the loop — useful for bisecting one drawn fault)."""
    chunks = []
    for f in compile_spec(spec_text, size=size):
        chunk = (f"{f.point}:rank={f.rank}:step={f.step}"
                 f":kind={f.kind}:times=1")
        if f.kind == "delay_ms":
            chunk += f":ms={f.ms:g}"
        elif f.kind == "exit":
            chunk += f":code={f.code}"
        chunks.append(chunk)
    return ";".join(chunks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Compile a HOROVOD_CHAOS_SPEC into its concrete "
                    "fault schedule")
    ap.add_argument("--spec", default=None,
                    help="chaos spec (default: $HOROVOD_CHAOS_SPEC)")
    ap.add_argument("--size", type=int, default=0,
                    help="world size bounding the default rank pool "
                         "(default: $HOROVOD_SIZE)")
    ap.add_argument("--format", choices=("json", "fault-spec"),
                    default="json")
    args = ap.parse_args(argv)
    spec = args.spec if args.spec is not None else _config.chaos_spec()
    if not spec:
        ap.error("no spec: pass --spec or set HOROVOD_CHAOS_SPEC")
    try:
        if args.format == "fault-spec":
            print(to_fault_spec(spec, size=args.size))
        else:
            print(json.dumps(schedule_record(spec, size=args.size),
                             indent=1))
    except ValueError as e:
        print(f"chaos_sched: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
