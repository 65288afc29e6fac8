"""Profile a model-zoo train step on the port and summarize the device
time by operation.

The port of ``tools/profile_resnet.py``: ``--model`` picks any entry of
``image_bench.MODELS`` (resnet50/resnet101/vgg16/inception3), built as
``image_bench`` builds it (bf16, ``SGD(0.01, momentum=0.9)``, a batch of
``--batch-size`` images a rank at the model's canonical size), run for 3
warm-up steps and then ``--steps`` steps under ``torch.profiler`` (CPU
and CUDA activities).

    python -m horovod_tpu_torch.tools.profile_resnet [--model resnet50]
        [--batch-size 32] [--steps 5] [--out DIR]

Writes ``<out>/<model>_trace_<ts>/`` (the Chrome trace of the steps) and
``<out>/<model>_trace_<ts>_summary.md`` (the top ops by device self time),
prints one JSON line of the run and the summary's path. The default
``--out`` is ``build/horovod_tpu_torch/probes`` in the checkout. With
``--device cpu`` there is no device time: ``--include-host`` sums the
host-side ops' self time instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "horovod_tpu_torch", "probes")


def capture(args):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.image_bench import MODELS, _sync, build_model
    from horovod_tpu_torch.training import (init_train_state,
                                            make_train_step, shard_batch)

    hvd.init(device=args.device)
    n, device = hvd.size(), hvd.device()
    if args.image_size is None:
        args.image_size = MODELS[args.model]["size"]
    args.space_to_depth = False   # build_model's flag: the 7x7 stem
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model = build_model(args, device)
    step = make_train_step(model, init_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)))

    global_batch = args.batch_size * n
    images = np.random.RandomState(0).rand(
        global_batch, args.image_size, args.image_size, 3).astype(np.float32)
    labels = np.random.RandomState(1).randint(
        0, 1000, size=(global_batch,)).astype(np.int64)
    images, labels = shard_batch((images, labels), hvd.rank(), n, device)

    for _ in range(3):  # warm-up (cuDNN's autotuning)
        loss = step(images, labels)
    float(loss)

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    ts = time.strftime("%Y%m%dT%H%M%S")
    trace_dir = os.path.join(args.out, f"{args.model}_trace_{ts}")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = step(images, labels)
        float(loss)
        _sync(device)
        dt = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    meta = dict(platform="gpu" if device.type == "cuda" else device.type,
                device_kind=kind, model=args.model,
                batch_size=args.batch_size, steps=args.steps,
                img_per_sec=round(global_batch * args.steps / dt, 1),
                step_ms=round(1e3 * dt / args.steps, 2))
    return trace_dir, meta, prof.key_averages()


def op_times(events, include_host):
    """{op name: self time in us} over the profiled steps: device kernels
    (and, with ``include_host``, host-side ops)."""
    out = {}
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
        elif include_host and e.device_type == torch.autograd.DeviceType.CPU:
            us = e.self_cpu_time_total
        else:
            continue
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def summarize(meta, events, args):
    """The summary's markdown, or None when no op time was recorded."""
    per_op = op_times(events, args.include_host)
    if not per_op:
        print("no device events recorded", file=sys.stderr)
        return None
    total = sum(per_op.values())
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:args.top]
    lines = [
        f"# {meta['model']} train-step trace — {meta['platform']} "
        f"({meta['device_kind']})",
        "",
        f"Captured {time.strftime('%Y-%m-%d %H:%M:%S')}: "
        f"batch {meta['batch_size']}/device x {meta['steps']} steps, "
        f"{meta['img_per_sec']} img/s, {meta['step_ms']} ms/step "
        f"(torch.profiler on).",
        "",
        f"Total {'device' if meta['platform'] == 'gpu' else 'op'} self "
        f"time parsed: {total / 1e3:.2f} ms across {len(per_op)} distinct "
        f"ops.",
        "",
        "| rank | op | total ms | % of busy |",
        "|---|---|---|---|",
    ]
    for i, (name, us) in enumerate(top):
        lines.append(f"| {i + 1} | `{name[:80]}` | {us / 1e3:.3f} | "
                     f"{100 * us / total:.1f}% |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    from horovod_tpu_torch.image_bench import MODELS

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50", choices=sorted(MODELS))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--image-size", type=int, default=None,
                   help="defaults to the model's canonical size")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--include-host", action="store_true",
                   help="also sum host-side ops (CPU runs)")
    p.add_argument("--device", default=None,
                   help="default cuda:<local rank>; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import horovod_tpu_torch as hvd

    try:
        trace_dir, meta, events = capture(args)
    finally:
        hvd.shutdown()
    print(json.dumps(meta), flush=True)
    summary = summarize(meta, events, args)
    if summary:
        out = trace_dir.rstrip("/") + "_summary.md"
        with open(out, "w") as f:
            f.write(summary)
        print(f"summary -> {out}", file=sys.stderr)
        sys.stderr.write(summary[:2000] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
