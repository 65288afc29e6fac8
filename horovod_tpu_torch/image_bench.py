"""Image-model training benchmark on the port: images/s per GPU for
ResNet-50 (the headline), ResNet-101, VGG-16 and Inception V3, data
parallel.

The port of ``bench.py``'s resnet worker: the same flags and defaults and
one JSON line with its keys and meanings. One process per GPU (size 1
without a launcher). The protocol: synthetic ImageNet-shaped data (a
global batch of ``--batch-size`` images per rank drawn by
``RandomState(0)`` and labels by ``RandomState(1)``, each rank taking its
rows), bf16 model, ``SGD(lr=0.01, momentum=0.9)`` (``optax.sgd(0.01,
momentum=0.9)``), gradients averaged by fused bucket all-reduces and
batch-norm statistics averaged over the world every step; warm-up steps,
then timed steps ending in one ``torch.cuda.synchronize`` and one read of
the loss. On a GPU cuDNN autotunes its convolutions
(``cudnn.benchmark``), as fixed-shape CNN training is run.

    python -m horovod_tpu_torch.image_bench                 # ResNet-50
    python -m horovod_tpu_torch.image_bench --model vgg16
    python -m horovod_tpu_torch.image_bench --device cpu --model resnet50 \\
        --image-size 32 --batch-size 2 --num-warmup 1 --num-iters 2

MFU = images/s x 3 x forward FLOPs at the canonical size x (size /
canonical)^2 over the card's dense bf16 peak, on an H100 only
(``bench.py``'s convention).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .transformer_bench import _sync, peak_flops

# The reference's published ResNet-101 tf_cnn_benchmarks number, 1656.82
# images/s on 16 Pascal GPUs (docs/benchmarks.rst:31-41 of the reference):
# the yardstick of ``vs_baseline``.
BASELINE_IMG_PER_SEC_PER_DEVICE = 1656.82 / 16.0

# Forward FLOPs per image at the canonical input size (2 x GMACs); a
# training step is taken as 3 forwards. The reference's benchmark trio
# plus the ResNet-101 its throughput table quotes.
MODELS = {
    "resnet50": {"fwd_flops": 2 * 4.1e9, "size": 224,
                 "module": "horovod_tpu_torch.models.resnet",
                 "cls": "ResNet50", "s2d": True},
    "resnet101": {"fwd_flops": 2 * 7.6e9, "size": 224,
                  "module": "horovod_tpu_torch.models.resnet",
                  "cls": "ResNet101", "s2d": True},
    "vgg16": {"fwd_flops": 2 * 15.5e9, "size": 224,
              "module": "horovod_tpu_torch.models.vgg", "cls": "VGG16",
              "s2d": False},
    "inception3": {"fwd_flops": 2 * 2.85e9, "size": 299,
                   "module": "horovod_tpu_torch.models.inception",
                   "cls": "InceptionV3", "s2d": False},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50", choices=sorted(MODELS))
    p.add_argument("--batch-size", type=int, default=32, help="per rank")
    p.add_argument("--num-warmup", type=int, default=5)
    p.add_argument("--num-iters", type=int, default=30)
    p.add_argument("--image-size", type=int, default=None,
                   help="default: the model's canonical size (224; 299 for "
                        "inception3)")
    p.add_argument("--fence-each", action="store_true",
                   help="synchronize after every timed step and report "
                        "steps/s with a 95%% CI")
    p.add_argument("--space-to-depth", action="store_true",
                   help="the resnets' space-to-depth stem (the 7x7 stem's "
                        "kernel re-tiled; models/resnet.py)")
    p.add_argument("--bucket-mb", type=float, default=None,
                   help="fusion bucket cap in MB (0: one bucket per dtype); "
                        "unset: HOROVOD_FUSION_THRESHOLD, else one bucket")
    p.add_argument("--compression", default=None,
                   choices=["none", "fp16", "bf16", "ef16"],
                   help="on-wire gradient compression; unset: "
                        "HOROVOD_COMPRESSION, else none")
    p.add_argument("--device", default=None,
                   help="default cuda:<local rank>; 'cpu' to run on the CPU")
    return p.parse_args(argv)


class BenchRun(NamedTuple):
    result: dict        # the JSON line
    losses: list        # every step's world-averaged loss, warm-up included
    allreduce_count: int  # bucket all-reduces the optimizer launched
    step: Callable[[], torch.Tensor]  # one more step on the same batch


def build_model(args, device, dtype=torch.bfloat16, seed: int = 0):
    """The registry's model for ``args`` on ``device``."""
    spec = MODELS[args.model]
    ctor = getattr(importlib.import_module(spec["module"]), spec["cls"])
    kwargs = dict(num_classes=1000, dtype=dtype, device=device, seed=seed)
    if spec["s2d"]:
        kwargs["space_to_depth_stem"] = args.space_to_depth
    if args.model.startswith("vgg"):
        kwargs["image_size"] = args.image_size
    return ctor(**kwargs)


def _config_source(flag_set: bool, env: str, resolved) -> str:
    if flag_set:
        return "flag"
    if resolved is None:
        return "unset"
    return "env" if os.environ.get(env) is not None else "config"


def run(args) -> BenchRun:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.compression import resolve_compression
    from horovod_tpu_torch.common.fusion import (describe_plan,
                                                 leaf_wire_nbytes,
                                                 plan_buckets_for,
                                                 resolve_bucket_cap)
    from horovod_tpu_torch.training import (init_train_state,
                                            make_train_step, shard_batch)

    if args.image_size is None:
        args.image_size = MODELS[args.model]["size"]
    args.num_iters = max(1, args.num_iters)
    hvd.init(device=args.device)
    device = hvd.device()
    size, rank = hvd.size(), hvd.rank()
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    print(f"image_bench: {args.model} on {device} ({kind}), {size} rank(s), "
          f"batch {args.batch_size}/rank at {args.image_size} px",
          file=sys.stderr)

    model = build_model(args, device)
    comp = resolve_compression(args.compression or "auto")
    bucket_cap = (int(args.bucket_mb * 1024 * 1024) or None
                  if args.bucket_mb is not None
                  else resolve_bucket_cap("auto"))
    optimizer = init_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=comp, bucket_cap_bytes=bucket_cap)
    step = make_train_step(model, optimizer)
    params = list(model.parameters())
    fusion = {"bucket_cap_bytes": bucket_cap,
              "source": _config_source(args.bucket_mb is not None,
                                       "HOROVOD_FUSION_THRESHOLD",
                                       bucket_cap),
              **describe_plan(plan_buckets_for(params, bucket_cap, comp))}
    compression = {
        "mode": comp.name if comp is not None else "none",
        "source": _config_source(args.compression is not None,
                                 "HOROVOD_COMPRESSION", comp),
        # Gradient bytes one rank puts into the all-reduces per step.
        "wire_bytes_per_step": sum(leaf_wire_nbytes(p, comp)
                                   for p in params)}

    global_batch = args.batch_size * size
    images = np.random.RandomState(0).rand(
        global_batch, args.image_size, args.image_size, 3).astype(np.float32)
    labels = np.random.RandomState(1).randint(
        0, 1000, size=(global_batch,)).astype(np.int64)
    images, labels = shard_batch((images, labels), rank, size, device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = [step(images, labels) for _ in range(max(1, args.num_warmup))]
    _sync(device)
    step_times = []
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        t1 = time.perf_counter()
        losses.append(step(images, labels))
        if args.fence_each:
            _sync(device)
            step_times.append(time.perf_counter() - t1)
    _sync(device)
    last = float(losses[-1])
    dt = time.perf_counter() - t0
    losses = [float(x) for x in losses[:-1]] + [last]
    peak_mem = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)

    spec = MODELS[args.model]
    per_chip = global_batch * args.num_iters / dt / size
    result = {
        "metric": f"{args.model}_images_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "images/sec/chip",
        # The reference publishes one per-device throughput (ResNet-101);
        # a ratio against it means something for the resnets only.
        "vs_baseline": (round(per_chip / BASELINE_IMG_PER_SEC_PER_DEVICE, 3)
                        if args.model.startswith("resnet") else None),
        "fusion": fusion,
        "compression": compression,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": kind,
        "workload": {"model": args.model, "batch_size": args.batch_size,
                     "image_size": args.image_size,
                     "space_to_depth": bool(args.space_to_depth
                                            and spec["s2d"]),
                     "fence_each": bool(args.fence_each),
                     "num_iters": args.num_iters},
        "step_ms": round(1e3 * dt / args.num_iters, 2),
        "loss": round(last, 4),  # world average
        "peak_mem_bytes": peak_mem,
    }
    peak = peak_flops(device)
    if peak:
        train_flops = (3 * spec["fwd_flops"]
                       * (args.image_size / spec["size"]) ** 2)
        result["mfu"] = round(per_chip * train_flops / peak, 4)
    if step_times:
        # Per-step rates and a 95% CI (mean +- 1.96 std / sqrt(n)).
        rates = [1.0 / t for t in step_times]
        mean = sum(rates) / len(rates)
        var = sum((r - mean) ** 2 for r in rates) / len(rates)
        result["steps_per_sec"] = round(mean, 4)
        result["steps_per_sec_ci95"] = round(
            1.96 * var ** 0.5 / len(rates) ** 0.5, 4)
    return BenchRun(result, losses, optimizer.allreduce_count,
                    lambda: step(images, labels))


def main(argv=None):
    import horovod_tpu_torch as hvd

    try:
        print(json.dumps(run(parse_args(argv)).result))
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
