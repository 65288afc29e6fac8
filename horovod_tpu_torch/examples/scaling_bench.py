"""Allreduce scaling-efficiency harness on the port (the BASELINE.md
north-star protocol: >= 90 % efficiency scaling ResNet over devices).

The port of ``examples/scaling_bench.py``. It trains the data-parallel
step (``training.make_train_step``: fused bucket all-reduces) in worlds
of growing size (1, 2, 4, ... up to the GPUs attached, or ``--devices``)
with a FIXED per-device batch, and reports

    efficiency(d) = img/s-per-device(d) / img/s-per-device(1)

which isolates the cost the all-reduce adds as the world grows. Where
the JAX harness shrinks one process's mesh, the port's world is
processes: each size is a world of its own, ``d`` ranks started by the
launcher's ``run()`` API (one process per GPU; the launcher takes a free
port pair from ``common/config.free_port_pair``). A rank times its own
steps; a world's per-device rate is taken at its slowest rank. Prints one
JSON line last.

NOTE: only meaningful where each device is its own silicon. With
``--cpu-devices N`` the worlds are gloo processes of up to N ranks that
timeshare one host's cores, so per-device throughput falls by
construction; there the harness only validates that the protocol runs.

    python -m horovod_tpu_torch.examples.scaling_bench --model resnet50 \\
        --batch-size 32 --image-size 224
    python -m horovod_tpu_torch.examples.scaling_bench --cpu-devices 2 \\
        --devices 1 2 --batch-size 2 --image-size 32
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", type=int, nargs="*", default=None,
                        help="world sizes to measure (default: powers of 2 "
                             "up to the attached device count)")
    parser.add_argument("--model", choices=["resnet18", "resnet50"],
                        default="resnet18")
    parser.add_argument("--batch-size", type=int, default=4,
                        help="per-device batch (held constant across sizes)")
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--num-classes", type=int, default=100)
    parser.add_argument("--num-warmup", type=int, default=2)
    parser.add_argument("--num-iters", type=int, default=8)
    parser.add_argument("--cpu-devices", type=int, default=None,
                        help="run gloo worlds of up to N processes on the "
                             "CPU (protocol validation without hardware)")
    return parser.parse_args(argv)


def world_rank(model_name, batch_size, image_size, num_classes, num_warmup,
               num_iters, device):
    """One rank of one world: the seconds its timed steps took."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet18, ResNet50
    from horovod_tpu_torch.training import (init_train_state,
                                            make_train_step, shard_batch)

    hvd.init(device=device)
    try:
        d, dev = hvd.size(), hvd.device()
        if dev.type == "cuda":
            torch.backends.cudnn.benchmark = True
        ctor = ResNet18 if model_name == "resnet18" else ResNet50
        model = ctor(num_classes=num_classes, dtype=torch.bfloat16,
                     device=dev, seed=0)
        step = make_train_step(model, init_train_state(
            model, torch.optim.SGD(model.parameters(), lr=0.01,
                                   momentum=0.9)))
        gb = batch_size * d
        images = np.random.RandomState(0).rand(
            gb, image_size, image_size, 3).astype(np.float32)
        labels = np.random.RandomState(1).randint(
            0, num_classes, (gb,)).astype(np.int64)
        images, labels = shard_batch((images, labels), hvd.rank(), d, dev)
        for _ in range(num_warmup):
            loss = step(images, labels)
        float(loss)  # completion fence
        t0 = time.perf_counter()
        for _ in range(num_iters):
            loss = step(images, labels)
        float(loss)
        dt = time.perf_counter() - t0
        return {"rank": hvd.rank(), "seconds": dt,
                "platform": "gpu" if dev.type == "cuda" else dev.type}
    finally:
        hvd.shutdown()


def main(argv=None):
    args = parse_args(argv)

    import torch

    from horovod_tpu_torch.run import run

    if args.cpu_devices:
        attached, device = args.cpu_devices, "cpu"
    else:
        attached, device = torch.cuda.device_count(), None
    sizes = args.devices
    if not sizes:
        sizes, d = [], 1
        while d <= attached:
            sizes.append(d)
            d *= 2
    sizes = [d for d in sizes if d <= attached]
    if not sizes:
        raise SystemExit(
            f"no requested world size fits the {attached} attached "
            f"device(s); pass smaller --devices (or --cpu-devices N)")
    args.num_warmup = max(1, args.num_warmup)  # the fence reads warmup loss

    results, platform = [], None
    for d in sizes:
        ranks = run(world_rank, args=(
            args.model, args.batch_size, args.image_size, args.num_classes,
            args.num_warmup, args.num_iters, device), np=d,
            hosts=f"localhost:{d}")
        platform = ranks[0]["platform"]
        dt = max(r["seconds"] for r in ranks)
        per_dev = args.batch_size * d * args.num_iters / dt / d
        results.append((d, per_dev))
        print(f"devices={d:3d}  img/s/device={per_dev:9.2f}  "
              f"efficiency vs {results[0][0]}-device: "
              f"{per_dev / results[0][1] * 100:6.1f}%", flush=True)

    base = results[0][1]
    if platform == "cpu":
        print("NOTE: virtual CPU devices timeshare one host — this "
              "efficiency reflects core contention, not allreduce cost; "
              "run on real chips for the meaningful number.")
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": round(results[-1][1] / base, 4),
        "unit": f"fraction at {results[-1][0]} devices vs {results[0][0]}",
        "per_device_img_per_sec": {str(d): round(v, 2) for d, v in results},
        "platform": platform,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
