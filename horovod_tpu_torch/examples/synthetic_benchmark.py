"""Synthetic ResNet-50 throughput benchmark on the port's bucketed step.

The port of ``examples/jax_synthetic_benchmark.py``: ResNet-50 in bf16,
a per-device batch of ``--batch-size`` images at ``--image-size`` px
(synthetic ImageNet-shaped data: images by ``RandomState(0)``, labels by
``RandomState(1)``, each rank taking its rows), ``SGD(0.01 * n,
momentum=0.9)``, one step through ``training.make_train_step`` (gradients
in fused bucket all-reduces) or, with ``--zero``, ZeRO-1 through
``zero.py`` (reduce-scatter of the gradients, the update on this rank's
fp32 master shard, all-gather of the parameters). Warm-up steps, then
timed iterations, each ending in a read of the loss; rank 0 prints each
iteration's and the mean images/s per device. One process per GPU:

    python -m horovod_tpu_torch.run -np 4 \\
        python -m horovod_tpu_torch.examples.synthetic_benchmark
    python -m horovod_tpu_torch.examples.synthetic_benchmark --device cpu \\
        --batch-size 2 --image-size 32 --num-warmup 1 --num-iters 2
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-device batch size")
    parser.add_argument("--num-warmup", type=int, default=3)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1 optimizer sharding (horovod_tpu_torch."
                             "zero): reduce-scatter grads, per-shard update "
                             "on fp32 masters, all-gather params")
    parser.add_argument("--device", default=None,
                        help="default cuda:<local rank>; 'cpu' to run on "
                             "the CPU")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import zero
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.training import (init_train_state,
                                            make_train_step, shard_batch)

    hvd.init(device=args.device)
    try:
        n, device = hvd.size(), hvd.device()
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         device=device, seed=0)
        sgd = functools.partial(torch.optim.SGD, lr=0.01 * n, momentum=0.9)
        if args.zero:
            state = zero.init_zero_train_state(model, sgd, zero_stage=1)
            zero_step = zero.make_zero_train_step()

            def step(images, labels):
                nonlocal state
                state, loss = zero_step(state, images, labels)
                return loss
        else:
            step = make_train_step(
                model, init_train_state(model, sgd(model.parameters())))

        global_batch = args.batch_size * n
        images = np.random.RandomState(0).rand(
            global_batch, args.image_size, args.image_size,
            3).astype(np.float32)
        labels = np.random.RandomState(1).randint(
            0, 1000, (global_batch,)).astype(np.int64)
        images, labels = shard_batch((images, labels), hvd.rank(), n,
                                     device)

        for _ in range(args.num_warmup):
            loss = step(images, labels)
        float(loss)  # force completion

        img_secs = []
        for i in range(args.num_iters):
            t0 = time.perf_counter()
            loss = step(images, labels)
            float(loss)
            dt = time.perf_counter() - t0
            img_secs.append(global_batch / dt)
            if hvd.rank() == 0:
                print(f"Iter #{i}: {img_secs[-1] / n:.1f} img/sec per device",
                      flush=True)

        mean, conf = np.mean(img_secs) / n, 1.96 * np.std(img_secs) / n
        if hvd.rank() == 0:
            print(f"Img/sec per device: {mean:.1f} +-{conf:.1f}")
            print(f"Total img/sec on {n} device(s): {mean * n:.1f}",
                  flush=True)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
