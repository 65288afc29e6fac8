"""Synthetic ResNet-50 throughput benchmark, PyTorch binding.

Protocol mirrors the reference's ``examples/pytorch_synthetic_benchmark.py``:
synthetic ImageNet-shaped data, ``--num-warmup-batches`` warmup, timed
iterations of ``--num-batches-per-iter`` batches, printing per-device
img/sec mean with a 95% confidence interval, then the world-aggregate
number on rank 0.

torchvision is not required: a self-contained bottleneck ResNet-50 is
defined below. This is the port's copy of
``examples/pytorch_synthetic_benchmark.py`` on ``horovod_tpu_torch.torch``,
with upstream Horovod's CUDA placement: each rank on
``cuda:<local rank>``, or on the CPU with ``--no-cuda``. Run under the
launcher for multi-process:

    python -m horovod_tpu.run -np 4 python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark
"""

import argparse
import timeit

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        identity = x if self.down is None else self.down(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


def resnet50(num_classes=1000):
    layers = [3, 4, 6, 3]
    blocks = []
    cin, width = 64, 64
    stem = nn.Sequential(
        nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
        nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1))
    for i, n in enumerate(layers):
        stride = 1 if i == 0 else 2
        for j in range(n):
            blocks.append(Bottleneck(cin, width, stride if j == 0 else 1))
            cin = width * Bottleneck.expansion
        width *= 2
    return nn.Sequential(
        stem, *blocks, nn.AdaptiveAvgPool2d(1), nn.Flatten(),
        nn.Linear(cin, num_classes))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-warmup-batches", type=int, default=2)
    parser.add_argument("--num-batches-per-iter", type=int, default=5)
    parser.add_argument("--num-iters", type=int, default=5)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--use-adasum", action="store_true",
                        help="use Adasum gradient combination")
    parser.add_argument("--no-cuda", action="store_true",
                        help="run on the CPU")
    args = parser.parse_args(argv)
    args.cuda = not args.no_cuda

    hvd.init(device=None if args.cuda else "cpu")
    if args.cuda:
        torch.cuda.set_device(hvd.local_rank())
    torch.manual_seed(42 + hvd.rank())

    model = resnet50(args.num_classes)
    if args.cuda:
        model.cuda()
    lr_scaler = 1 if args.use_adasum else hvd.size()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * lr_scaler)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        op=hvd.Adasum if args.use_adasum else hvd.Average)

    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size)
    target = torch.randint(0, args.num_classes, (args.batch_size,))
    if args.cuda:
        data, target = data.cuda(), target.cuda()

    def benchmark_step():
        optimizer.zero_grad()
        output = model(data)
        loss = F.cross_entropy(output, target)
        loss.backward()
        optimizer.step()

    if hvd.rank() == 0:
        print(f"Model: resnet50, batch size: {args.batch_size}, "
              f"ranks: {hvd.size()}")
    for _ in range(args.num_warmup_batches):
        benchmark_step()

    img_secs = []
    for i in range(args.num_iters):
        elapsed = timeit.timeit(benchmark_step,
                                number=args.num_batches_per_iter)
        img_sec = args.batch_size * args.num_batches_per_iter / elapsed
        if hvd.rank() == 0:
            print(f"Iter #{i}: {img_sec:.1f} img/sec per device")
        img_secs.append(img_sec)

    img_sec_mean = np.mean(img_secs)
    img_sec_conf = 1.96 * np.std(img_secs)
    if hvd.rank() == 0:
        print(f"Img/sec per device: {img_sec_mean:.1f} +-{img_sec_conf:.1f}")
        print(f"Total img/sec on {hvd.size()} device(s): "
              f"{hvd.size() * img_sec_mean:.1f} "
              f"+-{hvd.size() * img_sec_conf:.1f}")
    hvd.shutdown()
    return img_secs


if __name__ == "__main__":
    main()
