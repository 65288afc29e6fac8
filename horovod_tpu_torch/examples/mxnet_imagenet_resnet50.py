"""ImageNet ResNet-50 on the port's MXNet binding (the port's copy of
``examples/mxnet_imagenet_resnet50.py``: gluon ResNet-50, the parameters
broadcast, DistributedTrainer with the LR scaled by the world's size and
warmed up, checkpoints and validation on rank 0).

It runs where mxnet is installed, and otherwise exits 1 saying so.
Without ``--use-rec`` it trains on synthetic ImageNet-shaped data.

    python -m horovod_tpu_torch.run -np 8 \\
        python -m horovod_tpu_torch.examples.mxnet_imagenet_resnet50 \\
        --use-rec --rec-train train.rec --rec-val val.rec
"""

import argparse
import time

import numpy as np


def parse_args():
    p = argparse.ArgumentParser(
        description="MXNet ImageNet ResNet-50",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--use-rec", action="store_true",
                   help="read ImageRecordIter .rec files (synthetic data "
                        "otherwise)")
    p.add_argument("--rec-train", type=str, default="")
    p.add_argument("--rec-train-idx", type=str, default="")
    p.add_argument("--rec-val", type=str, default="")
    p.add_argument("--rec-val-idx", type=str, default="")
    p.add_argument("--batch-size", type=int, default=128,
                   help="per-worker batch size")
    p.add_argument("--num-epochs", type=int, default=90)
    p.add_argument("--lr", type=float, default=0.05,
                   help="single-worker learning rate (scaled by world "
                        "size)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--warmup-epochs", type=int, default=10)
    p.add_argument("--synthetic-batches", type=int, default=64,
                   help="batches/epoch without --use-rec")
    p.add_argument("--save-frequency", type=int, default=10,
                   help="rank-0 checkpoint every N epochs (0 = off)")
    return p.parse_args()


def make_data(args, rank, size, batch):
    if args.use_rec:
        import mxnet as mx

        # Each worker reads its 1/size shard of the record file — the
        # upstream example partitions with num_parts/part_index the same way.
        train = mx.io.ImageRecordIter(
            path_imgrec=args.rec_train, path_imgidx=args.rec_train_idx,
            data_shape=(3, 224, 224), batch_size=batch, shuffle=True,
            num_parts=size, part_index=rank, rand_mirror=True)
        val = mx.io.ImageRecordIter(
            path_imgrec=args.rec_val, path_imgidx=args.rec_val_idx,
            data_shape=(3, 224, 224), batch_size=batch,
            num_parts=size, part_index=rank) if args.rec_val else None
        return train, val

    import mxnet as mx

    rng = np.random.RandomState(rank)

    class SyntheticIter:
        def __iter__(self):
            for _ in range(args.synthetic_batches):
                yield (mx.nd.array(rng.rand(batch, 3, 224, 224)),
                       mx.nd.array(rng.randint(0, 1000, batch)))

        def reset(self):
            pass

    return SyntheticIter(), None


def main():
    args = parse_args()
    try:
        import mxnet as mx
        from mxnet import autograd, gluon
    except ImportError:
        raise SystemExit(
            "mxnet is not installed on this machine; see the port's "
            "pytorch_imagenet_resnet50.py or keras_imagenet_resnet50.py "
            "examples for runnable ImageNet flavors.")

    import horovod_tpu_torch.mxnet as hvd

    hvd.init()
    rank, size = hvd.rank(), hvd.size()

    net = gluon.model_zoo.vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1, 3, 224, 224)))  # materialize params

    params = {k: v for k, v in net.collect_params().items()}
    hvd.broadcast_parameters(params, root_rank=0)

    train_data, val_data = make_data(args, rank, size, args.batch_size)
    batches_per_epoch = (args.synthetic_batches if not args.use_rec
                         else max(1, 1281167 // (args.batch_size * size)))

    # Linear warmup to the size-scaled LR, then step decay — the
    # upstream example's warmup and schedule.
    base_lr = args.lr * size
    warmup_steps = max(1, args.warmup_epochs * batches_per_epoch)

    trainer = hvd.DistributedTrainer(
        params, "sgd",
        optimizer_params={"learning_rate": base_lr,
                          "momentum": args.momentum, "wd": args.wd})

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    step = 0
    for epoch in range(args.num_epochs):
        tic = time.time()
        train_data.reset()
        epoch_loss = 0.0
        nb = 0
        for data, label in _iter_batches(train_data):
            step += 1
            lr = base_lr * min(1.0, step / warmup_steps)
            if epoch >= 60:
                lr *= 0.01
            elif epoch >= 40:
                lr *= 0.1
            trainer.set_learning_rate(lr)
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            epoch_loss += float(loss.mean().asscalar())
            nb += 1
        # Average the epoch metric across workers (MetricAverage role).
        avg = float(np.asarray(hvd.allreduce(
            mx.nd.array([epoch_loss / max(1, nb)]), average=True,
            name="epoch_loss").asnumpy())[0])
        if rank == 0:
            print(f"epoch {epoch}: loss {avg:.4f} "
                  f"({time.time() - tic:.1f}s)")
            if args.save_frequency and \
                    (epoch + 1) % args.save_frequency == 0:
                net.save_parameters(f"resnet50-{epoch + 1:04d}.params")
        if val_data is not None:
            _validate(net, val_data, hvd, rank)


def _iter_batches(it):
    import mxnet as mx

    if hasattr(it, "__iter__") and not hasattr(it, "next"):
        yield from it
        return
    for batch in it:  # mx.io.DataIter protocol
        yield batch.data[0], batch.label[0]


def _validate(net, val_data, hvd, rank):
    import mxnet as mx

    correct = total = 0
    val_data.reset()
    for data, label in _iter_batches(val_data):
        pred = net(data).argmax(axis=1)
        correct += int((pred == label.astype(pred.dtype)).sum().asscalar())
        total += data.shape[0]
    agg = hvd.allreduce(mx.nd.array([correct, total], dtype="float32"),
                        average=False, name="val_acc")
    agg = agg.asnumpy()
    if rank == 0 and agg[1] > 0:
        print(f"  val acc {agg[0] / agg[1]:.4f}")


if __name__ == "__main__":
    main()
