"""MNIST on the port's MXNet binding (the port's copy of
``examples/mxnet_mnist.py``: gluon parameters, their broadcast,
DistributedTrainer with the LR scaled by the world's size, the accuracy
averaged over the ranks).

It runs where mxnet is installed (or under ``tests/fake_mxnet.py``), and
otherwise exits 1 saying so:

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.mxnet_mnist --epochs 1
"""

import argparse

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.01)
    args = parser.parse_args()

    try:
        import mxnet as mx
    except ImportError:
        raise SystemExit(
            "mxnet is not installed; see the port's pytorch_mnist.py or "
            "tensorflow2_mnist.py examples for runnable MNIST flavors.")

    import horovod_tpu_torch.mxnet as hvd

    hvd.init()
    rng = np.random.RandomState(hvd.rank())
    n = 4096 // hvd.size()
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n)

    # A linear classifier keeps the example free of gluon model zoo
    # dependencies; the collective pattern is identical for any net.
    w = mx.gluon.Parameter("w", np.zeros((784, 10), np.float32))
    b = mx.gluon.Parameter("b", np.zeros((10,), np.float32))
    params = {"w": w, "b": b}
    hvd.broadcast_parameters(params, root_rank=0)

    trainer = hvd.DistributedTrainer(
        params, "sgd", optimizer_params={"learning_rate":
                                         args.lr * hvd.size()})

    for epoch in range(args.epochs):
        for start in range(0, n, args.batch_size):
            xb = x[start:start + args.batch_size].reshape(-1, 784)
            yb = y[start:start + args.batch_size]
            logits = xb @ w.data().asnumpy() + b.data().asnumpy()
            probs = np.exp(logits - logits.max(1, keepdims=True))
            probs /= probs.sum(1, keepdims=True)
            probs[np.arange(len(yb)), yb] -= 1.0
            gw = xb.T @ probs / len(yb)
            gb = probs.mean(0)
            w.list_grad()[0][:] = mx.nd.array(gw)
            b.list_grad()[0][:] = mx.nd.array(gb)
            trainer.step(batch_size=1)
        acc = hvd.allreduce(
            mx.nd.array([float(((x.reshape(-1, 784) @ w.data().asnumpy()
                                 + b.data().asnumpy()).argmax(1) == y)
                               .mean())]), average=True, name="acc")
        if hvd.rank() == 0:
            print(f"epoch {epoch}: accuracy={float(acc.asnumpy()[0]):.3f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
