"""The torch estimator on MNIST-shaped data (the port's copy of
``examples/pytorch_spark_mnist.py``): trains through
``horovod_tpu_torch.spark.TorchEstimator`` over Parquet data in a Store,
on ``cuda:0``, or on the CPU with ``--no-cuda``.

    python -m horovod_tpu_torch.examples.pytorch_spark_mnist --epochs 2
"""

import argparse
import tempfile

import numpy as np
import torch
import torch.nn as nn

from horovod_tpu_torch.spark import LocalStore, TorchEstimator


def make_dataframe(n=4096):
    # pandas loads cloudpickle, so it is imported where it is used.
    import pandas as pd

    rng = np.random.RandomState(0)
    images = rng.rand(n, 784).astype(np.float32)
    labels = rng.randint(0, 10, n).astype(np.int64)
    return pd.DataFrame({"features": list(images), "label": labels})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--no-cuda", action="store_true",
                        help="train and predict on the CPU")
    args = parser.parse_args(argv)

    model = nn.Sequential(
        nn.Linear(784, 128), nn.ReLU(), nn.Dropout(0.2), nn.Linear(128, 10))

    def ce_loss(output, target):
        return nn.functional.cross_entropy(output, target.long())

    est = TorchEstimator(
        model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=0.001),
        loss=ce_loss,
        feature_cols=["features"], label_cols=["label"],
        batch_size=args.batch_size, epochs=args.epochs,
        store=LocalStore(args.work_dir or tempfile.mkdtemp()),
        device="cpu" if args.no_cuda else None)
    trained = est.fit(make_dataframe())
    print("history:", [round(v, 4) for v in trained.history["loss"]])
    preds = trained.transform(make_dataframe(64))
    print("prediction sample:", preds["label__output"].iloc[0][:3], "...")


if __name__ == "__main__":
    main()
