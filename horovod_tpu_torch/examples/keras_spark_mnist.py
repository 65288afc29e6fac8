"""The Keras estimator on MNIST-shaped data (the port's copy of
``examples/keras_spark_mnist.py``): trains through
``horovod_tpu_torch.spark.KerasEstimator`` over Parquet data in a Store.

Runs with a local pandas DataFrame out of the box; when pyspark is
installed, pass ``--spark`` to go through a real SparkSession DataFrame.

    python -m horovod_tpu_torch.examples.keras_spark_mnist --epochs 2
"""

import argparse
import tempfile

import numpy as np
import pandas as pd
import keras

from horovod_tpu_torch.spark import KerasEstimator, LocalStore


def make_dataframe(n=4096):
    rng = np.random.RandomState(0)
    images = rng.rand(n, 784).astype(np.float32)
    labels = rng.randint(0, 10, n).astype(np.int64)
    return pd.DataFrame({"features": list(images), "label": labels})


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--spark", action="store_true",
                        help="route the DataFrame through pyspark")
    args = parser.parse_args()

    df = make_dataframe()
    if args.spark:
        from pyspark.sql import SparkSession

        spark = SparkSession.builder.master("local[2]") \
            .appName("keras_spark_mnist").getOrCreate()
        df = spark.createDataFrame(df)

    model = keras.Sequential([
        keras.layers.Input((784,)),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dropout(0.2),
        keras.layers.Dense(10, activation="softmax"),
    ])
    store = LocalStore(args.work_dir or tempfile.mkdtemp())
    est = KerasEstimator(
        model=model,
        optimizer=keras.optimizers.Adam(0.001),
        loss="sparse_categorical_crossentropy",
        metrics=["accuracy"],
        feature_cols=["features"], label_cols=["label"],
        batch_size=args.batch_size, epochs=args.epochs,
        validation=0.1, store=store)
    trained = est.fit(df)
    print("history:", {k: [round(v, 4) for v in vs]
                       for k, vs in trained.history.items()})
    preds = trained.transform(make_dataframe(64))
    print("predictions column:", preds["label__output"].iloc[0][:3], "...")


if __name__ == "__main__":
    main()
