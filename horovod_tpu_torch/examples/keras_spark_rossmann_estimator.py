"""Rossmann store sales through the Keras estimator (the port's copy of
``examples/keras_spark_rossmann_estimator.py``: tabular feature
engineering -> categorical-embedding Keras model -> ``KerasEstimator``
over Store-materialized Parquet -> RMSPE on a validation split).

Upstream Horovod's script expects the Kaggle Rossmann CSVs; this one
generates a synthetic store-sales table with the same structure (store
id, day-of-week, promo, distance, seasonality) when ``--data-dir`` has
no ``train.csv``, so the full estimator pipeline — engineering, Parquet
materialization through the Store, the streaming shard reader, the
distributed fit, and transform — runs anywhere.

    python -m horovod_tpu_torch.examples.keras_spark_rossmann_estimator \\
        --epochs 4
"""

import argparse
import os
import tempfile

import numpy as np
import pandas as pd

CATEGORICALS = {
    # column -> cardinality (embedding input size)
    "store": 200,
    "day_of_week": 7,
    "promo": 2,
    "state_holiday": 4,
    "month": 12,
}
CONTINUOUS = ["competition_distance", "days_since_promo"]


def load_or_synthesize(data_dir, n=20000):
    """The Kaggle CSVs when present; a structurally-identical synthetic
    table otherwise (sales depend on store quality, weekday, promo and
    distance, so the model has real signal to learn)."""
    path = os.path.join(data_dir or "", "train.csv")
    if data_dir and os.path.exists(path):
        return pd.read_csv(path)
    rng = np.random.RandomState(0)
    store = rng.randint(0, CATEGORICALS["store"], n)
    dow = rng.randint(0, 7, n)
    promo = rng.randint(0, 2, n)
    holiday = rng.choice(4, n, p=[0.9, 0.05, 0.03, 0.02])
    month = rng.randint(0, 12, n)
    distance = rng.lognormal(7.0, 1.0, n).astype(np.float32)
    days_since = rng.randint(0, 60, n).astype(np.float32)
    store_quality = rng.rand(CATEGORICALS["store"])[store]
    sales = (3000 * store_quality
             + 800 * promo
             + 400 * np.sin(2 * np.pi * month / 12)
             - 300 * (dow >= 5)
             - 0.02 * distance
             + rng.normal(0, 150, n))
    sales = np.maximum(sales, 100).astype(np.float32)
    return pd.DataFrame({
        "store": store, "day_of_week": dow, "promo": promo,
        "state_holiday": holiday, "month": month,
        "competition_distance": distance, "days_since_promo": days_since,
        "sales": sales,
    })


def engineer(df):
    """Upstream Horovod's engineering condensed: log target (RMSPE trains
    better in log space), normalized continuous features, and categorical
    ids offset into disjoint ranges so ONE shared embedding table serves
    every categorical — that keeps the model Lambda-free (Lambda layers
    don't survive the estimator's model serialization) while preserving
    per-category embeddings."""
    out = pd.DataFrame()
    cats = []
    offset = 0
    for col, card in CATEGORICALS.items():
        cats.append(df[col].to_numpy().astype(np.int64) + offset)
        offset += card
    conts = []
    for col in CONTINUOUS:
        v = df[col].to_numpy().astype(np.float32)
        conts.append((v - v.mean()) / (v.std() + 1e-6))
    out["cat_features"] = list(
        np.stack(cats, axis=1).astype(np.float32))
    out["cont_features"] = list(
        np.stack(conts, axis=1).astype(np.float32))
    out["log_sales"] = np.log(df["sales"].to_numpy().astype(np.float32))
    return out


def build_model():
    import keras

    n_cat = len(CATEGORICALS)
    total_cards = sum(CATEGORICALS.values())
    cat_in = keras.Input(shape=(n_cat,), name="cat_features")
    cont_in = keras.Input(shape=(len(CONTINUOUS),), name="cont_features")
    emb = keras.layers.Embedding(total_cards, 16)(cat_in)
    x = keras.layers.Concatenate()(
        [keras.layers.Flatten()(emb), cont_in])
    x = keras.layers.Dense(256, activation="relu")(x)
    x = keras.layers.Dense(128, activation="relu")(x)
    out = keras.layers.Dense(1)(x)
    return keras.Model([cat_in, cont_in], out)


def rmspe(y_true_log, y_pred_log):
    y_true = np.exp(y_true_log)
    y_pred = np.exp(y_pred_log)
    return float(np.sqrt(np.mean(((y_true - y_pred) / y_true) ** 2)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=None,
                        help="directory with the Kaggle train.csv "
                             "(synthetic data otherwise)")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--num-proc", type=int, default=2)
    args = parser.parse_args()

    import keras

    from horovod_tpu_torch.spark import KerasEstimator, LocalStore

    df = engineer(load_or_synthesize(args.data_dir))
    work = args.work_dir or tempfile.mkdtemp(prefix="rossmann_")
    store = LocalStore(work)

    est = KerasEstimator(
        model=build_model(),
        optimizer=keras.optimizers.Adam(1e-3),
        loss="mae",
        feature_cols=["cat_features", "cont_features"],
        label_cols=["log_sales"],
        batch_size=args.batch_size,
        epochs=args.epochs,
        validation=0.2,
        store=store,
        num_proc=args.num_proc,
        verbose=0,
    )
    model = est.fit(df)

    pred = model.transform(df.head(2048))
    score = rmspe(np.array([y for y in df.head(2048)["log_sales"]]),
                  pred["log_sales__output"].to_numpy().reshape(-1))
    print(f"validation RMSPE (lower is better): {score:.4f}")
    print(f"store dir: {work}")


if __name__ == "__main__":
    main()
