"""Data-preparation helpers for the Spark Estimators (parity:
``horovod/spark/common/util.py`` — ``prepare_data``/``get_simple_meta_from_parquet``).

The port's copy of ``horovod_tpu/spark/common/util.py``. A Spark
DataFrame (when pyspark is importable) or a pandas DataFrame is written
to Parquet in the Store through pyarrow, with the per-column metadata
(shape, dtype, row counts) that the remote training functions need, so
the whole estimator path runs without a cluster.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .store import Store


def _to_pandas(df):
    """Accept a pandas DataFrame directly or convert a Spark DataFrame."""
    import pandas as pd

    if isinstance(df, pd.DataFrame):
        return df
    # Spark DataFrame (duck-typed so pyspark stays optional).
    if hasattr(df, "toPandas"):
        return df.toPandas()
    raise TypeError(
        f"expected a pandas or Spark DataFrame, got {type(df)}")


def _col_shape(series) -> Tuple[int, ...]:
    """Per-row shape of a column: scalars → (), list/array cells → cell shape."""
    first = series.iloc[0]
    if isinstance(first, (list, tuple)):
        return (len(first),)
    if isinstance(first, np.ndarray):
        return tuple(first.shape)
    return ()


def make_metadata(pdf, feature_cols: Sequence[str],
                  label_cols: Sequence[str]) -> Dict:
    """Column metadata in the spirit of the reference's ``_get_metadata``."""
    meta = {"columns": {}, "feature_cols": list(feature_cols),
            "label_cols": list(label_cols), "rows": len(pdf)}
    avg_row_bytes = 0
    for col in list(feature_cols) + list(label_cols):
        if col not in pdf.columns:
            raise ValueError(f"column '{col}' not in DataFrame "
                             f"(have {list(pdf.columns)})")
        shape = _col_shape(pdf[col])
        arr = np.asarray(pdf[col].iloc[0])
        meta["columns"][col] = {
            "shape": list(shape),
            "dtype": str(arr.dtype),
            "size": int(np.prod(shape)) if shape else 1,
        }
        avg_row_bytes += (int(np.prod(shape)) if shape else 1) * arr.itemsize
    meta["avg_row_size"] = avg_row_bytes
    return meta


def write_parquet(pdf, path: str, num_partitions: int = 1) -> int:
    """Materialize a pandas DataFrame as a Parquet dataset directory with
    ``num_partitions`` files (the sharding unit for distributed readers)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    n = len(pdf)
    per = math.ceil(n / max(1, num_partitions)) or 1
    written = 0
    for i in range(max(1, num_partitions)):
        chunk = pdf.iloc[i * per:(i + 1) * per]
        if chunk.empty and i > 0:
            break
        table = pa.Table.from_pandas(chunk.reset_index(drop=True),
                                     preserve_index=False)
        # ~8 row groups per partition gives the round-robin shard reader
        # granularity (a world larger than the partition count still gets
        # data on every rank) without fragmenting large datasets into tiny
        # groups.
        row_group_size = max(1, math.ceil(len(chunk) / 8))
        pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"),
                       row_group_size=row_group_size)
        written += len(chunk)
    return written


def prepare_data(store: Store, df, feature_cols: Sequence[str],
                 label_cols: Sequence[str],
                 validation=None, num_partitions: int = 1,
                 dataset_idx=None) -> Dict:
    """Split ``df`` into train/val, write both to the store's intermediate
    Parquet paths, and return the metadata dict (parity:
    ``common/util.py`` ``prepare_data``).

    ``validation`` may be a float fraction (tail split, as the reference's
    random split plays that role), a column name of 0/1 flags, or a second
    DataFrame.
    """
    pdf = _to_pandas(df)
    val_pdf = None
    if validation is None:
        train_pdf = pdf
    elif isinstance(validation, float):
        n_val = int(len(pdf) * validation)
        train_pdf, val_pdf = pdf.iloc[:-n_val or None], (
            pdf.iloc[-n_val:] if n_val else None)
    elif isinstance(validation, str):
        mask = pdf[validation].astype(bool)
        train_pdf = pdf[~mask].drop(columns=[validation])
        val_pdf = pdf[mask].drop(columns=[validation])
    else:
        train_pdf, val_pdf = pdf, _to_pandas(validation)

    meta = make_metadata(train_pdf, feature_cols, label_cols)
    train_path = store.get_train_data_path(dataset_idx)
    meta["train_rows"] = write_parquet(train_pdf, train_path, num_partitions)
    meta["train_data_path"] = train_path
    if val_pdf is not None and len(val_pdf):
        val_path = store.get_val_data_path(dataset_idx)
        meta["val_rows"] = write_parquet(val_pdf, val_path, num_partitions)
        meta["val_data_path"] = val_path
    else:
        meta["val_rows"] = 0
        meta["val_data_path"] = None
    return meta


def _list_parquet_files(path: str) -> List[str]:
    """THE dataset file-listing rule (single definition for sharding and
    schema recovery)."""
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(".parquet"))


def iter_shard_groups(path: str, rank: int = 0, size: int = 1):
    """This rank's (filename, row_group_index, num_rows) triples.

    THE sharding rule (one definition; ``read_shard`` and the streaming
    ``ShardReader`` both consume it): sorted ``.parquet`` listing,
    round-robin by global row-group index — disjoint per rank, all rows
    covered, the granularity Petastorm uses in the reference's remote
    readers (``spark/keras/remote.py``). Only metadata is read here; no
    file handles outlive the call (a 4096-partition dataset must not pin
    4096 descriptors for a training run's lifetime).
    """
    import pyarrow.parquet as pq

    g = 0  # global row-group index across files
    for fname in _list_parquet_files(path):
        md = pq.read_metadata(fname)
        for rg in range(md.num_row_groups):
            if g % size == rank:
                yield fname, rg, md.row_group(rg).num_rows
            g += 1


def read_shard(path: str, rank: int = 0, size: int = 1,
               columns: Optional[List[str]] = None):
    """Read this rank's whole shard as a pandas DataFrame (see
    ``iter_shard_groups`` for the sharding rule; ``reader.ShardReader``
    streams the same shard with bounded memory)."""
    import pandas as pd
    import pyarrow.parquet as pq

    frames = []
    open_name, open_pf = None, None
    for fname, rg, _rows in iter_shard_groups(path, rank, size):
        if fname != open_name:
            open_name, open_pf = fname, pq.ParquetFile(fname)
        frames.append(open_pf.read_row_group(rg, columns=columns)
                      .to_pandas())
    if not frames:
        # Keep the dataset schema so downstream column selection works on
        # empty shards (this rank drew zero row groups).
        files = _list_parquet_files(path)
        schema_cols = (columns or
                       (pq.read_schema(files[0]).names if files else []))
        return pd.DataFrame(columns=schema_cols)
    return pd.concat(frames, ignore_index=True)


def to_arrays(pdf, cols: Sequence[str], meta: Dict) -> List[np.ndarray]:
    """Stack DataFrame columns into dense np arrays using column metadata
    (list/array cells become trailing dims)."""
    out = []
    for col in cols:
        info = meta["columns"][col]
        shape = tuple(info["shape"])
        if len(pdf) == 0:
            arr = np.zeros((0,) + shape, dtype=info["dtype"])
        elif shape:
            arr = np.stack([np.asarray(v) for v in pdf[col].to_numpy()])
            arr = arr.reshape((len(pdf),) + shape)
        else:
            arr = pdf[col].to_numpy()
        out.append(arr.astype(info["dtype"]))
    return out


def read_val_arrays(meta: Dict, rank: int, size: int,
                    transformation_fn=None):
    """This rank's validation split as ``(features, labels)`` array
    lists, or ``None`` when the split is absent or the shard empty.
    Shared by the keras/torch remote trainers (identical read →
    transform → to_arrays flow; one copy so fixes can't miss a
    framework)."""
    if not meta.get("val_data_path"):
        return None
    vdf = read_shard(meta["val_data_path"], rank, size,
                     columns=(meta["feature_cols"] + meta["label_cols"]))
    if transformation_fn is not None:
        vdf = transformation_fn(vdf)
    if not len(vdf):
        return None
    return (to_arrays(vdf, meta["feature_cols"], meta),
            to_arrays(vdf, meta["label_cols"], meta))
