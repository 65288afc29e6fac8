"""The port's Spark data layer (``horovod_tpu_torch/spark/common``: the
stores, ``prepare_data`` and the shard reader, and the estimator params)
against the JAX package's: the cases of ``tests/test_spark_store.py``,
``test_spark_reader.py`` and ``test_spark_estimator.py``'s data cases,
each run on both packages, and the two packages' shards, batches and
arrays held equal bitwise on the same DataFrame (made from a seed)."""

import importlib
import os
import types

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("pyarrow")

ROOTS = ("horovod_tpu", "horovod_tpu_torch")


def _package(root):
    m = types.SimpleNamespace()
    m.spark = importlib.import_module(f"{root}.spark")
    m.store = importlib.import_module(f"{root}.spark.common.store")
    m.util = importlib.import_module(f"{root}.spark.common.util")
    m.reader = importlib.import_module(f"{root}.spark.common.reader")
    m.estimator = importlib.import_module(f"{root}.spark.common.estimator")
    return m


@pytest.fixture(params=ROOTS)
def pkg(request):
    return _package(request.param)


def _make_df(n=64, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    y = (x.sum(axis=1) * 0.5).astype(np.float32)
    return pd.DataFrame({"features": list(x), "label": y})


# -- the stores (tests/test_spark_store.py) -----------------------------------


def test_store_create_dispatch(pkg, tmp_path):
    s = pkg.store.Store.create(str(tmp_path))
    assert isinstance(s, pkg.spark.LocalStore)
    assert isinstance(pkg.store.Store.create("hdfs://nn:9000/path"),
                      pkg.store.HDFSStore)
    assert isinstance(pkg.store.Store.create("s3://bucket/path"),
                      pkg.store.S3Store)


def test_hdfs_store_paths_without_cluster(pkg):
    s = pkg.store.HDFSStore("hdfs://namenode:9000/user/me/exp")
    assert s._host == "namenode" and s._port == 9000
    assert s.get_train_data_path() == \
        "hdfs://namenode:9000/user/me/exp/intermediate_train_data"
    assert s.get_train_data_path(2).endswith(".2")
    assert s.get_checkpoint_path("r7") == \
        "hdfs://namenode:9000/user/me/exp/runs/r7/checkpoint"
    assert s._strip(s.get_checkpoint_path("r7")) == \
        "/user/me/exp/runs/r7/checkpoint"
    assert pkg.store.HDFSStore("hdfs://nn/path")._host == "nn"
    with pytest.raises(Exception) as excinfo:
        s.exists(s.get_train_data_path())
    assert str(excinfo.value)


def test_s3_store_path_strip(pkg):
    s = pkg.store.S3Store("s3://bucket/prefix")
    assert s.get_train_data_path() == \
        "s3://bucket/prefix/intermediate_train_data"
    assert s._strip(s.get_train_data_path()) == \
        "bucket/prefix/intermediate_train_data"


def test_local_store_paths(pkg, tmp_path):
    s = pkg.spark.LocalStore(str(tmp_path))
    assert s.get_train_data_path().startswith(str(tmp_path))
    assert s.get_train_data_path(3).endswith(".3")
    assert s.get_checkpoint_path("r1") == \
        os.path.join(str(tmp_path), "runs", "r1", "checkpoint")
    assert s.get_logs_path("r1").endswith(os.path.join("r1", "logs"))
    assert s.saving_runs()


def test_local_store_io(pkg, tmp_path):
    s = pkg.spark.LocalStore(str(tmp_path))
    p = os.path.join(str(tmp_path), "a", "b.txt")
    s.write_text(p, "hello")
    assert s.exists(p)
    assert s.read(p) == b"hello"
    assert not s.is_parquet_dataset(str(tmp_path))
    s.clear()
    assert not os.path.exists(str(tmp_path))


# -- the estimator params (tests/test_spark_store.py) -------------------------


def test_estimator_params_validation(pkg):
    est_mod = pkg.estimator
    with pytest.raises(ValueError):
        est_mod.EstimatorParams(bogus_param=1)
    est = est_mod.HorovodEstimator(model=object(), feature_cols=["x"],
                                   label_cols=["y"], epochs=3)
    assert est.getOrDefault("epochs") == 3
    est.setParams(batch_size=16)
    assert est.getOrDefault("batch_size") == 16
    with pytest.raises(ValueError):
        est_mod.HorovodEstimator(feature_cols=["x"],
                                 label_cols=["y"])._validate()
    with pytest.raises(ValueError, match="store is required"):
        est.fit(None)
    with pytest.raises(NotImplementedError):
        est._make_trainer({}, "x")
    with pytest.raises(ValueError, match="unknown estimator param"):
        est_mod.HorovodEstimator(bogus=1)
    with pytest.raises(ValueError, match="feature_cols"):
        est_mod.HorovodEstimator(model=object(),
                                 label_cols=["y"])._validate()


def test_estimator_param_accessor_matrix(pkg):
    est = pkg.estimator.HorovodEstimator()
    for name, (camel, _) in type(est)._param_defs().items():
        assert callable(getattr(est, f"set{camel}", None)), camel
        assert getattr(est, f"get{camel}")() is None
    out = est.setEpochs(4).setBatchSize(8).setFeatureCols(["a", "b"])
    assert out is est
    assert (est.getEpochs(), est.getBatchSize(), est.getFeatureCols()) == \
        (4, 8, ["a", "b"])
    est.setParams(verbose=1)
    assert est.getVerbose() == 1
    H = pkg.estimator.HorovodEstimator
    assert H(num_proc=3).getNumProc() == 3
    assert H(label_cols="y").getLabelCols() == ["y"]
    with pytest.raises(TypeError, match="run_id"):
        H(run_id=7)
    with pytest.raises(TypeError, match="epochs"):
        H(epochs="three")
    with pytest.raises(TypeError, match="batch_size"):
        H().setBatchSize(2.5)
    with pytest.raises(TypeError, match="feature_cols"):
        H(feature_cols=[1, 2])
    assert H(epochs=3.0).getEpochs() == 3


def _surface(cls):
    return {name: (camel, conv and conv.__name__)
            for name, (camel, conv) in cls._param_defs().items()}


def test_the_packages_declare_the_same_params():
    """The port's param surface is the JAX package's, plus the torch
    estimator's ``device``."""
    ref, port = (_package(r) for r in ROOTS)
    assert _surface(port.estimator.EstimatorParams) == \
        _surface(ref.estimator.EstimatorParams)
    port_torch = _surface(port.spark.TorchEstimator)
    assert port_torch.pop("device") == ("Device", None)
    assert port_torch == _surface(ref.spark.TorchEstimator)
    assert _surface(port.spark.KerasEstimator) == \
        _surface(ref.spark.KerasEstimator)


def test_framework_estimators_declare_extra_params(pkg):
    ke = pkg.spark.KerasEstimator(custom_objects={"f": int})
    assert ke.getCustomObjects() == {"f": int}
    ke.setCustomObjects({"g": str})
    assert ke.getCustomObjects() == {"g": str}
    assert ke.setEpochs(2).getEpochs() == 2
    te = pkg.spark.TorchEstimator(input_shapes=[[-1, 4]])
    assert te.getInputShapes() == [[-1, 4]]
    assert te.setTrainMinibatchFn(abs).getTrainMinibatchFn() is abs
    with pytest.raises(ValueError, match="unknown estimator param"):
        pkg.spark.TorchEstimator(custom_objects={})


def test_model_wrapper(pkg, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "pyspark", None)
    m = pkg.estimator.HorovodModel(model=42, feature_cols=["x"], run_id="r")
    assert m.model == 42
    with pytest.raises(ImportError, match="requires pyspark"):
        m.transform(None)


def test_spark_run_requires_pyspark(pkg, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError, match="requires pyspark"):
        pkg.spark.run(lambda: 0, num_proc=1)


# -- prepare_data (tests/test_spark_estimator.py) -----------------------------


def test_prepare_data_and_shard_roundtrip(pkg, tmp_path):
    store = pkg.spark.LocalStore(str(tmp_path))
    df = _make_df(50)
    meta = pkg.util.prepare_data(store, df, ["features"], ["label"],
                                 validation=0.2, num_partitions=4)
    assert meta["train_rows"] == 40 and meta["val_rows"] == 10
    assert meta["columns"]["features"]["shape"] == [4]
    s0 = pkg.util.read_shard(meta["train_data_path"], 0, 2)
    s1 = pkg.util.read_shard(meta["train_data_path"], 1, 2)
    assert len(s0) + len(s1) == 40
    labels = np.sort(np.concatenate([s0["label"], s1["label"]]))
    xs = pkg.util.to_arrays(s0, ["features"], meta)
    assert xs[0].shape == (len(s0), 4)
    assert np.allclose(labels, np.sort(df["label"].to_numpy()[:40]))


def test_empty_shard_keeps_schema(pkg, tmp_path):
    store = pkg.spark.LocalStore(str(tmp_path))
    meta = pkg.util.prepare_data(store, _make_df(3), ["features"], ["label"])
    empty = pkg.util.read_shard(meta["train_data_path"], rank=97, size=99)
    assert "features" in empty.columns and len(empty) == 0
    xs = pkg.util.to_arrays(empty, ["features"], meta)
    ys = pkg.util.to_arrays(empty, ["label"], meta)
    assert xs[0].shape == (0, 4) and ys[0].shape == (0,)


def test_validation_column_split(pkg, tmp_path):
    store = pkg.spark.LocalStore(str(tmp_path))
    df = _make_df(20)
    df["is_val"] = ([0] * 15) + ([1] * 5)
    meta = pkg.util.prepare_data(store, df, ["features"], ["label"],
                                 validation="is_val")
    assert meta["train_rows"] == 15 and meta["val_rows"] == 5


# -- the shard reader (tests/test_spark_reader.py) ----------------------------


@pytest.fixture
def dataset(pkg, tmp_path):
    n = 103
    pdf = pd.DataFrame({
        "x": [np.arange(4, dtype=np.float32) + i for i in range(n)],
        "y": np.arange(n, dtype=np.int64),
    })
    meta = pkg.util.make_metadata(pdf, ["x"], ["y"])
    path = str(tmp_path / "train")
    pkg.util.write_parquet(pdf, path, num_partitions=3)
    return path, meta, n


def _collect(reader, epoch=0):
    feats, labs = [], []
    for xs, ys in reader.batches(epoch):
        assert len(xs) == 1 and len(ys) == 1
        assert xs[0].shape[1:] == (4,)
        feats.append(xs[0])
        labs.append(ys[0])
    return (np.concatenate(feats) if feats else np.zeros((0, 4)),
            np.concatenate(labs) if labs else np.zeros((0,), np.int64))


def test_full_coverage_disjoint_across_ranks(pkg, dataset):
    path, meta, n = dataset
    seen = []
    for r in range(3):
        reader = pkg.reader.ShardReader(path, meta, r, 3, batch_size=16)
        assert reader.rows > 0
        _, ys = _collect(reader)
        assert len(ys) == reader.rows
        seen.append(set(int(v) for v in ys))
    assert set().union(*seen) == set(range(n))
    for a in range(3):
        for b in range(a + 1, 3):
            assert not (seen[a] & seen[b])


def test_batch_sizes_and_row_alignment(pkg, dataset):
    path, meta, n = dataset
    reader = pkg.reader.ShardReader(path, meta, 0, 1, batch_size=16,
                                    shuffle=True)
    sizes = []
    for xs, ys in reader.batches(0):
        assert xs[0].shape[0] == ys[0].shape[0]
        np.testing.assert_array_equal(
            xs[0], np.arange(4, dtype=np.float32)[None] + ys[0][:, None])
        sizes.append(len(ys[0]))
    assert sum(sizes) == n
    assert all(s == 16 for s in sizes[:-1]), sizes


def test_epoch_shuffle_changes_order_not_content(pkg, dataset):
    path, meta, n = dataset
    reader = pkg.reader.ShardReader(path, meta, 0, 1, batch_size=32,
                                    shuffle=True)
    _, y0 = _collect(reader, epoch=0)
    _, y1 = _collect(reader, epoch=1)
    assert sorted(y0) == sorted(y1) == list(range(n))
    assert not np.array_equal(y0, y1)


def test_no_shuffle_is_deterministic(pkg, dataset):
    path, meta, n = dataset
    _, a = _collect(pkg.reader.ShardReader(path, meta, 0, 1, batch_size=20,
                                           shuffle=False))
    _, b = _collect(pkg.reader.ShardReader(path, meta, 0, 1, batch_size=20,
                                           shuffle=False))
    np.testing.assert_array_equal(a, b)
    assert pkg.reader.ShardReader(path, meta, 0, 1, batch_size=16) \
        .steps_per_epoch() == int(np.ceil(n / 16))


def test_transform_fn_and_sample_weights(pkg, tmp_path):
    n = 41
    pdf = pd.DataFrame({
        "x": [np.arange(4, dtype=np.float32) + i for i in range(n)],
        "y": np.arange(n, dtype=np.int64),
        "w": np.linspace(0.5, 1.5, n).astype(np.float32),
    })
    meta = pkg.util.make_metadata(pdf, ["x"], ["y"])
    path = str(tmp_path / "wtrain")
    pkg.util.write_parquet(pdf, path, num_partitions=2)

    def double_labels(frame):
        frame = frame.copy()
        frame["y"] = frame["y"] * 2
        return frame

    reader = pkg.reader.ShardReader(
        path, meta, 0, 1, batch_size=8, shuffle=False,
        transform_fn=double_labels, sample_weight_col="w")
    ys, ws = [], []
    for xs, labs, weights in reader.batches(0):
        assert len(weights) == 1 and len(weights[0]) == len(labs[0])
        ys.append(labs[0])
        ws.append(weights[0])
    np.testing.assert_array_equal(np.sort(np.concatenate(ys)),
                                  np.arange(n) * 2)
    np.testing.assert_allclose(np.sort(np.concatenate(ws)),
                               np.linspace(0.5, 1.5, n), rtol=1e-6)


@pytest.mark.parametrize("workers", [0, 3])
def test_prefetch_workers_identical_stream(pkg, dataset, workers):
    path, meta, n = dataset
    ref = pkg.reader.ShardReader(path, meta, 0, 1, batch_size=16,
                                 shuffle=True)
    got = pkg.reader.ShardReader(path, meta, 0, 1, batch_size=16,
                                 shuffle=True, num_workers=workers)
    ref_batches = list(ref.batches(epoch=2))
    got_batches = list(got.batches(epoch=2))
    assert len(ref_batches) == len(got_batches)
    for (rx, ry), (gx, gy) in zip(ref_batches, got_batches):
        np.testing.assert_array_equal(rx[0], gx[0])
        np.testing.assert_array_equal(ry[0], gy[0])


# -- the two packages on the same data: equal bitwise -------------------------


def _prepared(root, tmp_path, validation):
    m = _package(root)
    df = _make_df(203, d=5, seed=11)
    df["wt"] = np.random.RandomState(12).rand(len(df)).astype(np.float32)
    if validation == "column":
        df["is_val"] = np.random.RandomState(13).rand(len(df)) < 0.2
        validation = "is_val"
    store = m.spark.LocalStore(str(tmp_path / root))
    meta = m.util.prepare_data(store, df, ["features"], ["label"],
                               validation=validation, num_partitions=3)
    return m, meta


@pytest.mark.parametrize("validation", [None, 0.25, "column"])
def test_the_packages_write_and_read_the_same_shards(tmp_path, validation):
    (ref, ref_meta), (port, port_meta) = (
        _prepared(r, tmp_path, validation) for r in ROOTS)
    drop = ("train_data_path", "val_data_path")
    assert {k: v for k, v in port_meta.items() if k not in drop} == \
        {k: v for k, v in ref_meta.items() if k not in drop}
    for key in drop:
        if ref_meta[key] is None:
            assert port_meta[key] is None
            continue
        for rank, size in ((0, 1), (0, 2), (1, 2), (2, 3), (5, 6)):
            a = ref.util.read_shard(ref_meta[key], rank, size)
            b = port.util.read_shard(port_meta[key], rank, size)
            assert list(a.columns) == list(b.columns)
            for ra, rb in zip(ref.util.to_arrays(a, ["features", "label"],
                                                 ref_meta),
                              port.util.to_arrays(b, ["features", "label"],
                                                  port_meta)):
                assert ra.dtype == rb.dtype and ra.shape == rb.shape
                assert ra.tobytes() == rb.tobytes()
    va = ref.util.read_val_arrays(ref_meta, 1, 2)
    vb = port.util.read_val_arrays(port_meta, 1, 2)
    assert (va is None) == (vb is None)
    if va is not None:
        for xa, xb in zip(va[0] + va[1], vb[0] + vb[1]):
            assert xa.tobytes() == xb.tobytes()


@pytest.mark.parametrize("shuffle,workers", [(True, 0), (False, 0),
                                             (True, 2)])
def test_the_packages_stream_the_same_batches(tmp_path, shuffle, workers):
    (ref, ref_meta), (port, port_meta) = (
        _prepared(r, tmp_path, None) for r in ROOTS)

    def halve(frame):
        frame = frame.copy()
        frame["label"] = frame["label"] / 2
        return frame

    for rank, size in ((0, 1), (1, 2), (2, 3)):
        streams = [
            list(m.reader.ShardReader(
                meta["train_data_path"], meta, rank, size, batch_size=7,
                shuffle=shuffle, shuffle_window_row_groups=2,
                transform_fn=halve, sample_weight_col="wt",
                num_workers=workers).batches(epoch=3))
            for m, meta in ((ref, ref_meta), (port, port_meta))]
        assert len(streams[0]) == len(streams[1]) > 0
        for ba, bb in zip(*streams):
            assert len(ba) == len(bb) == 3
            for sa, sb in zip(ba, bb):
                for xa, xb in zip(sa, sb):
                    assert xa.dtype == xb.dtype and xa.shape == xb.shape
                    assert xa.tobytes() == xb.tobytes()
