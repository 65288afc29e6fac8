"""The port's Spark estimators (``horovod_tpu_torch.spark``) against the
JAX package's, at one rank on the ``LocalBackend``, from the same
DataFrame (made from a seed) and the same initial weights: the cases of
``tests/test_spark_estimator.py`` and ``test_spark_reader.py``'s
estimator case.

``TorchEstimator`` runs with ``device="cpu"``: both packages then train
torch on the CPU in the same order, so the history and the trained
``state_dict`` are held within 1e-6 (equal in practice), as are
``transform``'s predictions. ``KerasEstimator`` is held to the JAX
package's history within 1e-5. Without ``device`` the torch estimator
computes on ``cuda:<local rank>`` and raises where that GPU is missing.
"""

import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
torch = pytest.importorskip("torch")

import horovod_tpu.spark as ref_spark  # noqa: E402
import horovod_tpu_torch.spark as port_spark  # noqa: E402

TOL = 1e-6
KERAS_TOL = 1e-5


def _make_df(n=64, d=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    y = (x.sum(axis=1) * 0.5).astype(np.float32)
    return pd.DataFrame({"features": list(x), "label": y})


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 1),
        torch.nn.Flatten(0))


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= tol, f"{what}: {err:.3e} past {tol}"


def _hold_torch(ref, port, probe):
    """The port's trained TorchModel against the JAX package's."""
    assert sorted(port.history) == sorted(ref.history)
    for k in ref.history:
        _close(port.history[k], ref.history[k], TOL, f"history {k}")
    ref_sd, port_sd = ref.model.state_dict(), port.model.state_dict()
    assert list(port_sd) == list(ref_sd)
    for k in ref_sd:
        assert port_sd[k].device == torch.device("cpu")
        _close(port_sd[k], ref_sd[k], TOL, f"state_dict {k}")
    a = np.stack(ref.transform(probe)["label__output"].to_numpy())
    b = np.stack(port.transform(probe)["label__output"].to_numpy())
    _close(b, a, TOL, "transform")
    return ref.history


def _fit_torch(spark, tmp_path, df, port, setup=None, **kw):
    model = _mlp()
    kw.setdefault("optimizer", (torch.optim.SGD, {"lr": 0.1}))
    if port:
        kw["device"] = "cpu"
    est = spark.TorchEstimator(
        model=model, feature_cols=["features"], label_cols=["label"],
        store=spark.LocalStore(str(tmp_path / ("port" if port else "ref"))),
        **kw)
    if setup:
        setup(est)
    return est.fit(df)


def _both_torch(tmp_path, df, setup=None, **kw):
    return [_fit_torch(s, tmp_path, df, s is port_spark, setup, **kw)
            for s in (ref_spark, port_spark)]


def test_torch_estimator_end_to_end(tmp_path):
    ref, port = _both_torch(
        tmp_path, _make_df(128), loss=torch.nn.functional.mse_loss,
        batch_size=16, epochs=8)
    h = _hold_torch(ref, port, _make_df(16, seed=1))
    assert h["loss"][-1] < h["loss"][0]
    out = port.transform(_make_df(16, seed=1))
    assert np.asarray(out["label__output"]).shape == (16,)


def test_torch_estimator_optimizer_instance(tmp_path):
    """An optimizer instance is rebuilt from its class and defaults."""
    df = _make_df(96)
    models = []
    for spark in (ref_spark, port_spark):
        model = _mlp(3)
        est = spark.TorchEstimator(
            model=model,
            optimizer=torch.optim.Adam(model.parameters(), lr=0.01),
            loss=torch.nn.functional.mse_loss, feature_cols=["features"],
            label_cols=["label"], batch_size=32, epochs=3,
            store=spark.LocalStore(str(tmp_path / spark.__name__)),
            **({"device": "cpu"} if spark is port_spark else {}))
        models.append(est.fit(df))
    _hold_torch(*models, _make_df(8, seed=2))


def test_torch_estimator_full_param_surface(tmp_path):
    """input_shapes, transformation_fn, sample_weight_col with uneven
    weights, loss_constructors, gradient_compression and the accessors."""
    df = _make_df(96)
    df["wt"] = np.linspace(0.5, 1.5, len(df)).astype(np.float32)
    seen = {}

    def tf_fn(pdf):
        seen["n"] = seen.get("n", 0) + 1
        pdf = pdf.copy()
        pdf["label"] = pdf["label"] * 2
        return pdf

    def setup(est):
        est.setEpochs(6).setBatchSize(16).setTransformationFn(tf_fn)

    runs = []
    for spark in (ref_spark, port_spark):
        compression = __import__(
            f"{spark.__name__.split('.')[0]}.torch",
            fromlist=["Compression"]).Compression.fp16
        runs.append(_fit_torch(
            spark, tmp_path, df, spark is port_spark, setup,
            loss_constructors=[lambda: torch.nn.functional.mse_loss],
            input_shapes=[[-1, 4]], sample_weight_col="wt",
            gradient_compression=compression))
    assert seen["n"] > 0
    h = _hold_torch(*runs, _make_df(8, seed=3))
    assert h["loss"][-1] < h["loss"][0]


def test_torch_estimator_train_minibatch_fn(tmp_path):
    def minibatch(model, optimizer, xs, ys):
        loss = torch.nn.functional.l1_loss(model(*xs), ys[0])
        loss.backward()
        optimizer.step()
        return loss

    ref, port = _both_torch(
        tmp_path, _make_df(64), loss=torch.nn.functional.mse_loss,
        batch_size=16, epochs=3, train_minibatch_fn=minibatch)
    _hold_torch(ref, port, _make_df(8, seed=4))


def test_torch_estimator_validation_history(tmp_path):
    ref, port = _both_torch(
        tmp_path, _make_df(128), loss=torch.nn.functional.mse_loss,
        batch_size=16, epochs=6, validation=0.25)
    h = _hold_torch(ref, port, _make_df(8, seed=5))
    assert len(h["val_loss"]) == 6
    assert h["val_loss"][-1] < h["val_loss"][0]


def test_torch_estimator_and_model_persistence(tmp_path):
    from horovod_tpu_torch.spark.common.estimator import (HorovodEstimator,
                                                          HorovodModel)
    from horovod_tpu_torch.spark.torch import TorchModel

    est = port_spark.TorchEstimator(
        model=_mlp(), optimizer=(torch.optim.SGD, {"lr": 0.1}),
        loss=torch.nn.functional.mse_loss, feature_cols=["features"],
        label_cols=["label"], batch_size=16, epochs=3, device="cpu",
        store=port_spark.LocalStore(str(tmp_path / "store")))
    est.save(str(tmp_path / "est"))
    loaded = HorovodEstimator.load(str(tmp_path / "est"))
    assert isinstance(loaded, port_spark.TorchEstimator)
    assert loaded.getDevice() == "cpu" and loaded.getEpochs() == 3
    with pytest.raises(TypeError, match="TorchEstimator"):
        port_spark.KerasEstimator.load(str(tmp_path / "est"))
    trained = loaded.fit(_make_df(64))
    ref = _fit_torch(ref_spark, tmp_path, _make_df(64), False,
                     loss=torch.nn.functional.mse_loss, batch_size=16,
                     epochs=3)
    _hold_torch(ref, trained, _make_df(8, seed=6))
    trained.save(str(tmp_path / "mdl"))
    reloaded = TorchModel.load(str(tmp_path / "mdl"))
    assert isinstance(HorovodModel.load(str(tmp_path / "mdl")), TorchModel)
    probe = _make_df(8, seed=6)
    np.testing.assert_array_equal(
        trained.transform(probe)["label__output"].to_numpy(),
        reloaded.transform(probe)["label__output"].to_numpy())


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_torch_estimator_defaults_to_the_card(tmp_path, no_gpu):
    """Without ``device`` the trainer and ``transform`` ask for
    ``cuda:<local rank>``, and raise where there is none."""
    est = port_spark.TorchEstimator(
        model=_mlp(), optimizer=(torch.optim.SGD, {"lr": 0.1}),
        loss=torch.nn.functional.mse_loss, feature_cols=["features"],
        label_cols=["label"], store=port_spark.LocalStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit(_make_df(32))
    trained = est.setDevice("cpu").fit(_make_df(32))
    trained.device = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trained.transform(_make_df(4))


def test_a_missing_local_rank_gpu_raises(tmp_path, monkeypatch):
    """Two tasks on a host of one card: local rank 1 has no GPU, and the
    trainer and ``transform`` raise instead of moving to the CPU."""
    from horovod_tpu_torch.spark.torch import TorchModel
    from horovod_tpu_torch.spark.torch.remote import make_remote_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
    trainer = make_remote_trainer(b"", torch.optim.SGD, {"lr": 0.1}, [],
                                  16, 1, {}, str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="local rank 1 has no GPU"):
        trainer()
    model = TorchModel(model=_mlp(), feature_cols=["features"],
                       label_cols=["label"],
                       _metadata={"columns": {"features": {
                           "shape": [4], "dtype": "float32", "size": 4}}})
    with pytest.raises(RuntimeError, match="local rank 1 has no GPU"):
        model.transform(_make_df(4))


# -- Keras --------------------------------------------------------------------


def _keras_fit(spark, tmp_path, df, build, setup=None, **kw):
    import keras

    model, weights = build()
    model.set_weights(weights)
    est = spark.KerasEstimator(
        model=model, loss="mse", feature_cols=["features"],
        label_cols=["label"],
        store=spark.LocalStore(str(tmp_path / spark.__name__)),
        optimizer=keras.optimizers.SGD(learning_rate=0.05), **kw)
    if setup:
        setup(est)
    return est.fit(df)


def _keras_both(tmp_path, df, build, setup=None, **kw):
    ref, port = (_keras_fit(s, tmp_path, df, build, setup, **kw)
                 for s in (ref_spark, port_spark))
    assert sorted(port.history) == sorted(ref.history)
    for k in ref.history:
        _close(port.history[k], ref.history[k], KERAS_TOL, f"history {k}")
    return ref, port


def _dense(activation="relu"):
    def build():
        keras = pytest.importorskip("keras")
        keras.utils.set_random_seed(0)
        model = keras.Sequential([
            keras.layers.Input(shape=(4,)),
            keras.layers.Dense(8, activation=activation),
            keras.layers.Dense(1)])
        return model, model.get_weights()
    return build


def test_keras_estimator_end_to_end(tmp_path):
    pytest.importorskip("keras")
    ref, port = _keras_both(tmp_path, _make_df(128), _dense(),
                            batch_size=16, epochs=8, validation=0.2)
    assert port.history["loss"][-1] < port.history["loss"][0]
    probe = _make_df(16, seed=1)
    a = ref.transform(probe)["label__output"].to_numpy()
    b = port.transform(probe)["label__output"].to_numpy()
    _close(b, a, KERAS_TOL, "transform")


def test_keras_estimator_full_param_surface(tmp_path):
    keras = pytest.importorskip("keras")

    def my_act(x):
        return keras.activations.relu(x)

    df = _make_df(96)
    df["wt"] = np.linspace(0.5, 1.5, len(df)).astype(np.float32)
    seen = {"transform": 0}
    epoch_ends = []

    def tf_fn(pdf):
        seen["transform"] += 1
        return pdf

    class Counter(keras.callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            epoch_ends.append(epoch)

    def setup(est):
        est.setBatchSize(16).setEpochs(4).setSampleWeightCol("wt") \
           .setTransformationFn(tf_fn).setCallbacks([Counter()]) \
           .setTrainStepsPerEpoch(5).setVerbose(0)

    ref, port = _keras_both(tmp_path, df, _dense(my_act), setup,
                            metrics=["mae"], loss_weights=[1.0],
                            custom_objects={"my_act": my_act})
    assert "mae" in port.history
    assert len(epoch_ends) == 8 and seen["transform"] > 0
    out = port.transform(_make_df(8, seed=2))
    assert "label__output" in out.columns and len(out) == 8


def test_keras_estimator_reader_workers(tmp_path):
    pytest.importorskip("keras")
    n = 48
    pdf = pd.DataFrame({
        "features": [np.arange(4, dtype=np.float32) + i for i in range(n)],
        "label": np.arange(n, dtype=np.float32) / n,
    })
    ref, port = _keras_both(tmp_path, pdf, _dense(), batch_size=16,
                            epochs=2, train_reader_num_workers=2)
    assert len(port.history["loss"]) == 2


def test_keras_estimator_and_model_persistence(tmp_path):
    keras = pytest.importorskip("keras")
    from horovod_tpu_torch.spark.common.estimator import (HorovodEstimator,
                                                          HorovodModel)
    from horovod_tpu_torch.spark.keras.estimator import KerasModel

    model, weights = _dense()()
    est = port_spark.KerasEstimator(
        model=model, optimizer=keras.optimizers.SGD(learning_rate=0.1),
        loss="mse", feature_cols=["features"], label_cols=["label"],
        batch_size=16, epochs=4,
        store=port_spark.LocalStore(str(tmp_path / "store")))
    est.setTransformationFn(lambda pdf: pdf)
    est.save(str(tmp_path / "est"))
    loaded = port_spark.KerasEstimator.load(str(tmp_path / "est"))
    assert loaded.getEpochs() == 4
    assert loaded.getFeatureCols() == ["features"]
    assert callable(loaded.getTransformationFn())
    with pytest.raises(TypeError, match="KerasEstimator"):
        port_spark.TorchEstimator.load(str(tmp_path / "est"))
    assert isinstance(HorovodEstimator.load(str(tmp_path / "est")),
                      port_spark.KerasEstimator)
    trained = loaded.fit(_make_df(64))
    assert trained.history["loss"][-1] < trained.history["loss"][0]
    probe = _make_df(8, seed=5)
    before = trained.transform(probe)["label__output"].to_numpy()
    trained.save(str(tmp_path / "mdl"))
    reloaded = KerasModel.load(str(tmp_path / "mdl"))
    after = reloaded.transform(probe)["label__output"].to_numpy()
    np.testing.assert_allclose(np.stack(before).astype(np.float64),
                               np.stack(after).astype(np.float64),
                               rtol=1e-6)
    assert isinstance(HorovodModel.load(str(tmp_path / "mdl")), KerasModel)
    assert os.path.exists(str(tmp_path / "mdl"))
