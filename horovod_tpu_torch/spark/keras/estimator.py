"""The Keras Spark ML estimator (the port's copy of
``horovod_tpu/spark/keras/estimator.py``, after upstream Horovod's
``spark/keras/estimator.py`` KerasEstimator and KerasModel).

``fit`` writes the DataFrame to the Store as Parquet, runs the training
function on the backend (in this process by default,
``horovod_tpu_torch.spark.run`` on a ``SparkBackend``), and returns a
``KerasModel`` whose ``transform`` predicts.
"""

from __future__ import annotations

from typing import Optional

from ..common.backend import Backend
from ..common.estimator import (HorovodEstimator, HorovodModel,
                                install_accessors)
from ..common.store import Store
from ..common.util import to_arrays
from .remote import make_remote_trainer
from .util import deserialize_model, serialize_model, serialize_optimizer


class KerasEstimator(HorovodEstimator):
    """Train a Keras model over Store-backed Parquet data.

    Mirrors the reference's param surface (``keras/estimator.py:103-170``):
    model, optimizer, loss, loss_weights, metrics, gradient_compression,
    custom_objects, feature_cols, label_cols, sample_weight_col,
    batch_size, epochs, validation, callbacks, transformation_fn, store,
    num_proc, verbose, shuffle_buffer_size, train/validation steps,
    run_id — each with the Spark-ML camelCase accessor pair
    (``setEpochs``/``getEpochs``, ...).
    """

    # Framework-specific params (reference keras/estimator.py:159).
    _EXTRA_PARAM_DEFS = {
        "custom_objects": ("CustomObjects", None),
    }

    def __init__(self, model=None, optimizer=None, loss=None, metrics=None,
                 feature_cols=None, label_cols=None, batch_size: int = 32,
                 epochs: int = 1, validation=None, callbacks=None,
                 store: Optional[Store] = None, num_proc: Optional[int] = None,
                 backend: Optional[Backend] = None, custom_objects=None,
                 verbose: int = 0, shuffle_buffer_size: int = 0,
                 train_steps_per_epoch=None, validation_steps_per_epoch=None,
                 run_id: Optional[str] = None, **kwargs):
        super().__init__(model=model, loss=loss, metrics=metrics,
                         feature_cols=feature_cols, label_cols=label_cols,
                         batch_size=batch_size, epochs=epochs,
                         validation=validation, callbacks=callbacks,
                         store=store, num_proc=num_proc,
                         optimizer=optimizer, backend=backend,
                         custom_objects=custom_objects,
                         verbose=verbose,
                         shuffle_buffer_size=shuffle_buffer_size,
                         train_steps_per_epoch=train_steps_per_epoch,
                         validation_steps_per_epoch=validation_steps_per_epoch,
                         run_id=run_id, **kwargs)
        self._backend = backend

    _checkpoint_filename = "model.keras"

    def _make_trainer(self, meta, checkpoint_path):
        model = self.getOrDefault("model")
        # Compile driver-side so loss/metrics serialize with the archive.
        opt = (self.getOrDefault("optimizer")
               or getattr(model, "optimizer", None))
        if opt is None:
            raise ValueError("optimizer is required (pass optimizer= or a "
                             "compiled model)")
        model.compile(optimizer=opt, loss=self.getOrDefault("loss"),
                      loss_weights=self.getOrDefault("loss_weights"),
                      metrics=self.getOrDefault("metrics") or None)
        return make_remote_trainer(
            serialize_model(model), serialize_optimizer(opt),
            self.getOrDefault("loss"), self.getOrDefault("metrics"),
            self.getOrDefault("batch_size"), self.getOrDefault("epochs"),
            meta, checkpoint_path,
            custom_objects=self.getOrDefault("custom_objects"),
            verbose=self.getOrDefault("verbose"),
            shuffle_buffer_size=self.getOrDefault("shuffle_buffer_size"),
            train_steps_per_epoch=self.getOrDefault("train_steps_per_epoch"),
            validation_steps_per_epoch=self.getOrDefault(
                "validation_steps_per_epoch"),
            callbacks=self.getOrDefault("callbacks"),
            loss_weights=self.getOrDefault("loss_weights"),
            sample_weight_col=self.getOrDefault("sample_weight_col"),
            transformation_fn=self.getOrDefault("transformation_fn"),
            gradient_compression=self.getOrDefault("gradient_compression"),
            train_reader_num_workers=self.getOrDefault(
                "train_reader_num_workers"))

    def _load_model(self, store, checkpoint_path):
        return deserialize_model(
            store.read(checkpoint_path),
            custom_objects=self.getOrDefault("custom_objects"))

    def _make_model(self, trained, history, run_id, meta) -> "KerasModel":
        return KerasModel(model=trained,
                          feature_cols=self.getOrDefault("feature_cols"),
                          label_cols=self.getOrDefault("label_cols"),
                          run_id=run_id, history=history, _metadata=meta)


install_accessors(KerasEstimator)


class KerasModel(HorovodModel):
    """Trained-model wrapper (parity: ``keras/estimator.py:375``)."""

    def __init__(self, model=None, feature_cols=None, label_cols=None,
                 run_id=None, history=None, _metadata=None):
        super().__init__(model, feature_cols, label_cols, run_id)
        self.history = history
        self._metadata = _metadata

    def transform(self, df):
        """Append ``<label>__output`` prediction columns. Accepts a pandas
        DataFrame (Spark DataFrames convert via ``toPandas`` upstream)."""
        import numpy as np

        from ..common.util import _to_pandas

        pdf = _to_pandas(df).copy()
        meta = self._metadata or {
            "columns": {c: {"shape": [], "dtype": "float32", "size": 1}
                        for c in self.feature_cols}}
        xs = to_arrays(pdf, self.feature_cols, meta)
        preds = self.model.predict(xs[0] if len(xs) == 1 else xs, verbose=0)
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for col, p in zip(self.label_cols, preds):
            p = np.asarray(p)
            pdf[f"{col}__output"] = (
                list(p) if p.ndim > 1 and p.shape[-1] > 1 else p.reshape(-1))
        return pdf
