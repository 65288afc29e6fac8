"""The Spark ML estimator base (the port's copy of
``horovod_tpu/spark/common/estimator.py``, after upstream Horovod's
``spark/common/estimator.py`` HorovodEstimator / HorovodModel).

An estimator trains a Keras or torch model over Parquet data that a
``Store`` holds and returns a model for batch inference. The param
surface is upstream Horovod's; parameter validation, persistence and the
store's plumbing need no pyspark, and ``fit`` runs on the ``LocalBackend``
without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..task_exec import pickler
from .store import Store


def _save_dir(obj, payload, path: str, meta_name: str,
              blob_name: str) -> None:
    """Versioned-directory persistence shared by Estimator and Model
    (parity role: the reference's HorovodParamsWriter,
    ``keras/estimator.py:40-70``): a json sidecar naming the concrete
    class + format version, and a pickle blob of ``payload``."""
    import json
    import os

    os.makedirs(path, exist_ok=True)
    meta = {
        "class": f"{type(obj).__module__}.{type(obj).__qualname__}",
        "format_version": 1,
    }
    with open(os.path.join(path, meta_name), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(path, blob_name), "wb") as f:
        # cloudpickle carries closures and lambdas (callbacks,
        # transformation_fn); plain pickle only module-level functions.
        pickler().dump(payload, f)


def _load_meta_class(cls, path: str, meta_name: str, kind: str):
    """Read the meta sidecar and resolve+validate the saved class BEFORE
    any pickle bytes are touched (unpickling runs arbitrary code; the
    class gate must come first)."""
    import importlib
    import json
    import os

    with open(os.path.join(path, meta_name)) as f:
        meta = json.load(f)
    if meta.get("format_version") != 1:
        raise ValueError(
            f"unsupported {kind} format {meta.get('format_version')}")
    mod_name, _, qual = meta["class"].rpartition(".")
    klass = getattr(importlib.import_module(mod_name), qual)
    if not (klass is cls or issubclass(klass, cls)):
        raise TypeError(
            f"saved {kind} is a {meta['class']}, not a {cls.__qualname__}")
    return klass


def _to_int(name, v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise TypeError(f"estimator param '{name}' must be an int, "
                        f"got {type(v).__name__}")
    if int(v) != v:
        raise TypeError(f"estimator param '{name}' must be integral, "
                        f"got {v}")
    return int(v)


def _to_str(name, v):
    if not isinstance(v, str):
        raise TypeError(f"estimator param '{name}' must be a str, "
                        f"got {type(v).__name__}")
    return v


def _to_str_list(name, v):
    if isinstance(v, str):
        return [v]
    if not all(isinstance(s, str) for s in v):
        raise TypeError(f"estimator param '{name}' must be a list of str")
    return list(v)


class EstimatorParams:
    """Declared parameters (parity: the Param list + camelCase accessor
    surface of ``common/params.py:25-350`` — each param gets
    ``set<Name>``/``get<Name>`` methods generated below, the reference's
    Spark-ML ``Params`` idiom without the pyspark dependency).

    Values may be supplied via the constructor, ``setParams(**kwargs)``,
    or the per-param setters; typed params validate on set (the role of
    Spark's ``TypeConverters``)."""

    # name -> (camel accessor suffix, converter or None)
    _PARAM_DEFS = {
        "num_proc": ("NumProc", _to_int),
        "model": ("Model", None),
        "backend": ("Backend", None),
        "store": ("Store", None),
        "optimizer": ("Optimizer", None),
        "loss": ("Loss", None),
        "loss_constructors": ("LossConstructors", None),
        "metrics": ("Metrics", None),
        "loss_weights": ("LossWeights", None),
        "sample_weight_col": ("SampleWeightCol", _to_str),
        "gradient_compression": ("GradientCompression", None),
        "feature_cols": ("FeatureCols", _to_str_list),
        "label_cols": ("LabelCols", _to_str_list),
        "validation": ("Validation", None),
        "callbacks": ("Callbacks", None),
        "batch_size": ("BatchSize", _to_int),
        "epochs": ("Epochs", _to_int),
        "verbose": ("Verbose", _to_int),
        "shuffle_buffer_size": ("ShuffleBufferSize", _to_int),
        "partitions_per_process": ("PartitionsPerProcess", _to_int),
        "run_id": ("RunId", _to_str),
        "train_steps_per_epoch": ("TrainStepsPerEpoch", _to_int),
        "validation_steps_per_epoch": ("ValidationStepsPerEpoch", _to_int),
        "transformation_fn": ("TransformationFn", None),
        "train_reader_num_workers": ("TrainReaderNumWorkers", _to_int),
        # Accepted for reference-API compatibility: validation here is a
        # one-shot whole-shard read (fit holds it in memory), not the
        # reference's streaming Petastorm reader, so a val reader pool
        # has nothing to parallelize.
        "val_reader_num_workers": ("ValReaderNumWorkers", _to_int),
        "label_shapes": ("LabelShapes", None),
    }
    # Subclasses contribute framework-specific params (the reference's
    # class-level Param declarations on KerasEstimator/TorchEstimator)
    # via _EXTRA_PARAM_DEFS, merged down the MRO.
    _EXTRA_PARAM_DEFS: Dict[str, tuple] = {}

    @classmethod
    def _param_defs(cls) -> Dict[str, tuple]:
        defs = dict(EstimatorParams._PARAM_DEFS)
        for klass in reversed(cls.__mro__):
            defs.update(getattr(klass, "_EXTRA_PARAM_DEFS", {}))
        return defs

    def __init__(self, **kwargs):
        self._params: Dict[str, Any] = {
            k: None for k in type(self)._param_defs()}
        self.setParams(**kwargs)

    def _set_one(self, name: str, value):
        if name not in self._params:
            raise ValueError(
                f"unknown estimator param '{name}'; valid: "
                f"{sorted(self._params)}")
        conv = type(self)._param_defs().get(name, (None, None))[1]
        if value is not None and conv is not None:
            value = conv(name, value)
        self._params[name] = value

    def getOrDefault(self, name: str):
        return self._params.get(name)

    def setParams(self, **kwargs) -> "EstimatorParams":
        for k, v in kwargs.items():
            self._set_one(k, v)
        return self


def install_accessors(cls):
    """Generate ``set<Name>``/``get<Name>`` pairs for every declared param
    (parity: the explicit accessor list in ``common/params.py:145-350``).
    Apply to every concrete estimator class that adds _EXTRA_PARAM_DEFS."""
    def make(name):
        def setter(self, value):
            self._set_one(name, value)
            return self

        def getter(self):
            return self.getOrDefault(name)

        return setter, getter

    for name, (camel, _) in cls._param_defs().items():
        setter, getter = make(name)
        setter.__name__, getter.__name__ = f"set{camel}", f"get{camel}"
        setter.__doc__ = f"Set estimator param ``{name}``; returns self."
        getter.__doc__ = f"Get estimator param ``{name}``."
        if not hasattr(cls, f"set{camel}"):
            setattr(cls, setter.__name__, setter)
        if not hasattr(cls, f"get{camel}"):
            setattr(cls, getter.__name__, getter)
    return cls


install_accessors(EstimatorParams)


class HorovodEstimator(EstimatorParams):
    """Base estimator (parity: ``common/estimator.py:26``)."""

    # -- persistence (parity: the Spark-ML read/write surface the
    # reference provides through HorovodParamsWriter/Reader with custom
    # param serializers, keras/estimator.py:40-101; pyspark-free here:
    # params ride cloudpickle, the directory format is versioned) -------

    _PERSIST_META = "estimator.json"
    _PERSIST_PARAMS = "params.pkl"

    def save(self, path: str) -> "HorovodEstimator":
        """Persist this estimator (all params, including the model and
        any callbacks/functions) to a directory; reload with
        ``load(path)`` — the reference's ``est.write().save(path)``."""
        _save_dir(self, self._params, path, self._PERSIST_META,
                  self._PERSIST_PARAMS)
        return self

    @classmethod
    def load(cls, path: str) -> "HorovodEstimator":
        """Reload an estimator saved with ``save`` (reference
        ``Estimator.read().load(path)``). Returns an instance of the
        originally-saved class (which must be ``cls`` or a subclass)."""
        import os
        import pickle

        klass = _load_meta_class(cls, path, cls._PERSIST_META, "estimator")
        with open(os.path.join(path, cls._PERSIST_PARAMS), "rb") as f:
            params = pickle.load(f)
        est = klass()
        est._params.update(params)
        return est

    def _validate(self) -> None:
        if self.getOrDefault("model") is None:
            raise ValueError("model is required")
        store = self.getOrDefault("store")
        if store is not None and not isinstance(store, Store):
            raise ValueError(f"store must be a Store, got {type(store)}")
        if not self.getOrDefault("feature_cols"):
            raise ValueError("feature_cols is required")
        if not self.getOrDefault("label_cols"):
            raise ValueError("label_cols is required")

    # -- template method: shared fit orchestration ---------------------------
    # Subclasses implement the three hooks below; the flow (validate →
    # materialize Parquet → run the remote trainer on the backend → load
    # the rank-0 checkpoint) is identical across frameworks (parity:
    # the reference's HorovodEstimator._fit, ``common/estimator.py``).

    _checkpoint_filename = "model.bin"

    def _make_trainer(self, meta, checkpoint_path):
        """Return the zero-arg function executed on every worker."""
        raise NotImplementedError

    def _load_model(self, store, checkpoint_path):
        """Deserialize the trained model from the store checkpoint."""
        raise NotImplementedError

    def _make_model(self, trained, history, run_id, meta):
        """Wrap the trained model in the framework's HorovodModel."""
        raise NotImplementedError

    def fit(self, df):
        """Train on a (pandas or Spark) DataFrame; returns a HorovodModel."""
        import os
        import uuid

        from .backend import LocalBackend
        from .util import prepare_data

        self._validate()
        store = self.getOrDefault("store")
        if store is None:
            raise ValueError("store is required to fit")
        run_id = self.getOrDefault("run_id") or f"run_{uuid.uuid4().hex[:8]}"
        backend = (self.getOrDefault("backend")
                   or getattr(self, "_backend", None)
                   or LocalBackend(self.getOrDefault("num_proc") or 1))

        # partitions_per_process scales the Parquet partition count so
        # each worker shards over several row groups (reference
        # params.py:77-80; default 10 there, 1 here keeps tiny test
        # datasets intact — pass explicitly for production layouts).
        ppp = self.getOrDefault("partitions_per_process") or 1
        meta = prepare_data(
            store, df,
            self.getOrDefault("feature_cols"),
            self.getOrDefault("label_cols"),
            validation=self.getOrDefault("validation"),
            num_partitions=backend.num_processes() * ppp)

        checkpoint = os.path.join(store.get_checkpoint_path(run_id),
                                  self._checkpoint_filename)
        results = backend.run(self._make_trainer(meta, checkpoint))
        history = results[0]["history"]
        trained = self._load_model(store, checkpoint)
        return self._make_model(trained, history, run_id, meta)


class HorovodModel:
    """Trained-model wrapper for batch inference (parity:
    ``common/estimator.py`` HorovodModel)."""

    def __init__(self, model, feature_cols: Optional[List[str]] = None,
                 label_cols: Optional[List[str]] = None,
                 run_id: Optional[str] = None):
        self.model = model
        self.feature_cols = feature_cols
        self.label_cols = label_cols
        self.run_id = run_id

    # -- persistence (the Spark-ML Model read/write role) --------------------

    _PERSIST_META = "model.json"
    _PERSIST_BLOB = "model.pkl"

    def save(self, path: str) -> "HorovodModel":
        """Persist the trained-model wrapper (framework model + columns
        + history/metadata) to a directory; reload with ``load(path)``.
        Keras 3 and torch models both round-trip through cloudpickle."""
        _save_dir(self, self, path, self._PERSIST_META, self._PERSIST_BLOB)
        return self

    @classmethod
    def load(cls, path: str) -> "HorovodModel":
        import os
        import pickle

        # Class gate runs on the json sidecar BEFORE any pickle bytes
        # are touched (unpickling executes arbitrary code).
        _load_meta_class(cls, path, cls._PERSIST_META, "model")
        with open(os.path.join(path, cls._PERSIST_BLOB), "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, cls):
            raise TypeError(
                f"saved model is a {type(obj).__qualname__}, not a "
                f"{cls.__qualname__}")
        return obj

    def transform(self, df):
        from .. import _require_pyspark

        _require_pyspark()
        raise NotImplementedError(
            "batch inference requires pyspark; call model directly for "
            "local inference")
