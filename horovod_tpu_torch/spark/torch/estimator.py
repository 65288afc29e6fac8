"""The torch Spark ML estimator (the port's copy of
``horovod_tpu/spark/torch/estimator.py``, after upstream Horovod's
``spark/torch/estimator.py`` TorchEstimator and TorchModel).

The port's one addition to the surface is the ``device`` param: where the
trainer on every worker and ``TorchModel.transform`` compute. It defaults
to ``cuda:<local rank>`` (raising where that GPU is missing); ``"cpu"``
asks for the CPU, as ``hvd.init(device="cpu")`` does.
"""

from __future__ import annotations

import io
from typing import Optional

from ..common.backend import Backend
from ..common.estimator import (HorovodEstimator, HorovodModel,
                                install_accessors)
from ..common.store import Store
from ..common.util import to_arrays
from .remote import make_remote_trainer


def _device(device):
    from ...common.state import resolve_device

    return resolve_device(device)


class TorchEstimator(HorovodEstimator):
    """Train a torch ``nn.Module`` over Parquet data in a Store.

    The params are upstream Horovod's (model, optimizer as an instance or a
    (class, kwargs) pair, loss with one function a label column,
    loss_constructors, input_shapes, feature_cols, label_cols,
    sample_weight_col, gradient_compression, batch_size, epochs,
    validation, transformation_fn, store, num_proc, train_minibatch_fn),
    and ``device``; each has its camelCase accessor pair.
    """

    _EXTRA_PARAM_DEFS = {
        "input_shapes": ("InputShapes", None),
        "train_minibatch_fn": ("TrainMinibatchFn", None),
        "device": ("Device", None),
    }

    def __init__(self, model=None, optimizer=None, loss=None,
                 loss_constructors=None, feature_cols=None, label_cols=None,
                 input_shapes=None, batch_size: int = 32, epochs: int = 1,
                 validation=None, store: Optional[Store] = None,
                 num_proc: Optional[int] = None,
                 backend: Optional[Backend] = None, verbose: int = 0,
                 shuffle_buffer_size: int = 0, train_minibatch_fn=None,
                 sample_weight_col=None, run_id: Optional[str] = None,
                 device=None, **kwargs):
        super().__init__(model=model, loss=loss,
                         loss_constructors=loss_constructors,
                         feature_cols=feature_cols, label_cols=label_cols,
                         batch_size=batch_size, epochs=epochs,
                         validation=validation, store=store,
                         num_proc=num_proc, verbose=verbose,
                         optimizer=optimizer, backend=backend,
                         input_shapes=input_shapes,
                         train_minibatch_fn=train_minibatch_fn,
                         shuffle_buffer_size=shuffle_buffer_size,
                         sample_weight_col=sample_weight_col,
                         run_id=run_id, device=device, **kwargs)
        self._backend = backend

    def _optimizer_spec(self):
        """(class, kwargs) to build the optimizer again over the model's
        parameters on each worker."""
        import torch

        opt = self.getOrDefault("optimizer")
        if isinstance(opt, torch.optim.Optimizer):
            kwargs = {k: v for k, v in opt.defaults.items()}
            return type(opt), kwargs
        if isinstance(opt, tuple) and len(opt) == 2:
            return opt
        raise ValueError(
            "optimizer must be a torch.optim.Optimizer instance or a "
            "(class, kwargs) tuple")

    _checkpoint_filename = "model.pt"

    def _make_trainer(self, meta, checkpoint_path):
        import torch

        loss = self.getOrDefault("loss")
        loss_fns = loss if isinstance(loss, (list, tuple)) else [loss]
        if self.getOrDefault("loss_constructors"):
            loss_fns = [c() for c in self.getOrDefault("loss_constructors")]

        buf = io.BytesIO()
        torch.save(self.getOrDefault("model"), buf)
        opt_cls, opt_kwargs = self._optimizer_spec()
        return make_remote_trainer(
            buf.getvalue(), opt_cls, opt_kwargs, loss_fns,
            self.getOrDefault("batch_size"), self.getOrDefault("epochs"),
            meta, checkpoint_path, verbose=self.getOrDefault("verbose"),
            train_minibatch_fn=self.getOrDefault("train_minibatch_fn"),
            sample_weight_col=self.getOrDefault("sample_weight_col"),
            transformation_fn=self.getOrDefault("transformation_fn"),
            gradient_compression=self.getOrDefault("gradient_compression"),
            input_shapes=self.getOrDefault("input_shapes"),
            train_reader_num_workers=self.getOrDefault(
                "train_reader_num_workers"),
            device=self.getOrDefault("device"))

    def _load_model(self, store, checkpoint_path):
        import torch

        return torch.load(io.BytesIO(store.read(checkpoint_path)),
                          weights_only=False,
                          map_location=_device(self.getOrDefault("device")))

    def _make_model(self, trained, history, run_id, meta) -> "TorchModel":
        return TorchModel(model=trained,
                          feature_cols=self.getOrDefault("feature_cols"),
                          label_cols=self.getOrDefault("label_cols"),
                          run_id=run_id, history=history, _metadata=meta,
                          input_shapes=self.getOrDefault("input_shapes"),
                          device=self.getOrDefault("device"))


install_accessors(TorchEstimator)


class TorchModel(HorovodModel):
    """The trained model (upstream Horovod's ``TorchModel``); ``transform``
    computes on ``device`` (``cuda:<local rank>`` unless given)."""

    def __init__(self, model=None, feature_cols=None, label_cols=None,
                 run_id=None, history=None, _metadata=None,
                 input_shapes=None, device=None):
        super().__init__(model, feature_cols, label_cols, run_id)
        self.history = history
        self._metadata = _metadata
        self.input_shapes = input_shapes
        self.device = device

    def transform(self, df):
        """The DataFrame with a ``<label>__output`` prediction column a
        label (pandas in and out)."""
        import numpy as np
        import torch

        from ..common.util import _to_pandas

        dev = _device(self.device)
        pdf = _to_pandas(df).copy()
        meta = self._metadata
        xs = to_arrays(pdf, self.feature_cols, meta)
        tx = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in xs]
        if self.input_shapes:
            tx = [t.reshape(tuple(s))
                  for t, s in zip(tx, self.input_shapes)]
        self.model.to(dev)
        self.model.eval()
        with torch.no_grad():
            out = self.model(*tx)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for col, p in zip(self.label_cols, outs):
            p = p.cpu().numpy()
            pdf[f"{col}__output"] = (
                list(p) if p.ndim > 1 and p.shape[-1] > 1 else p.reshape(-1))
        return pdf
