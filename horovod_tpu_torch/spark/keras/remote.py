"""The Keras estimator's training function, run on every worker (the
port's copy of ``horovod_tpu/spark/keras/remote.py``, after upstream
Horovod's ``spark/keras/remote.py`` ``RemoteTrainer``).

Upstream Horovod reads the store's Parquet shards through Petastorm; here
the pyarrow row-group shard reader does, and the collectives are the
port's Keras binding, ``horovod_tpu_torch.keras``.
"""

from __future__ import annotations

import os
from typing import Dict


def make_remote_trainer(serialized_model: bytes, optimizer_bytes,
                        loss, metrics, batch_size: int, epochs: int,
                        meta: Dict, checkpoint_path: str,
                        custom_objects=None, verbose: int = 0,
                        shuffle_buffer_size: int = 0,
                        train_steps_per_epoch=None,
                        validation_steps_per_epoch=None,
                        callbacks=None, loss_weights=None,
                        sample_weight_col=None, transformation_fn=None,
                        gradient_compression=None,
                        train_reader_num_workers=None):
    """Build the function executed on every worker."""

    def trainer():
        import horovod_tpu_torch.keras as hvd
        from ..common.reader import ShardReader
        from .util import deserialize_model

        hvd.init()
        try:
            model = deserialize_model(serialized_model,
                                      custom_objects=custom_objects)
            opt = model.optimizer
            if optimizer_bytes is not None:
                from .util import deserialize_optimizer
                opt = deserialize_optimizer(optimizer_bytes)
            plain_opt = opt  # kept for the wrapper-free checkpoint below
            opt = hvd.DistributedOptimizer(
                opt, compression=(gradient_compression
                                  or hvd.Compression.none))
            model.compile(optimizer=opt, loss=loss,
                          loss_weights=loss_weights,
                          metrics=metrics or None)

            # Streaming shard reader (the reference streams through
            # Petastorm make_keras_dataset; bounded memory per worker).
            reader = ShardReader(
                meta["train_data_path"], meta, hvd.rank(), hvd.size(),
                batch_size=batch_size, shuffle=bool(shuffle_buffer_size),
                transform_fn=transformation_fn,
                sample_weight_col=sample_weight_col,
                num_workers=train_reader_num_workers or 0)
            if reader.rows == 0:
                # Fail loudly (the launcher aborts the job) rather than
                # spin in fit() waiting for batches that never come.
                raise ValueError(
                    f"rank {hvd.rank()}'s training shard is empty: the "
                    "dataset has fewer row groups than workers; increase "
                    "num_partitions (or reduce the world size)")

            def unwrap(cols):
                return cols[0] if len(cols) == 1 else tuple(cols)

            def gen():
                epoch = 0
                while True:  # keras pulls steps_per_epoch * epochs batches
                    for batch in reader.batches(epoch):
                        if sample_weight_col:
                            xs, ys, ws = batch
                            yield unwrap(xs), unwrap(ys), ws[0]
                        else:
                            xs, ys = batch
                            yield unwrap(xs), unwrap(ys)
                    epoch += 1

            # Validation is evaluated whole (fit holds it in memory
            # anyway), so the simple whole-shard read serves it; only the
            # training pass streams.
            val = None
            from ..common.util import read_val_arrays

            # Same transform as the training stream — val metrics on
            # untransformed data would be garbage (shared helper with
            # the torch remote).
            arrays = read_val_arrays(meta, hvd.rank(), hvd.size(),
                                     transformation_fn)
            if arrays is not None:
                val = (unwrap(arrays[0]), unwrap(arrays[1]))

            cbs = [hvd.callbacks.BroadcastGlobalVariablesCallback(0),
                   hvd.callbacks.MetricAverageCallback()]
            cbs.extend(callbacks or [])

            history = model.fit(
                gen(), epochs=epochs,
                steps_per_epoch=(train_steps_per_epoch
                                 or reader.steps_per_epoch()),
                validation_data=val, verbose=verbose, callbacks=cbs,
                validation_steps=validation_steps_per_epoch)

            result = {"history": {k: [float(v) for v in vs]
                                  for k, vs in history.history.items()}}
            if hvd.rank() == 0:
                os.makedirs(os.path.dirname(checkpoint_path), exist_ok=True)
                # Strip the dynamic Distributed* wrapper before saving so
                # the archive deserializes anywhere (the reference's
                # serialization.py plays the same role).
                model.compile(
                    optimizer=type(plain_opt).from_config(opt.get_config()),
                    loss=loss, loss_weights=loss_weights,
                    metrics=metrics or None)
                model.save(checkpoint_path)
                result["checkpoint"] = checkpoint_path
            return result
        finally:
            hvd.shutdown()

    return trainer
