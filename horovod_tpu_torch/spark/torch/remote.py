"""The torch estimator's training function, run on every worker (the
port's copy of ``horovod_tpu/spark/torch/remote.py``, after upstream
Horovod's ``spark/torch/remote.py``).

It reads this rank's Parquet shard, wraps the optimizer in
``horovod_tpu_torch.torch.DistributedOptimizer``, broadcasts the initial
state from rank 0 and checkpoints on rank 0. The model and the batches
live on ``device``: ``cuda:<local rank>`` unless the estimator was given
another (``"cpu"``), and a rank whose GPU is missing raises.
"""

from __future__ import annotations

import io
import os
from typing import Dict


def make_remote_trainer(model_bytes: bytes, optimizer_cls, optimizer_kwargs,
                        loss_fns, batch_size: int, epochs: int, meta: Dict,
                        checkpoint_path: str, verbose: int = 0,
                        shuffle: bool = True, train_minibatch_fn=None,
                        sample_weight_col=None, transformation_fn=None,
                        gradient_compression=None, input_shapes=None,
                        train_reader_num_workers=None, device=None):
    def trainer():
        import numpy as np
        import torch

        import horovod_tpu_torch.torch as hvd
        from ...common import state as _state
        from ..common.reader import ShardReader

        hvd.init(device=device)
        try:
            dev = _state.device()

            def features(arrays):
                xs = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                      for a in arrays]
                if input_shapes:
                    # Shapes with the batch dimension as -1 (e.g.
                    # [[-1, 1, 28, 28]]), as upstream Horovod's.
                    xs = [t.reshape(tuple(s))
                          for t, s in zip(xs, input_shapes)]
                return xs

            def labels(arrays):
                return [torch.as_tensor(np.asarray(a), device=dev)
                        for a in arrays]

            model = torch.load(io.BytesIO(model_bytes), weights_only=False,
                               map_location=dev)
            # On the device before the optimizer is built: the optimizer
            # keeps the parameters it is given.
            model.to(dev)
            optimizer = optimizer_cls(model.parameters(), **optimizer_kwargs)
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            hvd.broadcast_optimizer_state(optimizer, root_rank=0)
            optimizer = hvd.DistributedOptimizer(
                optimizer, named_parameters=model.named_parameters(),
                compression=(gradient_compression
                             or hvd.Compression.none))

            # Streams the shard with one window of row groups resident
            # (the role of Petastorm in upstream Horovod's trainer).
            reader = ShardReader(
                meta["train_data_path"], meta, hvd.rank(), hvd.size(),
                batch_size=batch_size, shuffle=shuffle,
                transform_fn=transformation_fn,
                sample_weight_col=sample_weight_col,
                num_workers=train_reader_num_workers or 0)
            if reader.rows == 0:
                # A rank without steps would skip the gradient allreduces
                # that the others submit, and the world would hang.
                raise ValueError(
                    f"rank {hvd.rank()}'s training shard is empty: the "
                    "dataset has fewer row groups than workers; increase "
                    "num_partitions (or reduce the world size)")

            # The validation shard, read whole. Whether it takes part is
            # decided by meta['val_data_path'], the same on every rank, so
            # the epoch's validation collectives match even where a shard
            # is empty (it adds 0 rows to the weighted mean).
            has_val = bool(meta.get("val_data_path"))
            val = None
            if has_val:
                from ..common.util import read_val_arrays

                arrays = read_val_arrays(meta, hvd.rank(), hvd.size(),
                                         transformation_fn)
                if arrays is not None:
                    val = (features(arrays[0]), labels(arrays[1]))

            def evaluate_val():
                """(row-weighted loss sum, rows) for the global mean, in
                batches; an empty shard gives (0, 0)."""
                if val is None:
                    return 0.0, 0.0
                model.eval()
                total, rows = 0.0, 0
                n = len(val[1][0])
                with torch.no_grad():
                    for s in range(0, n, batch_size):
                        bx = [t[s:s + batch_size] for t in val[0]]
                        by = [t[s:s + batch_size] for t in val[1]]
                        out = model(*bx)
                        outs = (out if isinstance(out, (list, tuple))
                                else [out])
                        b = len(by[0])
                        total += b * sum(float(fn(o, y)) for fn, o, y
                                         in zip(loss_fns, outs, by))
                        rows += b
                model.train()
                return total, float(rows)

            history = []
            val_history = []
            model.train()
            for epoch in range(epochs):
                total, steps = 0.0, 0
                for batch in reader.batches(epoch):
                    bx = features(batch[0])
                    by = labels(batch[1])
                    optimizer.zero_grad()
                    if train_minibatch_fn is not None:
                        loss = train_minibatch_fn(model, optimizer, bx, by)
                    else:
                        out = model(*bx)
                        outs = out if isinstance(out, (list, tuple)) else [out]
                        if sample_weight_col:
                            # Each row's loss scaled by its weight, then
                            # the batch mean (upstream Horovod's
                            # calculate_loss): the loss must take
                            # reduction='none', as functional losses do.
                            wt = torch.as_tensor(
                                np.asarray(batch[2][0], np.float32),
                                device=dev)
                            try:
                                losses = [
                                    (fn(o, y, reduction="none").flatten()
                                     * wt).mean()
                                    for fn, o, y in zip(loss_fns, outs, by)]
                            except TypeError as e:
                                raise TypeError(
                                    "sample_weight_col requires loss "
                                    "functions accepting "
                                    "reduction='none' (use functional "
                                    "losses like torch.nn.functional."
                                    "mse_loss)") from e
                        else:
                            losses = [fn(o, y) for fn, o, y
                                      in zip(loss_fns, outs, by)]
                        loss = sum(losses)
                        loss.backward()
                        optimizer.step()
                    total += float(loss.detach())
                    steps += 1
                avg = hvd.allreduce(
                    torch.tensor(total / max(1, steps), device=dev),
                    name=f"epoch_loss.{epoch}", op=hvd.Average)
                history.append(float(avg))
                if has_val:
                    lw, rows = evaluate_val()
                    sums = hvd.allreduce(
                        torch.tensor([lw, rows], device=dev),
                        name=f"epoch_val_loss.{epoch}", op=hvd.Sum)
                    val_history.append(
                        float(sums[0]) / max(1.0, float(sums[1])))
                if verbose and hvd.rank() == 0:
                    tail = (f" val_loss={val_history[-1]:.5f}"
                            if val_history else "")
                    print(f"epoch {epoch}: loss={float(avg):.5f}{tail}")

            result = {"history": {"loss": history}}
            if val_history:
                result["history"]["val_loss"] = val_history
            if hvd.rank() == 0:
                os.makedirs(os.path.dirname(checkpoint_path), exist_ok=True)
                torch.save(model, checkpoint_path)
                result["checkpoint"] = checkpoint_path
            return result
        finally:
            hvd.shutdown()

    return trainer
