"""Streaming Parquet shard reader — the Petastorm role.

Upstream Horovod's estimator remote trainers stream training data through
Petastorm readers over the store's Parquet shards
(``horovod/spark/keras/remote.py``, ``horovod/spark/torch/remote.py``)
rather than materializing a shard in memory. ``ShardReader`` plays that
role without Petastorm (the port's copy of
``horovod_tpu/spark/common/reader.py``): row groups are the sharding unit
(round-robin by global row-group index, disjoint per rank, full
coverage), one row group is resident at a time, and an optional
shuffle window mixes rows across nearby row groups — Petastorm's
``shuffle_row_groups`` + row buffer, bounded memory either way.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ShardReader:
    """Iterates this rank's shard of a Parquet dataset in batches.

    Yields ``(features, labels)`` — lists of np arrays stacked per column
    (same layout as ``util.to_arrays``) of ``batch_size`` rows (the final
    batch may be short). Re-iterable: each ``batches(epoch)`` pass
    re-reads from disk, with per-epoch shuffle order.
    """

    def __init__(self, path: str, meta: Dict, rank: int = 0, size: int = 1,
                 batch_size: int = 32, shuffle: bool = True,
                 shuffle_window_row_groups: int = 4,
                 columns: Optional[Sequence[str]] = None,
                 transform_fn=None, sample_weight_col: Optional[str] = None,
                 num_workers: int = 0):
        """``transform_fn(pdf) -> pdf`` is applied to each row group's
        pandas frame before batching — the Estimator ``transformation_fn``
        hook (the role Petastorm's TransformSpec plays in the reference's
        remote trainers). ``sample_weight_col`` adds a third per-batch
        array of per-row weights (reference ``sample_weight_col`` param).
        ``num_workers`` > 0 prefetches+decodes row groups on that many
        background threads (the ``train_reader_num_workers`` /
        ``val_reader_num_workers`` role — Petastorm's reader pool), with
        a bounded queue so memory stays at O(workers) row groups; 0 reads
        synchronously.
        """
        import pyarrow.parquet as pq

        self._pq = pq
        self._meta = meta
        self._batch = batch_size
        self._shuffle = shuffle
        self._window = max(1, shuffle_window_row_groups)
        self._transform = transform_fn
        self._weight_col = sample_weight_col
        self._num_workers = max(0, int(num_workers or 0))
        self._feature_cols = list(meta["feature_cols"])
        self._label_cols = list(meta["label_cols"])
        self._columns = (list(columns) if columns is not None
                         else self._feature_cols + self._label_cols)
        if sample_weight_col and sample_weight_col not in self._columns:
            self._columns.append(sample_weight_col)
        # This rank's (filename, row_group) list — the single sharding
        # rule lives in util.iter_shard_groups. Filenames, not handles:
        # files open lazily during iteration so descriptor count stays
        # O(1) regardless of partition count.
        from .util import iter_shard_groups

        self._groups: List[Tuple[str, int]] = []
        self._rows = 0
        for fname, rg, rows in iter_shard_groups(path, rank, size):
            self._groups.append((fname, rg))
            self._rows += rows

    @property
    def rows(self) -> int:
        """Rows in this rank's shard (known without reading data)."""
        return self._rows

    def steps_per_epoch(self) -> int:
        return max(1, int(np.ceil(self._rows / self._batch)))

    def _group_arrays(self, table) -> List[List[np.ndarray]]:
        # Decode through to_arrays (shared layout contract with the
        # whole-shard path) — pandas/pyarrow convert columns at C speed;
        # per-cell Python conversion would dominate epoch time. One
        # to_pandas per row group; the transformation_fn hook sees the
        # frame before any array extraction.
        from .util import to_arrays

        pdf = table.to_pandas()
        if self._transform is not None:
            pdf = self._transform(pdf)
        cols = [to_arrays(pdf, self._feature_cols, self._meta),
                to_arrays(pdf, self._label_cols, self._meta)]
        if self._weight_col:
            cols.append([np.asarray(pdf[self._weight_col])])
        return cols

    def _read_decode(self, group, tls):
        """Read + transform + decode one (file, row_group); returns
        (arrays, n_rows). Used from reader worker threads, so the
        transform_fn must be thread-safe when num_workers > 0. ``tls``
        is a threading.local carrying a per-worker {fname: ParquetFile}
        handle cache (one footer parse per file per worker, matching
        the synchronous path's cost profile)."""
        fname, rg = group
        cache = getattr(tls, "files", None)
        if cache is None:
            cache = tls.files = {}
        pf = cache.get(fname)
        if pf is None:
            pf = cache[fname] = self._pq.ParquetFile(fname)
        table = pf.read_row_group(rg, columns=self._columns)
        arrays = self._group_arrays(table)
        n_rows = len(arrays[1][0]) if arrays[1] else table.num_rows
        return arrays, n_rows

    def _iter_group_arrays(self, order):
        """Yield (arrays, n_rows) per row group in ``order``. With
        ``num_workers`` > 0, reads+decodes run ahead on a thread pool
        with bounded in-flight work (the Petastorm reader-pool role);
        results always arrive in order."""
        if self._num_workers <= 0:
            cache = {"name": None, "pf": None}  # one open file at a time
            for i in order:
                fname, rg = self._groups[i]
                if cache["name"] != fname:
                    cache["name"] = fname
                    cache["pf"] = self._pq.ParquetFile(fname)
                table = cache["pf"].read_row_group(
                    rg, columns=self._columns)
                arrays = self._group_arrays(table)
                n_rows = (len(arrays[1][0]) if arrays[1]
                          else table.num_rows)
                yield arrays, n_rows
            return
        import collections
        import concurrent.futures
        import threading

        tls = threading.local()
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._num_workers)
        pending = collections.deque()
        it = iter(order)

        def submit_next():
            try:
                i = next(it)
            except StopIteration:
                return
            pending.append(
                pool.submit(self._read_decode, self._groups[i], tls))

        try:
            for _ in range(self._num_workers + 1):
                submit_next()
            while pending:
                result = pending.popleft().result()
                submit_next()
                yield result
        finally:
            # An abandoned epoch (fit pulling fewer steps than the
            # shard holds) must not block on — or waste — the
            # prefetched reads: drop queued work, don't wait.
            pool.shutdown(wait=False, cancel_futures=True)

    def batches(self, epoch: int = 0
                ) -> Iterator[Tuple[List[np.ndarray], ...]]:
        """One pass over the shard, yielding ``(features, labels)`` — or
        ``(features, labels, [weights])`` with ``sample_weight_col`` —
        per batch. Bounded memory: at most ``shuffle_window_row_groups``
        (+ prefetch depth) row groups resident."""
        rng = np.random.RandomState(epoch)
        order = (rng.permutation(len(self._groups)) if self._shuffle
                 else np.arange(len(self._groups)))

        n_streams = 3 if self._weight_col else 2
        bufs: List[List[List[np.ndarray]]] = [[] for _ in range(n_streams)]
        buffered = 0

        def drain(final=False):
            nonlocal bufs, buffered
            if buffered == 0:
                return
            streams = [
                [np.concatenate([b[c] for b in bufs[s]])
                 for c in range(len(bufs[s][0]))]
                for s in range(n_streams)
            ]
            if self._shuffle:
                perm = rng.permutation(buffered)
                streams = [[a[perm] for a in s] for s in streams]
            n = buffered
            start = 0
            while start < n:
                end = min(start + self._batch, n)
                if not final and n - start < self._batch:
                    # Carry the remainder into the next window so only the
                    # epoch's last batch can be short.
                    bufs = [[[a[start:] for a in s]] for s in streams]
                    buffered = n - start
                    return
                yield tuple([a[start:end] for a in s] for s in streams)
                start = end
            bufs, buffered = [[] for _ in range(n_streams)], 0

        for arrays, n_rows in self._iter_group_arrays(order):
            for s in range(n_streams):
                bufs[s].append(arrays[s])
            buffered += n_rows
            if len(bufs[0]) >= self._window:
                yield from drain(final=False)
        yield from drain(final=True)
