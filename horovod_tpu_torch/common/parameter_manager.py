"""Autotuning parameter manager: the port's copy of
``horovod_tpu/common/parameter_manager.py`` (parity:
``horovod/common/parameter_manager.{h,cc}``).

Tunes (fusion threshold MB, cycle time ms) online, scoring each sample by
the application bytes its collectives moved per second: warmup samples
are discarded, then ``steps_per_sample`` scored steps for each candidate
that Bayesian optimization proposes, until ``bayes_opt_max_samples``
samples are taken; then the best point is pinned.

Placement: the coordinator (rank 0) plans the fusion, so the tuned
threshold applied there governs the whole job, and the cycle time rides
the response frames to every rank (``NativeCore.set_parameters``); the
hierarchical flags and the stripe count ride the same frames. Before the
numeric phase come categorical grids, each only when it applies: the four
hierarchical-dispatch combos (a world spanning hosts), the cross-host
stripe counts, the compression modes and the ZeRO stage-3 prefetch
depths (each scored like a sample and pinned).

Search space (the reference's): fusion threshold 0-64 MB, cycle time
1-25 ms. The optimizer's seed stays the reference's, so on the same scores
the port proposes the same candidates and pins the same point.
"""

from __future__ import annotations

import time
from typing import Optional

from . import logging as _log
from .optim.bayesian_optimization import BayesianOptimization

MB = 1024 * 1024


class ParameterManager:
    def __init__(self, core, warmup_samples: int = 3,
                 steps_per_sample: int = 10, max_samples: int = 20,
                 gp_noise: float = 0.8, log_file: str = "",
                 initial_cycle_ms: float = 5.0,
                 initial_fusion_bytes: int = 64 * MB,
                 tune_hierarchical: bool = False,
                 bucket_cap_setter=None,
                 compression_setter=None,
                 compression_candidates=(),
                 stripe_candidates=(),
                 zero_prefetch_setter=None,
                 zero_prefetch_candidates=()):
        self._core = core
        # The tuned fusion threshold also governs the optimizer's bucket
        # cap (common/fusion.resolve_bucket_cap("auto")): the setter
        # publishes each applied threshold into the live RuntimeConfig,
        # and optimizers built after it plan their buckets with it.
        self._bucket_cap_setter = bucket_cap_setter
        self._warmup_remaining = warmup_samples
        self._steps_per_sample = steps_per_sample
        self._max_samples = max_samples
        self._bayes = BayesianOptimization(
            # (fusion MB, cycle ms) — reference search space.
            bounds=[(0.0, 64.0), (1.0, 25.0)], alpha=gp_noise ** 2)
        self._log_file = log_file
        self._samples_taken = 0
        self._steps_in_sample = 0
        self._bytes_in_sample = 0
        self._sample_start = time.perf_counter()
        self._current = (initial_fusion_bytes / MB, initial_cycle_ms)
        self._tuning = True
        self._best_score: Optional[float] = None
        # Categorical phase (reference ParameterManager's categorical
        # params, parameter_manager.h:42-246): when a (cross, local) mesh
        # exists, grid-sample the four hierarchical-dispatch combos at the
        # initial numeric params, pin the best, then run the numeric GP.
        # Flags sync to every rank via the response-broadcast piggyback
        # (set_hier_flags -> Controller::set_hier_flags_hint).
        self._cat_combos = [0, 1, 2, 3] if tune_hierarchical else []
        self._cat_scores: dict = {}
        self._cat_best: Optional[int] = None
        # Stripe phase (docs/cross-transport.md): a categorical grid
        # over the cross-host stripe counts — typically (1, K_env),
        # i.e. "does the striping the user configured actually pay on
        # this fabric?" — scored like the hierarchical combos and
        # pinned via core.set_stripes (the frame-synced apply both
        # sides of every leader pair honor at the same boundary, so
        # the candidates are real lock-step A/Bs mid-world). Only
        # populated when the user opted in (HOROVOD_STRIPES > 1) and
        # the hierarchy spans hosts; runs after the hierarchical grid,
        # before compression.
        self._stripe_candidates = (list(stripe_candidates)
                                   if tune_hierarchical else [])
        self._stripe_scores: dict = {}
        self._stripe_best: Optional[int] = None
        # Compression phase (tensor-fusion v2's wire-compression sibling):
        # a categorical grid over the on-wire compression modes —
        # typically ("none", <the configured mode>), i.e. "does the
        # compression the user asked for actually pay on this model?" —
        # scored exactly like the hierarchical combos, pinned via
        # compression_setter (publishes into the live RuntimeConfig so
        # "auto"-built steps pick it up at their next build). Runs after
        # the hierarchical grid and before the numeric GP.
        self._compression_setter = compression_setter
        self._comp_candidates = (list(compression_candidates)
                                 if compression_setter else [])
        self._comp_scores: dict = {}
        self._comp_best: Optional[str] = None
        # Set by _apply_compression only — during an earlier (hier)
        # phase the ambient config's mode is still in force, and the
        # log column shows "-" rather than claiming a mode this tuner
        # has not applied yet.
        self._current_compression: Optional[str] = None
        # Prefetch phase (ZeRO stage-3's gather-overlap depth, zero.py;
        # docs/zero.md): a categorical grid over HOROVOD_ZERO_PREFETCH
        # depths, scored like the other grids and pinned via
        # zero_prefetch_setter (publishes into the live RuntimeConfig,
        # which "auto" stage-3 steps re-resolve each call). Opt-in like
        # the stripe grid: only populated on one-process worlds where
        # stage 3 is in force. Depth never changes numerics — only the
        # dataflow chain between gathers — so every candidate is a safe
        # A/B. Runs last among the categoricals, before the numeric GP.
        self._zero_prefetch_setter = zero_prefetch_setter
        self._pf_candidates = (list(zero_prefetch_candidates)
                               if zero_prefetch_setter else [])
        self._pf_scores: dict = {}
        self._pf_best: Optional[int] = None
        self._log_rows = 0
        if self._cat_combos:
            self._apply_hier(self._cat_combos[0])
        elif self._comp_candidates:
            self._apply_compression(self._comp_candidates[0])
        elif self._pf_candidates:
            self._apply_zero_prefetch(self._pf_candidates[0])
        if log_file:
            with open(log_file, "w") as f:
                f.write("sample,fusion_mb,cycle_ms,hier_flags,compression,"
                        "score_bytes_per_sec\n")

    @property
    def active(self) -> bool:
        return self._tuning

    def update(self, nbytes: int) -> None:
        """Record one completed collective step of ``nbytes`` total bytes
        (parity: ``ParameterManager::Update``)."""
        if not self._tuning:
            return
        self._bytes_in_sample += nbytes
        self._steps_in_sample += 1
        if self._steps_in_sample < self._steps_per_sample:
            return
        elapsed = max(time.perf_counter() - self._sample_start, 1e-6)
        score = self._bytes_in_sample / elapsed
        if self._warmup_remaining > 0:
            # Warmup: discard the score, keep current params
            # (parity: warmup logic parameter_manager.cc:42-150).
            self._warmup_remaining -= 1
        else:
            self._record_sample(score)
        self._steps_in_sample = 0
        self._bytes_in_sample = 0
        self._sample_start = time.perf_counter()

    def _record_sample(self, score: float) -> None:
        fusion_mb, cycle_ms = self._current
        self._log_sample(score)
        # Phase 1: grid over the hierarchical combos (categorical params
        # first, like the reference's categorical exploration), then pin
        # the winner for the numeric GP phase.
        if self._cat_combos:
            combo = self._cat_combos.pop(0)
            self._cat_scores[combo] = score
            if self._cat_combos:
                self._apply_hier(self._cat_combos[0])
                return
            self._cat_best = max(self._cat_scores,
                                 key=self._cat_scores.get)
            self._apply_hier(self._cat_best)
            _log.info(f"autotune: hierarchical flags pinned to "
                      f"{self._cat_best:#04b} "
                      f"({self._cat_scores[self._cat_best] / MB:.1f} MB/s)")
            if self._cat_best == 0:
                # No hierarchical leg won: there is no cross leader leg
                # for stripes to carry, so the stripe grid would score
                # noise against noise.
                self._stripe_candidates = []
            if self._stripe_candidates:
                self._apply_stripes(self._stripe_candidates[0])
            elif self._comp_candidates:
                self._apply_compression(self._comp_candidates[0])
            elif self._pf_candidates:
                self._apply_zero_prefetch(self._pf_candidates[0])
            return
        # Phase 1a': grid over the cross-host stripe counts, pin the
        # winner (each candidate is applied frame-synced on every rank,
        # so both sides of every leader pair renegotiate in lock-step
        # before the sample is scored).
        if self._stripe_candidates:
            k = self._stripe_candidates.pop(0)
            self._stripe_scores[k] = score
            if self._stripe_candidates:
                self._apply_stripes(self._stripe_candidates[0])
                return
            self._stripe_best = max(self._stripe_scores,
                                    key=self._stripe_scores.get)
            self._apply_stripes(self._stripe_best)
            _log.info(
                f"autotune: cross-host stripes pinned to "
                f"{self._stripe_best} "
                f"({self._stripe_scores[self._stripe_best] / MB:.1f} "
                f"MB/s)")
            if self._comp_candidates:
                self._apply_compression(self._comp_candidates[0])
            elif self._pf_candidates:
                self._apply_zero_prefetch(self._pf_candidates[0])
            return
        # Phase 1b: grid over the compression modes, pin the winner.
        if self._comp_candidates:
            mode = self._comp_candidates.pop(0)
            self._comp_scores[mode] = score
            if self._comp_candidates:
                self._apply_compression(self._comp_candidates[0])
                return
            self._comp_best = max(self._comp_scores,
                                  key=self._comp_scores.get)
            self._apply_compression(self._comp_best)
            _log.info(
                f"autotune: compression pinned to {self._comp_best!r} "
                f"({self._comp_scores[self._comp_best] / MB:.1f} MB/s)")
            if self._pf_candidates:
                self._apply_zero_prefetch(self._pf_candidates[0])
            return
        # Phase 1c: grid over the ZeRO stage-3 gather prefetch depths,
        # pin the winner.
        if self._pf_candidates:
            depth = self._pf_candidates.pop(0)
            self._pf_scores[depth] = score
            if self._pf_candidates:
                self._apply_zero_prefetch(self._pf_candidates[0])
                return
            self._pf_best = max(self._pf_scores,
                                key=self._pf_scores.get)
            self._apply_zero_prefetch(self._pf_best)
            _log.info(
                f"autotune: zero-3 prefetch depth pinned to "
                f"{self._pf_best} "
                f"({self._pf_scores[self._pf_best] / MB:.1f} MB/s)")
            return
        # Phase 2: numeric GP over (fusion, cycle).
        self._bayes.add_sample([fusion_mb, cycle_ms], score)
        self._samples_taken += 1
        if self._samples_taken >= self._max_samples:
            best_x, best_y = self._bayes.best()
            self._tuning = False
            self._best_score = best_y
            self._apply(best_x[0], best_x[1])
            _log.info(
                f"autotune converged: fusion={best_x[0]:.1f}MB "
                f"cycle={best_x[1]:.1f}ms ({best_y / MB:.1f} MB/s)")
            return
        nxt = self._bayes.suggest()
        self._apply(nxt[0], nxt[1])

    def _log_sample(self, score: float) -> None:
        if not self._log_file:
            return
        self._log_rows += 1
        fusion_mb, cycle_ms = self._current
        hier = self._cat_combos[0] if self._cat_combos else \
            (self._cat_best if self._cat_best is not None else -1)
        comp = self._current_compression or "-"
        with open(self._log_file, "a") as f:
            f.write(f"{self._log_rows},{fusion_mb:.2f},"
                    f"{cycle_ms:.2f},{hier},{comp},{score:.0f}\n")

    def _apply(self, fusion_mb: float, cycle_ms: float) -> None:
        self._current = (float(fusion_mb), float(cycle_ms))
        if self._core is not None:
            self._core.set_parameters(
                cycle_time_ms=float(cycle_ms),
                fusion_threshold=int(fusion_mb * MB))
        if self._bucket_cap_setter is not None:
            self._bucket_cap_setter(int(fusion_mb * MB))

    def _apply_hier(self, flags: int) -> None:
        if self._core is not None:
            self._core.set_hier_flags(int(flags))

    def _apply_stripes(self, stripes: int) -> None:
        if self._core is not None:
            self._core.set_stripes(int(stripes))

    def _apply_compression(self, mode: str) -> None:
        self._current_compression = mode
        if self._compression_setter is not None:
            self._compression_setter(mode)

    def _apply_zero_prefetch(self, depth: int) -> None:
        if self._zero_prefetch_setter is not None:
            self._zero_prefetch_setter(int(depth))

    # introspection
    @property
    def current(self):
        return self._current

    @property
    def samples_taken(self) -> int:
        return self._samples_taken

    @property
    def hier_flags(self) -> Optional[int]:
        """The pinned categorical decision (None before phase 1 ends)."""
        return self._cat_best

    @property
    def stripes(self) -> Optional[int]:
        """The pinned cross-host stripe count (None before the stripe
        grid ends or when it never ran)."""
        return self._stripe_best

    @property
    def compression(self) -> Optional[str]:
        """The pinned compression mode (None before phase 1b ends)."""
        return self._comp_best

    @property
    def zero_prefetch(self) -> Optional[int]:
        """The pinned stage-3 gather prefetch depth (None before the
        prefetch grid ends or when it never ran)."""
        return self._pf_best
