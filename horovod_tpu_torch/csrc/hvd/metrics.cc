#include "metrics.h"

#include <chrono>
#include <cstdio>

#include "env_util.h"

namespace hvd {
namespace metrics {

namespace {
// Index-aligned with HistId. Names are the snapshot/exporter contract
// (docs/metrics.md) — renaming one is a breaking observability change.
const char* kHistNames[kNumHistograms] = {
    "enq_to_neg_allreduce_us",
    "enq_to_neg_allgather_us",
    "enq_to_neg_broadcast_us",
    "enq_to_neg_other_us",
    "neg_to_done_allreduce_us",
    "neg_to_done_allgather_us",
    "neg_to_done_broadcast_us",
    "neg_to_done_other_us",
    "cycle_us",
    "gather_wait_us",
    "rank_skew_us",
    "cross_leg_us",
    "shm_leg_us",
    "stripe_leg_us",
    "leader_agg_us",
    "fanout_us",
};
constexpr size_t kMaxEvents = 64;
}  // namespace

const char* HistName(int id) {
  return (id >= 0 && id < kNumHistograms) ? kHistNames[id] : "unknown";
}

int64_t MonoNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- StragglerDetector -----------------------------------------------------

void StragglerDetector::Configure(int world_size, double threshold_ms,
                                  int patience) {
  MutexLock lk(mu_);
  ConfigureLocked(world_size, threshold_ms, patience);
}

void StragglerDetector::ConfigureLocked(int world_size, double threshold_ms,
                                        int patience) {
  threshold_ms_ = threshold_ms > 0 ? threshold_ms : 100.0;
  patience_ = patience > 0 ? patience : 3;
  ewma_ms_.assign(world_size > 0 ? world_size : 0, 0.0);
  last_ = -1;
  consecutive_ = 0;
  events_.clear();
  warnings_.store(0, std::memory_order_relaxed);
  last_rank_.store(-1, std::memory_order_relaxed);
  last_lag_ms_.store(0.0, std::memory_order_relaxed);
}

void StragglerDetector::Reset() {
  // First violation the -Wthread-safety pass surfaced: the old body
  // passed threshold_ms_/patience_ to Configure() by value, reading the
  // GUARDED_BY(mu_) fields lock-free against ObserveGroup's writes.
  MutexLock lk(mu_);
  ConfigureLocked(0, threshold_ms_, patience_);
}

void StragglerDetector::ObserveGroup(
    const std::vector<std::pair<int, double>>& lags_ms) {
  // One group = one tensor became globally ready; lag is each rank's
  // arrival minus the group's earliest. Needs >= 2 distinct ranks to say
  // anything about skew.
  if (lags_ms.size() < 2) return;
  MutexLock lk(mu_);
  int worst = -1;
  double worst_lag = -1.0;
  for (const auto& rl : lags_ms) {
    int r = rl.first;
    if (r < 0) continue;
    if (r >= static_cast<int>(ewma_ms_.size())) {
      ewma_ms_.resize(r + 1, 0.0);
    }
    ewma_ms_[r] = alpha_ * rl.second + (1.0 - alpha_) * ewma_ms_[r];
    if (rl.second > worst_lag) {
      worst_lag = rl.second;
      worst = r;
    }
  }
  if (worst < 0) return;
  if (worst == last_) {
    ++consecutive_;
  } else {
    last_ = worst;
    consecutive_ = 1;
  }
  if (consecutive_ >= patience_ && ewma_ms_[worst] >= threshold_ms_) {
    consecutive_ = 0;  // re-arm: a persistent straggler re-fires, bounded
    double lag = ewma_ms_[worst];
    warnings_.fetch_add(1, std::memory_order_relaxed);
    last_rank_.store(worst, std::memory_order_relaxed);
    last_lag_ms_.store(lag, std::memory_order_relaxed);
    if (events_.size() < kMaxEvents) {
      events_.push_back({worst, lag});
    }
    std::fprintf(stderr,
                 "[horovod_tpu metrics] STRAGGLER_WARNING rank=%d "
                 "lag_ms=%.1f (ewma over ready groups; threshold %.0f ms, "
                 "patience %d)\n",
                 worst, lag, threshold_ms_, patience_);
  }
}

std::vector<double> StragglerDetector::EwmaMs() const {
  MutexLock lk(mu_);
  return ewma_ms_;
}

std::vector<StragglerEvent> StragglerDetector::DrainEvents() {
  MutexLock lk(mu_);
  std::vector<StragglerEvent> out;
  out.swap(events_);
  return out;
}

void StragglerDetector::RestoreEvents(
    std::vector<StragglerEvent> undelivered) {
  MutexLock lk(mu_);
  undelivered.insert(undelivered.end(), events_.begin(), events_.end());
  events_ = std::move(undelivered);
  if (events_.size() > kMaxEvents) events_.resize(kMaxEvents);
}

// ---- Registry --------------------------------------------------------------

Registry& Registry::Get() {
  // Immortal, like GlobalState: a monitor thread may poll the registry
  // after (or racing) hvd_shutdown, so it is never destroyed.
  static Registry* r = new Registry();
  return *r;
}

void Registry::ResetForWorld(int world_size) {
  for (auto& h : hists_) h.Reset();
  cycles_.store(0, std::memory_order_relaxed);
  // Clamp exactly like the Python accessors (config.straggler_ms /
  // straggler_patience: unparseable -> default, then floor 1) so the
  // documented knob surface and the detector that consumes it agree —
  // PATIENCE=0 means "every group may warn", not a silent 3.
  long long thr = EnvLL("HOROVOD_STRAGGLER_MS", 100);
  if (thr < 1) thr = 1;
  long long pat = EnvLL("HOROVOD_STRAGGLER_PATIENCE", 3);
  if (pat < 1) pat = 1;
  straggler_.Configure(world_size, static_cast<double>(thr),
                       static_cast<int>(pat));
}

}  // namespace metrics
}  // namespace hvd
