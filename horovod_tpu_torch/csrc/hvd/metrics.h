// Unified native metrics registry (docs/metrics.md).
//
// One process-wide registry of lock-cheap counters and fixed-bucket
// log2 histograms, snapshotted as JSON through the single
// hvd_metrics_snapshot getter (operations.cc) — ending the
// getter-per-counter growth pattern the earlier observability work fell
// into (hvd_ring_local_bytes, hvd_ring_cross_bytes, hvd_ring_shm_bytes,
// hvd_ring_stripe_bytes, hvd_ring_cross_ns, ... one extern "C" symbol
// each). Existing getters stay, but every NEW measurement lands only in
// the registry and travels only through the snapshot.
//
// The registry is an immortal function-local static touched from the
// background cycle thread, the controller gather, the ring data plane,
// and arbitrary API/monitor threads: every hot-path mutation is a
// relaxed atomic add (the getter-race class is designed out,
// not patched out). The straggler detector serializes on its own mutex —
// it runs once per ready tensor group, far off the byte-moving paths.
//
// Reference grounding: the Horovod timeline's NEGOTIATE phases and the
// stall inspector are the paper's diagnosis tools for scaling losses
// (PAPER.md layer map); the histograms here make those phases
// *measurable* (enqueue→negotiated→executed per op class), and the
// rank-skew/straggler machinery attributes a slow world to the rank
// causing it — the prerequisite for tuning (ROADMAP item 5) and for
// debugging controller scale-out at 256 ranks (item 3).

#ifndef HVD_METRICS_H_
#define HVD_METRICS_H_

#include <atomic>
#include <cstdint>
#include <string>
#include <vector>

#include "thread_annotations.h"

namespace hvd {
namespace metrics {

// Fixed-bucket log2 histogram: bucket i counts values v with
// 2^i <= v < 2^(i+1) (bucket 0 also takes v <= 1; the last bucket is
// open-ended). 40 buckets span 1 us .. ~12.7 days for microsecond
// recordings — no allocation, no configuration, mergeable by addition.
class Log2Histogram {
 public:
  static constexpr int kBuckets = 40;

  void Record(long long v) {
    if (v < 0) v = 0;
    int b = 0;
    unsigned long long u = static_cast<unsigned long long>(v);
    while (u > 1 && b < kBuckets - 1) {
      u >>= 1;
      ++b;
    }
    buckets_[b].fetch_add(1, std::memory_order_relaxed);
    count_.fetch_add(1, std::memory_order_relaxed);
    sum_.fetch_add(v, std::memory_order_relaxed);
    long long prev = max_.load(std::memory_order_relaxed);
    while (v > prev &&
           !max_.compare_exchange_weak(prev, v, std::memory_order_relaxed)) {
    }
  }

  void Reset() {
    for (auto& b : buckets_) b.store(0, std::memory_order_relaxed);
    count_.store(0, std::memory_order_relaxed);
    sum_.store(0, std::memory_order_relaxed);
    max_.store(0, std::memory_order_relaxed);
  }

  long long count() const { return count_.load(std::memory_order_relaxed); }
  long long sum() const { return sum_.load(std::memory_order_relaxed); }
  long long max() const { return max_.load(std::memory_order_relaxed); }
  long long bucket(int i) const {
    return buckets_[i].load(std::memory_order_relaxed);
  }

 private:
  std::atomic<long long> buckets_[kBuckets] = {};
  std::atomic<long long> count_{0};
  std::atomic<long long> sum_{0};
  std::atomic<long long> max_{0};
};

// Every histogram the native plane records. Values are MICROSECONDS
// for every id (one unit, one mental model). Adding a measurement =
// one enum entry + one name below + Record() at the site — no new
// extern "C" symbol, no new ctypes binding.
enum HistId {
  // enqueue → negotiated (PerformOperation saw the response) per op class
  kEnqToNegAllreduceUs = 0,
  kEnqToNegAllgatherUs,
  kEnqToNegBroadcastUs,
  kEnqToNegOtherUs,
  // negotiated → executed (handle resolved) per op class
  kNegToDoneAllreduceUs,
  kNegToDoneAllgatherUs,
  kNegToDoneBroadcastUs,
  kNegToDoneOtherUs,
  // one background-loop cycle's active work (negotiate + execute)
  kCycleUs,
  // coordinator: gather-start → this rank's frame ingested, per rank
  kGatherWaitUs,
  // coordinator: last-ready minus first-ready arrival inside one ready
  // tensor group (the per-step rank skew the straggler detector eats)
  kRankSkewUs,
  // data-plane leg timings
  kCrossLegUs,
  kShmLegUs,
  kStripeLegUs,
  // hierarchical control plane (docs/control-plane.md): a leader's
  // member-frame gather + aggregate build, and its response fan-out
  // relay (the coordinator records both for its own host-0 group)
  kLeaderAggUs,
  kFanoutUs,
  kNumHistograms,
};

// Snapshot-stable names, index-aligned with HistId.
const char* HistName(int id);

struct StragglerEvent {
  int rank = -1;
  double lag_ms = 0.0;
};

// EWMA "persistently last" detector over the coordinator's per-rank
// ready timestamps. A rank whose smoothed lag behind the group's
// fastest rank exceeds the threshold (HOROVOD_STRAGGLER_MS) while it
// arrives last `patience` (HOROVOD_STRAGGLER_PATIENCE) consecutive
// groups is named in a STRAGGLER_WARNING (stderr echo + drainable
// event + cumulative counter; the Python plane turns drained events
// into timeline instants). Re-arms after each warning, so a persistent
// straggler re-fires every `patience` groups instead of spamming.
class StragglerDetector {
 public:
  void Configure(int world_size, double threshold_ms, int patience)
      EXCLUDES(mu_);
  void Reset() EXCLUDES(mu_);
  // One ready group: (rank, lag_ms) per submitting rank, lag measured
  // from the group's earliest arrival. Called once per ready tensor
  // group on the coordinator's cycle thread.
  void ObserveGroup(const std::vector<std::pair<int, double>>& lags_ms)
      EXCLUDES(mu_);

  // Snapshot accessors (events are drained separately; see Registry).
  long long warnings() const {
    return warnings_.load(std::memory_order_relaxed);
  }
  int last_rank() const { return last_rank_.load(std::memory_order_relaxed); }
  // Atomic like its siblings: written under mu_ by ObserveGroup but
  // read lock-free by the snapshot (the getter-race class again).
  double last_lag_ms() const {
    return last_lag_ms_.load(std::memory_order_relaxed);
  }
  std::vector<double> EwmaMs() const EXCLUDES(mu_);
  std::vector<StragglerEvent> DrainEvents() EXCLUDES(mu_);
  void RestoreEvents(std::vector<StragglerEvent> undelivered)
      EXCLUDES(mu_);

 private:
  void ConfigureLocked(int world_size, double threshold_ms, int patience)
      REQUIRES(mu_);

  mutable Mutex mu_;
  double threshold_ms_ GUARDED_BY(mu_) = 100.0;
  int patience_ GUARDED_BY(mu_) = 3;
  double alpha_ GUARDED_BY(mu_) = 0.3;
  std::vector<double> ewma_ms_ GUARDED_BY(mu_);
  // rank that arrived last in the previous group
  int last_ GUARDED_BY(mu_) = -1;
  // how many consecutive groups `last_` was last
  int consecutive_ GUARDED_BY(mu_) = 0;
  // bounded, drained by snapshot
  std::vector<StragglerEvent> events_ GUARDED_BY(mu_);
  std::atomic<long long> warnings_{0};
  std::atomic<int> last_rank_{-1};
  std::atomic<double> last_lag_ms_{0.0};
};

// The process registry. Immortal (function-local static, never freed):
// monitor threads may poll it straight through hvd_shutdown.
class Registry {
 public:
  static Registry& Get();

  void Record(HistId id, long long value_us) { hists_[id].Record(value_us); }
  const Log2Histogram& hist(int id) const { return hists_[id]; }

  void IncCycles() { cycles_.fetch_add(1, std::memory_order_relaxed); }
  long long cycles() const {
    return cycles_.load(std::memory_order_relaxed);
  }

  StragglerDetector& straggler() { return straggler_; }

  // Fresh-world reset (hvd_init): histograms and straggler state are
  // world-scoped, like the ring traffic counters — rank identities and
  // timings from a previous (elastic) world must not pollute the new
  // one. Reads the straggler knobs from the env here, once per world.
  void ResetForWorld(int world_size);

 private:
  Registry() = default;
  Log2Histogram hists_[kNumHistograms];
  std::atomic<long long> cycles_{0};
  StragglerDetector straggler_;
};

// Convenience recorders for call sites.
inline void Record(HistId id, long long value_us) {
  Registry::Get().Record(id, value_us);
}

// Monotonic nanoseconds (steady_clock) — the one clock every recording
// shares with the controller's negotiation events.
int64_t MonoNs();

}  // namespace metrics
}  // namespace hvd

#endif  // HVD_METRICS_H_
