// Stall detection: warn when some ranks submitted a tensor and others
// haven't (reference stall_inspector.{h,cc}, stall_inspector.h:30-96).

#ifndef HVD_STALL_INSPECTOR_H_
#define HVD_STALL_INSPECTOR_H_

#include <chrono>
#include <string>
#include <unordered_map>
#include <vector>

#include "thread_annotations.h"

namespace hvd {

class StallInspector {
 public:
  void Configure(double warning_sec, double shutdown_sec, int world_size,
                 bool enabled) {
    warning_sec_ = warning_sec;
    shutdown_sec_ = shutdown_sec;
    world_size_ = world_size;
    enabled_ = enabled;
  }

  // Record that `rank` submitted `name` (coordinator side).
  void RecordRank(const std::string& name, int rank) EXCLUDES(mu_);

  // Tensor completed: forget it.
  void Remove(const std::string& name) EXCLUDES(mu_);

  // Returns a human-readable stall report ("" if none) and sets
  // *should_shutdown when the hard limit passed. Call once per cycle.
  // `stalled_ranks` (optional) receives the deduplicated ranks missing
  // from any tensor pending past the warning window — the liveness
  // plane escalates them to SUSPECT through the same state machine as a
  // heartbeat miss (docs/liveness.md) instead of their stall being a
  // log line only.
  std::string Check(bool* should_shutdown,
                    std::vector<int>* stalled_ranks = nullptr)
      EXCLUDES(mu_);

 private:
  struct PendingInfo {
    std::chrono::steady_clock::time_point first_seen;
    std::vector<bool> ranks;
    bool warned = false;
  };

  Mutex mu_;
  // Configure() runs before the cycle thread exists (controller
  // Initialize); the thresholds are read-only afterwards, so they carry
  // no guard. The pending table is the shared state.
  double warning_sec_ = 60.0;
  double shutdown_sec_ = 0.0;
  int world_size_ = 1;
  bool enabled_ = true;
  std::unordered_map<std::string, PendingInfo> pending_ GUARDED_BY(mu_);
};

}  // namespace hvd

#endif  // HVD_STALL_INSPECTOR_H_
