#include "stall_inspector.h"

namespace hvd {

void StallInspector::RecordRank(const std::string& name, int rank) {
  if (!enabled_) return;
  MutexLock lk(mu_);
  auto it = pending_.find(name);
  if (it == pending_.end()) {
    PendingInfo info;
    info.first_seen = std::chrono::steady_clock::now();
    info.ranks.assign(world_size_, false);
    it = pending_.emplace(name, std::move(info)).first;
  }
  if (rank >= 0 && rank < world_size_) it->second.ranks[rank] = true;
}

void StallInspector::Remove(const std::string& name) {
  if (!enabled_) return;
  MutexLock lk(mu_);
  pending_.erase(name);
}

std::string StallInspector::Check(bool* should_shutdown,
                                  std::vector<int>* stalled_ranks) {
  *should_shutdown = false;
  if (!enabled_) return "";
  MutexLock lk(mu_);
  auto now = std::chrono::steady_clock::now();
  std::string report;
  std::vector<bool> stalled(stalled_ranks != nullptr ? world_size_ : 0,
                            false);
  for (auto& kv : pending_) {
    double waited =
        std::chrono::duration<double>(now - kv.second.first_seen).count();
    if (waited < warning_sec_) continue;
    if (shutdown_sec_ > 0 && waited > shutdown_sec_) *should_shutdown = true;
    if (stalled_ranks != nullptr) {
      for (int r = 0; r < world_size_; ++r) {
        if (!kv.second.ranks[r]) stalled[r] = true;
      }
    }
    if (kv.second.warned) continue;
    kv.second.warned = true;
    std::string missing;
    for (int r = 0; r < world_size_; ++r) {
      if (!kv.second.ranks[r]) {
        if (!missing.empty()) missing += ",";
        missing += std::to_string(r);
      }
    }
    report += "Stalled tensor '" + kv.first + "' waited " +
              std::to_string(static_cast<int>(waited)) +
              "s; missing ranks: [" + missing + "]\n";
  }
  if (stalled_ranks != nullptr) {
    stalled_ranks->clear();
    for (int r = 0; r < world_size_; ++r) {
      if (stalled[r]) stalled_ranks->push_back(r);
    }
  }
  return report;
}

}  // namespace hvd
