#include "tensor_queue.h"

// TSan-build detection across compilers (GCC spells it
// __SANITIZE_THREAD__, clang exposes __has_feature(thread_sanitizer)).
#if defined(__SANITIZE_THREAD__)
#define HVD_TSAN_BUILD 1
#elif defined(__has_feature)
#if __has_feature(thread_sanitizer)
#define HVD_TSAN_BUILD 1
#endif
#endif

namespace hvd {

Status TensorQueue::AddToTensorQueue(TensorTableEntry entry) {
  MutexLock lk(mu_);
  if (closed_) {
    // The background loop has exited (world abort or shutdown) and will
    // never drain this queue again; accepting the entry would strand the
    // caller's wait forever (observed: a worker death aborts the world
    // while a peer is mid-step, and the peer's next enqueue raced the
    // drain). Same closed-under-lock discipline the drain uses.
    return Status::Aborted("horovod_tpu runtime has been shut down");
  }
  auto name = entry.name;
  if (table_.count(name)) {
    return Status::InvalidArgument(
        "Duplicate tensor name in submission: " + name +
        "; a tensor may only be in flight once (use distinct names)");
  }
  queue_.push_back(entry.request);
  table_.emplace(std::move(name), std::move(entry));
  cv_.notify_all();
  return Status::OK();
}

std::vector<Request> TensorQueue::PopMessages() {
  MutexLock lk(mu_);
  std::vector<Request> out(queue_.begin(), queue_.end());
  queue_.clear();
  return out;
}

std::vector<TensorTableEntry> TensorQueue::GetTensorEntries(
    const std::vector<std::string>& names, bool remove) {
  MutexLock lk(mu_);
  std::vector<TensorTableEntry> out;
  out.reserve(names.size());
  for (const auto& n : names) {
    auto it = table_.find(n);
    if (it != table_.end()) {
      out.push_back(it->second);
      if (remove) table_.erase(it);
    }
  }
  return out;
}

void TensorQueue::RemoveTensorEntry(const std::string& name) {
  MutexLock lk(mu_);
  table_.erase(name);
}

bool TensorQueue::Contains(const std::string& name) {
  MutexLock lk(mu_);
  return table_.count(name) != 0;
}

size_t TensorQueue::PendingCount() {
  MutexLock lk(mu_);
  return table_.size();
}

void TensorQueue::WaitForMessages(
    std::chrono::steady_clock::time_point deadline) {
  UniqueLock lk(mu_);
#ifdef HVD_TSAN_BUILD
  // libstdc++ implements steady_clock cv waits via pthread_cond_clockwait,
  // which GCC-10-era libtsan does NOT intercept: TSan misses the
  // unlock/relock inside the wait, so every later lock of mu_ reports a
  // false "double lock" and the happens-before state of the whole mutex
  // is poisoned (verified with a minimal correct repro). The TSan build
  // therefore waits on the intercepted system_clock path. The clock
  // conversion is bounded by one cycle (ms) and an enqueue's notify
  // still breaks the wait, so instrumented behavior stays equivalent.
  // Written-out wait loop (no predicate lambda): the guarded reads of
  // queue_/closed_ stay in THIS function body, where the analysis knows
  // the UniqueLock holds mu_ (thread_annotations.h).
  auto sys_deadline =
      std::chrono::system_clock::now() +
      std::chrono::duration_cast<std::chrono::system_clock::duration>(
          deadline - std::chrono::steady_clock::now());
  while (queue_.empty() && !closed_) {
    if (cv_.wait_until(lk, sys_deadline) == std::cv_status::timeout) break;
  }
#else
  while (queue_.empty() && !closed_) {
    if (cv_.wait_until(lk, deadline) == std::cv_status::timeout) break;
  }
#endif
}

std::vector<TensorTableEntry> TensorQueue::DrainAll() {
  std::vector<TensorTableEntry> entries;
  MutexLock lk(mu_);
  closed_ = true;  // refuse post-drain enqueues; see AddToTensorQueue
  for (auto& kv : table_) entries.push_back(std::move(kv.second));
  table_.clear();
  queue_.clear();
  cv_.notify_all();
  return entries;
}

void TensorQueue::Reopen() {
  MutexLock lk(mu_);
  closed_ = false;
}

}  // namespace hvd
