// Thread-safe pending-tensor table + request queue.
//
// Parity: reference tensor_queue.{h,cc} (common/tensor_queue.h:28-63) —
// duplicate-name rejection, atomic pop of a message batch per cycle,
// finalize-with-abort on shutdown.

#ifndef HVD_TENSOR_QUEUE_H_
#define HVD_TENSOR_QUEUE_H_

#include <chrono>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "thread_annotations.h"

namespace hvd {

class TensorQueue {
 public:
  // Adds an entry; rejects duplicate in-flight names.
  Status AddToTensorQueue(TensorTableEntry entry) EXCLUDES(mu_);

  // Pops all queued requests (one cycle's worth).
  std::vector<Request> PopMessages() EXCLUDES(mu_);

  // Looks up (and optionally removes) entries for a response's tensors.
  std::vector<TensorTableEntry> GetTensorEntries(
      const std::vector<std::string>& names, bool remove) EXCLUDES(mu_);

  // Removes a single entry by name (after completion).
  void RemoveTensorEntry(const std::string& name) EXCLUDES(mu_);

  bool Contains(const std::string& name) EXCLUDES(mu_);
  size_t PendingCount() EXCLUDES(mu_);
  // Interruptible cycle sleep for the background loop: parks until a
  // request is queued (AddToTensorQueue notifies), the queue closes, or
  // `deadline` passes. Returns immediately when requests are already
  // waiting. An enqueue that lands mid-sleep thus starts the next
  // negotiation round at once instead of waiting out the cycle — at
  // large world sizes the cached-path RTT is otherwise dominated by
  // ranks sleeping through the round their peers are trying to start.
  void WaitForMessages(std::chrono::steady_clock::time_point deadline)
      EXCLUDES(mu_);

  // Drain every queued entry (shutdown path) and close the queue: later
  // enqueues are refused with ABORTED so no submission can slip in after
  // the final drain and strand its waiter. Caller resolves handles.
  std::vector<TensorTableEntry> DrainAll() EXCLUDES(mu_);

  // Re-arm after hvd_init reuses the process-global state (elastic reset).
  void Reopen() EXCLUDES(mu_);

 private:
  Mutex mu_;
  CondVar cv_;
  std::unordered_map<std::string, TensorTableEntry> table_ GUARDED_BY(mu_);
  std::deque<Request> queue_ GUARDED_BY(mu_);
  bool closed_ GUARDED_BY(mu_) = false;
};

}  // namespace hvd

#endif  // HVD_TENSOR_QUEUE_H_
