// Shared-memory intra-host transport backend (the zero-copy local leg).
//
// Each rank owns one POSIX shm segment holding a single-producer
// single-consumer inbox ring per same-host peer; a sender maps the
// receiver's segment and streams chunks through fixed slots with an
// acquire/release head/tail handshake — payload bytes move with ZERO
// socket syscalls (the wait loops spin then sched_yield; no futex, no
// read/write). This is what the hierarchical host plane
// (docs/hierarchical.md) was missing: the hierarchical legs made cross-host traffic cheap
// (once per host, not per rank), but the intra-host legs still paid
// loopback-TCP syscalls and two kernel copies per byte — 10-20x worse on
// gVisor-class kernels (csrc/hvd/socket.h).
//
// Registered behind OperationManager (op_manager.h) ahead of the TCP
// PeerLink backend; attach failures and mid-world poisoning fall through
// to TCP in lock-step, byte-identical (docs/shm-transport.md).
//
// Lifecycle: segments are named by the owner's world-unique data-plane
// listener port (fresh per hvd_init, identical on every rank from the
// controller's endpoint map), created at init after an orphan sweep
// (dead-owner hvdshm_* entries are unlinked), and unlinked on teardown
// (hvd_shutdown / EVICT / drain all funnel through ~Ring). A killed
// rank's segment is reaped by any surviving rank's next init or
// teardown sweep.

// Thread posture: configuration and the attach table are background-
// cycle-thread confined; the cross-thread observability surface
// (attach_ok_/attach_fail_/bytes_sent_) is std::atomic — the GUARDED_BY
// vs atomic rule of thread_annotations.h, atomic side (independent
// scalars polled lock-free through hvd.ring_traffic()). The inter-
// PROCESS ring-buffer handshake lives in shared memory and is ordered
// by acquire/release atomics, outside any one process's lock analysis.
//
#ifndef HVD_SHM_TRANSPORT_H_
#define HVD_SHM_TRANSPORT_H_

#include <atomic>
#include <cstdint>
#include <map>
#include <string>
#include <utility>
#include <vector>

#include "op_manager.h"

namespace hvd {

class ShmTransport : public TransportBackend {
 public:
  ShmTransport() = default;
  ~ShmTransport() override;
  ShmTransport(const ShmTransport&) = delete;
  ShmTransport& operator=(const ShmTransport&) = delete;

  // Create this rank's segment with one inbox ring per member of
  // `group` (sorted global ranks sharing this host, containing `rank`).
  // `ports[r]` is rank r's data-plane listener port — the world-unique
  // name discriminator every rank derives identically from the
  // controller's endpoint map. Returns false (backend disabled, TCP
  // carries everything) when creation fails; never throws.
  // `wait_timeout_ms` bounds every data-plane wait (HVD_SHM_TIMEOUT_MS
  // overrides): pass ~2x the liveness timeout when heartbeats are armed
  // so a wedged-but-alive peer (SIGSTOP) cannot park an shm wait past
  // the eviction the liveness plane already delivered on the TCP side.
  bool Init(int rank, const std::vector<int>& group,
            const std::vector<int>& ports, int64_t slot_bytes,
            long long wait_timeout_ms = 120000);
  // Poison every channel this rank touches (unblocking any peer mid
  // handshake), unmap, and unlink this rank's segment. Also sweeps
  // dead-owner segments so a killed peer's orphan is reaped by the
  // survivors. Idempotent; called from ~Ring.
  void Teardown();

  const char* Name() const override { return "shm"; }
  bool Enabled() const override { return enabled_; }
  // HOROVOD_SHM_FALLBACK: false = strict mode — an attach failure or a
  // poisoned channel is a hard collective error, never a silent TCP leg
  // (the per-backend knob the op_manager consults on every failure).
  bool FallthroughAllowed() const override { return allow_fallthrough_; }
  void set_allow_fallthrough(bool v) { allow_fallthrough_ = v; }
  // Whether this backend is plausibly carrying traffic: the segment is
  // live AND the attach record is not "every attempt failed" (a rank
  // whose attaches all fell back to TCP must not report shm as its
  // transport choice). Optimistically true before any attach attempt.
  // Atomics: the background thread's Prepare mutates the counters while
  // observability getters (hvd_shm_active via hvd.ring_traffic) poll
  // from arbitrary threads — the getter-race class.
  bool Active() const {
    return enabled_ &&
           !(attach_ok_.load() == 0 && attach_fail_.load() > 0);
  }
  // Sender-side attach of the peer's segment (bounded retry: the peer
  // may still be initializing). false = negotiation falls through.
  bool Prepare(int peer) override;
  int Send(int peer, const void* buf, size_t nbytes) override;
  int Recv(int peer, void* buf, size_t nbytes) override;

  long long bytes_sent() const { return bytes_sent_.load(); }

  // Unlink every /dev/shm entry under this build's prefix whose owner
  // pid is gone (the unlink-on-init orphan sweep; also used by tests).
  // Returns the number of segments reaped.
  static int SweepOrphans();
  // The segment name for (port, rank) under the current name tag —
  // exposed for tests/leak checks.
  static std::string SegmentName(int port, int rank);

 private:
  struct Attached {
    void* base = nullptr;
    size_t bytes = 0;
    int64_t owner_pid = 0;  // for dead-peer detection in Send waits
    bool failed = false;    // sticky: a failed attach never retries
  };

  void* ChannelOf(void* seg_base, int chan_index) const;
  bool CreateOwnSegment();
  size_t SegmentBytes() const;

  bool enabled_ = false;
  bool allow_fallthrough_ = true;
  int rank_ = -1;
  int my_index_ = -1;  // my slot in the (sorted) group
  std::vector<int> group_;
  std::vector<int> ports_;
  int64_t slot_bytes_ = 0;
  uint32_t nslots_ = 0;
  std::string own_name_;
  void* own_base_ = nullptr;
  size_t own_bytes_ = 0;
  std::map<int, Attached> attached_;  // peer rank -> mapping
  std::atomic<int> attach_ok_{0};
  std::atomic<int> attach_fail_{0};
  long long wait_timeout_ms_ = 120000;
  std::atomic<long long> bytes_sent_{0};
  // Deterministic exec-fault hook (HVD_SHM_POISON_AT=<k>): the k-th shm
  // message this process sends poisons its channel and falls through to
  // TCP instead — the per-op fallthrough proof for tests.
  long long poison_at_ = -1;
  long long msg_count_ = 0;
};

}  // namespace hvd

#endif  // HVD_SHM_TRANSPORT_H_
