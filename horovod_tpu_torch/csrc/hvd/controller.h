// Coordination protocol: decide, each cycle, which pending tensors are
// globally ready, validate cross-rank consistency, and fuse them into
// batched responses.
//
// Parity: reference controller.{h,cc} (ComputeResponseList controller.cc:62,
// ConstructResponse :378, FuseResponses :640, IncrementTensorCount :789),
// re-grounded for TPU (SURVEY §7): in the common single-controller SPMD case
// one process drives a whole slice, so readiness is local and the protocol
// collapses to LocalController (no network). The TCP star controller covers
// the multi-host case — the role MPI_Gather/Bcast plays in the reference —
// with a response cache shrinking repeat requests to 4-byte ids.

#ifndef HVD_CONTROLLER_H_
#define HVD_CONTROLLER_H_

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <functional>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "response_cache.h"
#include "socket.h"
#include "stall_inspector.h"
#include "thread_annotations.h"

namespace hvd {

struct ControllerConfig {
  int rank = 0;
  int size = 1;
  // This rank's host group (node index). Exchanged at world join so the
  // ring data plane can install the full rank -> host table (hierarchical
  // dispatch + the local/cross traffic split).
  int cross_rank = 0;
  std::string coordinator_addr = "127.0.0.1";
  int coordinator_port = 0;
  int64_t fusion_threshold_bytes = 64 * 1024 * 1024;
  size_t cache_capacity = 1024;
  double stall_warning_sec = 60.0;
  double stall_shutdown_sec = 0.0;
  bool stall_check_enabled = true;
  // Shared per-job secret (launcher-generated): hellos carrying a
  // different key are rejected so concurrent jobs on one host can't
  // cross-connect through a shared default port.
  std::string job_key;
  // Liveness plane (docs/liveness.md). heartbeat_ms > 0 arms it: worker
  // ranks run a heartbeat thread interleaving one-byte frames with their
  // request frames, and the coordinator's gather turns into a timed poll
  // that tracks last_seen per rank and escalates silence through
  // miss -> SUSPECT (half the timeout) -> EVICT (the full timeout).
  // 0 (the default) keeps the pre-liveness blocking protocol bit-for-bit.
  int heartbeat_ms = 0;
  int liveness_timeout_ms = 10000;
  // World incarnation (docs/self-healing.md): bumped per hvd_init in the
  // owning process. The coordinator stamps its value on the endpoint-map
  // broadcast and every response frame; workers ADOPT the coordinator's
  // value at bootstrap, so one world always agrees on one epoch and a
  // frame from a torn-down predecessor world is rejectable everywhere.
  long long epoch = 0;
};

class Controller {
 public:
  explicit Controller(ControllerConfig cfg)
      : cfg_(std::move(cfg)),
        fusion_threshold_bytes_(cfg_.fusion_threshold_bytes) {
    // Pre-exchange default: only this rank's own group is known; the TCP
    // controller replaces the table with the exchanged one at Initialize.
    cross_ranks_.assign(std::max(cfg_.size, 1), 0);
    if (cfg_.rank >= 0 && cfg_.rank < cfg_.size) {
      cross_ranks_[cfg_.rank] = cfg_.cross_rank;
    }
    // Local default: own incarnation counter. TCP workers overwrite it
    // with the coordinator's broadcast value at Initialize.
    epoch_ = cfg_.epoch;
  }
  virtual ~Controller() = default;

  // Runtime-tunable (autotuner): read each cycle by the fusion planner.
  void set_fusion_threshold(int64_t bytes) {
    fusion_threshold_bytes_.store(bytes, std::memory_order_relaxed);
  }
  int64_t fusion_threshold() const {
    return fusion_threshold_bytes_.load(std::memory_order_relaxed);
  }

  // Tuned-parameter sync (reference Controller::SynchronizeParameters,
  // controller.cc:33-47). The coordinator's current cycle time is staged
  // here by hvd_set_parameters and rides every response broadcast; workers
  // surface the received value via TakeSyncedCycleMs for the background
  // loop to apply.
  void set_cycle_hint_ms(double ms) {
    cycle_hint_ms_.store(ms, std::memory_order_relaxed);
  }
  double cycle_hint_ms() const {
    return cycle_hint_ms_.load(std::memory_order_relaxed);
  }
  // Returns the coordinator-synced cycle time once, then -1 until the next
  // update arrives.
  double TakeSyncedCycleMs() { return synced_cycle_ms_.exchange(-1.0); }

  // Tuned categorical flags (bit0 = hierarchical allreduce, bit1 =
  // hierarchical allgather; -1 = untuned). The coordinator's autotuner
  // sets the hint; it rides the next response broadcast and every rank
  // (coordinator included) applies it at that frame boundary via
  // TakeSyncedHierFlags, so dispatch never diverges across ranks.
  void set_hier_flags_hint(int flags) {
    hier_flags_hint_.store(flags, std::memory_order_relaxed);
  }
  int hier_flags_hint() const {
    return hier_flags_hint_.load(std::memory_order_relaxed);
  }
  int TakeSyncedHierFlags() { return synced_hier_flags_.exchange(-1); }

  // Tuned cross-host stripe count (docs/cross-transport.md; -1 =
  // untuned). Rides the response broadcast exactly like the hier flags
  // and is applied at the same frame boundary on every rank
  // (Ring::ApplyStripeCount), so both sides of every leader pair
  // renegotiate their cross transport in lock-step.
  void set_stripe_hint(int stripes) {
    stripe_hint_.store(stripes, std::memory_order_relaxed);
  }
  int stripe_hint() const {
    return stripe_hint_.load(std::memory_order_relaxed);
  }
  int TakeSyncedStripes() { return synced_stripes_.exchange(-1); }

  virtual Status Initialize() = 0;
  // One negotiation cycle. `this_rank_shutdown` signals this rank wants
  // out; `this_rank_drain` marks the departure as a graceful DRAIN
  // farewell (clean preemption exit — recorded distinctly from a crash);
  // returns responses to execute now; sets *world_shutdown once the world
  // must end.
  virtual std::vector<Response> ComputeResponseList(
      std::vector<Request> local_requests, bool this_rank_shutdown,
      bool this_rank_drain, bool* world_shutdown) = 0;
  virtual void Finalize() {}

  // Host data-plane endpoints (rank -> host:port), filled by Initialize for
  // multi-process controllers.
  const std::vector<std::pair<std::string, int>>& data_endpoints() const {
    return data_endpoints_;
  }
  // Per-rank host groups (rank -> cross_rank), exchanged alongside the
  // endpoint map. Feeds Ring::SetTopology.
  const std::vector<int>& cross_ranks() const { return cross_ranks_; }
  const ControllerConfig& config() const { return cfg_; }
  // Accumulated stall-inspector warnings (coordinator only). Consumes and
  // returns at most max_bytes so a bounded caller buffer never silently
  // drops the tail; callers loop until empty. Called from API threads
  // while the background loop appends.
  std::string TakeStallReport(size_t max_bytes = SIZE_MAX)
      EXCLUDES(stall_report_mu_) {
    MutexLock lk(stall_report_mu_);
    if (stall_report_.size() <= max_bytes) {
      std::string r = std::move(stall_report_);
      stall_report_.clear();
      return r;
    }
    std::string r = stall_report_.substr(0, max_bytes);
    stall_report_.erase(0, max_bytes);
    return r;
  }
  // Requests this rank transmitted as 4-byte cache ids instead of full
  // serialized frames (worker ranks only; the coordinator ingests its own
  // requests directly).
  int64_t cache_hits() const {
    return cache_hits_.load(std::memory_order_relaxed);
  }

  // The world epoch this controller settled on at Initialize: the
  // coordinator's cfg_.epoch, adopted by workers from the endpoint-map
  // broadcast. The data plane stamps it into every link hello and the
  // resume handshake (docs/self-healing.md). Written once at Initialize
  // before the background thread exists; read-only after.
  long long epoch() const { return epoch_; }

  // Accumulated liveness events (SUSPECT / EVICT / DRAIN /
  // COORD_TIMEOUT lines; docs/liveness.md), drained like the stall
  // report: consumes at most max_bytes of whole lines per call so a
  // bounded caller buffer never silently drops the tail.
  std::string TakeLivenessReport(size_t max_bytes = SIZE_MAX)
      EXCLUDES(liveness_mu_) {
    MutexLock lk(liveness_mu_);
    if (liveness_report_.size() <= max_bytes) {
      std::string r = std::move(liveness_report_);
      liveness_report_.clear();
      return r;
    }
    std::string r = liveness_report_.substr(0, max_bytes);
    liveness_report_.erase(0, max_bytes);
    return r;
  }

  // Put back a drained liveness report that could not be delivered
  // (hvd_metrics_snapshot drains it into the JSON, but a too-small
  // caller buffer must not lose events — same no-silent-truncation rule
  // as the negotiation-event requeue).
  void RestoreLivenessReport(std::string undelivered)
      EXCLUDES(liveness_mu_) {
    MutexLock lk(liveness_mu_);
    undelivered += liveness_report_;
    liveness_report_ = std::move(undelivered);
  }

  // Per-rank negotiation ticks (reference Timeline::NegotiateRankReady,
  // controller.cc:797-809): when enabled, the coordinator records the
  // monotonic time each rank's submission arrives, so the timeline can
  // show which rank straggled. Bounded buffer; oldest events drop.
  void set_record_negotiation(bool on) {
    record_negotiation_.store(on, std::memory_order_relaxed);
  }
  struct NegotiationEvent {
    std::string name;
    int rank;
    int64_t mono_ns;
  };
  std::vector<NegotiationEvent> DrainNegotiationEvents()
      EXCLUDES(events_mu_) {
    MutexLock lk(events_mu_);
    std::vector<NegotiationEvent> out;
    out.swap(events_);
    return out;
  }
  // Put back events a bounded drain could not deliver (oldest first).
  void RequeueNegotiationEvents(std::vector<NegotiationEvent> undelivered)
      EXCLUDES(events_mu_) {
    MutexLock lk(events_mu_);
    undelivered.insert(undelivered.end(),
                       std::make_move_iterator(events_.begin()),
                       std::make_move_iterator(events_.end()));
    events_ = std::move(undelivered);
  }

 protected:
  // Shared machinery (used by both concrete controllers).
  // Validates that all ranks' requests for one tensor agree on
  // op/dtype/shape/root; returns an error Response if not.
  static bool ValidateGroup(const std::string& name,
                            const std::vector<Request>& group, int world_size,
                            Response* out);
  // Bin single-tensor responses into fused responses under the threshold.
  static std::vector<Response> FuseResponses(std::vector<Response> singles,
                                             int64_t threshold_bytes);
  // Record a per-rank negotiation tick (no-op unless enabled).
  void RecordNegotiationEvent(const std::string& name, int rank);
  // Append one liveness event line (newline added here) to the report
  // buffer drained by hvd_liveness_report, and echo it to stderr so the
  // launcher log shows membership churn even without a drain consumer.
  void RecordLivenessEvent(const std::string& line)
      EXCLUDES(liveness_mu_);

  ControllerConfig cfg_;
  std::atomic<int64_t> fusion_threshold_bytes_;
  std::atomic<double> cycle_hint_ms_{-1.0};
  std::atomic<double> synced_cycle_ms_{-1.0};
  std::atomic<int> hier_flags_hint_{-1};
  std::atomic<int> synced_hier_flags_{-1};
  std::atomic<int> stripe_hint_{-1};
  std::atomic<int> synced_stripes_{-1};
  std::atomic<int64_t> cache_hits_{0};
  Mutex stall_report_mu_;
  std::atomic<bool> record_negotiation_{false};
  Mutex events_mu_;
  std::vector<NegotiationEvent> events_ GUARDED_BY(events_mu_);
  // Filled by Initialize before any other thread exists; read-only after.
  std::vector<std::pair<std::string, int>> data_endpoints_;
  std::vector<int> cross_ranks_;
  long long epoch_ = 0;
  std::string stall_report_ GUARDED_BY(stall_report_mu_);
  Mutex liveness_mu_;
  std::string liveness_report_ GUARDED_BY(liveness_mu_);
};

// Single-process controller: the driving process sees every enqueue, so
// every request is globally ready the moment it is queued.
class LocalController : public Controller {
 public:
  using Controller::Controller;
  Status Initialize() override { return Status::OK(); }
  std::vector<Response> ComputeResponseList(std::vector<Request> reqs,
                                            bool this_rank_shutdown,
                                            bool this_rank_drain,
                                            bool* world_shutdown) override;
};

// TCP star controller: rank 0 plays coordinator (the reference's rank-0
// coordinator role, controller.cc:62-356), workers gather requests and
// receive broadcast responses each cycle over persistent sockets.
class TcpController : public Controller {
 public:
  TcpController(ControllerConfig cfg, int data_port, std::string my_host)
      : Controller(std::move(cfg)), data_port_(data_port),
        my_host_(std::move(my_host)) {}
  ~TcpController() override { StopHeartbeat(); }
  Status Initialize() override;
  std::vector<Response> ComputeResponseList(std::vector<Request> reqs,
                                            bool this_rank_shutdown,
                                            bool this_rank_drain,
                                            bool* world_shutdown) override;
  void Finalize() override;

  // Liveness peer states (coordinator-side; docs/liveness.md).
  enum PeerState { kAlive = 0, kSuspect = 1, kEvicted = 2, kDrained = 3 };

  // Hierarchical control plane (docs/control-plane.md). The channel
  // carries the intra-host member<->leader hops (in this runtime:
  // Ring::CtrlSendFrame/CtrlRecvFrame over the LOCAL_CTRL registry
  // leg). EnableHierControl derives the per-host leader topology from
  // the exchanged cross_ranks table (leader = lowest rank of each host
  // group — the same derivation Ring::SetTopology uses, so control and
  // data planes always agree) and switches every subsequent cycle to
  // the two-level protocol: members speak to their leader, leaders
  // aggregate and speak to the coordinator, the coordinator does O(H)
  // socket work per cycle and fans responses back through leaders.
  // Must be called after Initialize (the table) and before the
  // background loop starts (the fields are unguarded, like
  // data_endpoints_: written once pre-thread, read-only after).
  struct CtrlChannel {
    std::function<bool(int peer, const std::string&)> send;
    std::function<bool(int peer, std::string*)> recv;
  };
  void EnableHierControl(CtrlChannel ch);
  bool hier_control() const { return hier_on_; }

 private:
  std::vector<Response> CoordinatorCycle(std::vector<Request> my_reqs,
                                         bool my_shutdown, bool my_drain,
                                         bool* world_shutdown);
  std::vector<Response> WorkerCycle(std::vector<Request> my_reqs,
                                    bool my_shutdown, bool my_drain,
                                    bool* world_shutdown);
  // Hier-mode worker cycles (docs/control-plane.md): a member speaks
  // only to its leader over the ctrl channel; a non-coordinator leader
  // gathers its members, sends one aggregate TCP frame, and relays the
  // response bytes VERBATIM back (so hier and flat worlds execute
  // byte-identical response frames).
  std::vector<Response> MemberCycle(std::vector<Request> my_reqs,
                                    bool my_shutdown, bool my_drain,
                                    bool* world_shutdown);
  std::vector<Response> LeaderCycle(std::vector<Request> my_reqs,
                                    bool my_shutdown, bool my_drain,
                                    bool* world_shutdown);
  // Split this rank's requests into novel ones and response-cache hits
  // (counting the hits), then build the wire frame: delta-first — a
  // cycle with no novel requests ships the compact cache-id bitset
  // frame instead of names.
  std::string BuildRequestFrame(std::vector<Request> reqs, bool my_shutdown,
                                bool my_drain);
  // Worker-side response application shared by the flat and hier paths:
  // deserialize, adopt synced parameters, cache, return responses.
  std::vector<Response> ApplyResponseBytes(const std::string& bytes,
                                           bool* world_shutdown);
  // Receive one coordinator frame on coord_sock_ with the liveness
  // timeout discipline (COORD_TIMEOUT surfacing) shared by the flat
  // worker and hier leader paths.
  bool RecvFromCoordinator(std::string* bytes);
  void CacheResponses(const std::vector<Response>& resps);
  // Liveness helpers (all coordinator-side except the heartbeat pair).
  void StartHeartbeat() EXCLUDES(hb_mu_);
  void StopHeartbeat() EXCLUDES(hb_mu_);
  // Gather one request frame per live worker, skipping heartbeat frames
  // and escalating silence to eviction (liveness mode only). Ingests via
  // `ingest(rank, bytes)`.
  // `expect_frame` (hier mode) restricts which ranks' request frames
  // the gather WAITS for (the per-host leaders); every live worker is
  // still polled so member heartbeats keep refreshing last_seen_ and
  // the SUSPECT/EVICT machine covers members and leaders alike.
  // nullptr = every live worker (the flat protocol).
  void GatherWithLiveness(
      const std::function<void(int, const std::string&)>& ingest,
      const std::vector<bool>* expect_frame = nullptr);
  void EvictRank(int rank, const char* reason, double silence_ms);
  void MarkSuspect(int rank, const char* reason, double silence_ms);

  int data_port_ = 0;
  std::string my_host_;
  Listener listener_;                 // coordinator only
  std::vector<Socket> worker_socks_;  // coordinator: index = rank-1
  Socket coord_sock_;                 // workers
  // Liveness plane state. `liveness_on_` is fixed at Initialize.
  bool liveness_on_ = false;
  std::vector<std::chrono::steady_clock::time_point> last_seen_;
  std::vector<int> peer_state_;
  // Worker heartbeat thread: beats every heartbeat_ms on the control
  // socket; send_mu_ serializes its frames against the cycle thread's.
  // coord_sock_ itself stays unannotated: its SENDS are guarded by
  // send_mu_ but its receives are cycle-thread-only — a split the
  // capability system cannot express on one object (the discipline is
  // "every SendFrame on it holds send_mu_", enforced by review; the
  // receive side has exactly one caller thread by construction).
  std::thread hb_thread_;
  Mutex hb_mu_;
  CondVar hb_cv_;
  bool hb_stop_ GUARDED_BY(hb_mu_) = false;
  Mutex send_mu_;

  // Coordinator negotiation state: name -> per-rank requests seen so far.
  std::unordered_map<std::string, std::vector<Request>> pending_;
  std::vector<bool> shutdown_ranks_;
  // Join state (reference controller.cc:219-230,289-306): ranks that called
  // join() stop submitting; readiness counts only non-joined live ranks, and
  // when every live rank has joined a JOIN response (root_rank = the rank
  // that joined last) releases them all.
  std::vector<bool> joined_ranks_;
  int last_joined_ = -1;
  StallInspector stall_;
  ResponseCache cache_;  // symmetric ids on all ranks (see CacheResponses)

  // Hierarchical control plane (EnableHierControl). Written once before
  // the background thread exists; read-only after — no guards, same
  // posture as data_endpoints_.
  bool hier_on_ = false;
  CtrlChannel ctrl_;
  std::vector<int> leader_of_;      // rank -> its host group's leader
  std::vector<bool> leader_rank_;   // rank -> is a per-host leader
  std::vector<int> my_members_;     // leaders: my group minus myself
};

// Canonical name of the join sentinel entry (reference JOIN_TENSOR_NAME).
inline const char* kJoinTensorName = "join.internal";

}  // namespace hvd

#endif  // HVD_CONTROLLER_H_
