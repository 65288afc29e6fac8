// Transport registry for the host data plane's intra-host legs.
//
// The role of the reference's OperationManager (ops/operation_manager.cc):
// a priority-ordered list of backends per collective leg, dispatched to
// the first enabled one, with per-op fallthrough when a backend cannot
// carry a transfer. The reference orders whole collective engines
// (MPI/NCCL/Gloo); here the engines are point-to-point *transports* for
// the legs of the two-level collectives (ring_ops.cc HierAllreduce/
// HierAllgatherv): on the intra-host legs shared memory first
// (shm_transport.cc, zero socket syscalls); on the cross-host leader
// legs striped multi-socket TCP first (stripe_transport.cc, K parallel
// connections per pair); the TCP PeerLink path is the always-enabled
// registered fallback for both. Future backends (RDMA verbs, an ICI
// proxy) slot into the same lists without touching the collective
// algorithms.
//
// Fallthrough is LOCK-STEP: a sender that abandons a backend for a peer
// first poisons that backend's channel (so the blocked receiver's Recv
// reports a soft fall-through instead of data), then announces the new
// choice on the control channel (a TCP PeerLink frame) before the first
// payload rides the new backend. Both sides therefore switch at the same
// message boundary and results are byte-identical to a TCP-only world.

// Thread posture: the manager and its agreement tables are confined to
// the background cycle thread (every hierarchical leg runs there — see
// the member comments), so they carry no capabilities; the backends it
// dispatches to publish their counters through std::atomic for the
// lock-free observability getters.
//
#ifndef HVD_OP_MANAGER_H_
#define HVD_OP_MANAGER_H_

#include <cstddef>
#include <functional>
#include <map>
#include <string>
#include <vector>

namespace hvd {

// The point-to-point legs of the two-level collectives. Intra-host:
// member->leader reduce, member->leader gather, leader->member
// broadcast/fan-out. Cross-host: the leader ring's send and receive
// directions (SubRingAllreduce / HierAllgatherv leader legs) — split
// per direction because a leader negotiates its send toward `next`
// independently of its receive from `prev` (the sender side always
// owns the choice; the receiver follows via the control frame). Each
// leg owns its own priority list: the LOCAL legs register shm ahead of
// TCP, the CROSS legs register the striped multi-socket backend ahead
// of the single-socket fallback (stripe_transport.cc).
enum class TransportLeg : int {
  LOCAL_REDUCE = 0,
  LOCAL_GATHER = 1,
  LOCAL_BCAST = 2,
  CROSS_SEND = 3,
  CROSS_RECV = 4,
  // Hierarchical control plane (docs/control-plane.md): member->leader
  // request/delta frames and the leader->member response relay. Always
  // intra-host, so it registers like the LOCAL data legs (shm first,
  // TCP PeerLink fallback) — negotiation frames must not pay socket
  // syscalls when the data plane already proved shm works on this pair.
  LOCAL_CTRL = 5,
};
constexpr int kNumTransportLegs = 6;

// Send/Recv return codes (see OperationManager dispatch).
constexpr int kTransportOk = 1;
// The backend cannot carry this transfer but left the channel in a
// clean state (nothing consumed/produced): the manager falls through to
// the next backend in priority order.
constexpr int kTransportFellThrough = 0;
// Hard failure (partial transfer, timeout with a wedged peer): no
// fallthrough is safe; the collective aborts like a TCP failure would.
constexpr int kTransportError = -1;

class TransportBackend {
 public:
  virtual ~TransportBackend() = default;
  virtual const char* Name() const = 0;
  // Capability probe, taken at registration time and before every
  // negotiation: a disabled backend is skipped by every dispatch.
  virtual bool Enabled() const = 0;
  // Whether a failure of THIS backend (Prepare refusal, mid-world soft
  // failure) may slide down the priority list. Per backend, not per
  // manager: HOROVOD_SHM_FALLBACK and HOROVOD_STRIPE_FALLBACK are
  // independent strict-mode knobs.
  virtual bool FallthroughAllowed() const { return true; }
  // One-time sender-side channel setup toward `peer` (e.g. mapping the
  // peer's shared-memory segment, dialing the stripe connections).
  // false = this backend cannot reach the peer; the negotiation moves
  // down the priority list.
  virtual bool Prepare(int peer) {
    (void)peer;
    return true;
  }
  // One-time receiver-side setup, run when a control frame announces
  // this backend for (leg, peer) — e.g. accepting the sender's stripe
  // connections. false is a hard error: the sender is already
  // committed, so there is no clean boundary to fall through at.
  virtual bool PrepareRecv(int peer) {
    (void)peer;
    return true;
  }
  virtual int Send(int peer, const void* buf, size_t nbytes) = 0;
  virtual int Recv(int peer, void* buf, size_t nbytes) = 0;
};

class OperationManager {
 public:
  // The control channel carries the one-time per-(leg, direction)
  // agreement frames and every mid-world fallthrough announcement —
  // in this runtime: the Ring's TCP PeerLink frames, whose per-pair
  // FIFO ordering the lock-step switch protocol relies on.
  struct ControlChannel {
    std::function<bool(int peer, const std::string&)> send;
    std::function<bool(int peer, std::string*)> recv;
  };

  explicit OperationManager(ControlChannel ctl) : ctl_(std::move(ctl)) {}

  // Register `b` for `leg`; earlier registrations win the negotiation.
  // The global backend id (`RegisterBackend`'s insertion index) is the
  // value exchanged on the control channel, so every rank must register
  // the same backends in the same order (they do: one code path).
  int RegisterBackend(TransportBackend* b);  // -> global backend id
  void RegisterForLeg(TransportLeg leg, int backend_id);

  // Transfer `nbytes` to/from a peer on the agreed backend, negotiating
  // on first contact and falling through on soft failure. Returns the
  // global backend id that carried the payload, or -1 on a hard error.
  int Send(TransportLeg leg, int peer, const void* buf, size_t nbytes);
  int Recv(TransportLeg leg, int peer, void* buf, size_t nbytes);

  // Agreement without transfer, for duplex callers (the cross-host ring
  // step sends to `next` while receiving from `prev`, so both backends
  // must be pinned before either payload moves): negotiate/announce (or
  // read the announcement) exactly as Send/Recv would, run the
  // backend's Prepare/PrepareRecv, and return the agreed global backend
  // id (-1 on hard error). Idempotent after first contact.
  int AgreeSend(TransportLeg leg, int peer);
  int AgreeRecv(TransportLeg leg, int peer);

  // Forget every agreement for `leg` (both directions are reset by the
  // caller resetting both leg enums). Used by the frame-synced stripe
  // count apply: every rank clears at the same response boundary, so
  // the next cross transfer renegotiates in lock-step with the new
  // backend capabilities.
  void ResetLeg(TransportLeg leg);

  // Observability: the backend currently agreed for (leg, peer) sends,
  // -1 before first contact.
  int AgreedSend(TransportLeg leg, int peer) const;
  const char* BackendName(int backend_id) const;

 private:
  int Negotiate(TransportLeg leg, int peer, int below);

  ControlChannel ctl_;
  std::vector<TransportBackend*> backends_;
  std::vector<std::vector<int>> per_leg_{
      std::vector<std::vector<int>>(kNumTransportLegs)};
  // (leg, peer) -> agreed global backend id. Touched only by the
  // background cycle thread (all hier legs run there), so no lock.
  std::map<std::pair<int, int>, int> agreed_send_;
  std::map<std::pair<int, int>, int> agreed_recv_;
};

}  // namespace hvd

#endif  // HVD_OP_MANAGER_H_
