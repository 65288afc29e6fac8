#include "ring_ops.h"

#include <algorithm>
#include <cfloat>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

#include "env_util.h"
#include "half.h"
#include "message.h"
#include "metrics.h"

namespace hvd {

namespace {

// ---- self-healing link policy (docs/self-healing.md) ----------------------
// Bounded in-place reconnect knobs. The deadline default sits well below
// the liveness timeout default (HOROVOD_LIVENESS_TIMEOUT_MS = 10000) on
// purpose: a link that cannot heal in time must surface as exactly the
// pre-healing transport error so the evict/elastic path fires — healing
// must never mask a real death past the liveness window.
int LinkRetryAttempts() {
  return static_cast<int>(EnvLL("HOROVOD_LINK_RETRY_ATTEMPTS", 3));
}
long long LinkRetryBackoffMs() {
  return EnvMs("HOROVOD_LINK_RETRY_BACKOFF_MS", 100);
}
long long LinkRetryDeadlineMs() {
  return EnvMs("HOROVOD_LINK_RETRY_DEADLINE_MS", 3000);
}

long long SteadyNowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- dtype-generic float view ---------------------------------------------
// All reductions accumulate in double-width host arithmetic: fp32 for
// 16-bit floats (reference AVX fp32-accumulation parity) and native types
// otherwise.

void ToFloat(const void* src, float* dst, int64_t n, DataType dt) {
  switch (dt) {
    case DataType::HVD_FLOAT32:
      std::memcpy(dst, src, n * 4);
      return;
    case DataType::HVD_BFLOAT16: {
      auto* p = static_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < n; ++i) dst[i] = Bf16ToFloat(p[i]);
      return;
    }
    case DataType::HVD_FLOAT16: {
      auto* p = static_cast<const uint16_t*>(src);
      for (int64_t i = 0; i < n; ++i) dst[i] = Fp16ToFloat(p[i]);
      return;
    }
    default:
      break;
  }
}

void FromFloat(const float* src, void* dst, int64_t n, DataType dt) {
  switch (dt) {
    case DataType::HVD_FLOAT32:
      std::memcpy(dst, src, n * 4);
      return;
    case DataType::HVD_BFLOAT16: {
      auto* p = static_cast<uint16_t*>(dst);
      for (int64_t i = 0; i < n; ++i) p[i] = FloatToBf16(src[i]);
      return;
    }
    case DataType::HVD_FLOAT16: {
      auto* p = static_cast<uint16_t*>(dst);
      for (int64_t i = 0; i < n; ++i) p[i] = FloatToFp16(src[i]);
      return;
    }
    default:
      break;
  }
}

template <typename T>
void AccumulateT(T* dst, const T* src, int64_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:  // accumulation step unused for adasum
      for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
      break;
    case ReduceOp::MIN:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::min(dst[i], src[i]);
      break;
    case ReduceOp::MAX:
      for (int64_t i = 0; i < n; ++i) dst[i] = std::max(dst[i], src[i]);
      break;
  }
}

bool Is16BitFloat(DataType dt) {
  return dt == DataType::HVD_FLOAT16 || dt == DataType::HVD_BFLOAT16;
}

// Accumulate src into dst (both raw buffers of dtype dt).
void Accumulate(void* dst, const void* src, int64_t n, DataType dt,
                ReduceOp op) {
  switch (dt) {
    case DataType::HVD_FLOAT32:
      AccumulateT(static_cast<float*>(dst), static_cast<const float*>(src), n,
                  op);
      break;
    case DataType::HVD_FLOAT64:
      AccumulateT(static_cast<double*>(dst),
                  static_cast<const double*>(src), n, op);
      break;
    case DataType::HVD_INT32:
      AccumulateT(static_cast<int32_t*>(dst),
                  static_cast<const int32_t*>(src), n, op);
      break;
    case DataType::HVD_INT64:
      AccumulateT(static_cast<int64_t*>(dst),
                  static_cast<const int64_t*>(src), n, op);
      break;
    case DataType::HVD_UINT8:
      AccumulateT(static_cast<uint8_t*>(dst),
                  static_cast<const uint8_t*>(src), n, op);
      break;
    case DataType::HVD_INT8:
      AccumulateT(static_cast<int8_t*>(dst), static_cast<const int8_t*>(src),
                  n, op);
      break;
    case DataType::HVD_UINT16:
      AccumulateT(static_cast<uint16_t*>(dst),
                  static_cast<const uint16_t*>(src), n, op);
      break;
    case DataType::HVD_INT16:
      AccumulateT(static_cast<int16_t*>(dst),
                  static_cast<const int16_t*>(src), n, op);
      break;
    case DataType::HVD_BOOL: {
      auto* d = static_cast<uint8_t*>(dst);
      auto* s = static_cast<const uint8_t*>(src);
      for (int64_t i = 0; i < n; ++i) d[i] = d[i] || s[i];
      break;
    }
    case DataType::HVD_FLOAT16:
    case DataType::HVD_BFLOAT16: {
      std::vector<float> a(n), b(n);
      ToFloat(dst, a.data(), n, dt);
      ToFloat(src, b.data(), n, dt);
      AccumulateT(a.data(), b.data(), n, op);
      FromFloat(a.data(), dst, n, dt);
      break;
    }
  }
}

void ScaleBuffer(void* data, int64_t n, DataType dt, double factor) {
  if (factor == 1.0) return;
  switch (dt) {
    case DataType::HVD_FLOAT32: {
      auto* p = static_cast<float*>(data);
      for (int64_t i = 0; i < n; ++i) p[i] *= static_cast<float>(factor);
      break;
    }
    case DataType::HVD_FLOAT64: {
      auto* p = static_cast<double*>(data);
      for (int64_t i = 0; i < n; ++i) p[i] *= factor;
      break;
    }
    case DataType::HVD_FLOAT16:
    case DataType::HVD_BFLOAT16: {
      std::vector<float> tmp(n);
      ToFloat(data, tmp.data(), n, dt);
      for (int64_t i = 0; i < n; ++i) tmp[i] *= static_cast<float>(factor);
      FromFloat(tmp.data(), data, n, dt);
      break;
    }
    default:
      break;  // integer scaling intentionally unsupported
  }
}

// Small-payload routing threshold (wire bytes): at or under it allreduces
// take the binomial-tree path instead of the chunked ring. The ring is
// bandwidth-optimal but its 2*(N-1) lock-stepped steps each wake every
// process — latency-hostile for the few-byte tensors of the cached
// negotiation fast path. Read once per process.
long long TreeThresholdBytes() {
  static const long long v = [] {
    const char* e = std::getenv("HOROVOD_RING_TREE_THRESHOLD");
    if (e != nullptr && *e != 0) {
      char* end = nullptr;
      long long n = std::strtoll(e, &end, 10);
      if (end != nullptr && *end == 0 && n >= 0) return n;
    }
    return 16384LL;
  }();
  return v;
}

}  // namespace

// TCP adapter for the transport registry: wraps the lazily-established
// PeerLink sockets so the registered fallback keeps both the existing
// framing (4-byte length prefix, exact-size validation) and the split
// local/cross traffic accounting.
class Ring::TcpPeerBackend : public TransportBackend {
 public:
  explicit TcpPeerBackend(Ring* ring) : ring_(ring) {}
  const char* Name() const override { return "tcp"; }
  bool Enabled() const override { return true; }
  int Send(int peer, const void* buf, size_t nbytes) override {
    Socket* s = ring_->PeerLink(peer);
    // Copy-free (ptr, len) frame: the old code staged a std::string of
    // the whole payload per member — 3x the buffer per broadcast on a
    // 4-local-rank host.
    if (s == nullptr || !s->SendFrame(buf, nbytes)) {
      return kTransportError;
    }
    ring_->AddSent(peer, nbytes);
    return kTransportOk;
  }
  int Recv(int peer, void* buf, size_t nbytes) override {
    // Copy-free, like Send: straight into the caller's buffer.
    Socket* s = ring_->PeerLink(peer);
    if (s == nullptr || !s->RecvFrameInto(buf, nbytes)) {
      return kTransportError;
    }
    return kTransportOk;
  }

 private:
  Ring* ring_;
};

void Ring::ConfigureTransports(bool use_shm, long long slot_bytes,
                               bool allow_fallthrough,
                               long long shm_wait_timeout_ms, int stripes,
                               long long chunk_bytes,
                               bool stripe_fallthrough) {
  OperationManager::ControlChannel ctl;
  // Control frames ride the PeerLink sockets (FIFO per direction, like
  // every payload fallback frame) and stay off the traffic counters:
  // they are negotiation, not payload.
  ctl.send = [this](int peer, const std::string& frame) {
    Socket* s = PeerLink(peer);
    return s != nullptr && s->SendFrame(frame);
  };
  ctl.recv = [this](int peer, std::string* frame) {
    Socket* s = PeerLink(peer);
    return s != nullptr && s->RecvFrame(frame);
  };
  op_mgr_ = std::make_unique<OperationManager>(ctl);
  tcp_backend_ = std::make_unique<TcpPeerBackend>(this);
  shm_ = std::make_unique<ShmTransport>();
  shm_->set_allow_fallthrough(allow_fallthrough);
  if (use_shm && group_.size() > 1) {
    std::vector<int> ports(size_);
    for (int r = 0; r < size_; ++r) ports[r] = endpoints_[r].second;
    if (!shm_->Init(rank_, group_, ports, slot_bytes,
                    shm_wait_timeout_ms)) {
      std::fprintf(stderr,
                   "[horovod_tpu] shm transport init failed at rank %d; "
                   "TCP carries the intra-host legs\n",
                   rank_);
    }
  }
  stripe_ = std::make_unique<StripeTransport>();
  stripe_->Init(rank_, endpoints_, stripes, chunk_bytes,
                stripe_fallthrough,
                [this](int peer) { return PumpStripeAccepts(peer); },
                epoch_);
  // The CROSS legs only route through the registry when striping is
  // configured: with K <= 1 they keep the direct PeerLink duplex — no
  // negotiation frames, bit-for-bit the pre-stripe path. K > 1 worlds
  // pay one control frame per (leg, direction, pair) first contact.
  cross_registry_ = stripes > 1;
  // Backend ids are the values exchanged in control frames, so the
  // registration ORDER must be identical on every rank: shm and stripe
  // are registered even when disabled on this rank (env off, init
  // failure) — Enabled()/Prepare() keep them out of every negotiation,
  // while the id table stays globally consistent.
  shm_backend_id_ = op_mgr_->RegisterBackend(shm_.get());
  stripe_backend_id_ = op_mgr_->RegisterBackend(stripe_.get());
  int tcp_id = op_mgr_->RegisterBackend(tcp_backend_.get());
  for (int leg = 0; leg < kNumTransportLegs; ++leg) {
    auto l = static_cast<TransportLeg>(leg);
    if (l == TransportLeg::CROSS_SEND || l == TransportLeg::CROSS_RECV) {
      op_mgr_->RegisterForLeg(l, stripe_backend_id_);
    } else {
      op_mgr_->RegisterForLeg(l, shm_backend_id_);
    }
    op_mgr_->RegisterForLeg(l, tcp_id);
  }
}

void Ring::ApplyStripeCount(int stripes) {
  if (stripe_ == nullptr || op_mgr_ == nullptr) return;
  // Clamp exactly like StripesFromEnv: the tuner hint arrives here on
  // every rank with the same wire value, so an identical clamp keeps the
  // lock-step agreement while protecting RecvPieces' fixed poll set from
  // an out-of-range hvd_set_stripes.
  if (stripes < 1) stripes = 1;
  if (stripes > StripeTransport::kMaxStripes)
    stripes = StripeTransport::kMaxStripes;
  if (stripes == stripe_->stripes()) return;
  // Frame-synced on every rank (RunLoopOnce applies the broadcast value
  // before executing the frame's responses), so both sides of every
  // leader pair drop their agreements and connections at the same
  // message boundary and the next cross transfer renegotiates cleanly.
  op_mgr_->ResetLeg(TransportLeg::CROSS_SEND);
  op_mgr_->ResetLeg(TransportLeg::CROSS_RECV);
  stripe_->SetStripes(stripes);
  cross_registry_ = stripes > 1;
}

bool Ring::LocalSend(TransportLeg leg, int peer, const void* buf,
                     size_t nbytes) {
  if (op_mgr_ == nullptr) {
    // Registry never configured (standalone rings in unit tests): the
    // pre-registry direct TCP frame.
    Socket* s = PeerLink(peer);
    if (s == nullptr || !s->SendFrame(buf, nbytes)) return false;
    AddSent(peer, nbytes);
    return true;
  }
  auto t0 = std::chrono::steady_clock::now();
  int id = op_mgr_->Send(leg, peer, buf, nbytes);
  if (id < 0) return false;
  if (id == shm_backend_id_) {
    // TCP sends account inside CountedSendFrame; shm payload counts
    // into the total here (and into the shm counter in the backend).
    bytes_sent_.fetch_add(static_cast<long long>(nbytes));
    metrics::Record(metrics::kShmLegUs,
                    std::chrono::duration_cast<std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - t0)
                        .count());
  }
  return true;
}

bool Ring::LocalRecv(TransportLeg leg, int peer, void* buf, size_t nbytes) {
  if (op_mgr_ == nullptr) {
    Socket* s = PeerLink(peer);
    return s != nullptr && s->RecvFrameInto(buf, nbytes);
  }
  auto t0 = std::chrono::steady_clock::now();
  int id = op_mgr_->Recv(leg, peer, buf, nbytes);
  if (id < 0) return false;
  if (id == shm_backend_id_) {
    metrics::Record(metrics::kShmLegUs,
                    std::chrono::duration_cast<std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - t0)
                        .count());
  }
  return true;
}

bool Ring::CtrlSendFrame(int peer, const std::string& payload) {
  // Length-prefixed so the receiver — whose LocalRecv needs an exact
  // byte count — can size the payload read. Two registry transfers per
  // frame; control frames are tens of bytes, so the second slot write
  // is noise next to the socket syscalls this leg exists to avoid.
  uint32_t len = static_cast<uint32_t>(payload.size());
  char hdr[4];
  std::memcpy(hdr, &len, 4);
  if (!LocalSend(TransportLeg::LOCAL_CTRL, peer, hdr, 4)) return false;
  if (len == 0) return true;
  return LocalSend(TransportLeg::LOCAL_CTRL, peer, payload.data(), len);
}

bool Ring::CtrlRecvFrame(int peer, std::string* payload) {
  char hdr[4];
  if (!LocalRecv(TransportLeg::LOCAL_CTRL, peer, hdr, 4)) return false;
  uint32_t len = 0;
  std::memcpy(&len, hdr, 4);
  // Control frames are negotiation metadata, never tensor payloads: a
  // length past this clamp is a corrupt or misrouted frame, not a big
  // message — fail hard like any transport error.
  if (len > (256u << 20)) return false;
  payload->assign(len, '\0');
  if (len == 0) return true;
  return LocalRecv(TransportLeg::LOCAL_CTRL, peer, &(*payload)[0], len);
}

void Ring::SetTopology(const std::vector<int>& cross_ranks) {
  if (static_cast<int>(cross_ranks.size()) != size_) return;
  cross_ranks_ = cross_ranks;
  // Host groups keyed by cross_rank; members ascend within a group, so
  // every rank derives the identical leader (the group's lowest rank)
  // without another exchange. Groups are then ordered by leader rank
  // ascending — the tree/sub-ring index math over `leaders_` requires a
  // sorted rank list, and cross_rank values carry no such guarantee.
  std::map<int, std::vector<int>> by_host;
  for (int r = 0; r < size_; ++r) by_host[cross_ranks[r]].push_back(r);
  std::map<int, std::vector<int>> by_leader;
  for (auto& kv : by_host) by_leader[kv.second.front()] = kv.second;
  groups_.clear();
  leaders_.clear();
  group_.clear();
  group_idx_ = -1;
  for (auto& kv : by_leader) {
    if (cross_ranks_[kv.first] == cross_ranks_[rank_]) {
      group_idx_ = static_cast<int>(leaders_.size());
      group_ = kv.second;
    }
    leaders_.push_back(kv.first);
    groups_.push_back(kv.second);
  }
}

bool Ring::IsCrossHost(int peer) const {
  // No topology installed: conservative one-process-per-host accounting
  // (every TCP byte presumed to cross hosts).
  if (cross_ranks_.empty() || peer < 0 || peer >= size_) return true;
  return cross_ranks_[peer] != cross_ranks_[rank_];
}

void Ring::AddSent(int peer, size_t nbytes) {
  long long n = static_cast<long long>(nbytes);
  bytes_sent_.fetch_add(n);
  if (IsCrossHost(peer)) {
    cross_bytes_sent_.fetch_add(n);
  } else {
    local_bytes_sent_.fetch_add(n);
  }
}

void Ring::SenderLoop() {
  UniqueLock lk(send_mu_);
  while (true) {
    // Written-out wait loop (no predicate lambda): the guarded reads
    // stay in this body, where the analysis tracks the UniqueLock.
    while (send_buf_ == nullptr && !sender_exit_) send_cv_.wait(lk);
    if (sender_exit_) return;
    const void* buf = send_buf_;
    size_t n = send_bytes_;
    Socket* sock = send_sock_;
    int peer = send_peer_;
    SendKind kind = send_kind_;
    lk.unlock();
    bool ok;
    if (kind == SendKind::kStripe) {
      // Striped cross-leg send: pieces round-robin across the pair's
      // stripe sockets while the posting thread receives — the send of
      // chunk i drains here as the receive of chunk i+1 progresses
      // there. The stripe backend counts its own bytes; AddSent keeps
      // cross_bytes byte-identical to the single-socket path.
      ok = stripe_->Send(peer, buf, n) == kTransportOk;
    } else {
      // Copy-free (ptr, len) frame: `buf` stays valid until send_done_,
      // so the old std::string staging (a full payload copy per ring
      // step) is pure waste.
      ok = sock->SendFrame(buf, n);
    }
    if (ok) AddSent(peer, n);
    lk.lock();
    send_buf_ = nullptr;
    send_done_ = true;
    send_ok_ = ok;
    send_cv_.notify_all();
  }
}

bool Ring::CountedSendFrame(Socket& sock, int peer,
                            const std::string& payload) {
  bool ok = sock.SendFrame(payload);
  if (ok) AddSent(peer, payload.size());
  return ok;
}

bool Ring::SendRecvDuplex(Socket* send_sock, int send_peer,
                          const void* sbuf, size_t sbytes,
                          Socket* recv_sock, void* rbuf, size_t rbytes) {
  bool send_ok = false, recv_ok = false;
  DuplexSplit(send_sock, send_peer, sbuf, sbytes, recv_sock, rbuf, rbytes,
              &send_ok, &recv_ok);
  return send_ok && recv_ok;
}

void Ring::DuplexSplit(Socket* send_sock, int send_peer, const void* sbuf,
                       size_t sbytes, Socket* recv_sock, void* rbuf,
                       size_t rbytes, bool* send_ok_out, bool* recv_ok_out) {
  static const char kEmpty = 0;
  // A null sbuf (legal for 0-byte fragments) must not look like "no
  // pending send" to the sender loop's wakeup predicate.
  if (sbuf == nullptr) sbuf = &kEmpty;
  {
    MutexLock lk(send_mu_);
    send_kind_ = SendKind::kTcpFrame;
    send_sock_ = send_sock;
    send_peer_ = send_peer;
    send_buf_ = sbuf;
    send_bytes_ = sbytes;
    send_done_ = false;
  }
  send_cv_.notify_all();
  std::string rframe;
  bool recv_ok = recv_sock->RecvFrame(&rframe) && rframe.size() == rbytes;
  {
    UniqueLock lk(send_mu_);
    while (!send_done_) send_cv_.wait(lk);
    if (recv_ok && rbytes > 0) std::memcpy(rbuf, rframe.data(), rbytes);
    *send_ok_out = send_ok_;
    *recv_ok_out = recv_ok;
  }
}

bool Ring::MaybeAdoptStripeHello(const std::string& hello, Socket& s) {
  if (hello.rfind("stripe ", 0) != 0) return false;
  int pr = -1, idx = -1;
  long long ep = -1;
  int fields =
      std::sscanf(hello.c_str(), "stripe %d %d %lld", &pr, &idx, &ep);
  if (fields >= 3 && ep >= 0 && ep != epoch_) {
    // A stripe dial from a different world incarnation: never adopt it
    // — its pieces would interleave into this world's streams. The
    // socket dies with the caller's scope.
    stale_epoch_rejected_.fetch_add(1);
    return true;
  }
  if (stripe_ != nullptr && fields >= 2) {
    stripe_->Adopt(pr, idx, std::move(s));
  }
  return true;
}

bool Ring::ParsePeerHello(const std::string& hello, int* peer, bool* stale) {
  if (hello.rfind("vhdd ", 0) != 0) return false;
  int pr = -1;
  long long ep = -1;
  int fields = std::sscanf(hello.c_str(), "vhdd %d %lld", &pr, &ep);
  if (fields < 1) return false;
  *peer = pr;
  *stale = fields >= 2 && ep >= 0 && ep != epoch_;
  return true;
}

bool Ring::PumpStripeAccepts(int peer) {
  // Accept until every stripe `peer` dialed toward this rank is
  // adopted. Stray hellos are stashed exactly as PeerLink's loop does:
  // "vhdd <r>" dials into peers_, other peers' stripe dials into the
  // stripe backend. Bounded so garbage hellos can't spin forever.
  if (listener_ == nullptr || stripe_ == nullptr) return false;
  for (int tries = 0; !stripe_->HasAllStripes(peer) && tries < 256;
       ++tries) {
    Socket s = listener_->Accept(120000);
    if (!s.valid()) return false;
    std::string hello;
    if (!s.RecvFrame(&hello)) continue;
    int pr = -1;
    bool stale = false;
    if (ParsePeerHello(hello, &pr, &stale)) {
      if (stale) {
        stale_epoch_rejected_.fetch_add(1);
        continue;
      }
      peers_[pr] = std::move(s);
      continue;
    }
    MaybeAdoptStripeHello(hello, s);
  }
  return stripe_->HasAllStripes(peer);
}

bool Ring::CrossSendRecv(int next, const void* sbuf, size_t sbytes,
                         int prev, void* rbuf, size_t rbytes,
                         const std::function<void(size_t, size_t)>&
                             on_piece) {
  // Leg-local timing (cross_leg_ns): the one honest clock for a
  // transport A/B — everything inside here IS the leader leg. The same
  // duration also lands in the metrics histograms (cross always, stripe
  // when the striped carrier is in active use) so the snapshot shows
  // the leg's latency distribution, not just its total.
  struct LegTimer {
    std::atomic<long long>& acc;
    bool striped;
    std::chrono::steady_clock::time_point t0 =
        std::chrono::steady_clock::now();
    ~LegTimer() {
      long long ns =
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - t0)
              .count();
      acc.fetch_add(ns);
      metrics::Record(metrics::kCrossLegUs, ns / 1000);
      if (striped) metrics::Record(metrics::kStripeLegUs, ns / 1000);
    }
  } timer{cross_ns_, stripe_ != nullptr && stripe_->active_stripes() > 0};
  if (!cross_registry_ || op_mgr_ == nullptr) {
    // Striping off: the direct PeerLink duplex, bit-for-bit the
    // pre-stripe path (no negotiation frames) — plus the self-healing
    // wrap (docs/self-healing.md): a lost leg redials in place and
    // resumes at the exact frame boundary instead of failing the
    // collective outright.
    Socket* snext = PeerLink(next);
    Socket* sprev = PeerLink(prev);
    if (snext == nullptr || sprev == nullptr) return false;
    if (cross_drop_at_ > 0 && ++cross_duplex_n_ == cross_drop_at_) {
      // HVD_FAULT_CROSS_DROP seam: cut the outbound cross link right
      // before this step's payload moves — both ends see a dead stream
      // mid-collective, the exact shape the healer must absorb.
      std::fprintf(stderr,
                   "[hvd fault] rank %d dropping cross link to %d before "
                   "duplex %lld\n",
                   rank_, next, cross_duplex_n_);
      snext->ShutdownBoth();
    }
    const long long base_send = cross_send_seq_[next];
    const long long base_recv = cross_recv_seq_[prev];
    bool send_ok = false, recv_ok = false;
    DuplexSplit(snext, next, sbuf, sbytes, sprev, rbuf, rbytes, &send_ok,
                &recv_ok);
    if (send_ok) cross_send_seq_[next] = base_send + 1;
    if (recv_ok) cross_recv_seq_[prev] = base_recv + 1;
    if (!send_ok || !recv_ok) {
      if (!HealCrossStep(next, sbuf, sbytes, prev, rbuf, rbytes, base_send,
                         base_recv)) {
        return false;
      }
    }
    if (on_piece) on_piece(0, rbytes);
    return true;
  }
  // Pin both directions' backends before any payload moves: the sender
  // side owns each choice and announces it on the PeerLink control
  // channel, so both ends of every pair switch at the same message
  // boundary (mixed pairs — striped one way, single-socket the other —
  // are fine; each direction is its own agreement).
  int sid = op_mgr_->AgreeSend(TransportLeg::CROSS_SEND, next);
  int rid = op_mgr_->AgreeRecv(TransportLeg::CROSS_RECV, prev);
  if (sid < 0 || rid < 0) return false;
  static const char kEmpty = 0;
  if (sbuf == nullptr) sbuf = &kEmpty;
  Socket* snext = nullptr;
  if (sid != stripe_backend_id_) {
    snext = PeerLink(next);
    if (snext == nullptr) return false;
  }
  {
    MutexLock lk(send_mu_);
    send_kind_ = sid == stripe_backend_id_ ? SendKind::kStripe
                                           : SendKind::kTcpFrame;
    send_sock_ = snext;
    send_peer_ = next;
    send_buf_ = sbuf;
    send_bytes_ = sbytes;
    send_done_ = false;
  }
  send_cv_.notify_all();
  bool recv_ok;
  if (rid == stripe_backend_id_) {
    // Poll across prev's stripe fds; each completed pipeline chunk is
    // handed to the caller while later chunks are still in flight.
    recv_ok = stripe_->RecvPieces(prev, rbuf, rbytes, on_piece) ==
              kTransportOk;
  } else {
    Socket* sprev = PeerLink(prev);
    recv_ok = sprev != nullptr && sprev->RecvFrameInto(rbuf, rbytes);
    if (recv_ok && on_piece) on_piece(0, rbytes);
  }
  UniqueLock lk(send_mu_);
  while (!send_done_) send_cv_.wait(lk);
  return send_ok_ && recv_ok;
}

bool Ring::HealPeerLink(int peer, long long deadline_ms,
                        long long* peer_send_seq, long long* peer_recv_seq) {
  // Drop the dead link first: erasing closes the fd, which also fails
  // the peer's half fast if it hasn't noticed the cut yet.
  peers_.erase(peer);
  long long remain = deadline_ms - SteadyNowMs();
  if (remain < 1) return false;
  Socket fresh;
  if (rank_ < peer) {
    // Same deterministic dial rule as PeerLink, bounded by the retry
    // deadline instead of the bootstrap timeout.
    fresh = Socket::Connect(endpoints_[peer].first, endpoints_[peer].second,
                            static_cast<int>(remain));
    if (!fresh.valid()) return false;
    if (!fresh.SendFrame("vhdd " + std::to_string(rank_) + " " +
                         std::to_string(epoch_))) {
      return false;
    }
  } else {
    for (int tries = 0; tries < 64 && !fresh.valid(); ++tries) {
      remain = deadline_ms - SteadyNowMs();
      if (remain < 1 || listener_ == nullptr) return false;
      Socket s = listener_->Accept(static_cast<int>(remain));
      if (!s.valid()) return false;
      std::string hello;
      if (!s.RecvFrame(&hello)) continue;
      if (MaybeAdoptStripeHello(hello, s)) continue;
      int pr = -1;
      bool stale = false;
      if (!ParsePeerHello(hello, &pr, &stale)) continue;
      if (stale) {
        stale_epoch_rejected_.fetch_add(1);
        continue;
      }
      if (pr == peer) {
        fresh = std::move(s);
      } else {
        peers_[pr] = std::move(s);
      }
    }
    if (!fresh.valid()) return false;
  }
  // Resume exchange over the fresh socket, before any payload. Dialer
  // speaks first — deterministic like the dial rule itself, so the two
  // ends never cross frames.
  std::string mine = SerializeResume(epoch_, rank_, cross_send_seq_[peer],
                                     cross_recv_seq_[peer]);
  std::string theirs;
  bool moved = rank_ < peer
                   ? fresh.SendFrame(mine) &&
                         fresh.RecvFrameTimeout(
                             &theirs,
                             static_cast<int>(
                                 std::max<long long>(
                                     1, deadline_ms - SteadyNowMs()))) == 1
                   : fresh.RecvFrameTimeout(
                         &theirs,
                         static_cast<int>(std::max<long long>(
                             1, deadline_ms - SteadyNowMs()))) == 1 &&
                         fresh.SendFrame(mine);
  if (!moved) return false;
  long long pep = -1, pss = -1, prs = -1;
  int prk = -1;
  if (!DeserializeResume(theirs, &pep, &prk, &pss, &prs) || prk != peer) {
    return false;
  }
  if (pep != epoch_) {
    // The far end belongs to a different world incarnation: resuming
    // would splice two worlds' byte streams. Reject and count.
    stale_epoch_rejected_.fetch_add(1);
    return false;
  }
  peers_[peer] = std::move(fresh);
  link_reconnects_.fetch_add(1);
  *peer_send_seq = pss;
  *peer_recv_seq = prs;
  return true;
}

bool Ring::HealCrossStep(int next, const void* sbuf, size_t sbytes,
                         int prev, void* rbuf, size_t rbytes,
                         long long base_send, long long base_recv) {
  const int attempts = LinkRetryAttempts();
  const long long backoff = LinkRetryBackoffMs();
  const long long deadline = SteadyNowMs() + LinkRetryDeadlineMs();
  for (int a = 0; a < attempts; ++a) {
    if (a > 0) {
      std::this_thread::sleep_for(std::chrono::milliseconds(backoff));
    }
    if (SteadyNowMs() >= deadline) break;
    bool need_send = cross_send_seq_[next] == base_send;
    bool need_recv = cross_recv_seq_[prev] == base_recv;
    if (!need_send && !need_recv) return true;
    // Redial every link with a pending leg; one redial + one resume
    // exchange covers both directions when next == prev (the two-host
    // leader pair, where a single socket is full-duplex).
    long long p_send = -1, p_recv = -1;
    if (need_send || (next == prev && need_recv)) {
      if (!HealPeerLink(next, deadline, &p_send, &p_recv)) continue;
      if (need_send) {
        if (p_recv == base_send + 1) {
          // The in-flight frame crossed before the cut: replaying it
          // would double-apply, so suppress it and count.
          resume_chunks_discarded_.fetch_add(1);
          cross_send_seq_[next] = base_send + 1;
          need_send = false;
        } else if (p_recv != base_send) {
          // More than one frame adrift — impossible under lock-step
          // duplex unless streams desynced. Unrecoverable in place.
          return false;
        }
      } else if (p_recv == base_send) {
        // Our send "succeeded" only into the dying socket's buffer: the
        // peer's resume says it is still waiting on THIS step's frame
        // (the model's resume_skips_chunk tooth, tools/hvdmc). The
        // caller buffer is live — same duplex step — so rewind the seq
        // and replay.
        cross_send_seq_[next] = base_send;
        need_send = true;
      } else if (p_recv != base_send + 1) {
        return false;
      }
      if (next == prev && need_recv && p_send != base_recv &&
          p_send != base_recv + 1) {
        return false;
      }
    }
    if (next != prev && need_recv) {
      if (!HealPeerLink(prev, deadline, &p_send, &p_recv)) continue;
      // p_send == base_recv + 1 is fine: the peer thinks it sent the
      // frame we never got; our resume told it our recv_seq, so it
      // rewinds and replays (its caller buffer is still live — it is
      // inside the same duplex step).
      if (p_send != base_recv && p_send != base_recv + 1) return false;
    }
    // Replay exactly the pending legs on the fresh link(s).
    Socket* snext = need_send ? PeerLink(next) : nullptr;
    Socket* sprev = need_recv ? PeerLink(prev) : nullptr;
    if ((need_send && snext == nullptr) ||
        (need_recv && sprev == nullptr)) {
      continue;
    }
    bool sok = !need_send, rok = !need_recv;
    if (need_send && need_recv) {
      DuplexSplit(snext, next, sbuf, sbytes, sprev, rbuf, rbytes, &sok,
                  &rok);
    } else if (need_send) {
      sok = snext->SendFrame(sbuf, sbytes);
      if (sok) AddSent(next, sbytes);
    } else if (need_recv) {
      rok = sprev->RecvFrameInto(rbuf, rbytes);
    }
    if (sok) cross_send_seq_[next] = base_send + 1;
    if (rok) cross_recv_seq_[prev] = base_recv + 1;
    if (sok && rok) return true;
  }
  return false;
}

bool Ring::SendRecvStep(const void* sbuf, size_t sbytes, void* rbuf,
                        size_t rbytes) {
  return SendRecvDuplex(&next_, (rank_ + 1) % size_, sbuf, sbytes, &prev_,
                        rbuf, rbytes);
}

Ring::Ring() = default;

Ring::~Ring() {
  if (sender_.joinable()) {
    {
      MutexLock lk(send_mu_);
      sender_exit_ = true;
    }
    send_cv_.notify_all();
    sender_.join();
  }
}

Status Ring::Connect(int rank, const std::vector<std::pair<std::string, int>>&
                                   endpoints,
                     Listener* listener) {
  rank_ = rank;
  size_ = static_cast<int>(endpoints.size());
  endpoints_ = endpoints;
  listener_ = listener;
  if (const char* spec = std::getenv("HVD_FAULT_CROSS_DROP")) {
    // Fault seam (docs/fault-injection.md): "rank:n" — on that rank, cut
    // the cross link right before its n-th cross duplex step.
    int fr = -1;
    long long fn = -1;
    if (std::sscanf(spec, "%d:%lld", &fr, &fn) == 2 && fr == rank_ &&
        fn > 0) {
      cross_drop_at_ = fn;
    }
  }
  if (size_ == 1) return Status::OK();
  int next_rank = (rank_ + 1) % size_;
  // Even ranks connect first then accept; odd ranks accept first — avoids
  // the circular wait when every rank dials simultaneously.
  auto dial = [&]() -> bool {
    next_ = Socket::Connect(endpoints[next_rank].first,
                            endpoints[next_rank].second, 120000);
    if (!next_.valid()) return false;
    return CountedSendFrame(next_, next_rank,
                            std::to_string(rank_) + " " +
                                std::to_string(epoch_));
  };
  int prev_rank = (rank_ - 1 + size_) % size_;
  auto answer = [&]() -> bool {
    // Accept until the peer introducing itself as prev arrives; stash
    // early VHDD peer dials (and stripe dials) instead of mistaking
    // them for prev. Any hello carrying a foreign world epoch is
    // rejected outright (docs/self-healing.md).
    for (int tries = 0; tries < 64; ++tries) {
      Socket s = listener->Accept(120000);
      if (!s.valid()) return false;
      std::string hello;
      if (!s.RecvFrame(&hello)) continue;
      int pr = -1;
      bool stale = false;
      if (ParsePeerHello(hello, &pr, &stale)) {
        if (stale) {
          stale_epoch_rejected_.fetch_add(1);
          continue;
        }
        peers_[pr] = std::move(s);
        continue;
      }
      if (MaybeAdoptStripeHello(hello, s)) continue;
      long long ep = -1;
      if (std::sscanf(hello.c_str(), "%d %lld", &pr, &ep) >= 2 &&
          ep >= 0 && ep != epoch_) {
        stale_epoch_rejected_.fetch_add(1);
        continue;
      }
      if (std::atoi(hello.c_str()) != prev_rank) continue;
      prev_ = std::move(s);
      return true;
    }
    return false;
  };
  bool ok = (rank_ % 2 == 0) ? (dial() && answer()) : (answer() && dial());
  if (!ok) {
    return Status::Error(StatusType::UNKNOWN_ERROR,
                         "ring neighbor connection failed at rank " +
                             std::to_string(rank_));
  }
  sender_ = std::thread(&Ring::SenderLoop, this);
  return Status::OK();
}

Status Ring::Allreduce(void* data, void* output, int64_t count, DataType dtype,
                       ReduceOp op, double prescale, double postscale) {
  int es = DataTypeSize(dtype);
  if (output != data) std::memcpy(output, data, count * es);
  ScaleBuffer(output, count, dtype, prescale);
  if (size_ > 1) {
    if (op == ReduceOp::ADASUM) {
      return Status::InvalidArgument("use AdasumAllreduce");
    }
    if (static_cast<long long>(count) * es <= TreeThresholdBytes()) {
      // Latency path: for tiny payloads (the cached negotiation round's
      // few-byte tensors) the chunked ring's 2*(size-1) lock-stepped
      // steps dominate RTT — wake O(size) processes total instead of
      // O(size^2).
      std::vector<int> all(size_);
      for (int r = 0; r < size_; ++r) all[r] = r;
      Status st = TreeAllreduce(output, count, dtype, op, all);
      if (!st.ok()) return st;
    } else {
    // chunk partition
    std::vector<int64_t> offs(size_ + 1);
    for (int i = 0; i <= size_; ++i) offs[i] = count * i / size_;
    auto chunk_ptr = [&](int c) {
      return static_cast<char*>(output) + offs[c] * es;
    };
    auto chunk_n = [&](int c) { return offs[c + 1] - offs[c]; };
    int64_t max_chunk = 0;
    for (int c = 0; c < size_; ++c) max_chunk = std::max(max_chunk, chunk_n(c));
    std::vector<char> recv_buf(max_chunk * es);

    // reduce-scatter
    for (int step = 0; step < size_ - 1; ++step) {
      int send_c = ((rank_ - step) % size_ + size_) % size_;
      int recv_c = ((rank_ - step - 1) % size_ + size_) % size_;
      if (!SendRecvStep(chunk_ptr(send_c), chunk_n(send_c) * es,
                        recv_buf.data(), chunk_n(recv_c) * es)) {
        return Status::Aborted("ring allreduce communication failure");
      }
      Accumulate(chunk_ptr(recv_c), recv_buf.data(), chunk_n(recv_c), dtype,
                 op);
    }
    // allgather
    for (int step = 0; step < size_ - 1; ++step) {
      int send_c = ((rank_ + 1 - step) % size_ + size_) % size_;
      int recv_c = ((rank_ - step) % size_ + size_) % size_;
      if (!SendRecvStep(chunk_ptr(send_c), chunk_n(send_c) * es,
                        recv_buf.data(), chunk_n(recv_c) * es)) {
        return Status::Aborted("ring allgather communication failure");
      }
      std::memcpy(chunk_ptr(recv_c), recv_buf.data(), chunk_n(recv_c) * es);
    }
    }
  }
  if (op == ReduceOp::AVERAGE) {
    ScaleBuffer(output, count, dtype, 1.0 / size_);
  }
  ScaleBuffer(output, count, dtype, postscale);
  return Status::OK();
}

Status Ring::TreeAllreduce(void* buf, int64_t count, DataType dtype,
                           ReduceOp op, const std::vector<int>& ranks) {
  // Binomial reduce to ranks[0], binomial broadcast back (any participant
  // count, tree rooted at index 0). Every link used by the broadcast was
  // established by the reduce (same parent/child pairs), and a parent is
  // always the lower rank of its pairs, so PeerLink's lower-dials rule
  // never deadlocks: dials are non-blocking and accepts stash strays.
  int n = static_cast<int>(ranks.size());
  if (n <= 1) return Status::OK();
  int idx = static_cast<int>(
      std::lower_bound(ranks.begin(), ranks.end(), rank_) - ranks.begin());
  if (idx >= n || ranks[idx] != rank_) {
    return Status::InvalidArgument("tree allreduce: caller not in group");
  }
  int es = DataTypeSize(dtype);
  size_t nbytes = static_cast<size_t>(count) * es;
  int sent_mask = 0;  // the level at which this index reduced up
  for (int mask = 1; mask < n; mask <<= 1) {
    if (idx & mask) {
      int parent = ranks[idx - mask];
      Socket* s = PeerLink(parent);
      if (s == nullptr ||
          !CountedSendFrame(*s, parent, std::string(
              static_cast<const char*>(buf), nbytes))) {
        return Status::Aborted("tree reduce send failed");
      }
      sent_mask = mask;
      break;
    }
    int src = idx + mask;
    if (src < n) {
      Socket* s = PeerLink(ranks[src]);
      std::string frame;
      if (s == nullptr || !s->RecvFrame(&frame) ||
          frame.size() != nbytes) {
        return Status::Aborted("tree reduce recv failed");
      }
      Accumulate(buf, frame.data(), count, dtype, op);
    }
  }
  int top;
  if (idx == 0) {
    top = 1;
    while (top < n) top <<= 1;
    top >>= 1;
  } else {
    Socket* s = PeerLink(ranks[idx - sent_mask]);
    std::string frame;
    if (s == nullptr || !s->RecvFrame(&frame) || frame.size() != nbytes) {
      return Status::Aborted("tree bcast recv failed");
    }
    std::memcpy(buf, frame.data(), nbytes);
    top = sent_mask >> 1;
  }
  for (int d = top; d >= 1; d >>= 1) {
    if (idx + d < n) {
      Socket* s = PeerLink(ranks[idx + d]);
      if (s == nullptr ||
          !CountedSendFrame(*s, ranks[idx + d], std::string(
              static_cast<const char*>(buf), nbytes))) {
        return Status::Aborted("tree bcast send failed");
      }
    }
  }
  return Status::OK();
}

Status Ring::SubRingAllreduce(void* buf, int64_t count, DataType dtype,
                              ReduceOp op, const std::vector<int>& ranks) {
  // The flat chunked ring (reduce-scatter + allgather) over an arbitrary
  // sorted rank subset, on direct peer links — the cross-host leader leg
  // of the hierarchical path. Bandwidth-optimal: each participant puts
  // 2*count*(H-1)/H elements on the wire.
  int n = static_cast<int>(ranks.size());
  if (n <= 1) return Status::OK();
  if (static_cast<long long>(count) * DataTypeSize(dtype) <=
      TreeThresholdBytes()) {
    return TreeAllreduce(buf, count, dtype, op, ranks);
  }
  int idx = static_cast<int>(
      std::lower_bound(ranks.begin(), ranks.end(), rank_) - ranks.begin());
  if (idx >= n || ranks[idx] != rank_) {
    return Status::InvalidArgument("sub-ring allreduce: caller not in group");
  }
  int next = ranks[(idx + 1) % n];
  int prev = ranks[(idx - 1 + n) % n];
  int es = DataTypeSize(dtype);
  std::vector<int64_t> offs(n + 1);
  for (int i = 0; i <= n; ++i) offs[i] = count * i / n;
  auto chunk_ptr = [&](int c) {
    return static_cast<char*>(buf) + offs[c] * es;
  };
  auto chunk_n = [&](int c) { return offs[c + 1] - offs[c]; };
  int64_t max_chunk = 0;
  for (int c = 0; c < n; ++c) max_chunk = std::max(max_chunk, chunk_n(c));
  std::vector<char> recv_buf(max_chunk * es);
  for (int step = 0; step < n - 1; ++step) {
    int send_c = ((idx - step) % n + n) % n;
    int recv_c = ((idx - step - 1) % n + n) % n;
    // Pipelined reduce-scatter step: each received pipeline chunk is
    // accumulated the moment it completes, overlapping the reduction
    // with the chunks still in flight (and with this step's outgoing
    // send draining on the sender thread). Pieces cover disjoint,
    // element-aligned spans, so piecewise accumulation is bitwise the
    // whole-buffer accumulation — the transport never touches the
    // chunk math.
    char* dst = chunk_ptr(recv_c);
    auto acc_piece = [&](size_t off, size_t len) {
      Accumulate(dst + off, recv_buf.data() + off,
                 static_cast<int64_t>(len / es), dtype, op);
    };
    if (!CrossSendRecv(next, chunk_ptr(send_c), chunk_n(send_c) * es,
                       prev, recv_buf.data(), chunk_n(recv_c) * es,
                       acc_piece)) {
      return Status::Aborted("sub-ring reduce-scatter failure");
    }
  }
  for (int step = 0; step < n - 1; ++step) {
    int send_c = ((idx + 1 - step) % n + n) % n;
    int recv_c = ((idx - step) % n + n) % n;
    // Allgather steps land in place: the incoming chunk IS the final
    // bytes, so the striped path writes pieces straight into the output
    // (the single-socket path keeps its one bounce copy).
    if (!CrossSendRecv(next, chunk_ptr(send_c), chunk_n(send_c) * es,
                       prev, chunk_ptr(recv_c), chunk_n(recv_c) * es)) {
      return Status::Aborted("sub-ring allgather failure");
    }
  }
  return Status::OK();
}

void Ring::AbortLocalWaiters() {
  // A leader failing mid-collective (cross leg aborted, strict-mode
  // stripe/shm refusal, gather recv error) must not leave its members
  // parked on the phase-3 bcast receive until liveness eviction: a
  // 0-byte frame on the LOCAL_BCAST channel fails their size-checked
  // receive immediately (TCP: RecvFrameInto length mismatch; shm:
  // chunk-length mismatch), so the whole host errors together and the
  // elastic retry loop takes over. Best-effort by design — the
  // collective is already failing.
  static const char kZero = 0;
  for (int m : group_) {
    if (m == rank_) continue;
    LocalSend(TransportLeg::LOCAL_BCAST, m, &kZero, 0);
  }
}

Status Ring::HierAllreduce(void* data, void* output, int64_t count,
                           DataType dtype, ReduceOp op, double prescale,
                           double postscale) {
  if (op == ReduceOp::ADASUM) {
    return Status::InvalidArgument("use AdasumAllreduce");
  }
  // Degenerate topologies where two-level == flat: no topology table, a
  // single host (everything is loopback anyway), or one rank per host
  // (the leader ring IS the flat ring).
  if (cross_ranks_.empty() || leaders_.size() <= 1 ||
      static_cast<int>(leaders_.size()) == size_) {
    return Allreduce(data, output, count, dtype, op, prescale, postscale);
  }
  int es = DataTypeSize(dtype);
  size_t nbytes = static_cast<size_t>(count) * es;
  if (output != data) std::memcpy(output, data, count * es);
  ScaleBuffer(output, count, dtype, prescale);
  int leader = group_.front();
  // Phase 1: intra-host reduce to the local leader through the
  // transport registry — shm rings when attached (zero socket
  // syscalls), loopback TCP PeerLink frames as the registered fallback.
  // Deterministic ascending-member order, so every run sums in the same
  // order. The reference's NCCLReduce-to-local-root leg
  // (nccl_operations.cc:164-357).
  if (rank_ != leader) {
    if (!LocalSend(TransportLeg::LOCAL_REDUCE, leader, output, nbytes)) {
      return Status::Aborted("hier intra-host reduce send failed");
    }
  } else {
    std::vector<char> member_buf(nbytes);
    for (int m : group_) {
      if (m == rank_) continue;
      if (!LocalRecv(TransportLeg::LOCAL_REDUCE, m, member_buf.data(),
                     nbytes)) {
        AbortLocalWaiters();
        return Status::Aborted("hier intra-host reduce recv failed");
      }
      Accumulate(output, member_buf.data(), count, dtype, op);
    }
    // Phase 2: cross-host leg among leaders only — every byte that
    // crosses the slow links is paid once per host, not once per rank.
    Status st = SubRingAllreduce(output, count, dtype, op, leaders_);
    if (!st.ok()) {
      AbortLocalWaiters();
      return st;
    }
    // Phase 3: intra-host broadcast of the reduced result. A failed
    // send still aborts the waiters: members later in group_ have not
    // been served yet and would otherwise park until liveness eviction.
    for (int m : group_) {
      if (m == rank_) continue;
      if (!LocalSend(TransportLeg::LOCAL_BCAST, m, output, nbytes)) {
        AbortLocalWaiters();
        return Status::Aborted("hier intra-host bcast send failed");
      }
    }
  }
  if (rank_ != leader) {
    if (!LocalRecv(TransportLeg::LOCAL_BCAST, leader, output, nbytes)) {
      return Status::Aborted("hier intra-host bcast recv failed");
    }
  }
  if (op == ReduceOp::AVERAGE) {
    ScaleBuffer(output, count, dtype, 1.0 / size_);
  }
  ScaleBuffer(output, count, dtype, postscale);
  return Status::OK();
}

Status Ring::HierAllgatherv(const void* data, void* output,
                            const std::vector<int64_t>& counts,
                            DataType dtype) {
  if (static_cast<int>(counts.size()) != size_) {
    return Status::InvalidArgument("allgatherv counts/world size mismatch");
  }
  if (cross_ranks_.empty() || leaders_.size() <= 1 ||
      static_cast<int>(leaders_.size()) == size_) {
    return Allgatherv(data, output, counts, dtype);
  }
  int es = DataTypeSize(dtype);
  std::vector<int64_t> disp(size_ + 1, 0);
  for (int r = 0; r < size_; ++r) disp[r + 1] = disp[r] + counts[r] * es;
  char* out = static_cast<char*>(output);
  std::memcpy(out + disp[rank_], data, counts[rank_] * es);
  int leader = group_.front();
  size_t total = static_cast<size_t>(disp[size_]);
  if (rank_ != leader) {
    // Phase 1: hand my block to the leader; phase 3: receive the fully
    // assembled result. Both legs are intra-host: shm when attached,
    // loopback TCP as the registered fallback. Zero-count blocks are
    // skipped symmetrically on both sides.
    if (counts[rank_] > 0 &&
        !LocalSend(TransportLeg::LOCAL_GATHER, leader, out + disp[rank_],
                   counts[rank_] * es)) {
      return Status::Aborted("hier allgather gather send failed");
    }
    if (!LocalRecv(TransportLeg::LOCAL_BCAST, leader, out, total)) {
      return Status::Aborted("hier allgather result recv failed");
    }
    return Status::OK();
  }
  // Leader: collect the host's blocks into place.
  for (int m : group_) {
    if (m == rank_ || counts[m] == 0) continue;
    if (!LocalRecv(TransportLeg::LOCAL_GATHER, m, out + disp[m],
                   counts[m] * es)) {
      AbortLocalWaiters();
      return Status::Aborted("hier allgather gather recv failed");
    }
  }
  // Phase 2: ring the per-host bundles around the leaders. A bundle is
  // the host's rank blocks concatenated in rank order — hosts need not
  // be contiguous in rank space (round-robin placement), so bundles are
  // (de)serialized against the global displacement map on each hop.
  int H = static_cast<int>(leaders_.size());
  auto bundle_bytes = [&](int g) {
    size_t b = 0;
    for (int m : groups_[g]) b += static_cast<size_t>(counts[m] * es);
    return b;
  };
  auto pack = [&](int g) {
    std::string b;
    b.reserve(bundle_bytes(g));
    for (int m : groups_[g]) b.append(out + disp[m], counts[m] * es);
    return b;
  };
  auto unpack = [&](int g, const std::string& b) {
    size_t off = 0;
    for (int m : groups_[g]) {
      std::memcpy(out + disp[m], b.data() + off, counts[m] * es);
      off += static_cast<size_t>(counts[m] * es);
    }
  };
  int next = leaders_[(group_idx_ + 1) % H];
  int prev = leaders_[(group_idx_ - 1 + H) % H];
  for (int step = 0; step < H - 1; ++step) {
    int send_g = ((group_idx_ - step) % H + H) % H;
    int recv_g = ((group_idx_ - step - 1) % H + H) % H;
    std::string sbuf = pack(send_g);
    std::string rbuf(bundle_bytes(recv_g), 0);
    // Leader bundle exchange through the cross registry: striped +
    // pipelined when negotiated, single-socket otherwise (the bundle is
    // (de)serialized against the displacement map either way, so the
    // per-piece hook is unused — unpack needs the whole bundle).
    if (!CrossSendRecv(next, sbuf.data(), sbuf.size(), prev,
                       rbuf.empty() ? nullptr : &rbuf[0], rbuf.size())) {
      AbortLocalWaiters();
      return Status::Aborted("hier allgather leader ring failure");
    }
    unpack(recv_g, rbuf);
  }
  // Phase 3: hand the assembled result to every local member. As in
  // HierAllreduce, a failed send aborts the not-yet-served waiters.
  for (int m : group_) {
    if (m == rank_) continue;
    if (!LocalSend(TransportLeg::LOCAL_BCAST, m, out, total)) {
      AbortLocalWaiters();
      return Status::Aborted("hier allgather result send failed");
    }
  }
  return Status::OK();
}

Status Ring::Allgather(const void* data, void* output, int64_t count,
                       DataType dtype) {
  return Allgatherv(data, output, std::vector<int64_t>(size_, count), dtype);
}

Status Ring::Allgatherv(const void* data, void* output,
                        const std::vector<int64_t>& counts, DataType dtype) {
  if (static_cast<int>(counts.size()) != size_) {
    return Status::InvalidArgument("allgatherv counts/world size mismatch");
  }
  int es = DataTypeSize(dtype);
  // Displacements: rank r's block starts at the sum of earlier ranks'
  // counts (reference SetDisplacements, ops/collective_operations.cc).
  std::vector<int64_t> disp(size_ + 1, 0);
  for (int r = 0; r < size_; ++r) disp[r + 1] = disp[r] + counts[r] * es;
  char* out = static_cast<char*>(output);
  std::memcpy(out + disp[rank_], data, counts[rank_] * es);
  for (int step = 0; step < size_ - 1; ++step) {
    int send_c = ((rank_ - step) % size_ + size_) % size_;
    int recv_c = ((rank_ - step - 1) % size_ + size_) % size_;
    if (!SendRecvStep(out + disp[send_c], counts[send_c] * es,
                      out + disp[recv_c], counts[recv_c] * es)) {
      return Status::Aborted("ring allgather communication failure");
    }
  }
  return Status::OK();
}

Status Ring::Broadcast(void* data, int64_t count, DataType dtype, int root) {
  if (size_ == 1) return Status::OK();
  int es = DataTypeSize(dtype);
  size_t nbytes = count * es;
  // pipeline around the ring, root -> ... -> root-1
  bool is_last = ((rank_ + 1) % size_) == root;
  int next_rank = (rank_ + 1) % size_;
  if (rank_ == root) {
    std::string payload(static_cast<const char*>(data), nbytes);
    if (!CountedSendFrame(next_, next_rank, payload)) {
      return Status::Aborted("bcast send failed");
    }
  } else {
    std::string frame;
    if (!prev_.RecvFrame(&frame) || frame.size() != nbytes) {
      return Status::Aborted("bcast recv failed");
    }
    std::memcpy(data, frame.data(), nbytes);
    if (!is_last) {
      if (!CountedSendFrame(next_, next_rank, frame)) {
        return Status::Aborted("bcast fwd failed");
      }
    }
  }
  return Status::OK();
}

Socket* Ring::PeerLink(int peer) {
  auto it = peers_.find(peer);
  if (it != peers_.end()) return &it->second;
  if (peer < 0 || peer >= size_ || peer == rank_) return nullptr;
  if (rank_ < peer) {
    if (!stale_hello_fired_) {
      const char* e = std::getenv("HVD_TEST_STALE_HELLO");
      if (e != nullptr && *e != 0 && std::strcmp(e, "0") != 0) {
        // Fencing seam (a self-healing test's): before the real dial,
        // burn one throwaway connection introducing itself with LAST
        // world's epoch. The peer's accept loop must reject it (counted
        // in its stale_epoch_rejected) and still adopt the real dial.
        stale_hello_fired_ = true;
        Socket stale = Socket::Connect(endpoints_[peer].first,
                                       endpoints_[peer].second, 120000);
        if (stale.valid()) {
          stale.SendFrame("vhdd " + std::to_string(rank_) + " " +
                          std::to_string(epoch_ - 1));
        }
      }
    }
    // Lower rank dials; deterministic on both sides, so no crossed dials.
    Socket s = Socket::Connect(endpoints_[peer].first,
                               endpoints_[peer].second, 120000);
    if (!s.valid()) return nullptr;
    if (!CountedSendFrame(s, peer,
                          "vhdd " + std::to_string(rank_) + " " +
                              std::to_string(epoch_)))
      return nullptr;
    peers_[peer] = std::move(s);
  } else {
    // Higher rank accepts. Dials from *other* lower peers can arrive
    // first (ranks progress through VHDD levels at different speeds);
    // stash them by rank instead of mis-assigning. Stripe dials landing
    // here are stashed for the stripe backend's PrepareRecv. Bounded
    // like Connect's answer loop so garbage hellos can't spin forever.
    for (int tries = 0;
         peers_.find(peer) == peers_.end() && tries < 64; ++tries) {
      if (listener_ == nullptr) return nullptr;
      Socket s = listener_->Accept(120000);
      if (!s.valid()) return nullptr;
      std::string hello;
      if (!s.RecvFrame(&hello)) continue;
      if (MaybeAdoptStripeHello(hello, s)) continue;
      int pr = -1;
      bool stale = false;
      if (!ParsePeerHello(hello, &pr, &stale)) continue;
      if (stale) {
        stale_epoch_rejected_.fetch_add(1);
        continue;
      }
      peers_[pr] = std::move(s);
    }
    if (peers_.find(peer) == peers_.end()) return nullptr;
  }
  return &peers_[peer];
}

Status Ring::ScalarTreeAllreduce(std::vector<double>& vals, int span) {
  // Fixed binomial tree over the `span`-rank block containing this rank
  // (the role of the reference's reduction_comms, adasum_mpi.cc:29-69):
  // reduce to the block root, broadcast the exact bytes back down — every
  // rank ends with bitwise-identical scalars, so the coefficients applied
  // to the distributed fragments agree everywhere.
  size_t nbytes = vals.size() * sizeof(double);
  int rb = rank_ & (span - 1);
  for (int d = 1; d < span; d <<= 1) {
    int low = rb & (2 * d - 1);
    if (low == d) {
      Socket* s = PeerLink(rank_ ^ d);
      if (s == nullptr ||
          !CountedSendFrame(*s, rank_ ^ d, std::string(
              reinterpret_cast<const char*>(vals.data()), nbytes))) {
        return Status::Aborted("adasum scalar reduce send failed");
      }
      break;
    }
    if (low == 0) {
      Socket* s = PeerLink(rank_ ^ d);
      std::string frame;
      if (s == nullptr || !s->RecvFrame(&frame) || frame.size() != nbytes) {
        return Status::Aborted("adasum scalar reduce recv failed");
      }
      const double* other = reinterpret_cast<const double*>(frame.data());
      for (size_t i = 0; i < vals.size(); ++i) vals[i] += other[i];
    }
  }
  for (int d = span >> 1; d >= 1; d >>= 1) {
    int low = rb & (2 * d - 1);
    if (low == 0) {
      Socket* s = PeerLink(rank_ ^ d);
      if (s == nullptr ||
          !CountedSendFrame(*s, rank_ ^ d, std::string(
              reinterpret_cast<const char*>(vals.data()), nbytes))) {
        return Status::Aborted("adasum scalar bcast send failed");
      }
    } else if (low == d) {
      Socket* s = PeerLink(rank_ ^ d);
      std::string frame;
      if (s == nullptr || !s->RecvFrame(&frame) || frame.size() != nbytes) {
        return Status::Aborted("adasum scalar bcast recv failed");
      }
      std::memcpy(vals.data(), frame.data(), nbytes);
    }
  }
  return Status::OK();
}

Status Ring::PairwiseCombine(char* a, const char* b,
                             const std::vector<int64_t>& counts, int level,
                             bool is_left, DataType work_dt) {
  // Per-tensor dot/norms on the local fragments, reduced over the
  // 2*level block so they cover the pair's FULL vectors, then the Adasum
  // linear combination per tensor (reference
  // FusedPairwiseReduceWithComm, adasum.h:338-398). Scalar slots are
  // packed canonically as (dot, left-norm, right-norm) so both sides of
  // the pair sum agreeing layouts. ``work_dt`` is the wire/storage
  // element: fp32, or the caller's own 16-bit float — fragments then
  // convert through fp32 scratch for the math and round back per level
  // (the reference's AVX fp16 path semantics, adasum.h:426-546).
  // Zero-norm fallback threshold. The reference uses sqrt(DBL_MIN)
  // (adasum.h:345); this repo standardizes on 1e-30 across both planes
  // (the Python Adasum's combine and reference) so host- and
  // XLA-plane results agree in the degenerate-input regime too.
  static const double kNormFloor = 1e-30;
  const bool narrow = work_dt != DataType::HVD_FLOAT32;
  size_t T = counts.size();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  std::vector<double> scal(3 * T, 0.0);

  // Narrow path: convert both spans to fp32 ONCE, do all math on the
  // scratch, round back with one FromFloat at the end (per-level
  // rounding, exactly the reference's fp16 buffer behavior).
  std::vector<float> fa, fb;
  float* ap;
  const float* bp;
  if (narrow) {
    fa.resize(total);
    fb.resize(total);
    ToFloat(a, fa.data(), total, work_dt);
    ToFloat(b, fb.data(), total, work_dt);
    ap = fa.data();
    bp = fb.data();
  } else {
    ap = reinterpret_cast<float*>(a);
    bp = reinterpret_cast<const float*>(b);
  }

  int64_t off = 0;
  for (size_t t = 0; t < T; ++t) {
    double dot = 0, mine = 0, theirs = 0;
    for (int64_t i = 0; i < counts[t]; ++i) {
      double x = ap[off + i], y = bp[off + i];
      dot += x * y;
      mine += x * x;
      theirs += y * y;
    }
    scal[3 * t] = dot;
    scal[3 * t + 1] = is_left ? mine : theirs;
    scal[3 * t + 2] = is_left ? theirs : mine;
    off += counts[t];
  }
  Status s = ScalarTreeAllreduce(scal, 2 * level);
  if (!s.ok()) return s;
  off = 0;
  for (size_t t = 0; t < T; ++t) {
    double dot = scal[3 * t];
    double anorm = is_left ? scal[3 * t + 1] : scal[3 * t + 2];
    double bnorm = is_left ? scal[3 * t + 2] : scal[3 * t + 1];
    double ac = anorm >= kNormFloor ? 1.0 - dot / anorm * 0.5 : 1.0;
    double bc = bnorm >= kNormFloor ? 1.0 - dot / bnorm * 0.5 : 1.0;
    for (int64_t i = 0; i < counts[t]; ++i) {
      ap[off + i] = static_cast<float>(ac * ap[off + i]
                                       + bc * bp[off + i]);
    }
    off += counts[t];
  }
  if (narrow) {
    FromFloat(fa.data(), a, total, work_dt);
  }
  return Status::OK();
}

namespace {

// Split `cur` per-tensor counts at element position `cut` (prefix
// length): `prefix[i]` + `suffix[i]` == cur[i], prefix filled greedily in
// tensor order (reference nghrCountVec bookkeeping, adasum.h:240-290).
void SplitCounts(const std::vector<int64_t>& cur, int64_t cut,
                 std::vector<int64_t>* prefix, std::vector<int64_t>* suffix) {
  prefix->assign(cur.size(), 0);
  suffix->assign(cur.size(), 0);
  int64_t sofar = 0;
  for (size_t i = 0; i < cur.size(); ++i) {
    int64_t take = std::max<int64_t>(
        0, std::min(cur[i], cut - sofar));
    (*prefix)[i] = take;
    (*suffix)[i] = cur[i] - take;
    sofar += cur[i];
  }
}

}  // namespace

Status Ring::AdasumAllreduce(void* data, void* output,
                             const std::vector<int64_t>& tensor_counts,
                             DataType dtype, double prescale,
                             double postscale) {
  // True vector-halving distance-doubling (reference FusedAllreduce,
  // adasum.h:194-336): at each doubling level exchange *halves* with
  // rank^level, combine per tensor with block-reduced scalars, then
  // distance-halving allgather back. Per-rank wire traffic is O(count)
  // (count/2 + count/4 + ... down, the reverse up) versus the
  // O(count*size) of an allgather-everything scheme. 16-bit floats ride
  // the wire AT 16-BIT WIDTH with fp32 math per level (the reference's
  // AVX fp16 path, adasum.h:426-546); fp32/fp64 work in fp32.
  int64_t count = 0;
  for (int64_t c : tensor_counts) count += c;
  if ((size_ & (size_ - 1)) != 0) {
    return Status::InvalidArgument(
        "Adasum requires a power-of-two world size");
  }
  if (!(Is16BitFloat(dtype) || dtype == DataType::HVD_FLOAT32 ||
        dtype == DataType::HVD_FLOAT64)) {
    return Status::InvalidArgument("Adasum requires floating point data");
  }

  // Working buffer in the WIRE dtype: the caller's own 16-bit float, or
  // fp32 for fp32/fp64 inputs.
  const DataType work_dt =
      Is16BitFloat(dtype) ? dtype : DataType::HVD_FLOAT32;
  const int wes = DataTypeSize(work_dt);
  std::vector<char> work(static_cast<size_t>(count) * wes);
  std::vector<char> recv(static_cast<size_t>(count) * wes);
  if (Is16BitFloat(dtype) || dtype == DataType::HVD_FLOAT32) {
    std::memcpy(work.data(), data, static_cast<size_t>(count) * wes);
  } else {
    auto* p = static_cast<const double*>(data);
    auto* w = reinterpret_cast<float*>(work.data());
    for (int64_t i = 0; i < count; ++i) w[i] = static_cast<float>(p[i]);
  }
  // Pre/postscale parity with the non-Adasum path and the XLA plane
  // (grouped_allreduce applies _apply_prescale/_apply_postscale).
  if (prescale != 1.0) {
    ScaleBuffer(work.data(), count, work_dt, prescale);
  }

  if (size_ > 1) {
    char* grad = work.data();
    char* rbuf = recv.data();
    std::vector<int64_t> my_counts = tensor_counts;
    int64_t my_count = count;
    struct LevelInfo {
      std::vector<int64_t> nghr_counts;
      int64_t nghr_count;
    };
    std::vector<LevelInfo> hist;

    for (int level = 1; level < size_; level <<= 1) {
      Socket* peer = PeerLink(rank_ ^ level);
      if (peer == nullptr) {
        return Status::Aborted("adasum peer link failed at level " +
                               std::to_string(level));
      }
      int64_t first_half = my_count >> 1;
      int64_t second_half = my_count - first_half;
      LevelInfo li;
      std::vector<int64_t> kept;
      int64_t send_off, nghr;
      bool is_left = (rank_ & level) == 0;
      if (is_left) {
        // Keep the low (first) half; the partner takes the suffix.
        nghr = second_half;
        SplitCounts(my_counts, first_half, &kept, &li.nghr_counts);
        my_count = first_half;
        send_off = my_count;
      } else {
        // Keep the high half; the partner takes the prefix.
        nghr = first_half;
        SplitCounts(my_counts, first_half, &li.nghr_counts, &kept);
        my_count = second_half;
        send_off = 0;
      }
      my_counts = kept;
      li.nghr_count = nghr;
      // Full-duplex half-exchange: my outgoing half against the
      // partner's fragment aligned with what I keep.
      if (!SendRecvDuplex(peer, rank_ ^ level, grad + send_off * wes,
                          nghr * wes, peer,
                          rbuf + (is_left ? 0 : nghr * wes),
                          my_count * wes)) {
        return Status::Aborted("adasum half-exchange failed");
      }
      if (!is_left) {
        grad += nghr * wes;
        rbuf += nghr * wes;
      }
      Status s = PairwiseCombine(grad, rbuf, my_counts, level, is_left,
                                 work_dt);
      if (!s.ok()) return s;
      hist.push_back(std::move(li));
    }

    // Distance-halving allgather: undo each split in reverse, exchanging
    // full fragments with the same partners.
    for (int level = size_ >> 1; level >= 1; level >>= 1) {
      LevelInfo li = std::move(hist.back());
      hist.pop_back();
      Socket* peer = PeerLink(rank_ ^ level);
      bool is_left = (rank_ & level) == 0;
      char* rdst = is_left ? grad + my_count * wes
                           : grad - li.nghr_count * wes;
      if (!SendRecvDuplex(peer, rank_ ^ level, grad, my_count * wes, peer,
                          rdst, li.nghr_count * wes)) {
        return Status::Aborted("adasum allgather exchange failed");
      }
      if (!is_left) grad -= li.nghr_count * wes;
      my_count += li.nghr_count;
      for (size_t i = 0; i < my_counts.size(); ++i) {
        my_counts[i] += li.nghr_counts[i];
      }
    }
  }

  if (postscale != 1.0) {
    ScaleBuffer(work.data(), count, work_dt, postscale);
  }

  // The work buffer is already in the caller's dtype except for fp64.
  if (dtype == DataType::HVD_FLOAT64) {
    auto* w = reinterpret_cast<const float*>(work.data());
    auto* p = static_cast<double*>(output);
    for (int64_t i = 0; i < count; ++i) p[i] = w[i];
  } else {
    std::memcpy(output, work.data(), static_cast<size_t>(count) * wes);
  }
  return Status::OK();
}

}  // namespace hvd
