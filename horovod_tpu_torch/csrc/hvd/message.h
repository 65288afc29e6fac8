// Compact binary wire format for Request/Response lists.
//
// Plays the role of the reference's FlatBuffers schema (wire/message.fbs:
// 37-100): a self-contained length-delimited binary encoding with no
// external dependency (the build environment vendors no flatbuffers), fixed
// little-endian layout, versioned with a leading magic byte so future
// revisions can evolve.

// Thread posture: Writer/Reader and the (de)serializers are value types
// confined to their calling thread; no shared state, no capabilities.
//
#ifndef HVD_MESSAGE_H_
#define HVD_MESSAGE_H_

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvd {

class Writer {
 public:
  void u8(uint8_t v) { buf_.push_back(static_cast<char>(v)); }
  void i32(int32_t v) { raw(&v, 4); }
  void i64(int64_t v) { raw(&v, 8); }
  void f64(double v) { raw(&v, 8); }
  void str(const std::string& s) {
    i32(static_cast<int32_t>(s.size()));
    buf_.append(s);
  }
  void raw(const void* p, size_t n) {
    buf_.append(reinterpret_cast<const char*>(p), n);
  }
  const std::string& data() const { return buf_; }

 private:
  std::string buf_;
};

class Reader {
 public:
  Reader(const char* p, size_t n) : p_(p), end_(p + n) {}
  explicit Reader(const std::string& s) : Reader(s.data(), s.size()) {}
  bool ok() const { return ok_; }
  // Callers mark structurally invalid content (e.g. an out-of-range
  // element count) as a parse failure; continuing past it would leave
  // the reader misaligned and every later field parsing as garbage.
  void fail() { ok_ = false; }
  uint8_t u8() { return static_cast<uint8_t>(*take(1)); }
  // Bytes left unconsumed — the deserializers bound every count-driven
  // reserve()/loop by it, so a hostile count field can cost at most the
  // frame's own size in allocation, never a count * sizeof(T) product
  // (docs/protocol-models.md, codec-audit section).
  size_t remaining() const { return static_cast<size_t>(end_ - p_); }
  int32_t i32() { int32_t v = 0; memcpy_(&v, 4); return v; }
  int64_t i64() { int64_t v = 0; memcpy_(&v, 8); return v; }
  double f64() { double v = 0; memcpy_(&v, 8); return v; }
  std::string str() {
    int32_t n = i32();
    if (n < 0 || p_ + n > end_) { ok_ = false; return ""; }
    std::string s(p_, n);
    p_ += n;
    return s;
  }

 private:
  const char* take(size_t n) {
    static const char zero[8] = {0};
    if (p_ + n > end_) { ok_ = false; return zero; }
    const char* r = p_;
    p_ += n;
    return r;
  }
  void memcpy_(void* dst, size_t n);
  const char* p_;
  const char* end_;
  bool ok_ = true;
};

// Request list <-> bytes. `cached_ids` carries response-cache hit ids so a
// repeat submission costs 4 bytes instead of a full Request (the bandwidth
// role of the reference's cache bitvector sync, response_cache.h:45-167).
// The second byte is a flags field: bit0 = shutdown (this rank wants the
// world down), bit1 = drain (a DRAIN farewell — the rank leaves cleanly at
// a committed boundary, e.g. TPU-VM preemption; the driver must charge it
// zero blacklist strikes, unlike a crash).
std::string SerializeRequestList(const std::vector<Request>& reqs,
                                 const std::vector<uint32_t>& cached_ids,
                                 bool shutdown, bool drain = false);
bool DeserializeRequestList(const std::string& bytes,
                            std::vector<Request>* reqs,
                            std::vector<uint32_t>* cached_ids,
                            bool* shutdown, bool* drain = nullptr);

// ---- hierarchical control-plane frames (docs/control-plane.md) ------------
//
// Under HOROVOD_HIER_CONTROL=1 negotiation is two-level: members speak to
// their host leader, leaders speak for the group. Two frame kinds carry
// that traffic; both keep the request-frame flag semantics (bit0 shutdown,
// bit1 drain) so liveness intent survives aggregation.

// Delta frame: a fully-cached cycle's submissions as a response-cache-id
// bitset instead of a name list — the id set {base + i : bit i of the
// bitset}, LSB-first within each byte. A repeat-submission cycle costs
// O(id-range/8) bytes on the wire instead of a full Request per tensor
// (the delta-first encoding; ids are the symmetric response-cache
// ids, insert order == broadcast order on every rank).
std::string SerializeDeltaFrame(int rank,
                                const std::vector<uint32_t>& cached_ids,
                                bool shutdown, bool drain = false);
bool DeserializeDeltaFrame(const std::string& bytes, int* rank,
                           std::vector<uint32_t>* cached_ids,
                           bool* shutdown, bool* drain = nullptr);

// Aggregate frame: one leader->coordinator frame carrying every member's
// control frame verbatim as a length-prefixed body — kind 0 embeds a full
// request-list frame, kind 1 a delta frame. The leader does no semantic
// merging on the hot path (the coordinator already owns group bookkeeping);
// the top-level flags byte is the OR of member flags so the coordinator
// can check shutdown/drain intent without parsing every body.
struct AggMember {
  int rank = 0;
  uint8_t kind = 0;  // 0 = request-list body, 1 = delta body
  std::string body;  // embedded frame bytes, parsed by its own codec
};
std::string SerializeAggregateFrame(const std::vector<AggMember>& members,
                                    bool shutdown, bool drain = false);
bool DeserializeAggregateFrame(const std::string& bytes,
                               std::vector<AggMember>* members,
                               bool* shutdown, bool* drain = nullptr);

// Liveness heartbeat frame (docs/liveness.md): a one-byte frame a worker's
// heartbeat thread interleaves with request frames on the control socket so
// the coordinator can tell "alive but quiet" from "dead" without waiting
// for a collective to wedge. Distinguished by magic from request frames, so
// the coordinator's gather loop can skip any number of them.
std::string HeartbeatFrame();
bool IsHeartbeatFrame(const std::string& bytes);

// Magic peeks for the coordinator's gather dispatch (hier mode accepts
// request, delta, and aggregate frames on the same socket).
bool IsDeltaFrame(const std::string& bytes);
bool IsAggregateFrame(const std::string& bytes);

// cycle_time_ms / fusion_threshold / hier_flags / stripes piggyback the
// coordinator's tuned parameters on the broadcast (reference
// Controller::SynchronizeParameters, controller.cc:33-47); -1 = no hint.
// hier_flags: bit0 = hierarchical allreduce, bit1 = hierarchical
// allgather; stripes: the cross-host transport's connection count per
// leader pair (the tuner's categorical dimensions — every rank applies
// a synced stripe count at the same frame boundary so both sides of
// every pair renegotiate their cross transport in lock-step).
// epoch: the world incarnation the coordinator stamped at bootstrap
// (docs/self-healing.md) — a worker holding a different epoch is talking
// to the wrong world's coordinator (split brain) and must shut down; -1
// = no hint (legacy frames).
std::string SerializeResponseList(const std::vector<Response>& resps,
                                  double cycle_time_ms = -1.0,
                                  int64_t fusion_threshold = -1,
                                  int hier_flags = -1, int stripes = -1,
                                  long long epoch = -1);
bool DeserializeResponseList(const std::string& bytes,
                             std::vector<Response>* resps,
                             double* cycle_time_ms = nullptr,
                             int64_t* fusion_threshold = nullptr,
                             int* hier_flags = nullptr,
                             int* stripes = nullptr,
                             long long* epoch = nullptr);

// ---- link resume handshake (docs/self-healing.md) -------------------------
//
// After a cross-host data link drops and is redialed in place, both ends
// exchange one resume frame over the fresh socket before any payload:
// "I am <rank> in world <epoch>; I have sent you send_seq frames and
// received recv_seq frames." Each side compares the peer's recv_seq with
// its own send_seq to decide whether the in-flight frame must be replayed
// (peer never got it) or suppressed (peer got it before the cut —
// replaying would double-apply). A mismatched epoch means one end belongs
// to a torn-down world: reject, never resume across incarnations.
std::string SerializeResume(long long epoch, int rank, long long send_seq,
                            long long recv_seq);
bool DeserializeResume(const std::string& bytes, long long* epoch,
                       int* rank, long long* send_seq, long long* recv_seq);
bool IsResumeFrame(const std::string& bytes);

// ---- striped cross-host transport wire contract ---------------------------
//
// The striped backend (stripe_transport.cc behind the op_manager registry;
// docs/cross-transport.md) splits each logical message into pieces of at
// most HOROVOD_CHUNK_BYTES and round-robins them across K parallel TCP
// connections. Every piece carries a fixed 12-byte header so reassembly is
// order-proof: the sequence number alone places a piece, regardless of the
// order stripes deliver. The piece <-> span math is deterministic from
// (total bytes, chunk bytes) alone — both sides derive it independently,
// so no per-message metadata rides the wire beyond the headers.

constexpr uint32_t kStripeMagic = 0x54535648u;  // "HVST" little-endian
constexpr size_t kStripeHdrBytes = 12;          // magic + seq + len (u32 LE)

void EncodeStripeHdr(uint32_t seq, uint32_t len, char out[kStripeHdrBytes]);
// False on truncation (n < 12) or a magic mismatch — a desynced stripe
// stream must abort, never guess.
bool DecodeStripeHdr(const char* p, size_t n, uint32_t* seq, uint32_t* len);

// Number of pieces a `total`-byte message splits into (a 0-byte message
// is one empty piece, so the receiver still unblocks on something).
uint32_t StripePieceCount(size_t total, size_t chunk_bytes);
// Byte span [*off, *off + *len) of piece `idx` (0-based within the
// message); len of the final piece is the remainder.
void StripePieceSpan(uint32_t idx, size_t total, size_t chunk_bytes,
                     size_t* off, size_t* len);
// The stripe a piece rides: its global sequence number modulo the stripe
// count (the round-robin assignment both sides derive).
inline int StripeOfSeq(uint32_t seq, int stripes) {
  return static_cast<int>(seq % static_cast<uint32_t>(stripes));
}

}  // namespace hvd

#endif  // HVD_MESSAGE_H_
