#include "message.h"

#include <algorithm>
#include <cstring>

namespace hvd {

namespace {
constexpr uint8_t kRequestMagic = 0xA1;
constexpr uint8_t kResponseMagic = 0xA2;
constexpr uint8_t kHeartbeatMagic = 0xA3;
constexpr uint8_t kAggregateMagic = 0xA4;
constexpr uint8_t kDeltaMagic = 0xA5;
constexpr uint8_t kResumeMagic = 0xA6;
// Request-list flags byte (docs/liveness.md): the old bool shutdown byte
// widened into a bitfield — old frames (0/1) parse identically.
constexpr uint8_t kFlagShutdown = 1;
constexpr uint8_t kFlagDrain = 2;
}  // namespace

void Reader::memcpy_(void* dst, size_t n) {
  if (p_ + n > end_) { ok_ = false; std::memset(dst, 0, n); return; }
  std::memcpy(dst, p_, n);
  p_ += n;
}

const char* DataTypeName(DataType t) {
  switch (t) {
    case DataType::HVD_UINT8: return "uint8";
    case DataType::HVD_INT8: return "int8";
    case DataType::HVD_UINT16: return "uint16";
    case DataType::HVD_INT16: return "int16";
    case DataType::HVD_INT32: return "int32";
    case DataType::HVD_INT64: return "int64";
    case DataType::HVD_FLOAT16: return "float16";
    case DataType::HVD_FLOAT32: return "float32";
    case DataType::HVD_FLOAT64: return "float64";
    case DataType::HVD_BOOL: return "bool";
    case DataType::HVD_BFLOAT16: return "bfloat16";
  }
  return "unknown";
}

std::string TensorShape::DebugString() const {
  std::string s = "[";
  for (size_t i = 0; i < dims_.size(); ++i) {
    if (i) s += ", ";
    s += std::to_string(dims_[i]);
  }
  return s + "]";
}

static void WriteShape(Writer* w, const TensorShape& s) {
  w->i32(s.ndim());
  for (auto d : s.dims()) w->i64(d);
}

static TensorShape ReadShape(Reader* r) {
  int32_t nd = r->i32();
  std::vector<int64_t> dims;
  if (nd < 0 || nd >= 256) {
    // Out-of-range rank is a malformed frame, not a skippable field:
    // skipping the payload would leave the reader misaligned.
    r->fail();
    return TensorShape(std::move(dims));
  }
  dims.reserve(nd);
  for (int i = 0; i < nd; ++i) dims.push_back(r->i64());
  return TensorShape(std::move(dims));
}

static void WriteRequest(Writer* w, const Request& q) {
  w->i32(q.rank);
  w->u8(static_cast<uint8_t>(q.op));
  w->u8(static_cast<uint8_t>(q.reduce_op));
  w->u8(static_cast<uint8_t>(q.dtype));
  w->u8(static_cast<uint8_t>(q.plane));
  w->i32(q.root_rank);
  w->str(q.name);
  WriteShape(w, q.shape);
  w->f64(q.prescale);
  w->f64(q.postscale);
  w->i32(static_cast<int32_t>(q.chip_dims.size()));
  for (auto d : q.chip_dims) w->i64(d);
}

static Request ReadRequest(Reader* r) {
  Request q;
  q.rank = r->i32();
  q.op = static_cast<CollectiveOp>(r->u8());
  q.reduce_op = static_cast<ReduceOp>(r->u8());
  q.dtype = static_cast<DataType>(r->u8());
  q.plane = static_cast<DevicePlane>(r->u8());
  q.root_rank = r->i32();
  q.name = r->str();
  q.shape = ReadShape(r);
  q.prescale = r->f64();
  q.postscale = r->f64();
  int32_t nc = r->i32();
  if (nc < 0 || nc > (1 << 16)) {
    // Malformed count: reject the frame instead of skipping the payload
    // and parsing every subsequent request from a misaligned offset.
    r->fail();
    return q;
  }
  // Allocation bound: a chip-dim count can only cost what the frame
  // actually carries (8 bytes per entry), and a failed read ends the
  // loop instead of spinning out the full count on zeros.
  q.chip_dims.reserve(
      std::min<size_t>(nc, r->remaining() / 8 + 1));
  for (int32_t i = 0; i < nc && r->ok(); ++i) {
    q.chip_dims.push_back(r->i64());
  }
  return q;
}

namespace {
// Minimum serialized sizes (all fixed fields, empty strings/vectors):
// the reserve() clamp for count-prefixed lists — a 100-byte frame
// announcing 2^24 requests reserves for the 2 that could actually fit,
// not 16M * sizeof(Request).
constexpr size_t kMinRequestWire = 4 + 1 + 1 + 1 + 1 + 4 + 4 + 4 + 8 + 8 + 4;
constexpr size_t kMinResponseWire = 1 + 1 + 1 + 1 + 4 + 4 + 8 + 8 + 4 + 4;
}  // namespace

std::string SerializeRequestList(const std::vector<Request>& reqs,
                                 const std::vector<uint32_t>& cached_ids,
                                 bool shutdown, bool drain) {
  Writer w;
  w.u8(kRequestMagic);
  w.u8(static_cast<uint8_t>((shutdown ? kFlagShutdown : 0) |
                            (drain ? kFlagDrain : 0)));
  w.i32(static_cast<int32_t>(reqs.size()));
  for (const auto& q : reqs) WriteRequest(&w, q);
  w.i32(static_cast<int32_t>(cached_ids.size()));
  for (auto id : cached_ids) w.i32(static_cast<int32_t>(id));
  return w.data();
}

bool DeserializeRequestList(const std::string& bytes,
                            std::vector<Request>* reqs,
                            std::vector<uint32_t>* cached_ids,
                            bool* shutdown, bool* drain) {
  Reader r(bytes);
  if (r.u8() != kRequestMagic) return false;
  uint8_t flags = r.u8();
  *shutdown = (flags & kFlagShutdown) != 0;
  if (drain != nullptr) *drain = (flags & kFlagDrain) != 0;
  int32_t n = r.i32();
  if (n < 0 || n > (1 << 24)) return false;
  reqs->clear();
  reqs->reserve(std::min<size_t>(n, r.remaining() / kMinRequestWire + 1));
  for (int i = 0; i < n; ++i) {
    reqs->push_back(ReadRequest(&r));
    if (!r.ok()) return false;  // don't accumulate garbage past a bad frame
  }
  int32_t nc = r.i32();
  if (nc < 0 || nc > (1 << 24)) return false;
  cached_ids->clear();
  cached_ids->reserve(std::min<size_t>(nc, r.remaining() / 4 + 1));
  for (int i = 0; i < nc && r.ok(); ++i) {
    cached_ids->push_back(static_cast<uint32_t>(r.i32()));
  }
  return r.ok();
}

std::string SerializeDeltaFrame(int rank,
                                const std::vector<uint32_t>& cached_ids,
                                bool shutdown, bool drain) {
  Writer w;
  w.u8(kDeltaMagic);
  w.u8(static_cast<uint8_t>((shutdown ? kFlagShutdown : 0) |
                            (drain ? kFlagDrain : 0)));
  w.i32(rank);
  uint32_t base = 0, nbits = 0;
  if (!cached_ids.empty()) {
    uint32_t lo = cached_ids[0], hi = cached_ids[0];
    for (auto id : cached_ids) {
      lo = std::min(lo, id);
      hi = std::max(hi, id);
    }
    base = lo;
    nbits = hi - lo + 1;
  }
  w.i32(static_cast<int32_t>(base));
  w.i32(static_cast<int32_t>(nbits));
  std::string bits((nbits + 7) / 8, '\0');
  for (auto id : cached_ids) {
    uint32_t i = id - base;
    bits[i / 8] |= static_cast<char>(1u << (i % 8));
  }
  w.raw(bits.data(), bits.size());
  return w.data();
}

bool DeserializeDeltaFrame(const std::string& bytes, int* rank,
                           std::vector<uint32_t>* cached_ids,
                           bool* shutdown, bool* drain) {
  Reader r(bytes);
  if (r.u8() != kDeltaMagic) return false;
  uint8_t flags = r.u8();
  *shutdown = (flags & kFlagShutdown) != 0;
  if (drain != nullptr) *drain = (flags & kFlagDrain) != 0;
  *rank = r.i32();
  int32_t base = r.i32();
  int32_t nbits = r.i32();
  // A cache-id bitset wider than the id clamp (or a negative span) is a
  // malformed frame — the bitset bytes that follow would misalign.
  if (*rank < 0 || base < 0 || nbits < 0 || nbits > (1 << 24)) return false;
  size_t nbytes = (static_cast<size_t>(nbits) + 7) / 8;
  if (r.remaining() < nbytes) return false;  // truncated bitset
  const char* bits = bytes.data() + (bytes.size() - r.remaining());
  cached_ids->clear();
  for (int32_t i = 0; i < nbits; ++i) {
    if (static_cast<uint8_t>(bits[i / 8]) & (1u << (i % 8))) {
      cached_ids->push_back(static_cast<uint32_t>(base + i));
    }
  }
  return r.ok();
}

namespace {
// Fixed per-member overhead in an aggregate frame (rank + kind + body
// length prefix): the reserve() clamp for the member-count loop.
constexpr size_t kMinAggMemberWire = 4 + 1 + 4;
}  // namespace

std::string SerializeAggregateFrame(const std::vector<AggMember>& members,
                                    bool shutdown, bool drain) {
  Writer w;
  w.u8(kAggregateMagic);
  w.u8(static_cast<uint8_t>((shutdown ? kFlagShutdown : 0) |
                            (drain ? kFlagDrain : 0)));
  w.i32(static_cast<int32_t>(members.size()));
  for (const auto& m : members) {
    w.i32(m.rank);
    w.u8(m.kind);
    w.str(m.body);
  }
  return w.data();
}

bool DeserializeAggregateFrame(const std::string& bytes,
                               std::vector<AggMember>* members,
                               bool* shutdown, bool* drain) {
  Reader r(bytes);
  if (r.u8() != kAggregateMagic) return false;
  uint8_t flags = r.u8();
  *shutdown = (flags & kFlagShutdown) != 0;
  if (drain != nullptr) *drain = (flags & kFlagDrain) != 0;
  int32_t n = r.i32();
  // A host holds at most a few hundred ranks; 2^16 members in one
  // aggregate is hostile, same clamp family as the chip-dim count.
  if (n < 0 || n > (1 << 16)) return false;
  members->clear();
  members->reserve(std::min<size_t>(n, r.remaining() / kMinAggMemberWire + 1));
  for (int i = 0; i < n && r.ok(); ++i) {
    AggMember m;
    m.rank = r.i32();
    m.kind = r.u8();
    m.body = r.str();
    // Only the two defined body kinds exist; anything else means the
    // sender and receiver disagree about the frame layout — reject,
    // don't guess at the body's framing.
    if (m.rank < 0 || (m.kind != 0 && m.kind != 1)) return false;
    members->push_back(std::move(m));
  }
  return r.ok();
}

std::string HeartbeatFrame() {
  return std::string(1, static_cast<char>(kHeartbeatMagic));
}

bool IsHeartbeatFrame(const std::string& bytes) {
  return bytes.size() == 1 &&
         static_cast<uint8_t>(bytes[0]) == kHeartbeatMagic;
}

bool IsDeltaFrame(const std::string& bytes) {
  return !bytes.empty() && static_cast<uint8_t>(bytes[0]) == kDeltaMagic;
}

bool IsAggregateFrame(const std::string& bytes) {
  return !bytes.empty() && static_cast<uint8_t>(bytes[0]) == kAggregateMagic;
}

std::string SerializeResponseList(const std::vector<Response>& resps,
                                  double cycle_time_ms,
                                  int64_t fusion_threshold,
                                  int hier_flags, int stripes,
                                  long long epoch) {
  Writer w;
  w.u8(kResponseMagic);
  // Tuned-parameter piggyback (reference SynchronizeParameters,
  // controller.cc:33-47): the coordinator's current cycle time, fusion
  // threshold, categorical hierarchical-dispatch flags, cross-host
  // stripe count, and world epoch ride every response broadcast; -1 =
  // no hint.
  w.f64(cycle_time_ms);
  w.i64(fusion_threshold);
  w.i32(hier_flags);
  w.i32(stripes);
  w.i64(static_cast<int64_t>(epoch));
  w.i32(static_cast<int32_t>(resps.size()));
  for (const auto& p : resps) {
    w.u8(static_cast<uint8_t>(p.op));
    w.u8(static_cast<uint8_t>(p.reduce_op));
    w.u8(static_cast<uint8_t>(p.dtype));
    w.u8(static_cast<uint8_t>(p.plane));
    w.i32(p.root_rank);
    w.str(p.error_reason);
    w.f64(p.prescale);
    w.f64(p.postscale);
    w.i32(static_cast<int32_t>(p.tensor_names.size()));
    for (size_t i = 0; i < p.tensor_names.size(); ++i) {
      w.str(p.tensor_names[i]);
      WriteShape(&w, p.shapes[i]);
    }
    w.i32(static_cast<int32_t>(p.first_dims.size()));
    for (const auto& fd : p.first_dims) {
      w.i32(static_cast<int32_t>(fd.size()));
      for (auto d : fd) w.i64(d);
    }
  }
  return w.data();
}

bool DeserializeResponseList(const std::string& bytes,
                             std::vector<Response>* resps,
                             double* cycle_time_ms,
                             int64_t* fusion_threshold,
                             int* hier_flags, int* stripes,
                             long long* epoch) {
  Reader r(bytes);
  if (r.u8() != kResponseMagic) return false;
  double cyc = r.f64();
  int64_t fus = r.i64();
  int32_t hf = r.i32();
  int32_t st = r.i32();
  long long ep = static_cast<long long>(r.i64());
  if (cycle_time_ms != nullptr) *cycle_time_ms = cyc;
  if (fusion_threshold != nullptr) *fusion_threshold = fus;
  if (hier_flags != nullptr) *hier_flags = hf;
  if (stripes != nullptr) *stripes = st;
  if (epoch != nullptr) *epoch = ep;
  int32_t n = r.i32();
  if (n < 0 || n > (1 << 24)) return false;
  resps->clear();
  resps->reserve(std::min<size_t>(n, r.remaining() / kMinResponseWire + 1));
  for (int i = 0; i < n; ++i) {
    Response p;
    p.op = static_cast<CollectiveOp>(r.u8());
    p.reduce_op = static_cast<ReduceOp>(r.u8());
    p.dtype = static_cast<DataType>(r.u8());
    p.plane = static_cast<DevicePlane>(r.u8());
    p.root_rank = r.i32();
    p.error_reason = r.str();
    p.prescale = r.f64();
    p.postscale = r.f64();
    int32_t nt = r.i32();
    if (nt < 0 || nt > (1 << 24)) return false;
    // Failed reads end every count-driven loop immediately: a stomped
    // count must never spin out millions of iterations accumulating
    // zero-filled entries the final ok() check then throws away.
    for (int t = 0; t < nt && r.ok(); ++t) {
      p.tensor_names.push_back(r.str());
      p.shapes.push_back(ReadShape(&r));
    }
    int32_t nf = r.i32();
    if (nf < 0 || nf > (1 << 24)) return false;
    for (int f = 0; f < nf && r.ok(); ++f) {
      int32_t nr = r.i32();
      if (nr < 0 || nr > (1 << 24)) return false;
      std::vector<int64_t> fd;
      fd.reserve(std::min<size_t>(nr, r.remaining() / 8 + 1));
      for (int k = 0; k < nr && r.ok(); ++k) fd.push_back(r.i64());
      p.first_dims.push_back(std::move(fd));
    }
    resps->push_back(std::move(p));
    if (!r.ok()) return false;  // same bail as the request loop
  }
  return r.ok();
}

std::string SerializeResume(long long epoch, int rank, long long send_seq,
                            long long recv_seq) {
  Writer w;
  w.u8(kResumeMagic);
  w.i64(static_cast<int64_t>(epoch));
  w.i32(rank);
  w.i64(static_cast<int64_t>(send_seq));
  w.i64(static_cast<int64_t>(recv_seq));
  return w.data();
}

bool DeserializeResume(const std::string& bytes, long long* epoch,
                       int* rank, long long* send_seq, long long* recv_seq) {
  Reader r(bytes);
  if (r.u8() != kResumeMagic) return false;
  long long ep = static_cast<long long>(r.i64());
  int32_t rk = r.i32();
  long long ss = static_cast<long long>(r.i64());
  long long rs = static_cast<long long>(r.i64());
  // Negative counters or an out-of-range rank cannot be produced by a
  // healthy sender — a corrupted resume must abort the redial, never
  // seed the seq reconciliation with garbage.
  if (!r.ok() || rk < 0 || ss < 0 || rs < 0) return false;
  if (epoch != nullptr) *epoch = ep;
  if (rank != nullptr) *rank = rk;
  if (send_seq != nullptr) *send_seq = ss;
  if (recv_seq != nullptr) *recv_seq = rs;
  return true;
}

bool IsResumeFrame(const std::string& bytes) {
  return !bytes.empty() && static_cast<uint8_t>(bytes[0]) == kResumeMagic;
}

void EncodeStripeHdr(uint32_t seq, uint32_t len, char out[kStripeHdrBytes]) {
  uint32_t magic = kStripeMagic;
  std::memcpy(out, &magic, 4);
  std::memcpy(out + 4, &seq, 4);
  std::memcpy(out + 8, &len, 4);
}

bool DecodeStripeHdr(const char* p, size_t n, uint32_t* seq, uint32_t* len) {
  if (n < kStripeHdrBytes) return false;  // truncated header: abort
  uint32_t magic = 0;
  std::memcpy(&magic, p, 4);
  if (magic != kStripeMagic) return false;  // desynced stream: abort
  std::memcpy(seq, p + 4, 4);
  std::memcpy(len, p + 8, 4);
  return true;
}

uint32_t StripePieceCount(size_t total, size_t chunk_bytes) {
  if (total == 0) return 1;  // an empty piece still unblocks the receiver
  return static_cast<uint32_t>((total + chunk_bytes - 1) / chunk_bytes);
}

void StripePieceSpan(uint32_t idx, size_t total, size_t chunk_bytes,
                     size_t* off, size_t* len) {
  *off = static_cast<size_t>(idx) * chunk_bytes;
  if (*off >= total) {
    *len = 0;
    *off = total;
    return;
  }
  size_t rest = total - *off;
  *len = rest < chunk_bytes ? rest : chunk_bytes;
}

}  // namespace hvd
