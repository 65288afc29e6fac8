// Global state, background cycle loop, and the extern "C" API.
//
// Parity: reference operations.cc — InitializeHorovodOnce (:611),
// BackgroundThreadLoop (:338), RunLoopOnce (:557), PerformOperation (:237),
// the extern "C" block (:668-806) and EnqueueTensor* (:810-961) — reshaped
// for a two-plane TPU runtime:
//
//   HOST plane: entries carry host pointers; responses execute natively on
//     the ring data plane (ring_ops.cc) right in the background thread.
//   XLA plane: entries are metadata-only; fused responses are handed to a
//     registered callback (the Python/XLA executor), which launches the
//     compiled collective and reports completion via hvd_response_done —
//     the non-blocking Status::InProgress + finalizer design of the
//     reference GPU path (gpu_operations.cc:47-86) without device threads,
//     since XLA's async dispatch supplies the queueing.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <unordered_map>

#include "controller.h"
#include "env_util.h"
#include "message.h"
#include "metrics.h"
#include "ring_ops.h"
#include "tensor_queue.h"
#include "thread_annotations.h"

namespace hvd {
namespace {

using ExecCallback = void (*)(const char* response_bytes, int len,
                              long response_id);

struct HandleTable {
  Mutex mu;
  CondVar cv;
  std::unordered_map<int64_t, Status> done GUARDED_BY(mu);
  int64_t next GUARDED_BY(mu) = 0;

  int64_t NewHandle() EXCLUDES(mu) {
    MutexLock lk(mu);
    return next++;
  }
  void MarkDone(int64_t h, const Status& s) EXCLUDES(mu) {
    {
      MutexLock lk(mu);
      done[h] = s;
    }
    cv.notify_all();
  }
  // 0 = pending, 1 = ok, -1 = error (reason copied out)
  int Test(int64_t h, std::string* reason) EXCLUDES(mu) {
    MutexLock lk(mu);
    auto it = done.find(h);
    if (it == done.end()) return 0;
    if (it->second.ok()) return 1;
    if (reason) *reason = it->second.reason();
    return -1;
  }
  int Wait(int64_t h, std::string* reason) EXCLUDES(mu) {
    UniqueLock lk(mu);
    while (done.count(h) == 0) cv.wait(lk);
    const Status& s = done[h];
    if (s.ok()) return 1;
    if (reason) *reason = s.reason();
    return -1;
  }
  void Erase(int64_t h) EXCLUDES(mu) {
    MutexLock lk(mu);
    done.erase(h);
  }
};

// Executor-allocated collective result (ragged allgather): the output size
// is only known once the response's per-rank dims arrive, so the executor
// allocates and the caller fetches by handle after the wait resolves —
// the role of the reference's framework allocation callbacks
// (ops/collective_operations.cc AllocateOutput).
struct ResultBuffer {
  std::vector<char> bytes;
  std::vector<int64_t> first_dims;
};

struct GlobalState {
  Mutex init_mu;
  std::atomic<bool> initialized{false};
  std::atomic<bool> shutdown_requested{false};
  // Graceful-drain farewell (docs/liveness.md): set by hvd_drain before
  // hvd_shutdown so this rank's final frame carries the DRAIN flag — the
  // coordinator records a clean departure instead of a crash.
  std::atomic<bool> drain_requested{false};
  std::atomic<bool> loop_done{false};
  // The loop ended because a rank was lost (Controller::world_lost).
  std::atomic<bool> world_lost{false};

  // Atomic: written by hvd_init (under init_mu) but read lock-free by the
  // topology getters and the enqueue path — a monitor thread polling
  // hvd_rank() across an elastic re-init must not race the store
  // (TSan-verified by the reference's tsan test).
  std::atomic<int> rank{0}, size{1}, local_rank{0}, local_size{1};
  std::atomic<int> cross_rank{0}, cross_size{1};
  std::atomic<double> cycle_time_ms{5.0};
  // Join state (reference HorovodGlobalState::joined): while set, this rank
  // contributes zeros to other ranks' reductions instead of real tensors.
  std::atomic<bool> joined{false};
  std::atomic<int> last_joined{-1};

  // Lifecycle state guarded by init_mu: hvd_shutdown resets these while
  // arbitrary API/monitor threads poll the getters — the
  // use-after-free class, now a compile error instead of a TSan lottery.
  // The background cycle thread does NOT reach through these fields: it
  // receives raw Controller*/Ring* captured under init_mu at thread
  // start (BackgroundLoop's parameters), and hvd_shutdown joins it
  // before the reset — the happens-before is structural.
  // World incarnation counter (docs/self-healing.md): bumped by every
  // successful hvd_init in this process, stamped by the coordinator into
  // the endpoint-map broadcast and every response frame, and carried in
  // every data-plane hello so stale-world traffic is rejectable. Guarded
  // like the controller it feeds (written under init_mu; the snapshot
  // reads it under the same lock).
  long long world_epoch GUARDED_BY(init_mu) = 0;
  std::unique_ptr<Controller> controller GUARDED_BY(init_mu);
  std::unique_ptr<Ring> ring GUARDED_BY(init_mu);
  Listener data_listener GUARDED_BY(init_mu);
  TensorQueue tensor_queue;
  HandleTable handles;
  std::thread background GUARDED_BY(init_mu);

  // Atomic: re-registered at runtime (host staging replaces the host
  // world's placeholder) while the cycle thread reads it.
  std::atomic<ExecCallback> exec_cb{nullptr};
  // responses handed to the XLA executor, keyed by response id
  Mutex inflight_mu;
  std::unordered_map<long, std::vector<TensorTableEntry>> inflight
      GUARDED_BY(inflight_mu);
  std::atomic<long> next_response_id{1};

  // >= 0: fused host-plane allreduces of at least this many bytes are
  // routed to the registered executor (which stages them through the XLA
  // plane over ICI/DCN) instead of the TCP ring — the role of the
  // reference's GPU staging paths (torch/mpi_ops_v2.cc:81
  // DoAllreduceCudaOnCPU, nccl_operations.cc:164-357 hierarchical).
  std::atomic<long long> host_via_xla_threshold{-1};

  // Autotuned categorical dispatch flags (bit0 = hierarchical allreduce,
  // bit1 = hierarchical allgather; -1 = untuned — fall back to the env
  // config). Applied at frame boundaries from the controller's synced
  // value; stamped into each response frame handed to the executor so
  // dispatch is frame-exact on every rank. The HOST plane consumes the
  // same bits in ExecuteHostResponse, so the autotuner's categorical
  // grid tunes a real host-plane routing choice too.
  std::atomic<int> hier_flags{-1};
  // Untuned default from HOROVOD_HIERARCHICAL_ALLREDUCE/ALLGATHER (read
  // at init; must agree across ranks, like every dispatch env). Atomic:
  // hvd_host_hier_flags polls it lock-free while re-init rewrites it.
  std::atomic<int> hier_env_flags{0};

  // executor-allocated results, keyed by handle (fetched then erased)
  Mutex results_mu;
  std::unordered_map<int64_t, ResultBuffer> results GUARDED_BY(results_mu);
};

GlobalState* g() {
  static GlobalState* state = new GlobalState();
  return state;
}

bool EnvFlag(const char* name, bool dflt = false) {
  // Mirrors the Python config's _get_bool: only an explicit true-ish value
  // enables the flag, so "False"/"no"/"off" mean the same thing to the
  // host plane as to every Python-side consumer of the same variable.
  // `dflt` is returned when the variable is unset (the _get_bool default
  // parameter) — set values always parse through the shared grammar.
  const char* v = std::getenv(name);
  if (v == nullptr) return dflt;
  std::string s(v);
  size_t b = s.find_first_not_of(" \t");
  size_t e = s.find_last_not_of(" \t");
  s = (b == std::string::npos) ? "" : s.substr(b, e - b + 1);
  for (auto& c : s) c = static_cast<char>(std::tolower(c));
  return s == "1" || s == "true" || s == "yes" || s == "on";
}

// Shm ring-buffer slot size: HOROVOD_SHM_SLOT_BYTES when set (mirrors
// config.shm_slot_bytes), else derived from the fusion cap so a fused
// response usually streams in one slot write. Clamped to sane bounds
// either way (a one-byte slot would still be correct, just silly).
long long ShmSlotBytes(long long fusion_threshold) {
  long long v = -1;
  if (const char* e = std::getenv("HOROVOD_SHM_SLOT_BYTES")) {
    char* end = nullptr;
    long long n = std::strtoll(e, &end, 10);
    if (end != nullptr && *end == 0 && n > 0) v = n;
  }
  if (v < 0) v = fusion_threshold;
  const long long kMin = 64 << 10, kMax = 256LL << 20;
  return std::max(kMin, std::min(kMax, v));
}

// HOROVOD_STRIPES: parallel TCP connections per cross-host leader pair
// (docs/cross-transport.md). 1 (the default) keeps the single-socket
// path with zero registry overhead; clamped to the stripe engine's
// 32-fd poll set. A dispatch knob: must agree across ranks.
int StripesFromEnv() {
  long long v = EnvLL("HOROVOD_STRIPES", 1);
  if (v < 1) v = 1;
  if (v > StripeTransport::kMaxStripes) v = StripeTransport::kMaxStripes;
  return static_cast<int>(v);
}

// HOROVOD_CHUNK_BYTES: the striped transport's pipeline chunk — the
// unit round-robined across stripes and handed to the per-piece
// accumulate hook. Clamped sane ([4 KiB, 16 MiB]) and rounded to a
// 64-byte multiple so piece boundaries never split an element of any
// supported dtype.
long long ChunkBytesFromEnv() {
  long long v = EnvLL("HOROVOD_CHUNK_BYTES", 256 << 10);
  const long long kMin = 4096, kMax = 16LL << 20;
  if (v < kMin) v = kMin;
  if (v > kMax) v = kMax;
  return v & ~63LL;
}

// Effective hierarchical-dispatch bit for the host plane: the tuner's
// frame-synced flags when present, else the env default. Frame-exact:
// synced flags are applied in RunLoopOnce before PerformOperation runs
// this frame's responses, so every rank routes identically.
bool HostHierBit(int bit) {
  auto* s = g();
  int hf = s->hier_flags.load();
  int flags = hf >= 0 ? hf : s->hier_env_flags.load();
  return ((flags >> bit) & 1) != 0;
}

// ---- metrics plumbing (metrics.h; docs/metrics.md) -------------------------

metrics::HistId EnqHistFor(CollectiveOp op) {
  switch (op) {
    case CollectiveOp::ALLREDUCE: return metrics::kEnqToNegAllreduceUs;
    case CollectiveOp::ALLGATHER: return metrics::kEnqToNegAllgatherUs;
    case CollectiveOp::BROADCAST: return metrics::kEnqToNegBroadcastUs;
    default: return metrics::kEnqToNegOtherUs;
  }
}

metrics::HistId DoneHistFor(CollectiveOp op) {
  switch (op) {
    case CollectiveOp::ALLREDUCE: return metrics::kNegToDoneAllreduceUs;
    case CollectiveOp::ALLGATHER: return metrics::kNegToDoneAllgatherUs;
    case CollectiveOp::BROADCAST: return metrics::kNegToDoneBroadcastUs;
    default: return metrics::kNegToDoneOtherUs;
  }
}

// The response for this entry arrived: close the negotiation-latency
// span and open the execution one.
void MarkEntryNegotiated(TensorTableEntry& e) {
  e.negotiated_ns = metrics::MonoNs();
  if (e.enqueue_ns > 0) {
    metrics::Record(EnqHistFor(e.request.op),
                    (e.negotiated_ns - e.enqueue_ns) / 1000);
  }
}

// The entry's handle resolved (ring executed, or the XLA executor
// reported back): close the execution-latency span.
void RecordEntryDone(const TensorTableEntry& e) {
  if (e.negotiated_ns > 0) {
    metrics::Record(DoneHistFor(e.request.op),
                    (metrics::MonoNs() - e.negotiated_ns) / 1000);
  }
}

// ---- unified snapshot (docs/metrics.md) ------------------------------------
//
// ONE JSON document for every native counter and histogram, assembled
// under init_mu (the ring/controller pointers it reads are the ones
// hvd_shutdown resets — the getter-race class, guarded once
// here instead of once per getter). This is the single growth path for
// native observability: new measurements join the registry and appear
// here; they do not get their own extern "C" symbol.

void JsonEscapeInto(std::string& out, const std::string& s) {
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char esc[8];
          std::snprintf(esc, sizeof(esc), "\\u%04x", c);
          out += esc;
        } else {
          out += c;
        }
    }
  }
}

void AppendKV(std::string& out, const char* key, long long v,
              bool* first) {
  if (!*first) out += ',';
  *first = false;
  out += '"';
  out += key;
  out += "\":";
  out += std::to_string(v);
}

void AppendKVD(std::string& out, const char* key, double v, bool* first) {
  char num[64];
  std::snprintf(num, sizeof(num), "%.3f", v);
  if (!*first) out += ',';
  *first = false;
  out += '"';
  out += key;
  out += "\":";
  out += num;
}

std::string BuildMetricsJsonLocked(GlobalState* s,
                                   const std::string& liveness,
                                   bool with_liveness,
                                   const std::vector<metrics::StragglerEvent>&
                                       events,
                                   bool with_events)
    REQUIRES(s->init_mu) {
  auto& reg = metrics::Registry::Get();
  std::string out;
  out.reserve(4096);
  out += "{\"counters\":{";
  bool first = true;
  AppendKV(out, "initialized", s->initialized.load() ? 1 : 0, &first);
  AppendKV(out, "rank", s->rank.load(), &first);
  AppendKV(out, "size", s->size.load(), &first);
  AppendKV(out, "cycles", reg.cycles(), &first);
  AppendKV(out, "pending", static_cast<long long>(
                               s->tensor_queue.PendingCount()), &first);
  AppendKVD(out, "cycle_time_ms", s->cycle_time_ms.load(), &first);
  AppendKV(out, "cache_hits",
           s->controller ? static_cast<long long>(s->controller->cache_hits())
                         : 0,
           &first);
  AppendKV(out, "fusion_threshold",
           s->controller
               ? static_cast<long long>(s->controller->fusion_threshold())
               : -1,
           &first);
  AppendKV(out, "bytes_sent", s->ring ? s->ring->bytes_sent() : 0, &first);
  AppendKV(out, "local_bytes", s->ring ? s->ring->local_bytes_sent() : 0,
           &first);
  AppendKV(out, "cross_bytes", s->ring ? s->ring->cross_bytes_sent() : 0,
           &first);
  AppendKV(out, "shm_bytes", s->ring ? s->ring->shm_bytes_sent() : 0,
           &first);
  AppendKV(out, "stripe_bytes", s->ring ? s->ring->stripe_bytes_sent() : 0,
           &first);
  AppendKV(out, "shm_active",
           (s->ring && s->ring->shm_active()) ? 1 : 0, &first);
  AppendKV(out, "stripes", s->ring ? s->ring->stripe_count() : 0, &first);
  AppendKV(out, "cross_leg_ns", s->ring ? s->ring->cross_leg_ns() : 0,
           &first);
  {
    int hf = s->hier_flags.load();
    AppendKV(out, "host_hier_flags",
             hf >= 0 ? hf : s->hier_env_flags.load(), &first);
    AppendKV(out, "tuned_hier_flags", hf, &first);
  }
  // Self-healing plane (docs/self-healing.md): world incarnation plus
  // the link-heal counters — a healed transient shows up here (and in
  // the LINK_RECONNECT timeline instant), never as an eviction.
  AppendKV(out, "epoch",
           s->controller ? s->controller->epoch() : s->world_epoch, &first);
  AppendKV(out, "link.reconnects",
           s->ring ? s->ring->link_reconnects() : 0, &first);
  AppendKV(out, "link.resume_chunks_discarded",
           s->ring ? s->ring->resume_chunks_discarded() : 0, &first);
  AppendKV(out, "link.stale_epoch_rejected",
           s->ring ? s->ring->stale_epoch_rejected() : 0, &first);
  out += "},\"histograms\":{";
  for (int i = 0; i < metrics::kNumHistograms; ++i) {
    const auto& h = reg.hist(i);
    if (i) out += ',';
    out += '"';
    out += metrics::HistName(i);
    out += "\":{\"count\":";
    out += std::to_string(h.count());
    out += ",\"sum\":";
    out += std::to_string(h.sum());
    out += ",\"max\":";
    out += std::to_string(h.max());
    out += ",\"buckets\":[";
    bool fb = true;
    for (int b = 0; b < metrics::Log2Histogram::kBuckets; ++b) {
      long long c = h.bucket(b);
      if (c == 0) continue;  // sparse: [bucket_index, count] pairs
      if (!fb) out += ',';
      fb = false;
      out += '[';
      out += std::to_string(b);
      out += ',';
      out += std::to_string(c);
      out += ']';
    }
    out += "]}";
  }
  out += "},\"straggler\":{";
  auto& det = reg.straggler();
  first = true;
  AppendKV(out, "warnings", det.warnings(), &first);
  AppendKV(out, "last_rank", det.last_rank(), &first);
  AppendKVD(out, "last_lag_ms", det.last_lag_ms(), &first);
  out += ",\"ewma_ms\":[";
  {
    auto ewma = det.EwmaMs();
    for (size_t i = 0; i < ewma.size(); ++i) {
      if (i) out += ',';
      char num[64];
      std::snprintf(num, sizeof(num), "%.3f", ewma[i]);
      out += num;
    }
  }
  out += "],\"events\":[";
  if (with_events) {
    for (size_t i = 0; i < events.size(); ++i) {
      if (i) out += ',';
      char ev[96];
      std::snprintf(ev, sizeof(ev), "{\"rank\":%d,\"lag_ms\":%.3f}",
                    events[i].rank, events[i].lag_ms);
      out += ev;
    }
  }
  out += "]}";
  if (with_liveness) {
    out += ",\"reports\":{\"liveness\":\"";
    JsonEscapeInto(out, liveness);
    out += "\"}";
  }
  out += '}';
  return out;
}

// `ring` is the background thread's stable pointer (captured under
// init_mu at thread start; outlives the thread by join-before-reset) —
// this function never reads the GUARDED_BY(init_mu) global field.
void ExecuteHostResponse(Ring* ring, const Response& resp,
                         std::vector<TensorTableEntry>& entries) {
  // Fuse host entries into one flat buffer, run the ring op, scatter back —
  // MemcpyInFusionBuffer / MemcpyOutFusionBuffer parity
  // (collective_operations.cc).
  auto* s = g();
  int es = DataTypeSize(resp.dtype);
  Status st = Status::OK();
  switch (resp.op) {
    case CollectiveOp::ALLREDUCE: {
      // Build the fused buffer in the response's canonical layout, which
      // is identical on every rank. A joined rank may hold entries for
      // only some (or none) of the fused tensors — its missing slots stay
      // zero so ring transfer lengths agree across ranks (reference
      // AllocateZeros join path, tensor_queue.cc:88-113).
      int64_t total = 0;
      for (const auto& sh : resp.shapes) total += sh.num_elements();
      std::vector<char> fusion(total * es, 0);
      std::unordered_map<std::string, TensorTableEntry*> by_name;
      for (auto& e : entries) by_name[e.name] = &e;
      int64_t off = 0;
      for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
        int64_t n = resp.shapes[i].num_elements() * es;
        auto it = by_name.find(resp.tensor_names[i]);
        if (it != by_name.end()) {
          std::memcpy(fusion.data() + off, it->second->data, n);
        }
        off += n;
      }
      bool hier_ar = resp.reduce_op != ReduceOp::ADASUM && HostHierBit(0);
      if (resp.reduce_op == ReduceOp::ADASUM) {
        // Per-tensor boundaries ride into the fused Adasum: the
        // combination's dot/norm coefficients are computed per tensor,
        // so fusion never changes the math (reference tensor_counts
        // contract, adasum_gpu_operations.cc:208-232).
        std::vector<int64_t> tensor_counts;
        tensor_counts.reserve(resp.shapes.size());
        for (const auto& sh : resp.shapes) {
          tensor_counts.push_back(sh.num_elements());
        }
        st = ring->AdasumAllreduce(fusion.data(), fusion.data(),
                                      tensor_counts, resp.dtype,
                                      resp.prescale, resp.postscale);
      } else if (hier_ar) {
        // Two-level local-leader route (tuned bit0 / env default): the
        // fused buffer crosses hosts once per host, not once per rank.
        st = ring->HierAllreduce(fusion.data(), fusion.data(), total,
                                    resp.dtype, resp.reduce_op,
                                    resp.prescale, resp.postscale);
      } else {
        st = ring->Allreduce(fusion.data(), fusion.data(), total,
                                resp.dtype, resp.reduce_op, resp.prescale,
                                resp.postscale);
      }
      if (st.ok()) {
        off = 0;
        for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
          int64_t n = resp.shapes[i].num_elements() * es;
          auto it = by_name.find(resp.tensor_names[i]);
          if (it != by_name.end()) {
            TensorTableEntry* e = it->second;
            std::memcpy(e->output ? e->output : e->data,
                        fusion.data() + off, n);
          }
          off += n;
        }
      }
      break;
    }
    case CollectiveOp::ALLGATHER: {
      bool hier_ag = HostHierBit(1);
      std::unordered_map<std::string, TensorTableEntry*> by_name;
      for (auto& e : entries) by_name[e.name] = &e;
      for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
        auto it = by_name.find(resp.tensor_names[i]);
        if (it == by_name.end()) continue;
        TensorTableEntry& e = *it->second;
        const TensorShape& sh = e.request.shape;
        int64_t trailing = 1;
        for (int d = 1; d < sh.ndim(); ++d) trailing *= sh.dim(d);
        // Per-rank element counts from the response's first_dims (ragged
        // allgatherv); equal counts when absent.
        std::vector<int64_t> counts;
        const std::vector<int64_t>* fd =
            (i < resp.first_dims.size() && !resp.first_dims[i].empty())
                ? &resp.first_dims[i]
                : nullptr;
        if (fd != nullptr) {
          counts.reserve(fd->size());
          for (auto d : *fd) counts.push_back(d * trailing);
        } else {
          counts.assign(ring->size(), sh.num_elements());
        }
        if (e.output != nullptr) {
          // Caller-preallocated output (equal-shape fast path).
          st = hier_ag
                   ? ring->HierAllgatherv(e.data, e.output, counts,
                                             resp.dtype)
                   : ring->Allgatherv(e.data, e.output, counts,
                                         resp.dtype);
        } else {
          // Ragged path: executor allocates; caller fetches by handle
          // after the wait resolves.
          int64_t total = 0;
          for (auto c : counts) total += c;
          ResultBuffer rb;
          rb.bytes.resize(total * es);
          rb.first_dims =
              fd != nullptr
                  ? *fd
                  : std::vector<int64_t>(counts.size(),
                                         sh.ndim() > 0 ? sh.dim(0) : 1);
          st = hier_ag
                   ? ring->HierAllgatherv(e.data, rb.bytes.data(),
                                             counts, resp.dtype)
                   : ring->Allgatherv(e.data, rb.bytes.data(), counts,
                                         resp.dtype);
          if (st.ok()) {
            MutexLock lk(s->results_mu);
            s->results[e.handle] = std::move(rb);
          }
        }
        if (!st.ok()) break;
      }
      break;
    }
    case CollectiveOp::BROADCAST: {
      for (auto& e : entries) {
        if (e.output && e.output != e.data &&
            s->rank == resp.root_rank) {
          std::memcpy(e.output, e.data,
                      e.request.shape.num_elements() * es);
        }
        void* buf = e.output ? e.output : e.data;
        st = ring->Broadcast(buf, e.request.shape.num_elements(),
                                resp.dtype, resp.root_rank);
        if (!st.ok()) break;
      }
      break;
    }
    case CollectiveOp::BARRIER:
      break;  // negotiation itself is the barrier on a cycle-synced star
    default:
      st = Status::InvalidArgument("unsupported host-plane op");
  }
  for (auto& e : entries) {
    RecordEntryDone(e);
    s->handles.MarkDone(e.handle, st);
    if (e.callback) e.callback(st);
  }
}

void PerformOperation(Ring* ring, const Response& resp) {
  auto* s = g();
  if (resp.op == CollectiveOp::JOIN) {
    // All ranks have joined: resolve this rank's join sentinel and reset
    // join state (reference JoinOp::Execute, collective_operations.cc:217).
    s->last_joined.store(resp.root_rank);
    s->joined.store(false);
    auto entries = s->tensor_queue.GetTensorEntries({kJoinTensorName}, true);
    for (auto& e : entries) {
      s->handles.MarkDone(e.handle, Status::OK());
      if (e.callback) e.callback(Status::OK());
    }
    return;
  }
  if (!resp.error_reason.empty() || resp.op == CollectiveOp::ERROR_OP) {
    Status err = Status::PreconditionError(resp.error_reason);
    auto entries = s->tensor_queue.GetTensorEntries(resp.tensor_names, true);
    for (auto& e : entries) {
      s->handles.MarkDone(e.handle, err);
      if (e.callback) e.callback(err);
    }
    return;
  }
  auto entries = s->tensor_queue.GetTensorEntries(resp.tensor_names, true);
  // A joined rank may hold entries for some, none, or all of the fused
  // tensors; it must still participate (with zeros for the missing slots)
  // so the other ranks' collectives complete — reference
  // tensor_queue.cc:88-113 AllocateZeros path. Both executors zero-fill
  // missing slots from the response's canonical layout.
  if (entries.empty() && !s->joined.load()) return;
  for (auto& e : entries) MarkEntryNegotiated(e);
  if (resp.plane == DevicePlane::HOST) {
    // Large fused allreduces and broadcasts may opt into the XLA-plane
    // staging executor (hvd_set_host_via_xla); everything else runs on
    // the TCP ring. Broadcast staging matters for job startup:
    // broadcast_parameters moves the whole model.
    bool stage = (resp.op == CollectiveOp::ALLREDUCE ||
                  resp.op == CollectiveOp::BROADCAST ||
                  resp.op == CollectiveOp::ALLGATHER) &&
                 resp.reduce_op != ReduceOp::ADASUM &&
                 // bool allreduce semantics belong to the ring (logical
                 // reduction); bool BROADCAST stages fine as bytes.
                 !(resp.op == CollectiveOp::ALLREDUCE &&
                   resp.dtype == DataType::HVD_BOOL) &&
                 // 64-bit dtypes stay on the ring: the staging executor
                 // may canonicalize int64/float64 buffers to 32 bits
                 // (silent truncation).
                 resp.dtype != DataType::HVD_INT64 &&
                 resp.dtype != DataType::HVD_FLOAT64 &&
                 s->exec_cb.load() != nullptr;
    if (stage) {
      long long thr = s->host_via_xla_threshold.load();
      if (thr < 0) {
        stage = false;
      } else {
        int64_t bytes = 0;
        int es = DataTypeSize(resp.dtype);
        for (const auto& sh : resp.shapes) bytes += sh.num_elements() * es;
        stage = bytes >= thr;
      }
    }
    if (!stage) {
      ExecuteHostResponse(ring, resp, entries);
      return;
    }
  }
  // XLA plane (or staged host response): hand off to the registered
  // executor.
  ExecCallback cb = s->exec_cb.load();
  if (cb == nullptr) {
    Status err = Status::PreconditionError(
        "no XLA executor callback registered");
    for (auto& e : entries) {
      s->handles.MarkDone(e.handle, err);
      if (e.callback) e.callback(err);
    }
    return;
  }
  long id = s->next_response_id++;
  {
    MutexLock lk(s->inflight_mu);
    s->inflight[id] = std::move(entries);
  }
  std::string bytes =
      SerializeResponseList({resp}, -1.0, -1, s->hier_flags.load());
  cb(bytes.data(), static_cast<int>(bytes.size()), id);
}

// `ctl`/`ring` are the background thread's stable pointers (captured
// under init_mu at thread start): the loop never dereferences the
// GUARDED_BY(init_mu) global fields, so the analysis proves every
// remaining access to them is under the lock.
bool RunLoopOnce(Controller* ctl, Ring* ring,
                 std::chrono::steady_clock::time_point& last_cycle) {
  auto* s = g();
  auto now = std::chrono::steady_clock::now();
  auto target = last_cycle + std::chrono::duration_cast<
                                 std::chrono::steady_clock::duration>(
                                 std::chrono::duration<double, std::milli>(
                                     s->cycle_time_ms));
  // Latency fast path: the cycle sleep exists to batch submissions and
  // bound idle polling, but once requests are queued it only delays
  // them. The wait is interruptible — a LOCAL enqueue landing mid-sleep
  // wakes this rank's loop at once (TensorQueue::WaitForMessages), so a
  // rank's own submissions reach the wire without waiting out the
  // cycle. The coordinator still reads worker sockets only at its own
  // tick, so a worker-initiated round can wait up to one residual
  // coordinator cycle; cycle_time_ms therefore still bounds (not adds
  // to) cross-rank RTT. Idle ranks pace the world at cycle_time and
  // nothing busy-spins: the queue drains every cycle.
  if (now < target) {
    s->tensor_queue.WaitForMessages(target);
  }
  last_cycle = std::chrono::steady_clock::now();

  // Background-cycle duration (metrics.h): the ACTIVE portion of a
  // cycle — negotiation plus response execution — not the idle wait
  // above, so the histogram answers "how long does one round of work
  // take", the number the cycle-time knob is tuned against.
  auto cycle_start = std::chrono::steady_clock::now();
  bool want_shutdown = s->shutdown_requested.load();
  bool want_drain = s->drain_requested.load();
  bool world_shutdown = false;
  auto requests = s->tensor_queue.PopMessages();
  auto responses = ctl->ComputeResponseList(
      std::move(requests), want_shutdown || want_drain, want_drain,
      &world_shutdown);
  // Worker ranks: adopt the coordinator's autotuned cycle time delivered on
  // the response broadcast (reference SynchronizeParameters applied inside
  // BackgroundThreadLoop, operations.cc:598-604).
  double synced = ctl->TakeSyncedCycleMs();
  if (synced > 0) s->cycle_time_ms.store(synced);
  int synced_hier = ctl->TakeSyncedHierFlags();
  if (synced_hier >= 0) s->hier_flags.store(synced_hier);
  // Stripe-count sync applies BEFORE this frame's responses run, on
  // every rank at the same boundary, so both sides of every leader pair
  // renegotiate their cross transport in lock-step
  // (docs/cross-transport.md).
  int synced_stripes = ctl->TakeSyncedStripes();
  if (synced_stripes >= 1 && ring != nullptr) {
    ring->ApplyStripeCount(synced_stripes);
  }
  for (const auto& r : responses) PerformOperation(ring, r);
  metrics::Registry::Get().IncCycles();
  metrics::Record(metrics::kCycleUs,
                  std::chrono::duration_cast<std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - cycle_start)
                      .count());
  return !world_shutdown;
}

void BackgroundLoop(Controller* ctl, Ring* ring) {
  auto last = std::chrono::steady_clock::now();
  while (RunLoopOnce(ctl, ring, last)) {
  }
  auto* s = g();
  // Published before the handles below resolve, so a waiter woken by
  // "aborted" already sees why.
  s->world_lost.store(ctl->world_lost());
  // Resolve every still-queued handle so no waiter blocks forever when a
  // peer failure (stall shutdown) or hvd_shutdown ends the loop.
  Status aborted = Status::Aborted("horovod_tpu runtime has been shut down");
  for (auto& e : s->tensor_queue.DrainAll()) {
    s->handles.MarkDone(e.handle, aborted);
    if (e.callback) e.callback(aborted);
  }
  ctl->Finalize();
  s->loop_done.store(true);
}

DataType IntToDtype(int d) { return static_cast<DataType>(d); }

}  // namespace
}  // namespace hvd

// ---- extern "C" API --------------------------------------------------------

extern "C" {

int hvd_init(int rank, int size, int local_rank, int local_size,
             int cross_rank, int cross_size, const char* coordinator_addr,
             int coordinator_port, const char* my_host, double cycle_time_ms,
             long long fusion_threshold, int cache_capacity,
             double stall_warning_sec, double stall_shutdown_sec,
             int stall_check_enabled, int heartbeat_ms,
             int liveness_timeout_ms) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  if (s->initialized.load()) {
    // Re-init with an identical world is a no-op; a different world is a
    // caller bug that must not be silently ignored.
    return (rank == s->rank && size == s->size) ? 0 : -2;
  }
  // Fresh-world metrics baseline (metrics.h): histograms and straggler
  // state are world-scoped like the ring traffic counters — a previous
  // (elastic) world's rank identities and timings must not pollute this
  // one. Also re-reads the HOROVOD_STRAGGLER_* knobs.
  hvd::metrics::Registry::Get().ResetForWorld(size);
  // A fresh world starts from the env config; a previous world's tuned
  // dispatch flags must not leak through re-init.
  s->hier_flags.store(-1);
  s->hier_env_flags.store(
      (hvd::EnvFlag("HOROVOD_HIERARCHICAL_ALLREDUCE") ? 1 : 0) |
      (hvd::EnvFlag("HOROVOD_HIERARCHICAL_ALLGATHER") ? 2 : 0));
  s->rank = rank;
  s->size = size;
  s->local_rank = local_rank;
  s->local_size = local_size;
  s->cross_rank = cross_rank;
  s->cross_size = cross_size;
  s->cycle_time_ms = cycle_time_ms;
  s->shutdown_requested.store(false);
  s->drain_requested.store(false);
  s->loop_done.store(false);
  s->world_lost.store(false);
  s->tensor_queue.Reopen();  // re-arm after a prior world's final drain

  // New world incarnation: every successful init (first boot or elastic
  // re-init) gets a fresh epoch. Rank 0's value is authoritative — the
  // controller broadcasts it with the endpoint map and every rank's data
  // plane stamps the adopted value into its hellos, fencing off traffic
  // from any torn-down predecessor world (docs/self-healing.md).
  s->world_epoch += 1;

  hvd::ControllerConfig cfg;
  cfg.rank = rank;
  cfg.size = size;
  cfg.cross_rank = cross_rank;
  cfg.epoch = s->world_epoch;
  cfg.coordinator_addr = coordinator_addr ? coordinator_addr : "127.0.0.1";
  cfg.coordinator_port = coordinator_port;
  cfg.fusion_threshold_bytes = static_cast<int64_t>(fusion_threshold);
  cfg.cache_capacity = static_cast<size_t>(cache_capacity);
  cfg.stall_warning_sec = stall_warning_sec;
  cfg.stall_shutdown_sec = stall_shutdown_sec;
  cfg.stall_check_enabled = stall_check_enabled != 0;
  cfg.heartbeat_ms = heartbeat_ms;
  if (liveness_timeout_ms > 0) cfg.liveness_timeout_ms = liveness_timeout_ms;
  // Per-job isolation key (launcher-exported, same on every rank): guards
  // the shared default controller port against cross-job connections.
  // Hashed to a fixed hex token so any user-supplied charset/length works
  // in the whitespace-delimited hello. FNV-1a, not std::hash: the token
  // must agree across ranks built against different stdlibs/word sizes.
  if (const char* jk = std::getenv("HOROVOD_JOB_KEY")) {
    uint64_t h = 1469598103934665603ull;
    for (const char* p = jk; *p; ++p) {
      h ^= static_cast<unsigned char>(*p);
      h *= 1099511628211ull;
    }
    char tok[32];
    std::snprintf(tok, sizeof(tok), "%llx",
                  static_cast<unsigned long long>(h));
    cfg.job_key = tok;
  }

  if (size <= 1) {
    s->controller = std::make_unique<hvd::LocalController>(cfg);
    s->ring = std::make_unique<hvd::Ring>();
  } else {
    if (!s->data_listener.Listen(0)) return -2;
    s->controller = std::make_unique<hvd::TcpController>(
        cfg, s->data_listener.port(), my_host ? my_host : "127.0.0.1");
  }
  // hvdlint: ignore[blocking-under-lock] -- bootstrap by design:
  // init_mu IS the lifecycle lock, and the controller handshake
  // (accept/connect) must finish before any getter may observe the
  // world as initialized; bound: the 120 s accept/30 s connect
  // timeouts, paid once per (re)init, never on a hot path.
  hvd::Status st = s->controller->Initialize();
  if (!st.ok()) {
    std::fprintf(stderr, "[horovod_tpu] init failed: %s\n",
                 st.reason().c_str());
    return -1;
  }
  if (size > 1) {
    s->ring = std::make_unique<hvd::Ring>();
    // The data plane stamps the ADOPTED epoch (the coordinator's, not
    // this process's counter) into every hello and resume frame — set
    // before Connect so even the bootstrap dials are fenced.
    s->ring->set_epoch(s->controller->epoch());
    // hvdlint: ignore[blocking-under-lock] -- same bootstrap contract
    // as Initialize above: the data-plane dial must complete under
    // init_mu before initialized flips true; bound: the ring's
    // connect/accept timeouts, once per (re)init.
    st = s->ring->Connect(rank, s->controller->data_endpoints(),
                          &s->data_listener);
    if (!st.ok()) {
      std::fprintf(stderr, "[horovod_tpu] ring init failed: %s\n",
                   st.reason().c_str());
      return -1;
    }
    // Host topology from the controller's exchanged table: enables the
    // two-level hierarchical paths and the local/cross traffic split.
    s->ring->SetTopology(s->controller->cross_ranks());
    // Intra-host transport registry (op_manager.h): shm data plane when
    // HOROVOD_SHM is on (must agree across ranks, like every dispatch
    // env), TCP PeerLink as the registered fallback. The fallback
    // toggle (HOROVOD_SHM_FALLBACK, default on) turns attach/exec
    // failures into hard errors when disabled — for deployments that
    // would rather fail fast than silently ride loopback TCP. With
    // heartbeats armed, shm waits are bounded by ~2x the liveness
    // timeout so a wedged peer cannot park an shm leg past the
    // eviction the liveness plane delivers on the TCP side.
    long long shm_wait_ms =
        heartbeat_ms > 0 ? 2LL * cfg.liveness_timeout_ms : 120000;
    // Cross-host leader legs: striped multi-socket TCP when
    // HOROVOD_STRIPES > 1 (must agree across ranks, like every dispatch
    // env); HOROVOD_STRIPE_FALLBACK=0 makes a stripe connect failure a
    // hard error instead of a lock-step slide to single-socket TCP.
    // hvdlint: ignore[blocking-under-lock] -- transport bring-up (shm
    // attach + stripe dials, which may lazily PeerLink-accept) is part
    // of the same once-per-init bootstrap under the lifecycle lock;
    // bound: the transport connect timeouts, never a steady-state
    // path.
    s->ring->ConfigureTransports(
        hvd::EnvFlag("HOROVOD_SHM"),
        hvd::ShmSlotBytes(static_cast<long long>(fusion_threshold)),
        hvd::EnvFlag("HOROVOD_SHM_FALLBACK", /*dflt=*/true),
        shm_wait_ms, hvd::StripesFromEnv(), hvd::ChunkBytesFromEnv(),
        hvd::EnvFlag("HOROVOD_STRIPE_FALLBACK", /*dflt=*/true));
    // Hierarchical control plane (docs/control-plane.md): per-host
    // leaders aggregate their members' negotiation frames so the
    // coordinator does O(hosts) socket work per cycle instead of
    // O(ranks). Off by default — the flat star is byte-identical to
    // previous releases. A dispatch knob: must agree across ranks,
    // like every routing env. Member<->leader hops ride the ring's
    // LOCAL_CTRL registry leg (shm first, TCP PeerLink fallthrough),
    // wired here because the ring's transports must exist before the
    // first hier cycle — and the background thread starts only below.
    if (hvd::EnvFlag("HOROVOD_HIER_CONTROL")) {
      auto* tcp_ctl =
          static_cast<hvd::TcpController*>(s->controller.get());
      hvd::Ring* ring = s->ring.get();
      hvd::TcpController::CtrlChannel ch;
      ch.send = [ring](int peer, const std::string& frame) {
        return ring->CtrlSendFrame(peer, frame);
      };
      ch.recv = [ring](int peer, std::string* frame) {
        return ring->CtrlRecvFrame(peer, frame);
      };
      tcp_ctl->EnableHierControl(std::move(ch));
    }
  }
  // The background thread gets stable raw pointers captured here, under
  // init_mu — it must never reach through the GUARDED_BY(init_mu)
  // fields itself (hvd_shutdown joins it before resetting them).
  s->background = std::thread(hvd::BackgroundLoop, s->controller.get(),
                              s->ring.get());
  s->initialized.store(true);
  return 0;
}

void hvd_shutdown() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  if (!s->initialized.load()) return;
  s->shutdown_requested.store(true);
  if (s->background.joinable()) s->background.join();
  s->initialized.store(false);
  s->controller.reset();
  s->ring.reset();
  s->data_listener.Close();
  {
    // Resolve any responses still parked at the XLA executor so waiters
    // never hang across shutdown.
    hvd::MutexLock ilk(s->inflight_mu);
    hvd::Status aborted =
        hvd::Status::Aborted("horovod_tpu runtime has been shut down");
    for (auto& kv : s->inflight) {
      for (auto& e : kv.second) {
        s->handles.MarkDone(e.handle, aborted);
        if (e.callback) e.callback(aborted);
      }
    }
    s->inflight.clear();
  }
  {
    hvd::MutexLock rlk(s->results_mu);
    s->results.clear();
  }
}

// Autotuner hook: adjust the cycle time / fusion threshold of a running
// world (the reference applies ParameterManager updates inside
// BackgroundThreadLoop, operations.cc:598-604).
void hvd_set_parameters(double cycle_time_ms, long long fusion_threshold) {
  auto* s = hvd::g();
  // init_mu also guards hvd_shutdown's controller.reset(): without it a
  // tuner update racing shutdown could dereference a freed controller.
  hvd::MutexLock lk(s->init_mu);
  if (cycle_time_ms > 0) {
    s->cycle_time_ms.store(cycle_time_ms);
    // Stage the new cycle for the next response broadcast so worker ranks
    // converge to the coordinator's tuned value (SynchronizeParameters).
    if (s->controller) s->controller->set_cycle_hint_ms(cycle_time_ms);
  }
  if (fusion_threshold >= 0 && s->controller) {
    s->controller->set_fusion_threshold(
        static_cast<int64_t>(fusion_threshold));
  }
}

double hvd_get_cycle_time_ms() { return hvd::g()->cycle_time_ms.load(); }

// Observability hooks (reference: stall report text goes to the log,
// stall_inspector.cc; cache effectiveness is visible via timeline — here
// both are queryable so tests and users can assert on them directly).
long long hvd_cache_hits() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->controller ? static_cast<long long>(s->controller->cache_hits())
                       : 0;
}

// Per-rank negotiation ticks (reference Timeline::NegotiateRankReady,
// controller.cc:797-809). Enable alongside the timeline, then drain
// periodically: each line is "<rank> <steady-clock ns> <tensor name>".
void hvd_set_record_negotiation(int enabled) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  if (s->controller) s->controller->set_record_negotiation(enabled != 0);
}

int hvd_drain_negotiation(char* buf, int cap) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  if (s->controller == nullptr || buf == nullptr || cap <= 0) return 0;
  // Consume only whole events that fit; the rest stay queued for the next
  // call (same no-silent-truncation rule as hvd_stall_report).
  auto events = s->controller->DrainNegotiationEvents();
  std::string text;
  size_t used = 0;
  for (; used < events.size(); ++used) {
    const auto& e = events[used];
    std::string line = std::to_string(e.rank) + " " +
                       std::to_string(e.mono_ns) + " " + e.name + "\n";
    if (text.size() + line.size() > static_cast<size_t>(cap - 1)) break;
    text += line;
  }
  if (used < events.size()) {
    s->controller->RequeueNegotiationEvents(
        std::vector<hvd::Controller::NegotiationEvent>(
            events.begin() + used, events.end()));
  }
  std::memcpy(buf, text.data(), text.size());
  buf[text.size()] = '\0';
  return static_cast<int>(text.size());
}

// Graceful-drain farewell (docs/liveness.md): mark this rank's departure
// as a clean DRAIN before calling hvd_shutdown. The background loop's
// final request frame then carries the drain flag, so the coordinator's
// liveness stream records DRAIN (zero blacklist strikes) instead of a
// crash eviction.
void hvd_drain() { hvd::g()->drain_requested.store(true); }

// Accumulated liveness events (SUSPECT/EVICT/DRAIN/RECOVER lines from
// the controller's liveness plane). Same bounded-drain contract as
// hvd_stall_report: consumes only what fits; the rest stays queued.
int hvd_liveness_report(char* buf, int cap) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  if (s->controller == nullptr || buf == nullptr || cap <= 0) return 0;
  std::string r =
      s->controller->TakeLivenessReport(static_cast<size_t>(cap - 1));
  std::memcpy(buf, r.data(), r.size());
  buf[r.size()] = '\0';
  return static_cast<int>(r.size());
}

int hvd_stall_report(char* buf, int cap) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  if (s->controller == nullptr || buf == nullptr || cap <= 0) return 0;
  // Consumes only what fits; unread report text stays queued for the next
  // call, so a bounded buffer never loses warnings.
  std::string r =
      s->controller->TakeStallReport(static_cast<size_t>(cap - 1));
  std::memcpy(buf, r.data(), r.size());
  buf[r.size()] = '\0';
  return static_cast<int>(r.size());
}

long long hvd_get_fusion_threshold() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->controller ? static_cast<long long>(
                             s->controller->fusion_threshold())
                       : -1;
}

int hvd_initialized() { return hvd::g()->initialized.load() ? 1 : 0; }
// 1 once this rank's world ended because a rank was lost (died, was
// evicted, or stalled past the shutdown window), 0 while it lives or when
// it ended because a rank asked to leave.
int hvd_world_lost() { return hvd::g()->world_lost.load() ? 1 : 0; }
int hvd_rank() { return hvd::g()->rank.load(); }
int hvd_size() { return hvd::g()->size.load(); }
int hvd_local_rank() { return hvd::g()->local_rank.load(); }
int hvd_local_size() { return hvd::g()->local_size.load(); }
int hvd_cross_rank() { return hvd::g()->cross_rank.load(); }
int hvd_cross_size() { return hvd::g()->cross_size.load(); }

void hvd_register_exec_callback(void (*cb)(const char*, int, long)) {
  hvd::g()->exec_cb.store(cb);
}

// Enqueue a collective. Returns a handle (>= 0) or a negative error code.
// For HOST-plane tensors `data`/`output` are live host pointers that must
// stay valid until the handle resolves; XLA-plane entries pass nullptrs.
// `done`/`done_arg` (optional): fires exactly once — on the background or
// executor thread, possibly before this call returns — if and only if the
// return value is >= 0. The handle is passed to the callback so callers
// never need to read it from shared state (the role of the reference's
// StatusCallback for async framework kernels, tensorflow/mpi_ops.cc:294).
static long long EnqueueImpl(const char* name, int op, int reduce_op,
                             int dtype, const long long* shape, int ndim,
                             const long long* chip_dims, int n_chips,
                             void* data, void* output, int root_rank,
                             double prescale, double postscale, int plane,
                             void (*done)(void*, long long, int,
                                          const char*),
                             void* done_arg) {
  auto* s = hvd::g();
  if (!s->initialized.load()) return -1;
  hvd::TensorTableEntry e;
  if (chip_dims != nullptr && n_chips > 0) {
    e.request.chip_dims.assign(chip_dims, chip_dims + n_chips);
  }
  e.name = name;
  e.request.rank = s->rank;
  e.request.op = static_cast<hvd::CollectiveOp>(op);
  e.request.reduce_op = static_cast<hvd::ReduceOp>(reduce_op);
  e.request.dtype = hvd::IntToDtype(dtype);
  e.request.plane = static_cast<hvd::DevicePlane>(plane);
  e.request.root_rank = root_rank;
  e.request.name = name;
  e.request.prescale = prescale;
  e.request.postscale = postscale;
  std::vector<int64_t> dims(ndim);
  for (int i = 0; i < ndim; ++i) dims[i] = static_cast<int64_t>(shape[i]);
  e.request.shape = hvd::TensorShape(std::move(dims));
  e.data = data;
  e.output = output;
  e.enqueue_ns = hvd::metrics::MonoNs();
  e.handle = s->handles.NewHandle();
  long long h = e.handle;
  if (done != nullptr) {
    e.callback = [done, done_arg, h](const hvd::Status& st) {
      done(done_arg, h, st.ok() ? 1 : 0, st.reason().c_str());
    };
  }
  hvd::Status st = s->tensor_queue.AddToTensorQueue(std::move(e));
  if (!st.ok()) {
    s->handles.MarkDone(h, st);
    if (done != nullptr) done(done_arg, h, 0, st.reason().c_str());
  }
  return h;
}

long long hvd_enqueue_cb(const char* name, int op, int reduce_op, int dtype,
                         const long long* shape, int ndim, void* data,
                         void* output, int root_rank, double prescale,
                         double postscale, int plane,
                         void (*done)(void*, long long, int, const char*),
                         void* done_arg) {
  return EnqueueImpl(name, op, reduce_op, dtype, shape, ndim, nullptr, 0,
                     data, output, root_rank, prescale, postscale, plane,
                     done, done_arg);
}

long long hvd_enqueue(const char* name, int op, int reduce_op, int dtype,
                      const long long* shape, int ndim, void* data,
                      void* output, int root_rank, double prescale,
                      double postscale, int plane) {
  return hvd_enqueue_cb(name, op, reduce_op, dtype, shape, ndim, data,
                        output, root_rank, prescale, postscale, plane,
                        nullptr, nullptr);
}

// Allgather with explicit per-chip first dims (XLA plane, local_size > 1,
// possibly ragged across the locally-driven chips). chip_dims rides the
// Request so the coordinator can publish the rank-major per-chip dim
// table in the response (see Controller::ConstructResponse).
long long hvd_enqueue_chips(const char* name, int op, int reduce_op,
                            int dtype, const long long* shape, int ndim,
                            const long long* chip_dims, int n_chips,
                            void* data, void* output, int root_rank,
                            double prescale, double postscale, int plane) {
  return EnqueueImpl(name, op, reduce_op, dtype, shape, ndim, chip_dims,
                     n_chips, data, output, root_rank, prescale, postscale,
                     plane, nullptr, nullptr);
}

// Executor-allocated result access (ragged allgather): after hvd_wait
// resolves a handle, the result's byte size, per-rank first dims, and
// payload are fetched here. hvd_result_fetch erases the stored buffer.
long long hvd_result_bytes(long long handle) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->results_mu);
  auto it = s->results.find(handle);
  return it == s->results.end()
             ? -1
             : static_cast<long long>(it->second.bytes.size());
}

int hvd_result_dims(long long handle, long long* dims, int cap) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->results_mu);
  auto it = s->results.find(handle);
  if (it == s->results.end()) return -1;
  int n = static_cast<int>(it->second.first_dims.size());
  for (int i = 0; i < n && i < cap; ++i) {
    dims[i] = static_cast<long long>(it->second.first_dims[i]);
  }
  return n;
}

int hvd_result_fetch(long long handle, void* dst, long long cap) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->results_mu);
  auto it = s->results.find(handle);
  if (it == s->results.end()) return -1;
  if (static_cast<long long>(it->second.bytes.size()) > cap) return -2;
  std::memcpy(dst, it->second.bytes.data(), it->second.bytes.size());
  s->results.erase(it);
  return 1;
}

// Graceful departure (reference EnqueueJoin, operations.cc:937-961): this
// rank stops submitting tensors and contributes zeros to the other ranks'
// reductions until every rank has joined. Returns a handle that resolves
// when all ranks have joined; hvd_last_joined() then reports the rank that
// joined last.
long long hvd_join() {
  auto* s = hvd::g();
  if (!s->initialized.load()) return -1;
  hvd::TensorTableEntry e;
  e.name = hvd::kJoinTensorName;
  e.request.rank = s->rank;
  e.request.op = hvd::CollectiveOp::JOIN;
  e.request.plane = hvd::DevicePlane::HOST;
  e.request.name = e.name;
  e.handle = s->handles.NewHandle();
  long long h = e.handle;
  s->joined.store(true);
  hvd::Status st = s->tensor_queue.AddToTensorQueue(std::move(e));
  if (!st.ok()) {
    s->joined.store(false);
    s->handles.MarkDone(h, st);
  }
  return h;
}

int hvd_last_joined() { return hvd::g()->last_joined.load(); }

// Payload bytes this rank has sent on the host data plane (ring + peer
// links). Test hook for wire-traffic complexity assertions (e.g. VHDD
// Adasum must be O(count) per rank, not O(count * size)).
long long hvd_ring_bytes_sent() {
  auto* s = hvd::g();
  // init_mu also guards hvd_shutdown's ring.reset(): a monitor thread
  // polling traffic counters across shutdown must not dereference a ring
  // being freed (same race family as hvd_set_parameters vs shutdown).
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->bytes_sent() : 0;
}

// Split traffic accounting: bytes to same-host peers (loopback links) vs
// different-host peers (the scarce cross-host budget). local + cross ==
// bytes_sent once a topology is installed; without one everything is
// accounted cross (one process per host presumed).
long long hvd_ring_local_bytes() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->local_bytes_sent() : 0;
}

long long hvd_ring_cross_bytes() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->cross_bytes_sent() : 0;
}

// Payload bytes moved over the shared-memory transport (the zero-
// socket-syscall intra-host legs, docs/shm-transport.md). With shm
// active, local TCP bytes collapse to ~0 and this counter carries the
// entire local leg: bytes_sent == local + cross + shm.
long long hvd_ring_shm_bytes() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->shm_bytes_sent() : 0;
}

// 1 when this rank's shm segment is live (transport registered and
// enabled) — the transport choice bench.py records.
int hvd_shm_active() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return (s->ring && s->ring->shm_active()) ? 1 : 0;
}

// Striped cross-host transport observability (docs/cross-transport.md).
// Payload bytes that rode the stripes — a subset of cross_bytes, which
// stays byte-identical to the single-socket path (headers off every
// counter).
long long hvd_ring_stripe_bytes() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->stripe_bytes_sent() : 0;
}

// The stripe count in ACTIVE use: K once at least one leader pair
// carries striped traffic, 0 when striping is off or every pair fell
// back to single-socket TCP (what hvd.ring_traffic() / bench.py
// record).
int hvd_ring_stripe_count() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->stripe_count() : 0;
}

// Wall-clock nanoseconds spent inside cross-host leader-leg exchanges —
// the leg-local timing the --cross-leg A/B compares (end-to-end
// iteration time on an oversubscribed box is dominated by fusion copies
// and idle members' yield-spins, which the leg never touches).
long long hvd_ring_cross_ns() {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  return s->ring ? s->ring->cross_leg_ns() : 0;
}

// Coordinator autotuner: propose a tuned cross-host stripe count. It
// rides the next response broadcast and applies on every rank at that
// frame boundary (both sides of every pair renegotiate in lock-step).
void hvd_set_stripes(int stripes) {
  auto* s = hvd::g();
  // init_mu guards hvd_shutdown's controller.reset() — same race as
  // hvd_set_parameters (a tuner update vs a concurrent shutdown).
  hvd::MutexLock lk(s->init_mu);
  if (s->controller) s->controller->set_stripe_hint(stripes);
}

// The EFFECTIVE host-plane hierarchical dispatch flags this process would
// apply right now: the tuner's synced value when present, else the env
// default (bit0 = allreduce, bit1 = allgather). Observability for
// hvd.ring_traffic() / bench.py — hvd_get_hier_flags reports only the
// tuned value (-1 when untuned).
int hvd_host_hier_flags() {
  auto* s = hvd::g();
  int hf = s->hier_flags.load();
  return hf >= 0 ? hf : s->hier_env_flags.load();
}

// THE unified metrics getter (docs/metrics.md): every native counter
// and histogram as one JSON document. `drain_flags` bit0 additionally
// drains the liveness report into reports.liveness (consume-on-read,
// like hvd_liveness_report); bit1 drains the straggler warning events
// (the Python plane turns them into STRAGGLER_WARNING timeline
// instants). Returns the JSON length and writes it NUL-terminated when
// it fits in `cap`; otherwise restores anything drained and returns
// -(needed bytes) so the caller can retry with a bigger buffer — a
// too-small buffer never silently loses events.
int hvd_metrics_snapshot(char* buf, int cap, int drain_flags) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->init_mu);
  std::string liveness;
  bool with_liveness = false;
  if ((drain_flags & 1) && s->controller) {
    liveness = s->controller->TakeLivenessReport();
    with_liveness = true;
  }
  std::vector<hvd::metrics::StragglerEvent> events;
  bool with_events = (drain_flags & 2) != 0;
  if (with_events) {
    events = hvd::metrics::Registry::Get().straggler().DrainEvents();
  }
  std::string js = hvd::BuildMetricsJsonLocked(s, liveness, with_liveness,
                                               events, with_events);
  if (buf == nullptr || cap <= 0 ||
      js.size() > static_cast<size_t>(cap - 1)) {
    if (with_liveness && !liveness.empty()) {
      s->controller->RestoreLivenessReport(std::move(liveness));
    }
    if (with_events && !events.empty()) {
      hvd::metrics::Registry::Get().straggler().RestoreEvents(
          std::move(events));
    }
    return -static_cast<int>(js.size() + 1);
  }
  std::memcpy(buf, js.data(), js.size());
  buf[js.size()] = '\0';
  return static_cast<int>(js.size());
}

// Poll: 0 pending, 1 done-ok, -1 done-error.
int hvd_test(long long handle, char* err, int errlen) {
  std::string reason;
  int r = hvd::g()->handles.Test(handle, &reason);
  if (r < 0 && err && errlen > 0) {
    std::strncpy(err, reason.c_str(), errlen - 1);
    err[errlen - 1] = '\0';
  }
  return r;
}

int hvd_wait(long long handle, char* err, int errlen) {
  std::string reason;
  int r = hvd::g()->handles.Wait(handle, &reason);
  if (r < 0 && err && errlen > 0) {
    std::strncpy(err, reason.c_str(), errlen - 1);
    err[errlen - 1] = '\0';
  }
  hvd::g()->handles.Erase(handle);
  return r;
}

// XLA executor completion: resolves all entries of an in-flight response.
void hvd_response_done(long response_id, int ok, const char* error) {
  auto* s = hvd::g();
  std::vector<hvd::TensorTableEntry> entries;
  {
    hvd::MutexLock lk(s->inflight_mu);
    auto it = s->inflight.find(response_id);
    if (it == s->inflight.end()) return;
    entries = std::move(it->second);
    s->inflight.erase(it);
  }
  hvd::Status st = ok ? hvd::Status::OK()
                      : hvd::Status::Aborted(error ? error : "exec failed");
  if (!ok) {
    // Erroring callers never reach hvd_result_fetch (the only consumer
    // that erases stored results), so results already deposited for this
    // response's handles would strand until shutdown — drop them here.
    hvd::MutexLock lk(s->results_mu);
    for (auto& e : entries) s->results.erase(e.handle);
  }
  for (auto& e : entries) {
    hvd::RecordEntryDone(e);
    s->handles.MarkDone(e.handle, st);
    if (e.callback) e.callback(st);
  }
}

int hvd_pending_count() {
  return static_cast<int>(hvd::g()->tensor_queue.PendingCount());
}

// Enable (threshold >= 0, bytes) or disable (-1) routing of large fused
// host-plane allreduces to the registered executor for XLA-plane staging.
void hvd_set_host_via_xla(long long threshold) {
  hvd::g()->host_via_xla_threshold.store(threshold);
}

// Coordinator autotuner: propose tuned hierarchical-dispatch flags
// (bit0 = allreduce, bit1 = allgather). They ride the next response
// broadcast and apply on every rank at that frame boundary.
void hvd_set_hier_flags(int flags) {
  auto* s = hvd::g();
  // init_mu guards hvd_shutdown's controller.reset() — same race as
  // hvd_set_parameters (a tuner update vs a concurrent shutdown).
  hvd::MutexLock lk(s->init_mu);
  if (s->controller) s->controller->set_hier_flags_hint(flags);
}

int hvd_get_hier_flags() { return hvd::g()->hier_flags.load(); }

// Host-staging executor data access: the raw buffer pointers of one named
// entry of an in-flight response. Returns 1 (found), 0 (absent — a joined
// rank's missing slot), -1 (unknown response id).
int hvd_inflight_ptrs(long response_id, const char* name, void** data,
                      void** output) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->inflight_mu);
  auto it = s->inflight.find(response_id);
  if (it == s->inflight.end()) return -1;
  for (auto& e : it->second) {
    if (e.name == name) {
      if (data) *data = e.data;
      if (output) *output = e.output;
      return 1;
    }
  }
  return 0;
}

// The native handle of one named entry of an in-flight response (-1 when
// absent) — the key under which hvd_store_result deposits
// executor-allocated outputs (staged ragged allgather).
long long hvd_inflight_handle(long response_id, const char* name) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->inflight_mu);
  auto it = s->inflight.find(response_id);
  if (it == s->inflight.end()) return -1;
  for (auto& e : it->second) {
    if (e.name == name) return e.handle;
  }
  return -1;
}

// Deposit an executor-allocated result (staged allgather): the caller's
// wait then fetches it via hvd_result_bytes/dims/fetch exactly as for
// ring-produced ragged results.
int hvd_store_result(long long handle, const void* data, long long nbytes,
                     const long long* dims, int ndims) {
  auto* s = hvd::g();
  hvd::MutexLock lk(s->results_mu);
  auto& rb = s->results[handle];
  rb.bytes.assign(static_cast<const char*>(data),
                  static_cast<const char*>(data) + nbytes);
  rb.first_dims.assign(dims, dims + ndims);
  return 0;
}

}  // extern "C"
