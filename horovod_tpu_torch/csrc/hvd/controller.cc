#include "controller.h"

#include <poll.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>

#include "env_util.h"
#include "message.h"
#include "metrics.h"

// TSan-build detection (see tensor_queue.cc): GCC-10-era libtsan lacks
// the pthread_cond_clockwait interceptor libstdc++ uses for steady_clock
// cv waits, so the instrumented heartbeat thread must wait on the
// intercepted system_clock path.
#if defined(__SANITIZE_THREAD__)
#define HVD_TSAN_BUILD 1
#elif defined(__has_feature)
#if __has_feature(thread_sanitizer)
#define HVD_TSAN_BUILD 1
#endif
#endif

namespace hvd {

namespace {
double MsSince(std::chrono::steady_clock::time_point then,
               std::chrono::steady_clock::time_point now) {
  return std::chrono::duration<double, std::milli>(now - then).count();
}
}  // namespace

// ---- shared machinery ------------------------------------------------------

bool Controller::ValidateGroup(const std::string& name,
                               const std::vector<Request>& group,
                               int world_size, Response* out) {
  // Mirrors the reference's ConstructResponse error checking
  // (controller.cc:378-611): op, dtype, root rank, and (for allreduce)
  // shape must agree across ranks; allgather shapes may differ only in
  // dim 0.
  const Request& first = group.front();
  std::string error;
  for (size_t i = 1; i < group.size(); ++i) {
    const Request& r = group[i];
    if (r.op != first.op) {
      error = "Mismatched collective operations submitted for tensor '" +
              name + "'";
      break;
    }
    if (r.dtype != first.dtype) {
      error = "Mismatched data types submitted for tensor '" + name + "': " +
              std::string(DataTypeName(first.dtype)) + " vs " +
              DataTypeName(r.dtype);
      break;
    }
    if ((first.op == CollectiveOp::BROADCAST ||
         first.op == CollectiveOp::ALLREDUCE) &&
        r.shape != first.shape) {
      error = "Mismatched shapes submitted for tensor '" + name + "': " +
              first.shape.DebugString() + " vs " + r.shape.DebugString();
      break;
    }
    if (first.op == CollectiveOp::ALLGATHER ||
        first.op == CollectiveOp::ALLTOALL) {
      if (r.shape.ndim() != first.shape.ndim()) {
        error = "Mismatched ranks submitted for gather tensor '" + name + "'";
        break;
      }
      for (int d = 1; d < r.shape.ndim(); ++d) {
        if (r.shape.dim(d) != first.shape.dim(d)) {
          error = "Mismatched non-first dimensions for tensor '" + name + "'";
          break;
        }
      }
      if (!error.empty()) break;
      // First dimensions may differ (ragged allgather): per-rank sizes are
      // published in the response's first_dims (reference
      // SetDisplacements / MPI_Allgatherv, ops/collective_operations.cc,
      // ops/mpi_operations.cc:140-175).
    }
    if (first.op == CollectiveOp::BROADCAST &&
        r.root_rank != first.root_rank) {
      error = "Mismatched root ranks for broadcast tensor '" + name + "': " +
              std::to_string(first.root_rank) + " vs " +
              std::to_string(r.root_rank);
      break;
    }
    if (r.reduce_op != first.reduce_op) {
      error = "Mismatched reduce ops for tensor '" + name + "'";
      break;
    }
    if (r.plane != first.plane) {
      error = "Mismatched device planes for tensor '" + name + "'";
      break;
    }
    if (r.prescale != first.prescale || r.postscale != first.postscale) {
      error = "Mismatched prescale/postscale factors for tensor '" + name +
              "'";
      break;
    }
  }

  if (error.empty() && first.op == CollectiveOp::ALLGATHER &&
      first.plane == DevicePlane::HOST && first.shape.ndim() == 0) {
    // Parity with the reference's rank-zero allgather rejection
    // (controller.cc:468-472); the XLA plane accepts 0-d (stacked eager
    // convention gathers scalars into a vector).
    error = "Rank zero tried to allgather a rank-zero tensor for '" + name +
            "'.";
  }

  out->op = first.op;
  out->reduce_op = first.reduce_op;
  out->dtype = first.dtype;
  out->plane = first.plane;
  out->root_rank = first.root_rank;
  out->prescale = first.prescale;
  out->postscale = first.postscale;
  out->tensor_names = {name};
  out->shapes = {first.shape};
  if (error.empty() && first.op == CollectiveOp::ALLGATHER) {
    // Publish per-CHIP first-dim sizes, rank-major, so every rank can
    // size outputs and use displacement math without a separate exchange
    // (a host-plane rank drives one chip, so its entry count is 1; an
    // XLA-plane rank contributes one entry per locally-driven chip via
    // Request::chip_dims). Ranks absent from the group (world_size >
    // group, e.g. a single-controller world) default to the first
    // requester's chip list. Exactly one inner vector per tensor (empty
    // for 0-d) so fused responses stay index-aligned with tensor_names.
    if (first.shape.ndim() == 0) {
      out->first_dims = {std::vector<int64_t>{}};
    } else {
      auto chips_of = [](const Request& q) -> std::vector<int64_t> {
        if (!q.chip_dims.empty()) return q.chip_dims;
        return {q.shape.dim(0)};
      };
      std::vector<std::vector<int64_t>> per_rank(
          world_size, chips_of(first));
      for (const auto& q : group) {
        if (q.rank >= 0 && q.rank < world_size) per_rank[q.rank] = chips_of(q);
      }
      std::vector<int64_t> fd;
      for (const auto& chips : per_rank) {
        fd.insert(fd.end(), chips.begin(), chips.end());
      }
      out->first_dims = {std::move(fd)};
    }
  }
  if (!error.empty()) {
    out->error_reason = error;
    out->op = CollectiveOp::ERROR_OP;
    return false;
  }
  (void)world_size;
  return true;
}

std::vector<Response> Controller::FuseResponses(std::vector<Response> singles,
                                                int64_t threshold_bytes) {
  // Bin compatible single-tensor responses (reference FuseResponses,
  // controller.cc:640-761): same op/dtype/plane/reduce-op/root and scale
  // factors, cumulative payload under the threshold. Allgather responses
  // fuse too (the XLA executor concatenates flats per tensor itself).
  std::vector<Response> fused;
  for (auto& r : singles) {
    if (r.op == CollectiveOp::ERROR_OP || r.op == CollectiveOp::BARRIER ||
        r.op == CollectiveOp::JOIN) {
      fused.push_back(std::move(r));
      continue;
    }
    bool merged = false;
    for (auto& f : fused) {
      if (f.op == r.op && f.dtype == r.dtype && f.plane == r.plane &&
          f.reduce_op == r.reduce_op && f.root_rank == r.root_rank &&
          f.prescale == r.prescale && f.postscale == r.postscale &&
          f.error_reason.empty() &&
          f.total_bytes() + r.total_bytes() <= threshold_bytes) {
        f.tensor_names.push_back(std::move(r.tensor_names[0]));
        f.shapes.push_back(std::move(r.shapes[0]));
        if (!r.first_dims.empty()) {
          f.first_dims.push_back(std::move(r.first_dims[0]));
        }
        merged = true;
        break;
      }
    }
    if (!merged) fused.push_back(std::move(r));
  }
  return fused;
}

void Controller::RecordLivenessEvent(const std::string& line) {
  {
    MutexLock lk(liveness_mu_);
    // Bounded like the negotiation buffer: a pathological churn loop must
    // not grow the report without limit if nobody drains it.
    if (liveness_report_.size() < (1u << 20)) {
      liveness_report_ += line;
      liveness_report_ += '\n';
    }
  }
  std::fprintf(stderr, "[horovod_tpu liveness] %s\n", line.c_str());
}

void Controller::RecordNegotiationEvent(const std::string& name, int rank) {
  if (!record_negotiation_.load(std::memory_order_relaxed)) return;
  auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now().time_since_epoch())
                .count();
  MutexLock lk(events_mu_);
  if (events_.size() >= 65536) {
    events_.erase(events_.begin(), events_.begin() + 32768);
  }
  events_.push_back({name, rank, static_cast<int64_t>(ns)});
}

// ---- LocalController -------------------------------------------------------

std::vector<Response> LocalController::ComputeResponseList(
    std::vector<Request> reqs, bool this_rank_shutdown,
    bool this_rank_drain, bool* world_shutdown) {
  // A single-process world draining IS the world shutting down; the
  // distinction only matters to a coordinator accounting for peers.
  *world_shutdown = this_rank_shutdown || this_rank_drain;
  // Single-rank world: the tuner's categorical hints have no broadcast
  // to ride; apply them at the same cycle boundary the TCP path would.
  int hier = hier_flags_hint();
  if (hier >= 0) {
    synced_hier_flags_.store(hier, std::memory_order_relaxed);
  }
  int stripes = stripe_hint();
  if (stripes >= 0) {
    synced_stripes_.store(stripes, std::memory_order_relaxed);
  }
  std::vector<Response> singles;
  singles.reserve(reqs.size());
  for (auto& q : reqs) {
    if (q.op == CollectiveOp::JOIN) {
      // Single-process world: the only rank joined, so everyone has.
      Response r;
      r.op = CollectiveOp::JOIN;
      r.root_rank = 0;
      r.tensor_names = {kJoinTensorName};
      r.shapes = {TensorShape()};
      singles.push_back(std::move(r));
      continue;
    }
    Response r;
    std::vector<Request> group = {q};
    ValidateGroup(q.name, group, 1, &r);
    singles.push_back(std::move(r));
  }
  return FuseResponses(std::move(singles), fusion_threshold());
}

// ---- TcpController ---------------------------------------------------------

Status TcpController::Initialize() {
  shutdown_ranks_.assign(cfg_.size, false);
  joined_ranks_.assign(cfg_.size, false);
  stall_.Configure(cfg_.stall_warning_sec, cfg_.stall_shutdown_sec,
                   cfg_.size, cfg_.stall_check_enabled);
  liveness_on_ = cfg_.heartbeat_ms > 0 && cfg_.size > 1;
  last_seen_.assign(cfg_.size, std::chrono::steady_clock::now());
  peer_state_.assign(cfg_.size, kAlive);
  if (cfg_.rank == 0) {
    if (!listener_.Listen(cfg_.coordinator_port)) {
      return Status::Error(StatusType::UNKNOWN_ERROR,
                           "coordinator failed to listen on port " +
                               std::to_string(cfg_.coordinator_port));
    }
    worker_socks_.resize(cfg_.size - 1);
    data_endpoints_.assign(cfg_.size, {"", 0});
    data_endpoints_[0] = {my_host_, data_port_};
    // Every rank defaults to its own host group until its hello says
    // otherwise — the conservative stance matching the ring's
    // no-topology accounting (each process presumed on its own node).
    // The sentinel size+r cannot collide with any reported host-group
    // id (those are host indices < size), so a rank whose hello omits
    // the cross field can never be folded into a real host's group.
    cross_ranks_.assign(cfg_.size, 0);
    for (int r = 0; r < cfg_.size; ++r) cross_ranks_[r] = cfg_.size + r;
    cross_ranks_[0] = cfg_.cross_rank;
    // Accept size-1 hellos: "rank host data_port job_key cross_rank".
    // An empty job key travels as the "-" placeholder so the
    // whitespace-delimited field positions stay fixed. The job key
    // guards against two jobs sharing one host colliding on the default
    // controller port: a worker from another job is rejected loudly
    // instead of being adopted into the wrong world. A wall-clock
    // deadline spans the WHOLE loop — rejected/garbage connections retry
    // the slot but cannot extend the wait forever.
    // HVD_JOIN_TIMEOUT_MS is an internal test/bench seam (like
    // HVD_STRIPE_TIMEOUT_MS): on an oversubscribed box, hundreds of
    // worker interpreters can take longer than 120 s just to start
    // (the 256-rank controller_bench rung serializes ~256 numpy
    // imports on however many cores exist).
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(
                        EnvMs("HVD_JOIN_TIMEOUT_MS", 120000));
    for (int i = 0; i < cfg_.size - 1; ++i) {
      auto remaining = std::chrono::duration_cast<std::chrono::milliseconds>(
          deadline - std::chrono::steady_clock::now());
      if (remaining.count() <= 0) {
        return Status::Error(StatusType::UNKNOWN_ERROR,
                             "timed out waiting for workers to connect");
      }
      Socket s = listener_.Accept(static_cast<int>(remaining.count()));
      if (!s.valid()) {
        return Status::Error(StatusType::UNKNOWN_ERROR,
                             "timed out waiting for workers to connect");
      }
      std::string hello;
      if (!s.RecvFrame(&hello)) {
        // Port scanners / health checks connect and close without a
        // frame; drop the socket and keep accepting (Accept's timeout
        // still bounds the wait for real workers).
        s.Close();
        --i;
        continue;
      }
      int rank = 0, port = 0, cross = -1;
      long long peer_epoch = -1;
      char host[256] = {0};
      char key[256] = {0};
      // Field 6 (optional): the worker's local incarnation counter
      // (docs/self-healing.md). Informational only — epochs are
      // per-process counters until the coordinator's broadcast value is
      // adopted, so they are not comparable here; the authoritative
      // stamp rides the endpoint map below. Parsed so the hello format
      // is forward-settled and old 5-field hellos stay accepted.
      int fields =
          std::sscanf(hello.c_str(), "%d %255s %d %255s %d %lld", &rank,
                      host, &port, key, &cross, &peer_epoch);
      if (fields < 3 || rank <= 0 || rank >= cfg_.size) {
        std::fprintf(stderr,
                     "[horovod_tpu coordinator] ignoring malformed hello "
                     "from a non-worker connection\n");
        s.Close();
        --i;
        continue;
      }
      std::string peer_key = fields >= 4 ? key : "";
      if (peer_key == "-") peer_key = "";
      if (peer_key != cfg_.job_key) {
        // A stray worker from another job: reject it loudly and keep
        // accepting — one foreign packet must not kill this job's startup.
        std::fprintf(stderr,
                     "[horovod_tpu coordinator] rejected worker with a "
                     "different job key (another job sharing this "
                     "controller port?)\n");
        s.SendFrame("JOBKEY_MISMATCH");
        s.Close();
        --i;
        continue;
      }
      data_endpoints_[rank] = {host, port};
      if (fields >= 5) cross_ranks_[rank] = cross;
      worker_socks_[rank - 1] = std::move(s);
    }
    // Broadcast the endpoint map with the host-topology column: every
    // rank ends up with the same rank -> (host, port, cross_rank) table,
    // so the ring's hierarchical grouping needs no further exchange.
    // The coordinator's world epoch trails the table (workers with the
    // old map layout would stop reading before it — the same tolerant
    // tail-extension style as the hello's optional fields).
    epoch_ = cfg_.epoch;
    Writer w;
    w.i32(cfg_.size);
    for (int r = 0; r < cfg_.size; ++r) {
      w.str(data_endpoints_[r].first);
      w.i32(data_endpoints_[r].second);
      w.i32(cross_ranks_[r]);
    }
    w.i64(static_cast<int64_t>(cfg_.epoch));
    for (auto& s : worker_socks_) {
      if (!s.SendFrame(w.data())) {
        return Status::Error(StatusType::UNKNOWN_ERROR,
                             "failed to send endpoint map");
      }
    }
    // Bootstrap is over: every worker socket is established, so the
    // listener has no further accepts to serve. Closing it NOW (not at
    // Finalize) removes the stale-listener teardown race that an
    // acceptance world once absorbed with re-init retries: a worker re-init
    // that dials early gets connection-refused (never a backlog slot on
    // a dying listener) and Socket::Connect's retry loop waits for the
    // successor world's fresh listener deterministically.
    listener_.Close();
  } else {
    coord_sock_ = Socket::Connect(
        cfg_.coordinator_addr, cfg_.coordinator_port,
        static_cast<int>(EnvMs("HVD_JOIN_TIMEOUT_MS", 120000)));
    if (!coord_sock_.valid()) {
      return Status::Error(StatusType::UNKNOWN_ERROR,
                           "worker failed to reach coordinator at " +
                               cfg_.coordinator_addr + ":" +
                               std::to_string(cfg_.coordinator_port));
    }
    std::string hello = std::to_string(cfg_.rank) + " " + my_host_ + " " +
                        std::to_string(data_port_) + " " +
                        (cfg_.job_key.empty() ? "-" : cfg_.job_key) + " " +
                        std::to_string(cfg_.cross_rank) + " " +
                        std::to_string(cfg_.epoch);
    if (!coord_sock_.SendFrame(hello)) {
      return Status::Error(StatusType::UNKNOWN_ERROR, "hello send failed");
    }
    std::string map_bytes;
    if (!coord_sock_.RecvFrame(&map_bytes)) {
      return Status::Error(StatusType::UNKNOWN_ERROR,
                           "endpoint map receive failed");
    }
    if (map_bytes == "JOBKEY_MISMATCH") {
      return Status::Error(
          StatusType::UNKNOWN_ERROR,
          "coordinator rejected this worker's job key — another job is "
          "using this controller port (set HOROVOD_CONTROLLER_PORT to "
          "distinct values per job)");
    }
    Reader r(map_bytes);
    int n = r.i32();
    if (n != cfg_.size) {
      return Status::Error(StatusType::UNKNOWN_ERROR, "endpoint map mismatch");
    }
    data_endpoints_.clear();
    cross_ranks_.assign(n, 0);
    for (int i = 0; i < n; ++i) {
      std::string host = r.str();
      int port = r.i32();
      data_endpoints_.emplace_back(host, port);
      cross_ranks_[i] = r.i32();
    }
    // Adopt the coordinator's world epoch (the authoritative stamp —
    // local counters are per-process and not comparable across ranks).
    // A map without the trailing i64 comes from a pre-epoch
    // coordinator: keep the local counter so fencing degrades to
    // per-process behavior instead of failing the bootstrap.
    epoch_ = r.remaining() >= 8 ? static_cast<long long>(r.i64())
                                : cfg_.epoch;
    if (liveness_on_) StartHeartbeat();
  }
  return Status::OK();
}

// ---- hierarchical control plane (docs/control-plane.md) --------------------

void TcpController::EnableHierControl(CtrlChannel ch) {
  ctrl_ = std::move(ch);
  // Same grouping as Ring::SetTopology: host groups keyed by
  // cross_rank, leader = each group's lowest rank. Ranks whose hello
  // omitted the cross field sit on the sentinel groups (size + r) and
  // become single-member leaders — the protocol degrades to flat shape
  // (every rank speaks to the coordinator) instead of misgrouping.
  std::map<int, std::vector<int>> by_host;
  for (int r = 0; r < cfg_.size; ++r) by_host[cross_ranks_[r]].push_back(r);
  leader_of_.assign(cfg_.size, -1);
  leader_rank_.assign(cfg_.size, false);
  my_members_.clear();
  for (auto& kv : by_host) {
    int lead = kv.second.front();
    leader_rank_[lead] = true;
    for (int r : kv.second) leader_of_[r] = lead;
    if (lead == cfg_.rank) {
      for (int r : kv.second) {
        if (r != cfg_.rank) my_members_.push_back(r);
      }
    }
  }
  hier_on_ = true;
}

// ---- liveness plane (docs/liveness.md) -------------------------------------

void TcpController::StartHeartbeat() {
  {
    MutexLock lk(hb_mu_);
    hb_stop_ = false;
  }
  hb_thread_ = std::thread([this] {
    const std::string hb = HeartbeatFrame();
    const auto interval = std::chrono::milliseconds(cfg_.heartbeat_ms);
    UniqueLock lk(hb_mu_);
    while (!hb_stop_) {
      // Written-out wait loop (no predicate lambda — see
      // thread_annotations.h): wake at the deadline OR on a stop
      // notify, whichever comes first.
#ifdef HVD_TSAN_BUILD
      // Intercepted system_clock wait under TSan (see the header
      // comment); a stop notify still breaks it immediately.
      auto deadline = std::chrono::system_clock::now() + interval;
#else
      auto deadline = std::chrono::steady_clock::now() + interval;
#endif
      while (!hb_stop_ &&
             hb_cv_.wait_until(lk, deadline) != std::cv_status::timeout) {
      }
      if (hb_stop_) break;
      lk.unlock();
      bool ok;
      {
        MutexLock slk(send_mu_);
        // hvdlint: ignore[blocking-under-lock] -- the heartbeat and
        // cycle threads share coord_sock_, and send_mu_ is the lock
        // that keeps their frames from interleaving; bound: one
        // ~20-byte pre-built heartbeat frame per interval, so the
        // cycle thread waits at most one tiny kernel write.
        ok = coord_sock_.valid() && coord_sock_.SendFrame(hb);
      }
      lk.lock();
      // A dead coordinator connection ends the beat; the cycle thread
      // notices the same failure on its own frame and tears down.
      if (!ok) break;
    }
  });
}

void TcpController::StopHeartbeat() {
  {
    MutexLock lk(hb_mu_);
    hb_stop_ = true;
  }
  hb_cv_.notify_all();
  if (hb_thread_.joinable()) hb_thread_.join();
}

void TcpController::MarkSuspect(int rank, const char* reason,
                                double silence_ms) {
  if (peer_state_[rank] != kAlive) return;
  peer_state_[rank] = kSuspect;
  RecordLivenessEvent("SUSPECT rank=" + std::to_string(rank) + " reason=" +
                      reason + " silence_ms=" +
                      std::to_string(static_cast<long long>(silence_ms)));
}

void TcpController::EvictRank(int rank, const char* reason,
                              double silence_ms) {
  shutdown_ranks_[rank] = true;
  peer_state_[rank] = kEvicted;
  // Close the socket: a wedged-but-alive peer errors out on its next
  // frame instead of waiting for a response that will never come.
  if (rank >= 1) worker_socks_[rank - 1].Close();
  RecordLivenessEvent("EVICT rank=" + std::to_string(rank) + " reason=" +
                      reason + " silence_ms=" +
                      std::to_string(static_cast<long long>(silence_ms)));
}

void TcpController::GatherWithLiveness(
    const std::function<void(int, const std::string&)>& ingest,
    const std::vector<bool>* expect_frame) {
  // Liveness-mode gather: one request frame per awaited worker, but the
  // wait is a poll over ALL pending sockets with per-rank eviction
  // deadlines — a dead rank cannot park the coordinator on its socket
  // while the others' deadlines rot (the serial blocking gather would).
  // Heartbeat frames refresh last_seen and are skipped; a closed
  // connection is an immediate crash-departure. In hier mode only the
  // per-host leaders are awaited (O(H) request frames per cycle), but
  // every live worker stays polled: member heartbeats ride their direct
  // coordinator sockets, so the SUSPECT/EVICT machine keeps covering
  // the whole world, leaders and members alike.
  std::vector<int> pending;
  std::vector<bool> awaiting(cfg_.size, false);
  int nawait = 0;
  for (int r = 1; r < cfg_.size; ++r) {
    if (!shutdown_ranks_[r]) {
      pending.push_back(r);
      if (expect_frame == nullptr || (*expect_frame)[r]) {
        awaiting[r] = true;
        ++nawait;
      }
    }
  }
  const double timeout_ms = static_cast<double>(cfg_.liveness_timeout_ms);
  // First pass polls with a zero timeout: frames (heartbeats included)
  // that queued in the kernel buffers while this loop was busy
  // elsewhere — a long ring op, a backpressured broadcast — must
  // refresh last_seen_ BEFORE any deadline is judged, or a merely-busy
  // coordinator would evict every healthy worker off stale timestamps.
  bool drained_once = false;
  while (nawait > 0) {
    double min_wait_ms = timeout_ms;
    if (drained_once) {
      auto now = std::chrono::steady_clock::now();
      // Escalate silence: SUSPECT at half the timeout, EVICT at the
      // full timeout. Both measured from the last frame (request OR
      // heartbeat).
      for (auto it = pending.begin(); it != pending.end();) {
        int r = *it;
        double silence = MsSince(last_seen_[r], now);
        if (silence >= timeout_ms) {
          EvictRank(r, "heartbeat_timeout", silence);
          if (awaiting[r]) {
            awaiting[r] = false;
            --nawait;
          }
          it = pending.erase(it);
          continue;
        }
        if (silence >= timeout_ms / 2) {
          MarkSuspect(r, "heartbeat_miss", silence);
        }
        min_wait_ms = std::min(min_wait_ms, timeout_ms - silence);
        ++it;
      }
      if (nawait <= 0) break;
    }
    std::vector<struct pollfd> pfds;
    pfds.reserve(pending.size());
    for (int r : pending) {
      struct pollfd p;
      p.fd = worker_socks_[r - 1].fd();
      p.events = POLLIN;
      p.revents = 0;
      pfds.push_back(p);
    }
    // Cap the tick so suspect transitions happen near their deadline
    // even when no socket turns readable.
    int wait = drained_once
                   ? std::max(1, static_cast<int>(std::min(
                                     min_wait_ms,
                                     std::max(1.0, timeout_ms / 4))))
                   : 0;
    int pr = ::poll(pfds.data(), pfds.size(), wait);
    if (pr < 0 && errno != EINTR) break;
    if (pr > 0) {
      // Snapshot the readable ranks first: handling one erases from
      // `pending`, which would skew the pfd index mapping mid-walk.
      // EVERY readable socket is drained before the next deadline
      // sweep — a queued heartbeat must never sit unread through a
      // sweep that could evict its sender.
      std::vector<int> ready;
      for (size_t i = 0; i < pfds.size(); ++i) {
        if (pfds[i].revents & (POLLIN | POLLERR | POLLHUP)) {
          ready.push_back(pending[i]);
        }
      }
      for (int r : ready) {
        if (std::find(pending.begin(), pending.end(), r) ==
            pending.end()) {
          continue;
        }
        // Drain every frame already deliverable on this socket; stop
        // at the request frame (one per worker per cycle — extras stay
        // buffered for the next cycle).
        while (true) {
          std::string bytes;
          int rc = worker_socks_[r - 1].RecvFrameTimeout(&bytes, 0);
          if (rc < 0) {
            double silence =
                MsSince(last_seen_[r], std::chrono::steady_clock::now());
            EvictRank(r, "connection_closed", silence);
            if (awaiting[r]) {
              awaiting[r] = false;
              --nawait;
            }
            pending.erase(std::find(pending.begin(), pending.end(), r));
            break;
          }
          if (rc == 0) break;
          last_seen_[r] = std::chrono::steady_clock::now();
          if (peer_state_[r] == kSuspect) {
            peer_state_[r] = kAlive;
            RecordLivenessEvent("RECOVER rank=" + std::to_string(r));
          }
          if (IsHeartbeatFrame(bytes)) continue;
          ingest(r, bytes);
          if (awaiting[r]) {
            awaiting[r] = false;
            --nawait;
          }
          pending.erase(std::find(pending.begin(), pending.end(), r));
          break;
        }
      }
    }
    drained_once = true;
  }
}

void TcpController::CacheResponses(const std::vector<Response>& resps) {
  // Both coordinator and workers insert per-tensor requests into their
  // caches in broadcast order, so cache ids agree on every rank without a
  // separate synchronization round (the role of the reference's bitvector
  // AND/OR, controller.cc:613-638).
  for (const auto& p : resps) {
    if (!p.error_reason.empty() || p.op == CollectiveOp::BARRIER ||
        p.op == CollectiveOp::JOIN) {
      continue;
    }
    for (size_t i = 0; i < p.tensor_names.size(); ++i) {
      Request q;
      q.op = p.op;
      q.reduce_op = p.reduce_op;
      q.dtype = p.dtype;
      q.plane = p.plane;
      q.root_rank = p.root_rank;
      q.name = p.tensor_names[i];
      q.shape = p.shapes[i];
      q.prescale = p.prescale;
      q.postscale = p.postscale;
      cache_.Put(q);
    }
  }
}

std::vector<Response> TcpController::ComputeResponseList(
    std::vector<Request> reqs, bool this_rank_shutdown,
    bool this_rank_drain, bool* world_shutdown) {
  if (cfg_.rank == 0) {
    return CoordinatorCycle(std::move(reqs), this_rank_shutdown,
                            this_rank_drain, world_shutdown);
  }
  if (hier_on_) {
    return leader_rank_[cfg_.rank]
               ? LeaderCycle(std::move(reqs), this_rank_shutdown,
                             this_rank_drain, world_shutdown)
               : MemberCycle(std::move(reqs), this_rank_shutdown,
                             this_rank_drain, world_shutdown);
  }
  return WorkerCycle(std::move(reqs), this_rank_shutdown, this_rank_drain,
                     world_shutdown);
}

std::string TcpController::BuildRequestFrame(std::vector<Request> reqs,
                                             bool my_shutdown,
                                             bool my_drain) {
  // Split cache hits from novel requests.
  std::vector<Request> novel;
  std::vector<uint32_t> hits;
  for (auto& q : reqs) {
    uint32_t id = cache_.Lookup(q);
    if (id != ResponseCache::kInvalid) {
      hits.push_back(id);
    } else {
      novel.push_back(std::move(q));
    }
  }
  cache_hits_.fetch_add(static_cast<int64_t>(hits.size()),
                        std::memory_order_relaxed);
  // Delta-first (hier mode): a cycle with no novel requests — the
  // steady-state training loop, all hits (or idle) — ships the compact
  // cache-id bitset frame instead of repeating names. The flat protocol
  // keeps the request-list frame everywhere so a pre-delta coordinator
  // never sees a magic it cannot parse.
  if (hier_on_ && novel.empty()) {
    return SerializeDeltaFrame(cfg_.rank, hits, my_shutdown, my_drain);
  }
  return SerializeRequestList(novel, hits, my_shutdown, my_drain);
}

bool TcpController::RecvFromCoordinator(std::string* bytes) {
  if (liveness_on_) {
    // Liveness mode: a coordinator that went silent for 2x the liveness
    // timeout is dead or partitioned — surface it as a world failure the
    // elastic retry loop can recover, instead of blocking forever. 2x:
    // the coordinator legitimately pauses up to one timeout while it
    // waits out a dying peer's eviction deadline.
    int rc = coord_sock_.RecvFrameTimeout(bytes,
                                          2 * cfg_.liveness_timeout_ms);
    if (rc <= 0) {
      if (rc == 0) {
        RecordLivenessEvent(
            "COORD_TIMEOUT rank=" + std::to_string(cfg_.rank) +
            " silence_ms=" +
            std::to_string(2LL * cfg_.liveness_timeout_ms));
      }
      return false;
    }
    return true;
  }
  return coord_sock_.RecvFrame(bytes);
}

std::vector<Response> TcpController::WorkerCycle(std::vector<Request> reqs,
                                                 bool my_shutdown,
                                                 bool my_drain,
                                                 bool* world_shutdown) {
  *world_shutdown = false;
  // Frame assembly (serialization + response-cache bookkeeping) runs
  // BEFORE the send lock: only the socket write itself needs to be
  // serialized against the heartbeat thread, and byte-assembly under
  // send_mu_ would stall heartbeats for the whole encode
  // (blocking-under-lock, docs/static-analysis.md).
  const std::string frame =
      BuildRequestFrame(std::move(reqs), my_shutdown, my_drain);
  bool sent;
  {
    // Serialized against the heartbeat thread's frames (liveness mode);
    // uncontended (and the heartbeat thread absent) otherwise.
    MutexLock slk(send_mu_);
    // hvdlint: ignore[blocking-under-lock] -- send_mu_ exists to
    // serialize exactly this write against heartbeat frames on the
    // shared coordinator socket; bound: one pre-built request frame,
    // drained by the coordinator's cycle loop within its poll budget.
    sent = coord_sock_.SendFrame(frame);
  }
  if (!sent) {
    *world_shutdown = true;
    return {};
  }
  std::string bytes;
  if (!RecvFromCoordinator(&bytes)) {
    *world_shutdown = true;
    return {};
  }
  if (bytes == "SHUTDOWN") {
    *world_shutdown = true;
    return {};
  }
  return ApplyResponseBytes(bytes, world_shutdown);
}

std::vector<Response> TcpController::ApplyResponseBytes(
    const std::string& bytes, bool* world_shutdown) {
  std::vector<Response> resps;
  double synced_cycle = -1.0;
  int64_t synced_fusion = -1;
  int synced_hier = -1;
  int synced_stripes = -1;
  long long synced_epoch = -1;
  if (!DeserializeResponseList(bytes, &resps, &synced_cycle,
                               &synced_fusion, &synced_hier,
                               &synced_stripes, &synced_epoch)) {
    *world_shutdown = true;
    return {};
  }
  if (synced_epoch >= 0 && synced_epoch != epoch_) {
    // Split brain: this worker bootstrapped against a different world
    // incarnation than the coordinator now broadcasting to it (an
    // evicted-but-alive rank whose socket outlived the teardown, or a
    // crossed wire from a stale listener). Executing the frame would
    // inject this rank's data into a world it no longer belongs to —
    // end this rank's world instead (docs/self-healing.md).
    RecordLivenessEvent("EPOCH_MISMATCH rank=" + std::to_string(cfg_.rank) +
                        " ours=" + std::to_string(epoch_) +
                        " theirs=" + std::to_string(synced_epoch));
    *world_shutdown = true;
    return {};
  }
  // Apply the coordinator's tuned parameters (reference
  // SynchronizeParameters, controller.cc:33-47): fusion is ours to apply,
  // the cycle time belongs to the background loop (TakeSyncedCycleMs),
  // and the hierarchical flags to the executor (TakeSyncedHierFlags) —
  // both consumed at this frame boundary so every rank applies them to
  // the same responses.
  if (synced_fusion >= 0 && synced_fusion != fusion_threshold()) {
    set_fusion_threshold(synced_fusion);
  }
  if (synced_cycle > 0) {
    synced_cycle_ms_.store(synced_cycle, std::memory_order_relaxed);
  }
  if (synced_hier >= 0) {
    synced_hier_flags_.store(synced_hier, std::memory_order_relaxed);
  }
  if (synced_stripes >= 0) {
    synced_stripes_.store(synced_stripes, std::memory_order_relaxed);
  }
  CacheResponses(resps);
  return resps;
}

std::vector<Response> TcpController::MemberCycle(std::vector<Request> reqs,
                                                 bool my_shutdown,
                                                 bool my_drain,
                                                 bool* world_shutdown) {
  *world_shutdown = false;
  // One ctrl frame to my leader (delta-first), one response frame back.
  // No send_mu_: heartbeats ride the direct coordinator TCP socket, the
  // ctrl channel belongs to this cycle thread alone.
  int leader = leader_of_[cfg_.rank];
  if (!ctrl_.send(leader,
                  BuildRequestFrame(std::move(reqs), my_shutdown,
                                    my_drain))) {
    *world_shutdown = true;
    return {};
  }
  std::string bytes;
  if (!ctrl_.recv(leader, &bytes)) {
    // Dead leader: the ctrl transport fails (PeerLink close on process
    // death; shm waits are liveness-bounded) — surface a world failure
    // for the elastic retry loop, mirroring a dead coordinator socket.
    RecordLivenessEvent("LEADER_LOST rank=" + std::to_string(cfg_.rank) +
                        " leader=" + std::to_string(leader));
    *world_shutdown = true;
    return {};
  }
  if (bytes == "SHUTDOWN") {
    *world_shutdown = true;
    return {};
  }
  return ApplyResponseBytes(bytes, world_shutdown);
}

std::vector<Response> TcpController::LeaderCycle(std::vector<Request> reqs,
                                                 bool my_shutdown,
                                                 bool my_drain,
                                                 bool* world_shutdown) {
  *world_shutdown = false;
  auto agg_start = std::chrono::steady_clock::now();
  // My own entry first (lowest rank of the group), then each member's
  // ctrl frame embedded VERBATIM — the coordinator re-parses each body
  // with its own codec, so aggregation adds framing, never semantics.
  std::vector<AggMember> agg;
  agg.reserve(1 + my_members_.size());
  AggMember me;
  me.rank = cfg_.rank;
  me.body = BuildRequestFrame(std::move(reqs), my_shutdown, my_drain);
  me.kind = IsDeltaFrame(me.body) ? 1 : 0;
  agg.push_back(std::move(me));
  for (int m : my_members_) {
    std::string frame;
    if (!ctrl_.recv(m, &frame) || frame.empty()) {
      // A dead member wedges its whole host: end this rank's world and
      // let the coordinator's liveness machine evict the silent ranks.
      RecordLivenessEvent("MEMBER_LOST rank=" + std::to_string(cfg_.rank) +
                          " member=" + std::to_string(m));
      *world_shutdown = true;
      return {};
    }
    AggMember am;
    am.rank = m;
    am.kind = IsDeltaFrame(frame) ? 1 : 0;
    am.body = std::move(frame);
    agg.push_back(std::move(am));
  }
  std::string frame = SerializeAggregateFrame(agg, my_shutdown, my_drain);
  metrics::Record(metrics::kLeaderAggUs,
                  std::chrono::duration_cast<std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - agg_start)
                      .count());
  bool sent;
  {
    MutexLock slk(send_mu_);
    // hvdlint: ignore[blocking-under-lock] -- aggregate frame is fully
    // built above, outside the lock; only the write is serialized
    // against heartbeat frames on the shared coordinator socket.
    // Bound: one frame per negotiation cycle.
    sent = coord_sock_.SendFrame(frame);
  }
  if (!sent) {
    *world_shutdown = true;
    return {};
  }
  std::string bytes;
  if (!RecvFromCoordinator(&bytes)) {
    *world_shutdown = true;
    return {};
  }
  // Relay the response bytes VERBATIM (SHUTDOWN included) before
  // applying them locally: members decode the exact frame the
  // coordinator built, so hier and flat worlds execute byte-identical
  // response lists. A failed relay send is the member's problem to
  // surface (its next ctrl recv fails); the survivors must not wedge.
  auto fan_start = std::chrono::steady_clock::now();
  for (int m : my_members_) ctrl_.send(m, bytes);
  metrics::Record(metrics::kFanoutUs,
                  std::chrono::duration_cast<std::chrono::microseconds>(
                      std::chrono::steady_clock::now() - fan_start)
                      .count());
  if (bytes == "SHUTDOWN") {
    *world_shutdown = true;
    return {};
  }
  return ApplyResponseBytes(bytes, world_shutdown);
}

std::vector<Response> TcpController::CoordinatorCycle(
    std::vector<Request> my_reqs, bool my_shutdown, bool my_drain,
    bool* world_shutdown) {
  *world_shutdown = false;
  shutdown_ranks_[0] = shutdown_ranks_[0] || my_shutdown || my_drain;
  if (my_drain && peer_state_[0] != kDrained) {
    peer_state_[0] = kDrained;
    RecordLivenessEvent("DRAIN rank=0");
  }

  auto ingest = [this](std::vector<Request>&& rs,
                       std::vector<uint32_t>&& ids, int default_rank) {
    // Per-rank ready timestamp (metrics.h): the arrival stamp feeds the
    // rank-skew histogram + straggler detector once the group fires.
    int64_t now_ns = metrics::MonoNs();
    for (auto& q : rs) {
      if (q.rank < 0 || q.rank >= cfg_.size) q.rank = default_rank;
      if (q.op == CollectiveOp::JOIN) {
        if (!joined_ranks_[q.rank]) {
          joined_ranks_[q.rank] = true;
          last_joined_ = q.rank;
        }
        continue;
      }
      q.arrive_ns = now_ns;
      stall_.RecordRank(q.name, q.rank);
      RecordNegotiationEvent(q.name, q.rank);
      auto& group = pending_[q.name];
      group.push_back(q);
    }
    for (auto id : ids) {
      Request q;
      if (cache_.Get(id, &q)) {
        q.rank = default_rank;
        q.arrive_ns = now_ns;
        stall_.RecordRank(q.name, q.rank);
        RecordNegotiationEvent(q.name, q.rank);
        auto& group = pending_[q.name];
        group.push_back(q);
        }
    }
  };

  auto gather_start = std::chrono::steady_clock::now();

  // One control body (request-list or delta frame) attributed to rank r
  // — the unit a TCP frame carries directly (flat mode) or an aggregate
  // frame embeds per member (hier mode). The DRAIN flag marks a
  // graceful farewell (clean preemption exit): the rank departs exactly
  // like a shutdown, but the event stream lets the driver charge zero
  // blacklist strikes for it.
  auto ingest_body = [&](int r, const std::string& bytes) {
    std::vector<Request> rs;
    std::vector<uint32_t> ids;
    bool sd = false, dr = false;
    bool ok;
    if (IsDeltaFrame(bytes)) {
      // The sender identity comes from the socket/aggregate slot `r`,
      // not the frame's embedded rank field — the coordinator never
      // lets a frame impersonate another rank's submissions.
      int frame_rank = -1;
      ok = DeserializeDeltaFrame(bytes, &frame_rank, &ids, &sd, &dr);
    } else {
      ok = DeserializeRequestList(bytes, &rs, &ids, &sd, &dr);
    }
    if (!ok) return;
    if (dr) {
      shutdown_ranks_[r] = true;
      peer_state_[r] = kDrained;
      RecordLivenessEvent("DRAIN rank=" + std::to_string(r));
    } else if (sd) {
      shutdown_ranks_[r] = true;
    }
    ingest(std::move(rs), std::move(ids), r);
  };

  // One TCP frame from every awaited worker (hier mode: from every
  // leader, each carrying its whole host group).
  auto ingest_frame = [&](int r, const std::string& bytes) {
    // Per-frame gather wait: how long this cycle's gather waited for
    // this frame — the coordinator-scaling signal controller_bench
    // reports percentiles of (ROADMAP item 3). Recorded once per TCP
    // frame, so count/cycles measures the coordinator's per-cycle frame
    // fan-in: O(size) flat, O(hosts) hier (asserted in tests).
    metrics::Record(
        metrics::kGatherWaitUs,
        std::chrono::duration_cast<std::chrono::microseconds>(
            std::chrono::steady_clock::now() - gather_start)
            .count());
    if (IsAggregateFrame(bytes)) {
      std::vector<AggMember> members;
      bool agg_sd = false, agg_dr = false;
      if (!DeserializeAggregateFrame(bytes, &members, &agg_sd, &agg_dr)) {
        return;
      }
      for (auto& m : members) {
        // Leaders vouch only for their own host group: a body naming a
        // rank outside the sender's group is dropped, so a buggy leader
        // cannot submit on a foreign rank's behalf.
        if (m.rank < 0 || m.rank >= cfg_.size) continue;
        if (hier_on_ && leader_of_[m.rank] != r) continue;
        ingest_body(m.rank, m.body);
      }
      return;
    }
    ingest_body(r, bytes);
  };

  // Hier mode: this coordinator is also host 0's leader — drain my own
  // members' ctrl frames first (they are local and arrive at memory
  // speed; the TCP gather below then waits only on the other leaders).
  if (hier_on_ && !my_members_.empty()) {
    for (int m : my_members_) {
      if (shutdown_ranks_[m]) continue;
      std::string frame;
      if (!ctrl_.recv(m, &frame)) {
        // Dead member: the ctrl transport fails (PeerLink close on
        // process death; shm waits are liveness-bounded). Evict so the
        // departure is recorded and the world winds down this cycle.
        EvictRank(m, "ctrl_channel_closed",
                  MsSince(last_seen_[m], std::chrono::steady_clock::now()));
        continue;
      }
      ingest_body(m, frame);
    }
    metrics::Record(metrics::kLeaderAggUs,
                    std::chrono::duration_cast<std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - gather_start)
                        .count());
  }
  ingest(std::move(my_reqs), {}, 0);

  if (liveness_on_) {
    GatherWithLiveness(ingest_frame, hier_on_ ? &leader_rank_ : nullptr);
  } else if (hier_on_) {
    // Blocking serial gather over the leaders only — the O(H) frame
    // fan-in the hier protocol exists for.
    for (int r = 1; r < cfg_.size; ++r) {
      if (!leader_rank_[r] || shutdown_ranks_[r]) continue;
      std::string bytes;
      if (!worker_socks_[r - 1].RecvFrame(&bytes)) {
        shutdown_ranks_[r] = true;  // treat a dead socket as departed
        continue;
      }
      ingest_frame(r, bytes);
    }
  } else {
    for (int r = 1; r < cfg_.size; ++r) {
      if (shutdown_ranks_[r]) continue;
      std::string bytes;
      if (!worker_socks_[r - 1].RecvFrame(&bytes)) {
        shutdown_ranks_[r] = true;  // treat a dead socket as departed
        continue;
      }
      ingest_frame(r, bytes);
    }
  }

  // Ready = submitted by all non-departed, non-joined ranks (joined ranks'
  // pre-join submissions still count toward the group, as in the
  // reference's IncrementTensorCount with joined_size).
  int live = 0, joined = 0;
  for (int r = 0; r < cfg_.size; ++r) {
    if (!shutdown_ranks_[r]) {
      ++live;
      if (joined_ranks_[r]) ++joined;
    }
  }
  int active = live - joined;
  // Ready = every active rank has submitted this tensor. Counting group
  // size alone would let a joined rank's pre-join submission stand in for
  // a still-missing active rank and fire the collective early — the ring
  // would then hang waiting for the rank that never got an entry.
  auto all_active_submitted = [&](const std::vector<Request>& group) {
    std::vector<bool> seen(cfg_.size, false);
    for (const auto& q : group) seen[q.rank] = true;
    for (int r = 0; r < cfg_.size; ++r) {
      if (!shutdown_ranks_[r] && !joined_ranks_[r] && !seen[r]) return false;
    }
    return true;
  };
  static const bool trace = std::getenv("HVD_TRACE") != nullptr;
  std::vector<Response> singles;
  std::vector<std::string> done;
  for (auto& kv : pending_) {
    if (trace) {
      std::string ranks;
      for (const auto& q : kv.second) ranks += std::to_string(q.rank) + ",";
      std::fprintf(stderr, "[hvd trace sz=%d act=%d] pending '%s' ranks=%s\n",
                   cfg_.size, active, kv.first.c_str(), ranks.c_str());
    }
    if (active > 0 && all_active_submitted(kv.second)) {
      // Per-step rank skew (metrics.h): arrival spread inside the ready
      // group, and the per-rank lags behind the earliest arrival — the
      // straggler detector's food. Stamps can span cycles: a rank whose
      // submission arrived a cycle late shows its true lag.
      int64_t first_ns = 0, last_ns = 0;
      int stamped = 0;
      for (const auto& q : kv.second) {
        if (q.arrive_ns <= 0) continue;
        ++stamped;
        if (first_ns == 0 || q.arrive_ns < first_ns) first_ns = q.arrive_ns;
        if (q.arrive_ns > last_ns) last_ns = q.arrive_ns;
      }
      if (stamped >= 2) {
        metrics::Record(metrics::kRankSkewUs, (last_ns - first_ns) / 1000);
        std::vector<std::pair<int, double>> lags;
        lags.reserve(kv.second.size());
        for (const auto& q : kv.second) {
          if (q.arrive_ns > 0) {
            lags.emplace_back(q.rank, (q.arrive_ns - first_ns) / 1e6);
          }
        }
        metrics::Registry::Get().straggler().ObserveGroup(lags);
      }
      Response resp;
      ValidateGroup(kv.first, kv.second, cfg_.size, &resp);
      if (joined > 0 && resp.error_reason.empty() &&
          resp.op != CollectiveOp::ALLREDUCE &&
          resp.op != CollectiveOp::BARRIER) {
        // Joined ranks can only contribute zeros, which is meaningful for
        // reductions alone (reference controller.cc:454-457,529-531).
        resp.error_reason =
            std::string(resp.op == CollectiveOp::ALLGATHER
                            ? "Allgather"
                            : resp.op == CollectiveOp::BROADCAST
                                  ? "Broadcast"
                                  : "This operation") +
            " is not supported with Join at this time.";
        resp.op = CollectiveOp::ERROR_OP;
      }
      singles.push_back(std::move(resp));
      done.push_back(kv.first);
    }
  }
  // Deterministic order: by name (requests may arrive in any interleaving).
  std::sort(singles.begin(), singles.end(),
            [](const Response& a, const Response& b) {
              return a.tensor_names[0] < b.tensor_names[0];
            });
  for (auto& n : done) {
    pending_.erase(n);
    stall_.Remove(n);
  }

  bool stall_shutdown = false;
  std::vector<int> stalled_ranks;
  std::string report =
      stall_.Check(&stall_shutdown, liveness_on_ ? &stalled_ranks : nullptr);
  if (!report.empty()) {
    {
      MutexLock lk(stall_report_mu_);
      stall_report_ += report;
    }
    std::fprintf(stderr, "[horovod_tpu coordinator] %s", report.c_str());
  }
  if (liveness_on_) {
    // Stall escalation (docs/liveness.md): a rank stalled past the
    // warning window enters the same miss -> SUSPECT -> EVICT machine a
    // heartbeat miss does — its heartbeats prove the process is alive,
    // but a submit-starved rank is still wedging the world. The hard
    // stall window then EVICTS suspects instead of only logging.
    auto now = std::chrono::steady_clock::now();
    for (int r : stalled_ranks) {
      // r >= 1: rank 0 is this coordinator — its last_seen_ never
      // updates (no socket to itself) and no frame could ever RECOVER
      // it, so marking it would wedge a permanent bogus SUSPECT with a
      // run-age silence value in the report.
      if (r >= 1 && r < cfg_.size && !shutdown_ranks_[r]) {
        MarkSuspect(r, "stall", MsSince(last_seen_[r], now));
      }
    }
    if (stall_shutdown) {
      for (int r : stalled_ranks) {
        if (r >= 1 && r < cfg_.size && !shutdown_ranks_[r]) {
          EvictRank(r, "stall_hard_window", MsSince(last_seen_[r], now));
        }
      }
    }
  }

  auto fused = FuseResponses(std::move(singles), fusion_threshold());
  if (live > 0 && joined == live) {
    // Every live rank has joined: release them all and reset join state so
    // training can resume (reference controller.cc:300-306).
    Response jr;
    jr.op = CollectiveOp::JOIN;
    jr.root_rank = last_joined_;
    jr.tensor_names = {kJoinTensorName};
    jr.shapes = {TensorShape()};
    fused.push_back(std::move(jr));
    joined_ranks_.assign(cfg_.size, false);
  }
  CacheResponses(fused);

  // Any rank shutting down (or dying) ends the whole world — reference
  // semantics (RunLoopOnce exits on any DONE request, operations.cc:557):
  // survivors' pending collectives resolve as aborted, which the elastic
  // retry loop converts into restore + re-rendezvous. Graceful departure
  // that keeps the world alive is join(), not shutdown.
  bool any_down = false;
  for (int r = 0; r < cfg_.size; ++r) {
    any_down = any_down || shutdown_ranks_[r];
  }
  if (any_down || stall_shutdown) {
    // Hier mode: SHUTDOWN rides the same two-level fan-out as every
    // response — leaders relay it verbatim to their members; this
    // coordinator delivers host 0's members over ctrl directly (except
    // evicted ones, whose ctrl transport may be dead).
    for (int r = 1; r < cfg_.size; ++r) {
      if (hier_on_ && !leader_rank_[r]) continue;
      if (worker_socks_[r - 1].valid()) {
        worker_socks_[r - 1].SendFrame("SHUTDOWN");
      }
    }
    if (hier_on_) {
      for (int m : my_members_) {
        if (peer_state_[m] != kEvicted) ctrl_.send(m, "SHUTDOWN");
      }
    }
    *world_shutdown = true;
    return {};
  }

  int hier = hier_flags_hint();
  int stripes = stripe_hint();
  std::string bytes = SerializeResponseList(fused, cycle_hint_ms(),
                                            fusion_threshold(), hier,
                                            stripes, epoch_);
  for (int r = 1; r < cfg_.size; ++r) {
    if (hier_on_ && !leader_rank_[r]) continue;
    if (!shutdown_ranks_[r] && worker_socks_[r - 1].valid()) {
      worker_socks_[r - 1].SendFrame(bytes);
    }
  }
  if (hier_on_ && !my_members_.empty()) {
    auto fan_start = std::chrono::steady_clock::now();
    for (int m : my_members_) {
      if (!shutdown_ranks_[m]) ctrl_.send(m, bytes);
    }
    metrics::Record(metrics::kFanoutUs,
                    std::chrono::duration_cast<std::chrono::microseconds>(
                        std::chrono::steady_clock::now() - fan_start)
                        .count());
  }
  // The coordinator applies the flags at the same frame boundary it
  // broadcast them (workers apply on receive), so no rank ever executes
  // this frame's responses under a different dispatch — nor moves a
  // cross-host byte under a different stripe agreement.
  if (hier >= 0) {
    synced_hier_flags_.store(hier, std::memory_order_relaxed);
  }
  if (stripes >= 0) {
    synced_stripes_.store(stripes, std::memory_order_relaxed);
  }
  return fused;
}

void TcpController::Finalize() {
  // Stop the heartbeat thread BEFORE closing its socket: a beat racing
  // the close would write a freed fd.
  StopHeartbeat();
  for (auto& s : worker_socks_) s.Close();
  coord_sock_.Close();
  listener_.Close();
}

}  // namespace hvd
