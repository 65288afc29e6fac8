// Sanitizer stress harness for the port's native core (csrc/hvd), built
// against the TSan or ASan+UBSan variant of the core library
// (HOROVOD_NATIVE_SANITIZE, common/native.py) by
// tests/test_torch_native_sanitize.py and by chip_smoke.py's phase (o).
//
//   g++ -O1 -g -std=c++17 -pthread -fsanitize=thread stress_core.cc \
//       build/horovod_tpu_torch/libhvdcore-<hash>-tsan.so -lrt
//   ./a.out [world ring shm stripe reconnect liveness worldlost departure]
//
// With no argument every phase runs, in that order. The phases:
//
//   - world: concurrent EnqueueTensorAllreduce from several submitter
//     threads vs the background cycle loop (tensor queue, handle table,
//     response execution, wait/erase), with every observability getter
//     and hvd_world_lost polled from a monitor thread THROUGH
//     hvd_shutdown, and the autotuner hooks racing the cycle loop, over
//     repeated init/shutdown worlds (elastic re-init);
//   - ring: Ring::SetTopology + traffic counters on a standalone ring,
//     the init-thread-then-collective handoff the hierarchical paths
//     rely on;
//   - shm, stripe: the shared-memory and striped transports both ways
//     at once, their teardown and forced-failure paths;
//   - reconnect: a cut cross leg healed in place in a 4-ring world;
//   - liveness: in-process 2-rank TcpController worlds with heartbeats;
//     a poller reads both ends' world_lost() throughout, which must read
//     false after every DRAIN round and true on the coordinator after
//     every EVICT round;
//   - worldlost: the C API's verdict across processes. This binary starts
//     itself again as rank 1 of a 2-rank hvd_init world; a thread polls
//     hvd_world_lost() throughout, as the binding's watch does. Rank 1
//     exits without a farewell (the verdict turns 1), leaves by
//     hvd_shutdown (it stays 0), or SIGSTOPs itself with its connection
//     open while rank 0, with no heartbeats and a 1 s stall shutdown
//     window, waits in an allreduce (the coordinator's polling gather
//     runs the stall inspector; the verdict turns 1 within
//     kSilentBoundS); then rank 0 shuts down and re-inits a world of
//     one, where the verdict reads 0 again;
//   - departure: a death in the cycle of another rank's departure. The
//     coordinator and the leaving rank are TcpControllers of this
//     process; rank 1 is this binary again ("--death <port> <cross>
//     <frame>"), which joins, sends its cycle's frame and _exits. Only
//     then does the leaving rank send its farewell, in the same cycle,
//     so the coordinator holds rank 1's frame and a closed connection
//     when it gives its verdict, which must be LOST: every survivor ends
//     with world_lost() true. The order is forced, not timed, so every
//     round must see it. Rounds: flat (3 ranks), flat with heartbeats,
//     and hierarchical (2 hosts x 2, HOROVOD_HIER_CONTROL's protocol over
//     an in-process channel): there rank 1 is the coordinator's member,
//     whose frame is put on the channel for it before it exits, and the
//     leaving rank is the other host's member.
//
// The harness itself must stay race-free: every stop flag is atomic and
// threads are joined before each world teardown completes. Exits 0 and
// prints STRESS_OK when all phases complete; any TSan report fails the
// run via TSAN_OPTIONS=exitcode=66 (set by the tests and chip_smoke.py).

#include <signal.h>
#include <spawn.h>
#include <sys/wait.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "../hvd/controller.h"
#include "../hvd/message.h"
#include "../hvd/ring_ops.h"
#include "../hvd/shm_transport.h"
#include "../hvd/stripe_transport.h"

// The extern "C" surface of operations.cc (no installed header: the
// Python side binds by symbol, and so does this harness).
extern "C" {
int hvd_init(int rank, int size, int local_rank, int local_size,
             int cross_rank, int cross_size, const char* coordinator_addr,
             int coordinator_port, const char* my_host, double cycle_time_ms,
             long long fusion_threshold, int cache_capacity,
             double stall_warning_sec, double stall_shutdown_sec,
             int stall_check_enabled, int heartbeat_ms,
             int liveness_timeout_ms);
void hvd_drain();
int hvd_liveness_report(char* buf, int cap);
void hvd_shutdown();
long long hvd_enqueue(const char* name, int op, int reduce_op, int dtype,
                      const long long* shape, int ndim, void* data,
                      void* output, int root_rank, double prescale,
                      double postscale, int plane);
int hvd_test(long long handle, char* err, int errlen);
int hvd_wait(long long handle, char* err, int errlen);
int hvd_pending_count();
int hvd_initialized();
int hvd_world_lost();
int hvd_rank();
int hvd_size();
int hvd_local_rank();
int hvd_local_size();
int hvd_cross_rank();
int hvd_cross_size();
int hvd_last_joined();
long long hvd_cache_hits();
long long hvd_ring_bytes_sent();
long long hvd_ring_local_bytes();
long long hvd_ring_cross_bytes();
long long hvd_ring_shm_bytes();
int hvd_shm_active();
long long hvd_ring_stripe_bytes();
int hvd_ring_stripe_count();
long long hvd_ring_cross_ns();
void hvd_set_stripes(int stripes);
int hvd_host_hier_flags();
int hvd_get_hier_flags();
void hvd_set_hier_flags(int flags);
double hvd_get_cycle_time_ms();
long long hvd_get_fusion_threshold();
void hvd_set_parameters(double cycle_time_ms, long long fusion_threshold);
void hvd_set_host_via_xla(long long threshold);
void hvd_set_record_negotiation(int enabled);
int hvd_drain_negotiation(char* buf, int cap);
int hvd_stall_report(char* buf, int cap);
int hvd_metrics_snapshot(char* buf, int cap, int drain_flags);
}

namespace {

constexpr int kOpAllreduce = 0;   // CollectiveOp::ALLREDUCE
constexpr int kReduceSum = 1;     // ReduceOp::SUM
constexpr int kDtypeF32 = 7;      // DataType::HVD_FLOAT32
constexpr int kPlaneHost = 1;     // DevicePlane::HOST

int failures = 0;
#define CHECK(cond, what)                       \
  do {                                          \
    if (!(cond)) {                              \
      std::fprintf(stderr, "FAIL: %s\n", what); \
      ++failures;                               \
    }                                           \
  } while (0)

// Submitter: enqueue host-plane allreduces and wait each one out. Names
// repeat every 8 iterations so the controller's per-name negotiation
// path sees steady reuse (the cached-response shape of a training
// loop). A handle < 0 (enqueue refused: shutdown won the race) is fine;
// waiting on it would hang, so it is skipped.
void Submitter(int id, int iters) {
  float buf[16];
  float out[16];
  long long shape[1] = {16};
  char err[256];
  for (int i = 0; i < iters; ++i) {
    for (int k = 0; k < 16; ++k) buf[k] = static_cast<float>(id + i + k);
    std::string name =
        "stress_t" + std::to_string(id) + "_" + std::to_string(i % 8);
    long long h =
        hvd_enqueue(name.c_str(), kOpAllreduce, kReduceSum, kDtypeF32,
                    shape, 1, buf, out, -1, 1.0, 1.0, kPlaneHost);
    if (h < 0) return;  // world already gone — a valid interleaving
    hvd_wait(h, err, sizeof(err));  // ok or aborted-by-shutdown
  }
}

// Monitor: poll every observability getter, including straight through
// shutdown (the getters must be safe against a concurrently-freed
// ring/controller).
void Monitor(std::atomic<bool>* stop) {
  char buf[4096];
  // Unified-snapshot hammer (the getter-race class,
  // pre-empted this time): the JSON assembly walks the ring, the
  // controller, and the metrics registry under init_mu while
  // submitters enqueue and RunWorld tears worlds down — and the drain
  // flags cycle so the liveness-drain/restore and straggler-event
  // paths race shutdown too. A 4 KiB buffer is deliberately sometimes
  // too small: the negative-return restore path is part of the
  // surface.
  static char snap[16384];
  int k = 0;
  volatile long long sink = 0;  // keep loads observable
  while (!stop->load()) {
    ++k;
    sink += hvd_metrics_snapshot(snap, (k % 3) ? sizeof(snap) : 64,
                                 k % 4);
    sink += hvd_cache_hits();
    sink += hvd_ring_bytes_sent();
    sink += hvd_ring_local_bytes();
    sink += hvd_ring_cross_bytes();
    sink += hvd_ring_shm_bytes();
    sink += hvd_shm_active();
    sink += hvd_ring_stripe_bytes();
    sink += hvd_ring_stripe_count();
    sink += hvd_ring_cross_ns();
    sink += hvd_host_hier_flags();
    sink += hvd_get_hier_flags();
    sink += static_cast<long long>(hvd_get_cycle_time_ms());
    sink += hvd_get_fusion_threshold();
    sink += hvd_pending_count();
    sink += hvd_initialized() + hvd_world_lost();
    sink += hvd_rank() + hvd_size() + hvd_local_rank() + hvd_local_size();
    sink += hvd_cross_rank() + hvd_cross_size();
    sink += hvd_last_joined();
    sink += hvd_stall_report(buf, sizeof(buf));
    sink += hvd_liveness_report(buf, sizeof(buf));
  }
  (void)sink;
}

// Tuner: exercise every runtime-mutation hook the autotuner owns.
void Tuner(std::atomic<bool>* stop) {
  char buf[4096];
  int k = 0;
  while (!stop->load()) {
    ++k;
    hvd_set_parameters(1.0 + (k % 3), 1 << 20);
    hvd_set_hier_flags(k % 4);
    hvd_set_stripes(1 + (k % 4));
    hvd_set_host_via_xla(k % 2 ? -1 : (1 << 30));
    hvd_set_record_negotiation(k % 2);
    hvd_drain_negotiation(buf, sizeof(buf));
  }
}

// One world: init, hammer from submitters + monitor + tuner, then shut
// down WHILE the monitor and tuner are still hammering — the teardown
// interleaving is the point.
void RunWorld(int world, int submitters, int iters) {
  int rc = hvd_init(/*rank=*/0, /*size=*/1, /*local_rank=*/0,
                    /*local_size=*/1, /*cross_rank=*/0, /*cross_size=*/1,
                    "127.0.0.1", /*port=*/0, "127.0.0.1",
                    /*cycle_time_ms=*/1.0, /*fusion_threshold=*/1 << 20,
                    /*cache_capacity=*/64, /*stall_warning_sec=*/60.0,
                    /*stall_shutdown_sec=*/0.0, /*stall_check=*/0,
                    /*heartbeat_ms=*/2, /*liveness_timeout_ms=*/500);
  CHECK(rc == 0, "hvd_init");
  if (rc != 0) return;

  std::atomic<bool> stop{false};
  std::thread monitor(Monitor, &stop);
  std::thread tuner(Tuner, &stop);
  std::vector<std::thread> subs;
  for (int i = 0; i < submitters; ++i) {
    subs.emplace_back(Submitter, world * 100 + i, iters);
  }
  // Tear the world down under the last submitter (odd worlds) or after
  // all submitters finished (even worlds) — both interleavings matter.
  if (world % 2 == 1 && !subs.empty()) {
    for (size_t i = 0; i + 1 < subs.size(); ++i) subs[i].join();
    hvd_shutdown();  // races the final submitter's enqueue/wait
    subs.back().join();
  } else {
    for (auto& t : subs) t.join();
    hvd_shutdown();
  }
  // Monitor/tuner keep hammering a torn-down world for a moment: the
  // getters must stay safe against controller.reset()/ring.reset().
  hvd_shutdown();  // double-shutdown must be a no-op
  stop.store(true);
  monitor.join();
  tuner.join();
}

// Standalone Ring: SetTopology on one thread, then collectives on
// another (the init-thread -> background-thread handoff), with traffic
// counters polled concurrently throughout.
void RingPhase() {
  hvd::Ring ring;  // unconnected: size 1, local loop-back semantics
  std::atomic<bool> stop{false};
  std::thread poll([&] {
    volatile long long sink = 0;
    while (!stop.load()) {
      sink += ring.bytes_sent() + ring.local_bytes_sent() +
              ring.cross_bytes_sent() + ring.rank() + ring.size();
    }
    (void)sink;
  });
  for (int round = 0; round < 50; ++round) {
    ring.SetTopology({round % 2});  // rewrites the host-group table
    std::thread worker([&] {        // created AFTER: the real ordering
      float buf[32];
      for (int k = 0; k < 32; ++k) buf[k] = static_cast<float>(round + k);
      hvd::Status st =
          ring.Allreduce(buf, buf, 32, hvd::DataType::HVD_FLOAT32,
                         hvd::ReduceOp::SUM, 1.0, 1.0);
      CHECK(st.ok(), "standalone ring allreduce");
    });
    worker.join();
  }
  stop.store(true);
  poll.join();
}

// Liveness plane under the sanitizers: a real in-process 2-rank
// TcpController world with heartbeats armed. The worker's heartbeat
// thread races the cycle thread's sends (shared send mutex), the
// coordinator's poll-gather, and Finalize. Even rounds end with the
// shutdown/drain handshake; odd rounds tear the worker down abruptly
// mid-protocol so the coordinator exercises the connection-closed
// eviction path while the heartbeat thread is still beating. A poller
// reads both controllers' world_lost() throughout (the port's verdict,
// written by the cycle threads): after a DRAIN round it must read false
// on both ends, after an EVICT round true on the coordinator.
void LivenessControllerPhase() {
  for (int round = 0; round < 6 && failures == 0; ++round) {
    int port = 0;
    {
      hvd::Listener probe;
      if (!probe.Listen(0)) {
        CHECK(false, "liveness phase: port probe");
        return;
      }
      port = probe.port();
    }  // closed: TcpController re-binds it (benign TOCTOU in a test)
    hvd::ControllerConfig c0;
    c0.rank = 0;
    c0.size = 2;
    c0.coordinator_port = port;
    c0.heartbeat_ms = 1;
    c0.liveness_timeout_ms = 2000;
    hvd::ControllerConfig c1 = c0;
    c1.rank = 1;
    hvd::TcpController coord(c0, /*data_port=*/1, "127.0.0.1");
    hvd::TcpController worker(c1, /*data_port=*/2, "127.0.0.1");
    std::atomic<bool> stop{false};
    std::thread poll([&] {
      volatile long long sink = 0;
      while (!stop.load()) {
        sink += coord.world_lost() + worker.world_lost();
      }
      (void)sink;
    });
    std::thread ct([&] {
      if (!coord.Initialize().ok()) {
        CHECK(false, "liveness phase: coordinator init");
        return;
      }
      bool world_down = false;
      for (int cyc = 0; cyc < 200 && !world_down; ++cyc) {
        coord.ComputeResponseList({}, false, false, &world_down);
      }
      CHECK(world_down, "liveness phase: coordinator saw departure");
      coord.Finalize();
    });
    std::thread wt([&] {
      if (!worker.Initialize().ok()) {
        CHECK(false, "liveness phase: worker init");
        return;
      }
      bool world_down = false;
      for (int cyc = 0; cyc < 10 && !world_down; ++cyc) {
        worker.ComputeResponseList({}, false, false, &world_down);
      }
      if (round % 2 == 0 && !world_down) {
        // Clean departure: drain on even rounds (the farewell frame
        // races the heartbeat thread on send_mu_).
        worker.ComputeResponseList({}, true, true, &world_down);
      }
      // Odd rounds: Finalize with no handshake — teardown races the
      // heartbeat thread; the coordinator sees the close and evicts.
      worker.Finalize();
    });
    wt.join();
    ct.join();
    stop.store(true);
    poll.join();
    bool lost = round % 2 == 1;
    CHECK(coord.world_lost() == lost,
          lost ? "liveness phase: an EVICT round must set world_lost"
               : "liveness phase: a DRAIN round must not set world_lost");
    CHECK(!worker.world_lost(),
          "liveness phase: the leaving worker's world is not lost");
    std::printf("LIVENESS round=%d %s world_lost=%d\n", round,
                lost ? "EVICT" : "DRAIN", coord.world_lost() ? 1 : 0);
    // Drain the liveness streams so the buffers' locking runs too.
    coord.TakeLivenessReport();
    worker.TakeLivenessReport();
  }
}

// Shared-memory transport under the sanitizers (docs/shm-transport.md):
// two in-process "ranks" of one host group stream messages both ways
// through the SPSC rings concurrently (0-byte, sub-slot, exact-slot and
// chunked sizes) while a poller hammers the byte counters; then the
// mid-world teardown interleaving — a receiver parked on an empty ring
// must unblock via the peer's teardown poison, never touch freed pages —
// and the forced-attach-failure path. Segment lifecycle is asserted by
// the pytest driver: no /dev/shm orphans after this process exits.
void ShmPhase() {
  // Fake world-unique "ports" (they only feed segment names; the
  // session tag in the name isolates concurrent test sessions).
  int base = 60000 + static_cast<int>(getpid() % 5000);
  std::vector<int> ports = {base, base + 5000};
  std::vector<int> group = {0, 1};
  constexpr size_t kSlot = 8192;
  const size_t kSizes[] = {0, 1, 100, kSlot, kSlot * 3 + 17};
  constexpr int kIters = 200;
  {
    hvd::ShmTransport t0, t1;
    CHECK(t0.Init(0, group, ports, kSlot), "shm init rank0");
    CHECK(t1.Init(1, group, ports, kSlot), "shm init rank1");
    if (failures) return;
    CHECK(t0.Prepare(1), "shm attach 0->1");
    CHECK(t1.Prepare(0), "shm attach 1->0");
    std::atomic<bool> stop{false};
    std::thread poll([&] {
      volatile long long sink = 0;
      while (!stop.load()) sink += t0.bytes_sent() + t1.bytes_sent();
      (void)sink;
    });
    auto sender = [&](hvd::ShmTransport* t, int peer, unsigned seed) {
      for (int i = 0; i < kIters; ++i) {
        size_t n = kSizes[i % 5];
        std::vector<char> buf(n);
        for (size_t k = 0; k < n; ++k) {
          buf[k] = static_cast<char>((seed + i + k) & 0xff);
        }
        CHECK(t->Send(peer, buf.data(), n) == hvd::kTransportOk,
              "shm send");
      }
    };
    auto receiver = [&](hvd::ShmTransport* t, int peer, unsigned seed) {
      for (int i = 0; i < kIters; ++i) {
        size_t n = kSizes[i % 5];
        std::vector<char> buf(n, 0);
        CHECK(t->Recv(peer, buf.data(), n) == hvd::kTransportOk,
              "shm recv");
        for (size_t k = 0; k < n; ++k) {
          if (buf[k] != static_cast<char>((seed + i + k) & 0xff)) {
            CHECK(false, "shm payload mismatch");
            break;
          }
        }
      }
    };
    std::thread s01(sender, &t0, 1, 7u), r01(receiver, &t1, 0, 7u);
    std::thread s10(sender, &t1, 0, 99u), r10(receiver, &t0, 1, 99u);
    s01.join();
    r01.join();
    s10.join();
    r10.join();
    // Mid-world teardown: r is parked on t1's empty inbox from rank 0;
    // t0's Teardown poisons that channel (it lives in t1's segment, so
    // nothing r touches is unmapped) and the wait must end in a
    // non-success return, not a hang or a read of freed memory.
    std::thread blocked([&] {
      char b[16];
      CHECK(t1.Recv(0, b, sizeof(b)) != hvd::kTransportOk,
            "teardown recv must not succeed");
    });
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    t0.Teardown();
    blocked.join();
    t1.Teardown();
    stop.store(true);
    poll.join();
  }
  // Forced attach failure (the ring.shm.attach seam's native half):
  // Prepare must report unusable and leave both sides clean.
  setenv("HVD_SHM_FORCE_ATTACH_FAIL", "1", 1);
  {
    std::vector<int> ports2 = {base + 1, base + 5001};
    hvd::ShmTransport t0, t1;
    CHECK(t0.Init(0, group, ports2, kSlot), "shm init rank0 (forced)");
    CHECK(t1.Init(1, group, ports2, kSlot), "shm init rank1 (forced)");
    CHECK(!t0.Prepare(1), "forced attach must fail");
    t0.Teardown();
    t1.Teardown();
  }
  unsetenv("HVD_SHM_FORCE_ATTACH_FAIL");
}

// Striped cross-host transport under the sanitizers
// (docs/cross-transport.md): two in-process "leaders" exchange striped
// messages BOTH ways concurrently (0-byte, sub-chunk, exact-chunk and
// multi-piece sizes) while a poller hammers the per-stripe counters —
// the getter-race class re-checked on the new surface. Then the
// order-proof receive: pieces hand-written into the stripe sockets with
// whole stripes delivered out of order must reassemble byte-exact, with
// the per-piece pipeline hook covering disjoint spans exactly once.
// Finally the forced-connect-failure leg (the ring.stripe.connect
// seam's native half) must refuse cleanly.
void StripePhase() {
  hvd::Listener l0, l1;
  if (!l0.Listen(0) || !l1.Listen(0)) {
    CHECK(false, "stripe phase: listen");
    return;
  }
  std::vector<std::pair<std::string, int>> eps = {
      {"127.0.0.1", l0.port()}, {"127.0.0.1", l1.port()}};
  auto pump = [](hvd::Listener* l, hvd::StripeTransport* t) {
    return [l, t](int peer) {
      for (int tries = 0; !t->HasAllStripes(peer) && tries < 64;
           ++tries) {
        hvd::Socket s = l->Accept(15000);
        if (!s.valid()) return false;
        std::string hello;
        if (!s.RecvFrame(&hello)) continue;
        int pr = -1, idx = -1;
        if (std::sscanf(hello.c_str(), "stripe %d %d", &pr, &idx) == 2) {
          t->Adopt(pr, idx, std::move(s));
        }
      }
      return t->HasAllStripes(peer);
    };
  };
  constexpr int kStripes = 3;
  constexpr long long kChunk = 4096;
  {
    hvd::StripeTransport t0, t1;
    t0.Init(0, eps, kStripes, kChunk, true, pump(&l0, &t0));
    t1.Init(1, eps, kStripes, kChunk, true, pump(&l1, &t1));
    CHECK(t0.Prepare(1), "stripe dial 0->1");
    CHECK(t1.PrepareRecv(0), "stripe accept at 1");
    CHECK(t1.Prepare(0), "stripe dial 1->0");
    CHECK(t0.PrepareRecv(1), "stripe accept at 0");
    if (failures) return;
    CHECK(t0.active_stripes() == kStripes, "active stripe count");

    std::atomic<bool> stop{false};
    std::thread poll([&] {
      volatile long long sink = 0;
      while (!stop.load()) {
        sink += t0.bytes_sent() + t1.bytes_sent() + t0.active_stripes() +
                t1.active_stripes();
      }
      (void)sink;
    });
    const size_t kSizes[] = {0, 1, 100, kChunk, kChunk * 5 + 17};
    constexpr int kIters = 150;
    auto sender = [&](hvd::StripeTransport* t, int peer, unsigned seed) {
      for (int i = 0; i < kIters; ++i) {
        size_t n = kSizes[i % 5];
        std::vector<char> buf(n);
        for (size_t k = 0; k < n; ++k) {
          buf[k] = static_cast<char>((seed + i + k) & 0xff);
        }
        CHECK(t->Send(peer, buf.data(), n) == hvd::kTransportOk,
              "stripe send");
      }
    };
    auto receiver = [&](hvd::StripeTransport* t, int peer,
                        unsigned seed) {
      for (int i = 0; i < kIters; ++i) {
        size_t n = kSizes[i % 5];
        std::vector<char> buf(n, 0);
        CHECK(t->Recv(peer, buf.data(), n) == hvd::kTransportOk,
              "stripe recv");
        for (size_t k = 0; k < n; ++k) {
          if (buf[k] != static_cast<char>((seed + i + k) & 0xff)) {
            CHECK(false, "stripe payload mismatch");
            break;
          }
        }
      }
    };
    std::thread s01(sender, &t0, 1, 3u), r01(receiver, &t1, 0, 3u);
    std::thread s10(sender, &t1, 0, 77u), r10(receiver, &t0, 1, 77u);
    s01.join();
    r01.join();
    s10.join();
    r10.join();
    stop.store(true);
    poll.join();
  }
  // Order-proof receive: dial a fresh receiver by hand, write the
  // pieces with whole stripes out of order (stripe 2 first, stripe 0
  // reversed-last), and check RecvPieces reassembles byte-exact with
  // the pipeline hook covering each span exactly once.
  {
    hvd::Listener lr;
    if (!lr.Listen(0)) {
      CHECK(false, "stripe phase: reorder listen");
      return;
    }
    std::vector<std::pair<std::string, int>> eps2 = {
        {"127.0.0.1", 1}, {"127.0.0.1", lr.port()}};
    hvd::StripeTransport tr;
    tr.Init(1, eps2, kStripes, kChunk, true, pump(&lr, &tr));
    std::vector<hvd::Socket> dials;
    for (int i = 0; i < kStripes; ++i) {
      hvd::Socket s = hvd::Socket::Connect("127.0.0.1", lr.port(), 5000);
      CHECK(s.valid() &&
                s.SendFrame("stripe 0 " + std::to_string(i)),
            "reorder dial");
      dials.push_back(std::move(s));
    }
    if (failures) return;
    const size_t total = kChunk * 4 + 123;  // 5 pieces over 3 stripes
    std::string src(total, 0);
    for (size_t i = 0; i < total; ++i) {
      src[i] = static_cast<char>((i * 13 + 5) & 0xff);
    }
    uint32_t pieces = hvd::StripePieceCount(total, kChunk);
    // Whole-stripe delivery order: 2, then 1, then 0 — every piece
    // arrives "late" relative to round-robin order.
    for (int s = kStripes - 1; s >= 0; --s) {
      for (uint32_t i = 0; i < pieces; ++i) {
        if (hvd::StripeOfSeq(i, kStripes) != s) continue;
        size_t off = 0, len = 0;
        hvd::StripePieceSpan(i, total, kChunk, &off, &len);
        char hdr[hvd::kStripeHdrBytes];
        hvd::EncodeStripeHdr(i, static_cast<uint32_t>(len), hdr);
        // Raw stream bytes: header then slice (no frame prefix).
        struct iovec iov[2];
        iov[0].iov_base = hdr;
        iov[0].iov_len = sizeof(hdr);
        iov[1].iov_base = &src[off];
        iov[1].iov_len = len;
        CHECK(dials[s].SendVec(iov, len > 0 ? 2 : 1), "reorder write");
      }
    }
    CHECK(tr.PrepareRecv(0), "reorder accept");
    if (failures) return;
    std::string dst(total, 1);
    std::vector<char> seen(pieces, 0);
    size_t covered = 0;
    int rc = tr.RecvPieces(0, &dst[0], total,
                           [&](size_t off, size_t len) {
                             uint32_t i = static_cast<uint32_t>(
                                 off / kChunk);
                             CHECK(i < pieces && !seen[i],
                                   "piece hook fires once per span");
                             if (i < pieces) seen[i] = 1;
                             covered += len;
                           });
    CHECK(rc == hvd::kTransportOk, "reorder recv ok");
    CHECK(covered == total, "piece hooks cover the payload");
    CHECK(dst == src, "out-of-order stripes reassemble byte-exact");
  }
  // Forced connect failure (the ring.stripe.connect seam's native
  // half): Prepare must refuse without dialing, leaving the
  // negotiation to fall through to single-socket TCP.
  setenv("HVD_STRIPE_FORCE_CONNECT_FAIL", "1", 1);
  {
    hvd::StripeTransport tf;
    tf.Init(0, eps, kStripes, kChunk, true, nullptr);
    CHECK(!tf.Prepare(1), "forced stripe connect must fail");
    CHECK(tf.active_stripes() == 0, "failed pair is not active");
  }
  unsetenv("HVD_STRIPE_FORCE_CONNECT_FAIL");
}

// Self-healing reconnect under the sanitizers (docs/self-healing.md): a
// real 4-ring world (2 hosts x 2 ranks, leaders 0 and 1) runs
// hierarchical allreduces concurrently while HVD_FAULT_CROSS_DROP cuts
// leader 0's cross PeerLink mid-duplex. Both leaders' HealCrossStep /
// HealPeerLink (redial + resume handshake + replay) race each other,
// the members' local PeerLink legs, and a poller hammering the healing
// counters — the getter-vs-heal interleaving the Python worlds cannot
// observe races in. Every iteration's result must stay byte-exact
// across the cut.
void ReconnectPhase() {
  constexpr int kRanks = 4;
  constexpr int kIters = 6;
  constexpr int64_t kCount = 16384;  // 64 KiB fp32: ring cross path
  // Armed before any Connect (single-threaded), cleared after the
  // joins: only the rank-0 ring matches the spec. Duplex 5 is the 3rd
  // allreduce's reduce-scatter step (2 cross duplexes per H=2
  // allreduce) — mid-run, link warm, later iterations prove the healed
  // socket is a first-class peer link.
  setenv("HVD_FAULT_CROSS_DROP", "0:5", 1);
  hvd::Listener listeners[kRanks];
  std::vector<std::pair<std::string, int>> eps;
  for (int r = 0; r < kRanks; ++r) {
    if (!listeners[r].Listen(0)) {
      CHECK(false, "reconnect phase: listen");
      unsetenv("HVD_FAULT_CROSS_DROP");
      return;
    }
    eps.emplace_back("127.0.0.1", listeners[r].port());
  }
  hvd::Ring rings[kRanks];
  std::atomic<bool> stop{false};
  std::thread poll([&] {
    volatile long long sink = 0;
    while (!stop.load()) {
      for (int r = 0; r < kRanks; ++r) {
        sink += rings[r].link_reconnects() +
                rings[r].resume_chunks_discarded() +
                rings[r].stale_epoch_rejected() +
                rings[r].cross_bytes_sent() + rings[r].cross_leg_ns();
      }
    }
    (void)sink;
  });
  std::vector<std::thread> workers;
  for (int r = 0; r < kRanks; ++r) {
    workers.emplace_back([&, r] {
      if (!rings[r].Connect(r, eps, &listeners[r]).ok()) {
        CHECK(false, "reconnect phase: ring connect");
        return;
      }
      rings[r].SetTopology({0, 1, 0, 1});  // round-robin, leaders 0+1
      std::vector<float> buf(kCount);
      for (int it = 0; it < kIters; ++it) {
        for (int64_t i = 0; i < kCount; ++i) {
          buf[i] = static_cast<float>((i % 13) + r);
        }
        hvd::Status st = rings[r].HierAllreduce(
            buf.data(), buf.data(), kCount, hvd::DataType::HVD_FLOAT32,
            hvd::ReduceOp::SUM, 1.0, 1.0);
        CHECK(st.ok(), "reconnect phase: hier allreduce across the cut");
        if (!st.ok()) return;
        // Small integers: exact in fp32 at any summation order, so the
        // healed iteration must equal the closed form exactly.
        for (int64_t i = 0; i < kCount; ++i) {
          if (buf[i] != static_cast<float>((i % 13) * kRanks + 6)) {
            CHECK(false, "reconnect phase: payload diverged");
            break;
          }
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  stop.store(true);
  poll.join();
  unsetenv("HVD_FAULT_CROSS_DROP");
  if (failures) return;
  // Both ends of the cut leg healed in place; nobody else did, and no
  // stale-epoch frame ever appeared (all rings share epoch 0).
  CHECK(rings[0].link_reconnects() >= 1, "leader 0 counted its heal");
  CHECK(rings[1].link_reconnects() >= 1, "leader 1 counted its heal");
  CHECK(rings[2].link_reconnects() == 0 &&
            rings[3].link_reconnects() == 0,
        "members never heal");
  for (int r = 0; r < kRanks; ++r) {
    CHECK(rings[r].stale_epoch_rejected() == 0,
          "no stale epochs in a single-incarnation world");
  }
}

// The worldlost phase's silent round: rank 0's stall windows, and the
// seconds within which its allreduce must end after rank 1 stops.
constexpr double kSilentWarnS = 0.5, kSilentShutdownS = 1.0;
constexpr double kSilentBoundS = kSilentShutdownS + 4.0;

// Rank 1 of the worldlost phase's world, in a process of its own (this
// binary with "--rank1 <port> <mode>"): one allreduce, then an exit
// without a farewell ("exit"), a departure by hvd_shutdown, or a SIGSTOP
// ("stop": silent, its sockets open, until rank 0 kills it).
int Rank1(int port, const std::string& mode) {
  bool stop = mode == "stop";
  int rc = hvd_init(1, 2, 0, 1, 1, 2, "127.0.0.1", port, "127.0.0.1", 1.0,
                    1 << 20, 64, stop ? kSilentWarnS : 60.0,
                    stop ? kSilentShutdownS : 0.0, stop ? 1 : 0, 0, 0);
  if (rc != 0) {
    std::fprintf(stderr, "FAIL: rank 1 hvd_init\n");
    return 1;
  }
  float buf[16];
  for (int k = 0; k < 16; ++k) buf[k] = 1.0f;
  long long shape[1] = {16};
  char err[256];
  long long h = hvd_enqueue("wl.0", kOpAllreduce, kReduceSum, kDtypeF32,
                            shape, 1, buf, buf, -1, 1.0, 1.0, kPlaneHost);
  if (h < 0 || hvd_wait(h, err, sizeof(err)) != 1 || buf[0] != 2.0f) {
    std::fprintf(stderr, "FAIL: rank 1 allreduce\n");
    return 1;
  }
  if (mode == "exit") _exit(0);  // no farewell: its sockets just close
  if (stop) raise(SIGSTOP);
  hvd_shutdown();
  return 0;
}

// The C API's world-lost verdict across a lost rank, a departure, a
// shutdown and a re-init (operations.cc's store at the loop's end and
// reset at init), with a thread polling hvd_world_lost() throughout.
void WorldLostPhase(const char* self) {
  std::atomic<bool> stop{false};
  std::atomic<long long> polls{0};
  std::thread poll([&] {
    while (!stop.load()) {
      polls.fetch_add(hvd_world_lost() + hvd_initialized() + 1);
    }
  });
  const char* modes[] = {"exit", "shutdown", "stop"};
  for (int round = 0; round < 3 && failures == 0; ++round) {
    std::string mode = modes[round];
    bool stop = mode == "stop";
    int port = 0;
    {
      hvd::Listener probe;
      if (!probe.Listen(0)) {
        CHECK(false, "worldlost phase: port probe");
        break;
      }
      port = probe.port();
    }
    std::string port_s = std::to_string(port);
    char* argv[] = {const_cast<char*>(self), const_cast<char*>("--rank1"),
                    const_cast<char*>(port_s.c_str()),
                    const_cast<char*>(mode.c_str()), nullptr};
    pid_t child = -1;
    if (posix_spawn(&child, self, nullptr, nullptr, argv, environ) != 0) {
      CHECK(false, "worldlost phase: spawn rank 1");
      break;
    }
    int rc = hvd_init(0, 2, 0, 1, 0, 2, "127.0.0.1", port, "127.0.0.1", 1.0,
                      1 << 20, 64, stop ? kSilentWarnS : 60.0,
                      stop ? kSilentShutdownS : 0.0, stop ? 1 : 0, 0, 0);
    CHECK(rc == 0, "worldlost phase: rank 0 hvd_init");
    double waited = 0.0;
    if (rc == 0) {
      float buf[16];
      for (int k = 0; k < 16; ++k) buf[k] = 1.0f;
      long long shape[1] = {16};
      char err[256];
      long long h = hvd_enqueue("wl.0", kOpAllreduce, kReduceSum,
                                kDtypeF32, shape, 1, buf, buf, -1, 1.0, 1.0,
                                kPlaneHost);
      CHECK(h >= 0 && hvd_wait(h, err, sizeof(err)) == 1 && buf[0] == 2.0f,
            "worldlost phase: rank 0 allreduce");
      // The world ends with rank 1's exit, departure or silence: a
      // submission after it resolves as aborted.
      auto t0 = std::chrono::steady_clock::now();
      long long h2 = hvd_enqueue("wl.1", kOpAllreduce, kReduceSum,
                                 kDtypeF32, shape, 1, buf, buf, -1, 1.0,
                                 1.0, kPlaneHost);
      if (h2 >= 0) {
        CHECK(hvd_wait(h2, err, sizeof(err)) != 1,
              "worldlost phase: the world ended");
      }
      waited = std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0).count();
      CHECK(!stop || waited <= kSilentBoundS,
            "worldlost phase: a silent rank must end the world within the "
            "stall bound");
      bool want = mode != "shutdown";
      for (int i = 0; i < 2000 && (hvd_world_lost() == 1) != want; ++i) {
        std::this_thread::sleep_for(std::chrono::milliseconds(10));
      }
      int verdict = hvd_world_lost();
      CHECK(verdict == (want ? 1 : 0),
            want ? "worldlost phase: a lost rank must set hvd_world_lost"
                 : "worldlost phase: a departure must not set it");
      hvd_shutdown();
      CHECK(hvd_world_lost() == verdict,
            "worldlost phase: the verdict outlives shutdown");
      std::printf("WORLDLOST round=%d rank1=%s world_lost=%d\n", round,
                  mode.c_str(), verdict);
      if (stop) std::printf("WORLDLOST silent_s=%.3f\n", waited);
    }
    int status = 0;
    if (stop) kill(child, SIGKILL);
    waitpid(child, &status, 0);
    CHECK(stop ? WIFSIGNALED(status) && WTERMSIG(status) == SIGKILL
               : WIFEXITED(status) && WEXITSTATUS(status) == 0,
          "worldlost phase: rank 1 exited 0 (killed when silent)");
    // A re-init resets the verdict.
    int rc1 = hvd_init(0, 1, 0, 1, 0, 1, "127.0.0.1", 0, "127.0.0.1", 1.0,
                       1 << 20, 64, 60.0, 0.0, 0, 0, 0);
    CHECK(rc1 == 0, "worldlost phase: re-init");
    CHECK(hvd_world_lost() == 0, "worldlost phase: re-init resets it");
    hvd_shutdown();
  }
  stop.store(true);
  poll.join();
  CHECK(polls.load() > 0, "worldlost phase: the poller ran");
}

// Rank 1 of the departure phase, in a process of its own: the bootstrap
// hello (host group `cross`), the endpoint map, then (flat rounds) one
// request frame of the cycle, then an exit without a farewell.
int DeathRank(int port, int cross, bool frame) {
  hvd::Socket s = hvd::Socket::Connect("127.0.0.1", port, 30000);
  std::string hello = "1 127.0.0.1 0 - " + std::to_string(cross) + " 0";
  std::string map;
  if (!s.valid() || !s.SendFrame(hello) || !s.RecvFrame(&map)) {
    std::fprintf(stderr, "FAIL: departure phase: rank 1 bootstrap\n");
    return 1;
  }
  if (frame && !s.SendFrame(hvd::SerializeRequestList({}, {}, false))) {
    std::fprintf(stderr, "FAIL: departure phase: rank 1 frame\n");
    return 1;
  }
  _exit(0);
}

// The hierarchical control channel between in-process ranks: one queue
// of frames for each (from, to) pair; a receive waits up to 10 s.
class Mailbox {
 public:
  bool Send(int from, int to, const std::string& frame) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_[{from, to}].push_back(frame);
    }
    cv_.notify_all();
    return true;
  }
  bool Recv(int from, int to, std::string* frame) {
    std::unique_lock<std::mutex> lk(mu_);
    auto& q = q_[{from, to}];
    if (!cv_.wait_for(lk, std::chrono::seconds(10),
                      [&] { return !q.empty(); })) {
      return false;
    }
    *frame = q.front();
    q.pop_front();
    return true;
  }
  hvd::TcpController::CtrlChannel For(int rank) {
    hvd::TcpController::CtrlChannel ch;
    ch.send = [this, rank](int peer, const std::string& f) {
      return Send(rank, peer, f);
    };
    ch.recv = [this, rank](int peer, std::string* f) {
      return Recv(peer, rank, f);
    };
    return ch;
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::pair<int, int>, std::deque<std::string>> q_;
};

// A rank that dies after its frame, in the cycle in which another rank
// leaves: the coordinator's verdict must be LOST on every survivor.
void DeparturePhase(const char* self) {
  const char* kinds[] = {"flat", "flat+heartbeats", "hier"};
  int rounds = 0, lost_rounds = 0;
  // Every round runs, a failed one too, so the count says how many of
  // them ended on LOST.
  for (int round = 0; round < 9; ++round) {
    std::string kind = kinds[round % 3];
    bool hier = kind == "hier";
    int size = hier ? 4 : 3;
    int port = 0;
    {
      hvd::Listener probe;
      if (!probe.Listen(0)) {
        CHECK(false, "departure phase: port probe");
        break;
      }
      port = probe.port();
    }
    Mailbox mail;
    // Rank 1's frame to its leader (the coordinator), sent before it dies.
    if (hier) mail.Send(1, 0, hvd::SerializeRequestList({}, {}, false));
    std::string port_s = std::to_string(port);
    std::string cross_s = hier ? "0" : "1";
    std::string frame_s = hier ? "0" : "1";
    char* argv[] = {const_cast<char*>(self), const_cast<char*>("--death"),
                    const_cast<char*>(port_s.c_str()),
                    const_cast<char*>(cross_s.c_str()),
                    const_cast<char*>(frame_s.c_str()), nullptr};
    pid_t child = -1;
    if (posix_spawn(&child, self, nullptr, nullptr, argv, environ) != 0) {
      CHECK(false, "departure phase: spawn rank 1");
      break;
    }
    // Ranks 0 and 2 (flat), or 0, 2 and 3 (hier: 2 leads host 1, 3 is
    // its member); the last one leaves.
    std::vector<int> mine = hier ? std::vector<int>{0, 2, 3}
                                 : std::vector<int>{0, 2};
    std::vector<std::unique_ptr<hvd::TcpController>> ctl;
    for (int r : mine) {
      hvd::ControllerConfig c;
      c.rank = r;
      c.size = size;
      c.cross_rank = hier ? r / 2 : r;
      c.coordinator_port = port;
      if (kind == "flat+heartbeats") {
        c.heartbeat_ms = 1;
        c.liveness_timeout_ms = 5000;
      }
      ctl.emplace_back(new hvd::TcpController(c, /*data_port=*/1 + r,
                                              "127.0.0.1"));
    }
    std::atomic<bool> dead{false};
    std::vector<int> ended(mine.size(), 0);
    std::vector<std::thread> threads;
    for (size_t i = 0; i < mine.size(); ++i) {
      threads.emplace_back([&, i] {
        hvd::TcpController& c = *ctl[i];
        if (!c.Initialize().ok()) {
          CHECK(false, "departure phase: controller init");
          return;
        }
        if (hier) c.EnableHierControl(mail.For(mine[i]));
        bool leaves = i + 1 == mine.size();
        if (leaves) {
          while (!dead.load()) {
            std::this_thread::sleep_for(std::chrono::milliseconds(1));
          }
        }
        bool down = false;
        for (int cyc = 0; cyc < 50 && !down; ++cyc) {
          c.ComputeResponseList({}, leaves, false, &down);
        }
        ended[i] = down ? 1 : 0;
        c.Finalize();
      });
    }
    int status = 0;
    waitpid(child, &status, 0);
    CHECK(WIFEXITED(status) && WEXITSTATUS(status) == 0,
          "departure phase: rank 1 sent its frame and exited");
    // Its connection's close reaches the coordinator before the farewell.
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    dead.store(true);
    for (auto& t : threads) t.join();
    std::string verdicts;
    bool all_lost = true;
    for (size_t i = 0; i < mine.size(); ++i) {
      CHECK(ended[i], "departure phase: the world ended");
      all_lost = all_lost && ctl[i]->world_lost();
      verdicts += (i ? "," : "") + std::to_string(ctl[i]->world_lost());
    }
    CHECK(all_lost,
          "departure phase: a death in a departure's cycle must set "
          "world_lost on every survivor");
    ++rounds;
    lost_rounds += all_lost ? 1 : 0;
    std::printf("DEPARTURE round=%d kind=%s world_lost=%s\n", round,
                kind.c_str(), verdicts.c_str());
  }
  std::printf("DEPARTURE lost %d of %d rounds\n", lost_rounds, rounds);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc == 4 && std::strcmp(argv[1], "--rank1") == 0) {
    return Rank1(std::atoi(argv[2]), argv[3]);
  }
  if (argc == 5 && std::strcmp(argv[1], "--death") == 0) {
    return DeathRank(std::atoi(argv[2]), std::atoi(argv[3]),
                     std::atoi(argv[4]) != 0);
  }
  std::set<std::string> want(argv + 1, argv + argc);
  auto on = [&](const char* phase) {
    return failures == 0 && (want.empty() || want.count(phase) > 0);
  };
  for (int world = 0; world < 4 && on("world"); ++world) {
    RunWorld(world, /*submitters=*/3, /*iters=*/150);
  }
  if (on("ring")) RingPhase();
  if (on("shm")) ShmPhase();
  if (on("stripe")) StripePhase();
  if (on("reconnect")) ReconnectPhase();
  if (on("liveness")) LivenessControllerPhase();
  if (on("worldlost")) WorldLostPhase("/proc/self/exe");
  if (on("departure")) DeparturePhase("/proc/self/exe");
  if (failures) return 1;
  std::puts("STRESS_OK");
  return 0;
}
