#include "shm_transport.h"

#include <dirent.h>
#include <fcntl.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

#include "env_util.h"

namespace hvd {

namespace {

constexpr uint64_t kMagic = 0x48564453484d3031ull;  // "HVDSHM01"
constexpr int kMaxGroup = 240;                      // header stays one page
constexpr size_t kHdrBytes = 4096;
constexpr uint32_t kNumSlots = 4;

// Segment header (one page). POD + lock-free atomics only: the struct is
// shared across processes, so layout must not depend on library state.
struct SegHdr {
  uint64_t magic;
  int64_t owner_pid;
  int32_t owner_rank;
  int32_t nchan;
  uint32_t nslots;
  uint32_t reserved;
  int64_t slot_bytes;
  std::atomic<uint32_t> ready;  // 1 once channels are initialized
  int32_t members[kMaxGroup];
};
static_assert(sizeof(SegHdr) <= kHdrBytes, "header must fit one page");

// One SPSC inbox ring (sender: the peer at this channel index in the
// owner's group; receiver: the segment owner). Head/tail on their own
// cache lines; `poison` is the lock-step fallthrough flag — set by a
// sender abandoning shm (or a tearing-down owner), observed by the
// other side's wait loop once the ring is drained. `sender_pid` is
// stamped by the sender at attach time so the receiver's wait can
// notice a SIGKILLed sender (shm has no kernel FIN/RST to fail the
// read the way a dead TCP peer does).
struct Channel {
  std::atomic<uint64_t> head;
  char pad0[56];
  std::atomic<uint64_t> tail;
  char pad1[56];
  std::atomic<uint32_t> poison;
  uint32_t pad2;
  std::atomic<int64_t> sender_pid;
  char pad3[48];
};
static_assert(sizeof(Channel) == 192, "channel header is 3 cache lines");
static_assert(std::atomic<uint64_t>::is_always_lock_free,
              "cross-process handshake needs lock-free atomics");

size_t SlotStride(int64_t slot_bytes) {
  size_t s = 8 + static_cast<size_t>(slot_bytes);  // u64 len + payload
  return (s + 63) & ~size_t{63};
}

size_t ChannelBytes(int64_t slot_bytes, uint32_t nslots) {
  return sizeof(Channel) + nslots * SlotStride(slot_bytes);
}

char* SlotAt(Channel* ch, uint32_t nslots, int64_t slot_bytes, uint64_t seq) {
  return reinterpret_cast<char*>(ch) + sizeof(Channel) +
         (seq % nslots) * SlotStride(slot_bytes);
}

bool PidAlive(pid_t pid);  // defined below

// Spin-then-yield wait: `cond` polled syscall-free for a short burst,
// then with sched_yield between polls, bounded by `default_timeout_ms`
// (HVD_SHM_TIMEOUT_MS overrides; data-plane waits pass the liveness-
// derived bound from Init so a wedged-but-alive peer cannot outlast
// the eviction the liveness plane delivers on the TCP side). While
// yielding, `peer_pid` (when known, != 0) is liveness-checked every
// ~50 ms: a SIGKILLed peer never poisons its channels and shm has no
// kernel FIN/RST to fail the wait the way a dead TCP socket does, so
// without this a survivor would spin out the full timeout. Returns
// false on timeout or peer death.
template <typename Cond>
bool WaitFor(Cond cond, int64_t peer_pid = 0,
             long long default_timeout_ms = 120000) {
  for (int i = 0; i < 4096; ++i) {
    if (cond()) return true;
  }
  long long timeout_ms = EnvMs("HVD_SHM_TIMEOUT_MS", default_timeout_ms);
  auto now = std::chrono::steady_clock::now();
  auto deadline = now + std::chrono::milliseconds(timeout_ms);
  auto next_pid_check = now + std::chrono::milliseconds(50);
  while (!cond()) {
    std::this_thread::yield();
    now = std::chrono::steady_clock::now();
    if (now > deadline) return false;
    if (peer_pid != 0 && now > next_pid_check) {
      if (!PidAlive(static_cast<pid_t>(peer_pid))) return false;
      next_pid_check = now + std::chrono::milliseconds(50);
    }
  }
  return true;
}

bool ForceAttachFail() {
  const char* e = std::getenv("HVD_SHM_FORCE_ATTACH_FAIL");
  return e != nullptr && *e != 0 && std::strcmp(e, "0") != 0;
}

bool PidAlive(pid_t pid) {
  if (kill(pid, 0) != 0) return errno != ESRCH;
  // A zombie still answers kill(0) but will never unlink anything it
  // owns: read its state from /proc (this transport is Linux-only
  // anyway) and treat 'Z' as gone. The comm field may contain spaces
  // and parens, so the state letter is found after the LAST ')'.
  char path[64];
  std::snprintf(path, sizeof(path), "/proc/%d/stat",
                static_cast<int>(pid));
  FILE* f = std::fopen(path, "r");
  if (f == nullptr) return false;  // raced the reap: gone
  char buf[512];
  size_t n = std::fread(buf, 1, sizeof(buf) - 1, f);
  std::fclose(f);
  buf[n] = 0;
  const char* p = std::strrchr(buf, ')');
  if (p != nullptr && p[1] == ' ' && p[2] != 0) return p[2] != 'Z';
  return true;
}

std::string NameTag() {
  // Test sessions tag every world's segments (conftest's orphan sweep
  // globs them); production names carry no tag.
  const char* e = std::getenv("HVD_TEST_WORLD_TAG");
  if (e == nullptr) return "";
  std::string tag;
  for (const char* p = e; *p && tag.size() < 12; ++p) {
    if (std::isalnum(static_cast<unsigned char>(*p))) tag.push_back(*p);
  }
  return tag.empty() ? "" : tag + "_";
}

}  // namespace

std::string ShmTransport::SegmentName(int port, int rank) {
  return "/hvdshm_" + NameTag() + "p" + std::to_string(port) + "_r" +
         std::to_string(rank);
}

int ShmTransport::SweepOrphans() {
  DIR* d = opendir("/dev/shm");
  if (d == nullptr) return 0;
  int reaped = 0;
  std::vector<std::string> doomed;
  while (struct dirent* e = readdir(d)) {
    if (std::strncmp(e->d_name, "hvdshm_", 7) != 0) continue;
    std::string name = std::string("/") + e->d_name;
    int fd = shm_open(name.c_str(), O_RDONLY, 0);
    if (fd < 0) continue;
    SegHdr hdr;
    ssize_t n = pread(fd, &hdr, sizeof(hdr), 0);
    close(fd);
    if (n != static_cast<ssize_t>(sizeof(hdr)) || hdr.magic != kMagic) {
      continue;  // not ours / torn header: leave it alone
    }
    if (hdr.owner_pid > 0 && !PidAlive(static_cast<pid_t>(hdr.owner_pid))) {
      doomed.push_back(name);
    }
  }
  closedir(d);
  for (const auto& name : doomed) {
    if (shm_unlink(name.c_str()) == 0) ++reaped;
  }
  return reaped;
}

size_t ShmTransport::SegmentBytes() const {
  return kHdrBytes +
         group_.size() * ChannelBytes(slot_bytes_, nslots_);
}

void* ShmTransport::ChannelOf(void* seg_base, int chan_index) const {
  return static_cast<char*>(seg_base) + kHdrBytes +
         chan_index * ChannelBytes(slot_bytes_, nslots_);
}

bool ShmTransport::CreateOwnSegment() {
  own_name_ = SegmentName(ports_[rank_], rank_);
  shm_unlink(own_name_.c_str());  // stale same-name leftovers, if any
  int fd = shm_open(own_name_.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    std::fprintf(stderr, "[horovod_tpu] shm: create %s failed: %s\n",
                 own_name_.c_str(), std::strerror(errno));
    return false;
  }
  own_bytes_ = SegmentBytes();
  if (ftruncate(fd, static_cast<off_t>(own_bytes_)) != 0) {
    close(fd);
    shm_unlink(own_name_.c_str());
    return false;
  }
  own_base_ = mmap(nullptr, own_bytes_, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (own_base_ == MAP_FAILED) {
    own_base_ = nullptr;
    shm_unlink(own_name_.c_str());
    return false;
  }
  auto* hdr = static_cast<SegHdr*>(own_base_);
  hdr->magic = kMagic;
  hdr->owner_pid = static_cast<int64_t>(getpid());
  hdr->owner_rank = rank_;
  hdr->nchan = static_cast<int32_t>(group_.size());
  hdr->nslots = nslots_;
  hdr->slot_bytes = slot_bytes_;
  for (size_t i = 0; i < group_.size(); ++i) {
    hdr->members[i] = group_[i];
  }
  // Channels are already zero (fresh ftruncate pages). Publish.
  hdr->ready.store(1, std::memory_order_release);
  return true;
}

bool ShmTransport::Init(int rank, const std::vector<int>& group,
                        const std::vector<int>& ports, int64_t slot_bytes,
                        long long wait_timeout_ms) {
  if (group.size() < 2 || group.size() > kMaxGroup) return false;
  rank_ = rank;
  group_ = group;
  ports_ = ports;
  wait_timeout_ms_ = std::max(1LL, wait_timeout_ms);
  slot_bytes_ = std::max<int64_t>(4096, slot_bytes);
  nslots_ = kNumSlots;
  // Cap the whole segment (header + one ring per member) at 256 MiB:
  // fusion-cap-sized slots on a many-rank host would otherwise reach
  // gigabytes of tmpfs per rank, and exhausting /dev/shm mid-write is
  // a SIGBUS, not a fallback. Larger messages just chunk through the
  // smaller slots. Deterministic from (group size, env) alone, so the
  // attach-time slot_bytes validation still agrees across ranks.
  constexpr int64_t kMaxSegment = 256LL << 20;
  int64_t max_chan =
      (kMaxSegment - static_cast<int64_t>(kHdrBytes)) /
      static_cast<int64_t>(group_.size());
  int64_t max_slot =
      (max_chan - static_cast<int64_t>(sizeof(Channel))) / kNumSlots - 64;
  max_slot &= ~int64_t{63};
  slot_bytes_ = std::max<int64_t>(4096, std::min(slot_bytes_, max_slot));
  auto it = std::find(group_.begin(), group_.end(), rank_);
  if (it == group_.end()) return false;
  my_index_ = static_cast<int>(it - group_.begin());
  if (const char* e = std::getenv("HVD_SHM_POISON_AT")) {
    char* end = nullptr;
    long long v = std::strtoll(e, &end, 10);
    if (end != nullptr && *end == 0 && v >= 0) poison_at_ = v;
  }
  SweepOrphans();
  if (!CreateOwnSegment()) return false;
  enabled_ = true;
  return true;
}

bool ShmTransport::Prepare(int peer) {
  if (!enabled_ || peer == rank_) return false;
  auto it = attached_.find(peer);
  if (it != attached_.end()) return !it->second.failed;
  Attached a;
  a.failed = true;
  attached_[peer] = a;  // sticky unless the attach below succeeds
  ++attach_fail_;       // balanced by the success path's decrement
  if (ForceAttachFail()) {
    std::fprintf(stderr,
                 "[horovod_tpu] shm: attach to rank %d force-failed "
                 "(HVD_SHM_FORCE_ATTACH_FAIL); TCP carries this leg\n",
                 peer);
    return false;
  }
  if (std::find(group_.begin(), group_.end(), peer) == group_.end()) {
    return false;
  }
  std::string name = SegmentName(ports_[peer], peer);
  long long timeout_ms = EnvMs("HVD_SHM_ATTACH_TIMEOUT_MS", 15000);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  size_t bytes = SegmentBytes();
  int fd = -1;
  while (true) {
    if (fd < 0) fd = shm_open(name.c_str(), O_RDWR, 0600);
    if (fd >= 0) {
      // The owner creates then ftruncates: an attach landing between
      // the two sees a smaller (even 0-byte) file, and mapping past
      // EOF would SIGBUS on first touch — wait for the full size.
      struct stat st;
      if (fstat(fd, &st) == 0 &&
          st.st_size >= static_cast<off_t>(bytes)) {
        break;
      }
    }
    if ((fd < 0 && errno != ENOENT) ||
        std::chrono::steady_clock::now() > deadline) {
      std::fprintf(stderr,
                   "[horovod_tpu] shm: attach %s failed: %s; TCP carries "
                   "this leg\n",
                   name.c_str(), std::strerror(errno));
      if (fd >= 0) close(fd);
      return false;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(2));
  }
  void* base = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                    0);
  close(fd);
  if (base == MAP_FAILED) return false;
  auto* hdr = static_cast<SegHdr*>(base);
  // Ready-flag wait stays inside the ATTACH budget (not the data-plane
  // timeout): the remaining slice of the same deadline the open/size
  // loop above ran against.
  long long ready_ms = std::max<long long>(
      1, std::chrono::duration_cast<std::chrono::milliseconds>(
             deadline - std::chrono::steady_clock::now())
             .count());
  bool ready = WaitFor(
      [&] { return hdr->ready.load(std::memory_order_acquire) == 1; },
      /*peer_pid=*/0, ready_ms);
  if (!ready || hdr->magic != kMagic || hdr->owner_rank != peer ||
      hdr->nchan != static_cast<int32_t>(group_.size()) ||
      hdr->slot_bytes != slot_bytes_ || hdr->nslots != nslots_) {
    std::fprintf(stderr,
                 "[horovod_tpu] shm: segment %s failed validation; TCP "
                 "carries this leg\n",
                 name.c_str());
    munmap(base, bytes);
    return false;
  }
  // Stamp my pid into my channel so the owner's Recv waits can notice
  // this process dying without a teardown (see WaitFor).
  auto* my_ch = static_cast<Channel*>(ChannelOf(base, my_index_));
  my_ch->sender_pid.store(static_cast<int64_t>(getpid()),
                          std::memory_order_release);
  attached_[peer] = Attached{base, bytes, hdr->owner_pid, false};
  --attach_fail_;
  ++attach_ok_;
  return true;
}

int ShmTransport::Send(int peer, const void* buf, size_t nbytes) {
  auto it = attached_.find(peer);
  if (it == attached_.end() || it->second.failed) {
    return kTransportFellThrough;
  }
  auto* ch = static_cast<Channel*>(ChannelOf(it->second.base, my_index_));
  if (ch->poison.load(std::memory_order_acquire) != 0) {
    return kTransportFellThrough;
  }
  if (poison_at_ >= 0 && msg_count_++ == poison_at_) {
    // Deterministic exec fault: abandon shm for this peer mid-world.
    // Poison-before-announce is the lock-step contract (op_manager.h).
    ch->poison.store(1, std::memory_order_release);
    return kTransportFellThrough;
  }
  size_t off = 0;
  do {
    size_t chunk = std::min(static_cast<size_t>(slot_bytes_), nbytes - off);
    bool space = WaitFor([&] {
      if (ch->poison.load(std::memory_order_acquire) != 0) return true;
      return ch->head.load(std::memory_order_relaxed) -
                 ch->tail.load(std::memory_order_acquire) <
             nslots_;
    }, it->second.owner_pid, wait_timeout_ms_);
    if (ch->poison.load(std::memory_order_acquire) != 0) {
      // Receiver tore down (or a prior fault poisoned us) while we were
      // streaming: a partial message cannot fall through safely.
      return off == 0 ? kTransportFellThrough : kTransportError;
    }
    if (!space) {
      ch->poison.store(1, std::memory_order_release);
      return kTransportError;  // wedged receiver: abort like a TCP stall
    }
    uint64_t h = ch->head.load(std::memory_order_relaxed);
    char* slot = SlotAt(ch, nslots_, slot_bytes_, h);
    std::memcpy(slot, &chunk, sizeof(uint64_t));
    if (chunk > 0) {
      std::memcpy(slot + 8, static_cast<const char*>(buf) + off, chunk);
    }
    ch->head.store(h + 1, std::memory_order_release);
    off += chunk;
  } while (off < nbytes);
  bytes_sent_.fetch_add(static_cast<long long>(nbytes));
  return kTransportOk;
}

int ShmTransport::Recv(int peer, void* buf, size_t nbytes) {
  if (!enabled_ || own_base_ == nullptr) return kTransportFellThrough;
  auto it = std::find(group_.begin(), group_.end(), peer);
  if (it == group_.end()) return kTransportError;
  int ci = static_cast<int>(it - group_.begin());
  auto* ch = static_cast<Channel*>(ChannelOf(own_base_, ci));
  size_t off = 0;
  bool first = true;
  do {
    // The sender stamped its pid at attach time (before the first
    // control frame, so it is always set by the time a Recv waits).
    bool data = WaitFor([&] {
      if (ch->head.load(std::memory_order_acquire) >
          ch->tail.load(std::memory_order_relaxed)) {
        return true;
      }
      return ch->poison.load(std::memory_order_acquire) != 0;
    }, ch->sender_pid.load(std::memory_order_acquire), wait_timeout_ms_);
    uint64_t t = ch->tail.load(std::memory_order_relaxed);
    if (ch->head.load(std::memory_order_acquire) <= t) {
      // Ring drained and poisoned (sender abandoned shm) or timed out.
      // Fallthrough is only safe at a message boundary.
      if (data && first) return kTransportFellThrough;
      return kTransportError;
    }
    char* slot = SlotAt(ch, nslots_, slot_bytes_, t);
    uint64_t len;
    std::memcpy(&len, slot, sizeof(uint64_t));
    size_t expect = std::min(static_cast<size_t>(slot_bytes_), nbytes - off);
    if (len != expect) {
      return kTransportError;  // protocol desync: abort, never guess
    }
    if (len > 0) {
      std::memcpy(static_cast<char*>(buf) + off, slot + 8, len);
    }
    ch->tail.store(t + 1, std::memory_order_release);
    off += len;
    first = false;
  } while (off < nbytes);
  return kTransportOk;
}

void ShmTransport::Teardown() {
  if (own_base_ != nullptr) {
    // Unblock senders parked on my inbox rings.
    for (size_t i = 0; i < group_.size(); ++i) {
      auto* ch = static_cast<Channel*>(
          ChannelOf(own_base_, static_cast<int>(i)));
      ch->poison.store(1, std::memory_order_release);
    }
  }
  for (auto& kv : attached_) {
    if (kv.second.base != nullptr) {
      // Unblock the peer if it is mid-recv from me.
      auto* ch = static_cast<Channel*>(
          ChannelOf(kv.second.base, my_index_));
      ch->poison.store(1, std::memory_order_release);
      munmap(kv.second.base, kv.second.bytes);
    }
  }
  attached_.clear();
  if (own_base_ != nullptr) {
    munmap(own_base_, own_bytes_);
    own_base_ = nullptr;
    shm_unlink(own_name_.c_str());
  }
  if (enabled_) SweepOrphans();  // reap a killed peer's leftovers too
  enabled_ = false;
}

ShmTransport::~ShmTransport() { Teardown(); }

}  // namespace hvd
