#include "stripe_transport.h"

#include <poll.h>
#include <sys/uio.h>

#include <cerrno>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "env_util.h"
#include "message.h"

namespace hvd {

namespace {

bool ForceConnectFail() {
  // The ring.stripe.connect seam's native half (docs/cross-transport.md):
  // host_world arms this env when the absorbed kind=raise fires, so this
  // rank's stripe dials fail and the negotiation falls through to the
  // single-socket TCP backend in lock-step (strict mode hard-errors).
  const char* e = std::getenv("HVD_STRIPE_FORCE_CONNECT_FAIL");
  return e != nullptr && *e != 0 && std::strcmp(e, "0") != 0;
}

}  // namespace

void StripeTransport::Init(
    int rank, const std::vector<std::pair<std::string, int>>& endpoints,
    int stripes, long long chunk_bytes, bool allow_fallthrough,
    AcceptPump pump, long long epoch) {
  rank_ = rank;
  epoch_ = epoch;
  endpoints_ = endpoints;
  stripes_.store(stripes > 1 ? stripes : 1);
  chunk_bytes_ = chunk_bytes;
  allow_fallthrough_ = allow_fallthrough;
  pump_ = std::move(pump);
}

bool StripeTransport::Prepare(int peer) {
  int k = stripes_.load();
  if (k <= 1 || peer < 0 ||
      peer >= static_cast<int>(endpoints_.size()) || peer == rank_) {
    return false;
  }
  auto it = send_pairs_.find(peer);
  if (it != send_pairs_.end()) {
    // Sticky: an established pair stays; a recorded failure (empty
    // socks) never re-dials until a frame-synced SetStripes resets.
    return static_cast<int>(it->second.socks.size()) == k;
  }
  Pair& p = send_pairs_[peer];  // records the attempt, failure-sticky
  if (ForceConnectFail()) {
    std::fprintf(stderr,
                 "[horovod_tpu] stripe: connect to rank %d force-failed "
                 "(HVD_STRIPE_FORCE_CONNECT_FAIL); single-socket TCP "
                 "carries this leg\n",
                 peer);
    return false;
  }
  std::vector<Socket> socks;
  socks.reserve(k);
  for (int i = 0; i < k; ++i) {
    Socket s = Socket::Connect(endpoints_[peer].first,
                               endpoints_[peer].second,
                               static_cast<int>(EnvMs(
                                   "HVD_STRIPE_CONNECT_TIMEOUT_MS", 15000)));
    // The hello routes this socket at the peer's accept loop; the
    // backlog absorbs dials made while the peer is elsewhere, so the
    // connect needs no pending accept.
    if (!s.valid() ||
        !s.SendFrame("stripe " + std::to_string(rank_) + " " +
                     std::to_string(i) + " " + std::to_string(epoch_))) {
      std::fprintf(stderr,
                   "[horovod_tpu] stripe: dial %d/%d to rank %d failed; "
                   "single-socket TCP carries this leg\n",
                   i + 1, k, peer);
      return false;  // pair left empty: sticky failure
    }
    socks.push_back(std::move(s));
  }
  p.socks = std::move(socks);
  pairs_live_.fetch_add(1);
  return true;
}

void StripeTransport::Adopt(int peer, int idx, Socket s) {
  int k = stripes_.load();
  if (idx < 0 || idx >= k) return;  // stale dial from an old stripe count
  Pair& p = recv_pairs_[peer];
  if (static_cast<int>(p.socks.size()) != k) p.socks.resize(k);
  p.socks[idx] = std::move(s);
}

bool StripeTransport::HasAllStripes(int peer) const {
  auto it = recv_pairs_.find(peer);
  if (it == recv_pairs_.end()) return false;
  int k = stripes_.load();
  if (static_cast<int>(it->second.socks.size()) != k) return false;
  for (const Socket& s : it->second.socks) {
    if (!s.valid()) return false;
  }
  return true;
}

bool StripeTransport::PrepareRecv(int peer) {
  if (!HasAllStripes(peer)) {
    if (!pump_ || !pump_(peer) || !HasAllStripes(peer)) {
      std::fprintf(stderr,
                   "[horovod_tpu] stripe: accept of rank %d's stripes "
                   "failed\n",
                   peer);
      return false;
    }
  }
  // Count the pair exactly once, including when every stripe was
  // pre-adopted as a stray hello by another accept loop — a rank
  // receiving striped traffic must never report active_stripes() == 0.
  Pair& p = recv_pairs_[peer];
  if (!p.live) {
    p.live = true;
    pairs_live_.fetch_add(1);
  }
  return true;
}

int StripeTransport::Send(int peer, const void* buf, size_t nbytes) {
  auto it = send_pairs_.find(peer);
  int k = stripes_.load();
  if (it == send_pairs_.end() ||
      static_cast<int>(it->second.socks.size()) != k) {
    return kTransportError;  // registry never dispatches an unprepared pair
  }
  Pair& p = it->second;
  size_t chunk = static_cast<size_t>(chunk_bytes_);
  uint32_t pieces = StripePieceCount(nbytes, chunk);
  for (uint32_t i = 0; i < pieces; ++i) {
    uint32_t seq = p.next_seq + i;
    size_t off, len;
    StripePieceSpan(i, nbytes, chunk, &off, &len);
    char hdr[kStripeHdrBytes];
    EncodeStripeHdr(seq, static_cast<uint32_t>(len), hdr);
    struct iovec iov[2];
    iov[0].iov_base = hdr;
    iov[0].iov_len = kStripeHdrBytes;
    iov[1].iov_base =
        const_cast<char*>(static_cast<const char*>(buf) + off);
    iov[1].iov_len = len;
    // Round-robin by global sequence: stripes stay continuously loaded
    // across message boundaries, and the receiver derives the identical
    // assignment from the seq alone.
    Socket& s = p.socks[StripeOfSeq(seq, k)];
    if (!s.SendVec(iov, len > 0 ? 2 : 1)) {
      // Mid-stream failure: pieces already left on other stripes, so no
      // boundary exists to fall through at — abort like a TCP failure.
      return kTransportError;
    }
  }
  p.next_seq += pieces;
  bytes_sent_.fetch_add(static_cast<long long>(nbytes));
  return kTransportOk;
}

int StripeTransport::Recv(int peer, void* buf, size_t nbytes) {
  return RecvPieces(peer, buf, nbytes, nullptr);
}

int StripeTransport::RecvPieces(int peer, void* buf, size_t nbytes,
                                const PieceFn& fn) {
  auto it = recv_pairs_.find(peer);
  int k = stripes_.load();
  if (it == recv_pairs_.end() ||
      static_cast<int>(it->second.socks.size()) != k) {
    return kTransportError;
  }
  Pair& p = it->second;
  size_t chunk = static_cast<size_t>(chunk_bytes_);
  uint32_t pieces = StripePieceCount(nbytes, chunk);
  uint32_t base = p.next_seq;

  // Per-stripe piece queues: stripe s carries (in order) every local
  // piece i with (base + i) % k == s. Each stripe makes incremental
  // non-blocking progress through its queue, so cross-stripe arrival
  // order never matters — the seq header pins each piece to its span.
  struct StripeState {
    std::vector<uint32_t> queue;
    size_t qpos = 0;
    char hdr[kStripeHdrBytes];
    size_t hdr_got = 0;
    size_t payload_got = 0;
  };
  std::vector<StripeState> st(k);
  for (uint32_t i = 0; i < pieces; ++i) {
    st[StripeOfSeq(base + i, k)].queue.push_back(i);
  }
  uint32_t done = 0;

  // Progress one stripe as far as it can go without blocking. Returns
  // false on a hard error (desync, closed stripe).
  auto progress = [&](int s_idx) -> bool {
    StripeState& ss = st[s_idx];
    Socket& sock = p.socks[s_idx];
    while (ss.qpos < ss.queue.size()) {
      uint32_t i = ss.queue[ss.qpos];
      size_t off, len;
      StripePieceSpan(i, nbytes, chunk, &off, &len);
      if (ss.hdr_got < kStripeHdrBytes) {
        long r = sock.RecvSome(ss.hdr + ss.hdr_got,
                               kStripeHdrBytes - ss.hdr_got, true);
        if (r < 0) return false;
        if (r == 0) return true;  // would block: wait for poll
        ss.hdr_got += static_cast<size_t>(r);
        if (ss.hdr_got < kStripeHdrBytes) continue;
        uint32_t seq = 0, hlen = 0;
        if (!DecodeStripeHdr(ss.hdr, ss.hdr_got, &seq, &hlen) ||
            seq != base + i || hlen != static_cast<uint32_t>(len)) {
          // Desynced stripe stream: abort, never guess (the same
          // contract as a size-mismatched TCP frame).
          return false;
        }
      }
      if (ss.payload_got < len) {
        long r = sock.RecvSome(static_cast<char*>(buf) + off +
                                   ss.payload_got,
                               len - ss.payload_got, true);
        if (r < 0) return false;
        if (r == 0) return true;
        ss.payload_got += static_cast<size_t>(r);
        if (ss.payload_got < len) continue;
      }
      // Piece complete: hand the span to the pipeline hook while later
      // pieces are still in flight on the other stripes.
      if (fn) fn(off, len);
      ++done;
      ++ss.qpos;
      ss.hdr_got = 0;
      ss.payload_got = 0;
    }
    return true;
  };

  auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::milliseconds(EnvMs("HVD_STRIPE_TIMEOUT_MS", 120000));
  // First pass drains anything the hello's over-read buffered.
  for (int s = 0; s < k; ++s) {
    if (!progress(s)) return kTransportError;
  }
  while (done < pieces) {
    struct pollfd pfds[64];
    int map[64];
    int n = 0;
    for (int s = 0; s < k && n < 64; ++s) {
      if (st[s].qpos >= st[s].queue.size()) continue;
      pfds[n].fd = p.socks[s].fd();
      pfds[n].events = POLLIN;
      pfds[n].revents = 0;
      map[n] = s;
      ++n;
    }
    int pr = ::poll(pfds, n, 100);
    if (pr < 0 && errno != EINTR) return kTransportError;
    if (std::chrono::steady_clock::now() > deadline) {
      return kTransportError;  // wedged sender: abort like a TCP stall
    }
    for (int j = 0; j < n; ++j) {
      if (pfds[j].revents == 0) continue;
      if (!progress(map[j])) return kTransportError;
    }
  }
  p.next_seq += pieces;
  return kTransportOk;
}

void StripeTransport::SetStripes(int k) {
  // Frame-synced apply: close every connection (both roles) and forget
  // every attempt, so the lock-step renegotiation that follows re-dials
  // with the new count. Socket destructors close the fds; the peer's
  // mirrored apply at the same response boundary drops its ends too.
  send_pairs_.clear();
  recv_pairs_.clear();
  pairs_live_.store(0);
  if (k < 1) k = 1;
  if (k > kMaxStripes) k = kMaxStripes;
  stripes_.store(k);
}

}  // namespace hvd
