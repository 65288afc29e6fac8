#include "socket.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <sys/uio.h>

#include <chrono>
#include <cstring>
#include <thread>

#include "env_util.h"

namespace hvd {

namespace {
// Over-read size for the buffered receive path (covers a frame header +
// a small payload — the controller's cached-id frames — in one recv).
constexpr size_t kRecvBuf = 4096;

// Upper bound on any length-prefixed frame a peer can make this process
// allocate (HOROVOD_MAX_FRAME_BYTES, default the historical 1 GiB cap,
// clamped to [64 KiB, 1 GiB] like config.max_frame_bytes()). A header
// announcing more is a desynced or hostile stream: reject the frame —
// never resize() a payload buffer to an attacker-chosen size first.
uint32_t MaxFrameBytes() {
  static const uint32_t cap = [] {
    long long v = EnvLL("HOROVOD_MAX_FRAME_BYTES", 1LL << 30);
    if (v < (64LL << 10)) v = 64LL << 10;
    if (v > (1LL << 30)) v = 1LL << 30;
    return static_cast<uint32_t>(v);
  }();
  return cap;
}
}  // namespace

Socket& Socket::operator=(Socket&& o) noexcept {
  if (this != &o) {
    Close();
    fd_ = o.fd_;
    rbuf_ = std::move(o.rbuf_);
    rpos_ = o.rpos_;
    o.fd_ = -1;
    o.rpos_ = 0;
  }
  return *this;
}

Socket::~Socket() { Close(); }

void Socket::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
  rbuf_.clear();
  rpos_ = 0;
}

void Socket::ShutdownBoth() {
  if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
}

bool Socket::SendAll(const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  while (n > 0) {
    ssize_t w = ::send(fd_, c, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      return false;
    }
    c += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool Socket::RecvAll(void* p, size_t n) {
  char* c = static_cast<char*>(p);
  // Drain the user-space buffer first.
  size_t buffered = rbuf_.size() - rpos_;
  if (buffered > 0) {
    size_t take = buffered < n ? buffered : n;
    std::memcpy(c, rbuf_.data() + rpos_, take);
    rpos_ += take;
    if (rpos_ == rbuf_.size()) {
      rbuf_.clear();
      rpos_ = 0;
    }
    c += take;
    n -= take;
  }
  while (n > 0) {
    if (n < kRecvBuf) {
      // Short remainder (frame headers, small payloads): over-read into
      // the buffer so the header and payload — and often the next frame
      // — cost one syscall instead of one each.
      char tmp[kRecvBuf];
      ssize_t r = ::recv(fd_, tmp, sizeof(tmp), 0);
      if (r <= 0) {
        if (r < 0 && errno == EINTR) continue;
        return false;
      }
      size_t got = static_cast<size_t>(r);
      size_t take = got < n ? got : n;
      std::memcpy(c, tmp, take);
      c += take;
      n -= take;
      if (got > take) {
        rbuf_.assign(tmp + take, tmp + got);
        rpos_ = 0;
      }
      continue;
    }
    ssize_t r = ::recv(fd_, c, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    c += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool Socket::SendFrame(const std::string& payload) {
  return SendFrame(payload.data(), payload.size());
}

bool Socket::SendFrame(const void* payload, size_t nbytes) {
  uint32_t len = static_cast<uint32_t>(nbytes);
  const char* p = static_cast<const char*>(payload);
  // One writev for header + payload (one syscall for the common short
  // frame); fall back to SendAll for partial writes. The (ptr, len)
  // form exists so large transfers (the transport registry's intra-host
  // legs) never pay a std::string copy of the payload.
  struct iovec iov[2];
  iov[0].iov_base = &len;
  iov[0].iov_len = 4;
  iov[1].iov_base = const_cast<char*>(p);
  iov[1].iov_len = nbytes;
  struct msghdr msg;
  std::memset(&msg, 0, sizeof(msg));
  msg.msg_iov = iov;
  msg.msg_iovlen = 2;
  size_t total = 4 + nbytes;
  while (true) {
    // sendmsg, not writev: a dying peer must surface as an error, not a
    // process-killing SIGPIPE (MSG_NOSIGNAL — the chaos tests kill ranks
    // mid-frame on purpose).
    ssize_t w = ::sendmsg(fd_, &msg, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t sent = static_cast<size_t>(w);
    if (sent >= total) return true;
    // Partial write: finish byte-precise via SendAll.
    if (sent < 4) {
      const char* h = reinterpret_cast<const char*>(&len);
      return SendAll(h + sent, 4 - sent) && SendAll(p, nbytes);
    }
    return SendAll(p + (sent - 4), nbytes - (sent - 4));
  }
}

bool Socket::SendVec(const struct iovec* iov, int iovcnt) {
  struct msghdr msg;
  std::memset(&msg, 0, sizeof(msg));
  // sendmsg mutates nothing, but partial writes need a mutable copy to
  // advance; bound the vector at the two entries the stripe path uses.
  struct iovec local[8];
  if (iovcnt < 1 || iovcnt > 8) return false;
  std::memcpy(local, iov, iovcnt * sizeof(struct iovec));
  int first = 0;
  msg.msg_iov = local;
  msg.msg_iovlen = iovcnt;
  while (first < iovcnt) {
    msg.msg_iov = local + first;
    msg.msg_iovlen = iovcnt - first;
    ssize_t w = ::sendmsg(fd_, &msg, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t sent = static_cast<size_t>(w);
    while (first < iovcnt && sent >= local[first].iov_len) {
      sent -= local[first].iov_len;
      ++first;
    }
    if (first < iovcnt) {
      local[first].iov_base = static_cast<char*>(local[first].iov_base) +
                              sent;
      local[first].iov_len -= sent;
    }
  }
  return true;
}

long Socket::RecvSome(void* p, size_t n, bool nonblock) {
  if (n == 0) return 0;
  size_t buffered = rbuf_.size() - rpos_;
  if (buffered > 0) {
    size_t take = buffered < n ? buffered : n;
    std::memcpy(p, rbuf_.data() + rpos_, take);
    rpos_ += take;
    if (rpos_ == rbuf_.size()) {
      rbuf_.clear();
      rpos_ = 0;
    }
    return static_cast<long>(take);
  }
  while (true) {
    ssize_t r = ::recv(fd_, p, n, nonblock ? MSG_DONTWAIT : 0);
    if (r > 0) return static_cast<long>(r);
    if (r == 0) return -1;  // orderly close
    if (errno == EINTR) continue;
    if (nonblock && (errno == EAGAIN || errno == EWOULDBLOCK)) return 0;
    return -1;
  }
}

bool Socket::RecvFrame(std::string* payload) {
  uint32_t len = 0;
  if (!RecvAll(&len, 4)) return false;
  if (len > MaxFrameBytes()) return false;
  payload->resize(len);
  return len == 0 || RecvAll(&(*payload)[0], len);
}

bool Socket::RecvFrameInto(void* payload, size_t nbytes) {
  uint32_t len = 0;
  if (!RecvAll(&len, 4)) return false;
  if (len != nbytes) return false;  // desync: caller aborts
  return len == 0 || RecvAll(payload, len);
}

int Socket::RecvFrameTimeout(std::string* payload, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (true) {
    // A complete frame already buffered? rbuf_/rpos_ double as the
    // partial-frame accumulator, so a timed-out call never misaligns the
    // stream for the next one (or for blocking RecvFrame).
    size_t avail = rbuf_.size() - rpos_;
    if (avail >= 4) {
      uint32_t len = 0;
      std::memcpy(&len, rbuf_.data() + rpos_, 4);
      if (len > MaxFrameBytes()) return -1;
      if (avail >= 4 + static_cast<size_t>(len)) {
        payload->assign(rbuf_.data() + rpos_ + 4, len);
        rpos_ += 4 + len;
        if (rpos_ == rbuf_.size()) {
          rbuf_.clear();
          rpos_ = 0;
        }
        return 1;
      }
    }
    auto now = std::chrono::steady_clock::now();
    auto remaining = std::chrono::duration_cast<std::chrono::milliseconds>(
                         deadline - now)
                         .count();
    if (remaining < 0) remaining = 0;
    struct pollfd pfd;
    pfd.fd = fd_;
    pfd.events = POLLIN;
    pfd.revents = 0;
    int pr = ::poll(&pfd, 1, static_cast<int>(remaining));
    if (pr < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (pr == 0) return 0;  // budget exhausted without a complete frame
    // Compact the consumed prefix so the buffer only ever grows by what
    // the incomplete frame still needs.
    if (rpos_ > 0) {
      rbuf_.erase(rbuf_.begin(), rbuf_.begin() + rpos_);
      rpos_ = 0;
    }
    char tmp[kRecvBuf];
    ssize_t r = ::recv(fd_, tmp, sizeof(tmp), 0);
    if (r == 0) return -1;  // orderly close
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    rbuf_.insert(rbuf_.end(), tmp, tmp + r);
  }
}

Socket Socket::Connect(const std::string& host, int port, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (std::chrono::steady_clock::now() < deadline) {
    struct addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port_s = std::to_string(port);
    if (::getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0) {
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
      continue;
    }
    int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      if (::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
        ::freeaddrinfo(res);
        return Socket(fd);
      }
      ::close(fd);
    }
    ::freeaddrinfo(res);
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
  }
  return Socket();
}

bool Listener::Listen(int port) {
  fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd_ < 0) return false;
  int one = 1;
  ::setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd_, reinterpret_cast<struct sockaddr*>(&addr),
             sizeof(addr)) != 0) {
    ::close(fd_);
    fd_ = -1;
    return false;
  }
  if (::listen(fd_, 128) != 0) {
    ::close(fd_);
    fd_ = -1;
    return false;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(fd_, reinterpret_cast<struct sockaddr*>(&addr), &len);
  port_ = ntohs(addr.sin_port);
  return true;
}

Socket Listener::Accept(int timeout_ms) {
  struct pollfd pfd;
  pfd.fd = fd_;
  pfd.events = POLLIN;
  int r = ::poll(&pfd, 1, timeout_ms);
  if (r <= 0) return Socket();
  int cfd = ::accept(fd_, nullptr, nullptr);
  if (cfd < 0) return Socket();
  int one = 1;
  ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return Socket(cfd);
}

void Listener::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

Listener::~Listener() { Close(); }

}  // namespace hvd
