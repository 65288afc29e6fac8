// Minimal TCP helpers: length-prefixed frames over blocking sockets.
//
// This is the control/data transport of the multi-process controller — the
// role MPI point-to-point and the Gloo TCP context play in the reference
// (mpi_controller.cc, gloo/gloo_context.cc). TPU deployments coordinate
// across hosts over DCN/ethernet; plain TCP with frame framing is
// sufficient for the control plane and the host-tensor data plane.

// Thread posture: a Socket is SINGLE-OWNER state (fd + receive buffer)
// with a split-use contract the capability system cannot express on one
// object — e.g. the ring neighbor sockets are sent to by the sender
// thread while the posting thread receives, and the controller socket's
// sends are serialized by TcpController::send_mu_ while its receives
// are cycle-thread-only. The invariants that make this safe (exactly
// one reader thread per socket, sends serialized or single-threaded)
// are owned by the callers and documented at each member; this class
// itself carries no locks and no annotations.
//
#ifndef HVD_SOCKET_H_
#define HVD_SOCKET_H_

#include <sys/uio.h>

#include <cstdint>
#include <string>
#include <vector>

namespace hvd {

class Socket {
 public:
  Socket() = default;
  explicit Socket(int fd) : fd_(fd) {}
  Socket(const Socket&) = delete;
  Socket& operator=(const Socket&) = delete;
  Socket(Socket&& o) noexcept
      : fd_(o.fd_), rbuf_(std::move(o.rbuf_)), rpos_(o.rpos_) {
    o.fd_ = -1;
    o.rpos_ = 0;
  }
  Socket& operator=(Socket&& o) noexcept;
  ~Socket();

  bool valid() const { return fd_ >= 0; }
  int fd() const { return fd_; }
  void Close();
  // Half of a fault seam (docs/fault-injection.md): tears down both
  // directions of the TCP stream without releasing the fd, so every
  // later send/recv on either end fails deterministically — the shape a
  // mid-step connection drop presents to the self-healing data plane
  // (docs/self-healing.md). Never called outside injected faults.
  void ShutdownBoth();

  // Frame IO: 4-byte little-endian length + payload. Syscall-lean on
  // purpose — this runs under sandboxed kernels (gVisor-class) where a
  // syscall costs 10-20x native, and the controller hot path is frames:
  // sends coalesce header+payload into one writev, receives drain the
  // kernel buffer through a small user-space buffer so a short frame
  // (header + payload, often the NEXT frame too) costs one recv.
  bool SendFrame(const std::string& payload);
  // Copy-free forms for large payloads (the transport registry's
  // intra-host legs): same frames on the wire, no std::string staging.
  // RecvFrameInto expects EXACTLY nbytes — a differently-sized frame
  // fails (the stream is then desynced; callers abort, as they do on
  // any size-mismatched frame today).
  bool SendFrame(const void* payload, size_t nbytes);
  bool RecvFrameInto(void* payload, size_t nbytes);
  bool RecvFrame(std::string* payload);
  // Scatter-gather send for the striped cross-host transport
  // (stripe_transport.cc): header + payload slice in ONE sendmsg, no
  // staging copy and no frame length prefix — the stripe piece header
  // is the framing. Blocking; loops partial writes byte-precise.
  bool SendVec(const struct iovec* iov, int iovcnt);
  // One bounded read for the striped receive engine: drains the
  // internal buffer first (a hello's over-read must not strand bytes),
  // else a single recv — MSG_DONTWAIT when `nonblock`. Returns bytes
  // read (> 0), 0 when nonblocking and nothing is available, -1 on
  // error or orderly close.
  long RecvSome(void* p, size_t n, bool nonblock);
  // Timed receive for the liveness plane (docs/liveness.md): returns 1
  // with a complete frame, 0 on timeout (any partial frame stays buffered
  // — a later call resumes it byte-exact), -1 when the peer closed or the
  // socket errored. timeout_ms = 0 polls without blocking: it consumes
  // only frames already deliverable.
  int RecvFrameTimeout(std::string* payload, int timeout_ms);

  static Socket Connect(const std::string& host, int port,
                        int timeout_ms = 30000);

 private:
  bool SendAll(const void* p, size_t n);
  // Buffered receive: exactly n bytes into p, reading through rbuf_.
  // Single-reader per socket (every frame consumer is one thread).
  bool RecvAll(void* p, size_t n);
  int fd_ = -1;
  std::vector<char> rbuf_;
  size_t rpos_ = 0;
};

class Listener {
 public:
  // Binds on all interfaces; port 0 picks an ephemeral port.
  bool Listen(int port);
  int port() const { return port_; }
  Socket Accept(int timeout_ms = 30000);
  void Close();
  ~Listener();

 private:
  int fd_ = -1;
  int port_ = 0;
};

}  // namespace hvd

#endif  // HVD_SOCKET_H_
