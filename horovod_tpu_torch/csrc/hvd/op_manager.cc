#include "op_manager.h"

#include <cstdio>
#include <cstdlib>
#include <iterator>

namespace hvd {

namespace {

// Control-frame grammar: "T<global backend id>", or the abort marker
// "TX" (strict mode: the sender could not place the transfer on any
// permitted backend, and the receiver must error instead of waiting
// forever). One frame per (leg, direction) negotiation plus one per
// mid-world fallthrough; tiny and off the counters (control, not
// payload).
constexpr const char kAbortFrame[] = "TX";

std::string CtlFrame(int backend_id) {
  return "T" + std::to_string(backend_id);
}

int ParseCtlFrame(const std::string& frame) {
  if (frame == kAbortFrame) return -1;
  if (frame.size() < 2 || frame[0] != 'T') return -1;
  char* end = nullptr;
  long v = std::strtol(frame.c_str() + 1, &end, 10);
  if (end == nullptr || *end != 0 || v < 0) return -1;
  return static_cast<int>(v);
}

}  // namespace

int OperationManager::RegisterBackend(TransportBackend* b) {
  backends_.push_back(b);
  return static_cast<int>(backends_.size()) - 1;
}

void OperationManager::RegisterForLeg(TransportLeg leg, int backend_id) {
  per_leg_[static_cast<int>(leg)].push_back(backend_id);
}

int OperationManager::AgreedSend(TransportLeg leg, int peer) const {
  auto it = agreed_send_.find({static_cast<int>(leg), peer});
  return it == agreed_send_.end() ? -1 : it->second;
}

const char* OperationManager::BackendName(int backend_id) const {
  if (backend_id < 0 || backend_id >= static_cast<int>(backends_.size())) {
    return "?";
  }
  return backends_[backend_id]->Name();
}

void OperationManager::ResetLeg(TransportLeg leg) {
  int l = static_cast<int>(leg);
  for (auto it = agreed_send_.begin(); it != agreed_send_.end();) {
    it = it->first.first == l ? agreed_send_.erase(it) : std::next(it);
  }
  for (auto it = agreed_recv_.begin(); it != agreed_recv_.end();) {
    it = it->first.first == l ? agreed_recv_.erase(it) : std::next(it);
  }
}

int OperationManager::Negotiate(TransportLeg leg, int peer, int below) {
  // First enabled backend for this leg that can reach the peer. `below`
  // bounds the search on a mid-world fallthrough: only backends AFTER
  // the abandoned one are candidates (priority is strict). A backend
  // whose fallthrough is disabled (HOROVOD_SHM_FALLBACK=0 /
  // HOROVOD_STRIPE_FALLBACK=0) turns its own failed Prepare into a hard
  // error, never a silent slide down the list.
  const auto& order = per_leg_[static_cast<int>(leg)];
  bool past = below < 0;
  for (int id : order) {
    if (!past) {
      past = id == below;
      continue;
    }
    TransportBackend* b = backends_[id];
    if (!b->Enabled()) continue;
    if (b->Prepare(peer)) return id;
    if (!b->FallthroughAllowed()) return -1;
  }
  return -1;
}

int OperationManager::AgreeSend(TransportLeg leg, int peer) {
  auto key = std::make_pair(static_cast<int>(leg), peer);
  auto it = agreed_send_.find(key);
  if (it != agreed_send_.end()) return it->second;
  int id = Negotiate(leg, peer, -1);
  if (id < 0) {
    // No permitted backend (strict mode + failed Prepare): tell the
    // receiver to error out too instead of waiting on a transfer that
    // will never start.
    ctl_.send(peer, kAbortFrame);
    return -1;
  }
  if (!ctl_.send(peer, CtlFrame(id))) return -1;
  agreed_send_[key] = id;
  return id;
}

int OperationManager::AgreeRecv(TransportLeg leg, int peer) {
  auto key = std::make_pair(static_cast<int>(leg), peer);
  auto it = agreed_recv_.find(key);
  if (it != agreed_recv_.end()) return it->second;
  std::string frame;
  if (!ctl_.recv(peer, &frame)) return -1;
  int id = ParseCtlFrame(frame);
  if (id < 0 || id >= static_cast<int>(backends_.size())) return -1;
  // Receiver-side setup (e.g. accepting the sender's stripe dials). A
  // failure here is hard: the sender already announced and is
  // committed, so there is no clean boundary to fall through at.
  if (!backends_[id]->PrepareRecv(peer)) return -1;
  agreed_recv_[key] = id;
  return id;
}

int OperationManager::Send(TransportLeg leg, int peer, const void* buf,
                           size_t nbytes) {
  int id = AgreeSend(leg, peer);
  if (id < 0) return -1;
  auto key = std::make_pair(static_cast<int>(leg), peer);
  while (true) {
    int rc = backends_[id]->Send(peer, buf, nbytes);
    if (rc == kTransportOk) return id;
    if (rc == kTransportError) return -1;
    if (!backends_[id]->FallthroughAllowed()) {
      // Strict mode: the backend already poisoned its channel, so a
      // receiver parked on it errors as well; nothing rides the
      // fallback.
      return -1;
    }
    // Soft failure: the backend poisoned its channel before returning,
    // so the receiver's Recv reports fell-through and reads the control
    // frame we send next — the lock-step switch.
    int next = Negotiate(leg, peer, id);
    if (next < 0) return -1;
    std::fprintf(stderr,
                 "[horovod_tpu] transport %s -> %s fallthrough for peer "
                 "%d (leg %d)\n",
                 BackendName(id), BackendName(next), peer,
                 static_cast<int>(leg));
    if (!ctl_.send(peer, CtlFrame(next))) return -1;
    agreed_send_[key] = next;
    id = next;
  }
}

int OperationManager::Recv(TransportLeg leg, int peer, void* buf,
                           size_t nbytes) {
  int id = AgreeRecv(leg, peer);
  if (id < 0) return -1;
  auto key = std::make_pair(static_cast<int>(leg), peer);
  while (true) {
    int rc = backends_[id]->Recv(peer, buf, nbytes);
    if (rc == kTransportOk) return id;
    if (rc == kTransportError || !backends_[id]->FallthroughAllowed()) {
      return -1;
    }
    // Sender abandoned this backend: its announcement frame is the next
    // thing on the control channel.
    std::string frame;
    if (!ctl_.recv(peer, &frame)) return -1;
    int next = ParseCtlFrame(frame);
    if (next < 0 || next >= static_cast<int>(backends_.size())) return -1;
    if (!backends_[next]->PrepareRecv(peer)) return -1;
    agreed_recv_[key] = next;
    id = next;
  }
}

}  // namespace hvd
