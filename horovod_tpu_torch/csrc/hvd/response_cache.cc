#include "response_cache.h"

#include <cstdio>
#include <cstring>

namespace {
// Bit-exact key text for a double: std::to_string's fixed 6 decimals would
// collide distinct small scale factors and replay stale cached responses.
std::string DoubleKey(double v) {
  uint64_t b;
  std::memcpy(&b, &v, 8);
  char buf[17];
  std::snprintf(buf, sizeof(buf), "%016llx",
                static_cast<unsigned long long>(b));
  return std::string(buf);
}
}  // namespace

namespace hvd {

const uint32_t ResponseCache::kInvalid;

std::string ResponseCache::Key(const Request& req) {
  std::string k = req.name;
  k += '\x1f';
  k += std::to_string(static_cast<int>(req.op));
  k += '/';
  k += std::to_string(static_cast<int>(req.reduce_op));
  k += '/';
  k += std::to_string(static_cast<int>(req.dtype));
  k += '/';
  k += std::to_string(static_cast<int>(req.plane));
  k += '/';
  k += std::to_string(req.root_rank);
  k += '/';
  for (auto d : req.shape.dims()) {
    k += std::to_string(d);
    k += ',';
  }
  k += DoubleKey(req.prescale);
  k += '/';
  k += DoubleKey(req.postscale);
  // Per-chip dims are part of the identity: cached entries are rebuilt
  // from responses (CacheResponses) with chip_dims empty, so a request
  // that carries a multi-chip dim list must never replay such an entry —
  // the rebuilt request would publish a wrong per-chip dim table.
  // Multi-chip-per-process allgathers therefore always take the full
  // negotiation path; single-chip worlds keep their cache hits (a
  // single-entry chip list only matches when it equals shape.dim(0),
  // which is exactly the value the rebuilt entry would publish).
  if (!(req.chip_dims.size() == 1 &&
        req.shape.ndim() > 0 && req.chip_dims[0] == req.shape.dim(0))) {
    for (auto d : req.chip_dims) {
      k += '/';
      k += std::to_string(d);
    }
  }
  return k;
}

uint32_t ResponseCache::Lookup(const Request& req) {
  MutexLock lk(mu_);
  auto it = by_key_.find(Key(req));
  if (it == by_key_.end()) return kInvalid;
  // No recency refresh: eviction must stay deterministic across ranks
  // (see header comment).
  return it->second.id;
}

uint32_t ResponseCache::Put(const Request& req) {
  MutexLock lk(mu_);
  std::string key = Key(req);
  auto it = by_key_.find(key);
  if (it != by_key_.end()) return it->second.id;
  if (by_key_.size() >= capacity_ && !lru_.empty()) {
    uint32_t victim = lru_.back();
    lru_.pop_back();
    auto kit = by_id_.find(victim);
    if (kit != by_id_.end()) {
      by_key_.erase(kit->second);
      by_id_.erase(kit);
    }
  }
  uint32_t id = next_id_++;
  lru_.push_front(id);
  Entry e{id, req, lru_.begin()};
  by_key_.emplace(key, std::move(e));
  by_id_.emplace(id, std::move(key));
  return id;
}

bool ResponseCache::Get(uint32_t id, Request* out) {
  MutexLock lk(mu_);
  auto it = by_id_.find(id);
  if (it == by_id_.end()) return false;
  auto e = by_key_.find(it->second);
  if (e == by_key_.end()) return false;
  *out = e->second.req;
  return true;
}

void ResponseCache::Erase(const std::string& name) {
  MutexLock lk(mu_);
  for (auto it = by_key_.begin(); it != by_key_.end();) {
    if (it->second.req.name == name) {
      by_id_.erase(it->second.id);
      lru_.erase(it->second.lru_it);
      it = by_key_.erase(it);
    } else {
      ++it;
    }
  }
}

void ResponseCache::Clear() {
  MutexLock lk(mu_);
  by_key_.clear();
  by_id_.clear();
  lru_.clear();
}

size_t ResponseCache::size() {
  MutexLock lk(mu_);
  return by_key_.size();
}

}  // namespace hvd
