// Response cache keyed by tensor name + parameters, FIFO eviction.
//
// Parity: reference response_cache.{h,cc} (response_cache.h:45-167). Role
// here: a repeat submission of an identical request is transmitted to the
// coordinator as a 4-byte cache id instead of a full serialized Request,
// and the coordinator can rebuild the Response without re-validation.
//
// Eviction is strict FIFO by insertion order — NOT LRU — deliberately:
// every rank inserts entries in the identical broadcast-response order
// (CacheResponses), so FIFO keeps cache contents bit-identical across all
// ranks with zero synchronization. That cross-rank agreement is what the
// reference buys with its per-cycle bitvector AND/OR
// (controller.cc:613-638); per-rank LRU refreshes would silently diverge
// the eviction order between workers and coordinator and drop requests.

#ifndef HVD_RESPONSE_CACHE_H_
#define HVD_RESPONSE_CACHE_H_

#include <cstdint>
#include <list>
#include <string>
#include <unordered_map>

#include "common.h"
#include "thread_annotations.h"

namespace hvd {

class ResponseCache {
 public:
  explicit ResponseCache(size_t capacity = 1024) : capacity_(capacity) {}

  static const uint32_t kInvalid = 0xFFFFFFFFu;

  // Returns the cache id for a request identical to a previously completed
  // one, or kInvalid.
  uint32_t Lookup(const Request& req) EXCLUDES(mu_);

  // Records a completed single-tensor request; returns its id.
  uint32_t Put(const Request& req) EXCLUDES(mu_);

  // Rebuilds the request for a cache id (coordinator side).
  bool Get(uint32_t id, Request* out) EXCLUDES(mu_);

  void Erase(const std::string& name) EXCLUDES(mu_);
  void Clear() EXCLUDES(mu_);
  size_t size() EXCLUDES(mu_);

 private:
  static std::string Key(const Request& req);

  struct Entry {
    uint32_t id;
    Request req;
    std::list<uint32_t>::iterator lru_it;
  };

  Mutex mu_;
  size_t capacity_;  // ctor-set, never written after; read under mu_
  uint32_t next_id_ GUARDED_BY(mu_) = 1;
  std::unordered_map<std::string, Entry> by_key_ GUARDED_BY(mu_);
  std::unordered_map<uint32_t, std::string> by_id_ GUARDED_BY(mu_);
  std::list<uint32_t> lru_ GUARDED_BY(mu_);  // front = most recent
};

}  // namespace hvd

#endif  // HVD_RESPONSE_CACHE_H_
