// extern "C" surface of the embedding cache, consumed via ctypes by
// hetu_tpu/cstable.py (reference: pybind11 module defined in
// src/hetu_cache/src/python_api.cc, consumed by python/hetu/cstable.py).
//
// Handles are opaque pointers; async ops return tickets redeemed by
// CacheWait. Compiled into libhetu_ps.so so the cache shares the process's
// PS worker agent (the reference links hetu_cache against ps-lite the same
// way).

#include <cstring>
#include <sstream>
#include <string>

#include "cache/cache.h"

namespace hetups {
PsWorker* global_worker();  // defined in ps/capi.cc
}

namespace {
thread_local std::string t_cache_error;
}

extern "C" {

const char* CacheLastError() {
  static thread_local std::string report;
  report = t_cache_error;
  t_cache_error.clear();
  return report.c_str();
}

// policy: 0=LRU 1=LFU 2=LFUOpt
void* CacheCreate(int policy, long limit, long length, long width,
                  int node_id) {
  try {
    hetups::PsWorker* ps = hetups::global_worker();
    if (!ps) throw std::runtime_error("cache requires a PS worker (Init first)");
    switch (policy) {
      case 0:
        return new hetucache::LRUCache(limit, length, width, node_id, ps);
      case 1:
        return new hetucache::LFUCache(limit, length, width, node_id, ps);
      case 2:
        return new hetucache::LFUOptCache(limit, length, width, node_id, ps);
      default:
        throw std::runtime_error("unknown cache policy " +
                                 std::to_string(policy));
    }
  } catch (const std::exception& e) {
    t_cache_error = e.what();
    return nullptr;
  }
}

void CacheDestroy(void* h) {
  delete static_cast<hetucache::CacheBase*>(h);
}

void CacheSetBounds(void* h, long pull_bound, long push_bound) {
  auto* c = static_cast<hetucache::CacheBase*>(h);
  c->pull_bound = pull_bound;
  c->push_bound = push_bound;
}

long CacheEmbeddingLookup(void* h, const unsigned long long* keys, long n,
                          float* dest) {
  return static_cast<hetucache::CacheBase*>(h)->lookup_async(
      reinterpret_cast<const hetucache::cache_key_t*>(keys),
      static_cast<size_t>(n), dest);
}

long CacheEmbeddingUpdate(void* h, const unsigned long long* keys,
                          const float* grads, long n) {
  return static_cast<hetucache::CacheBase*>(h)->update_async(
      reinterpret_cast<const hetucache::cache_key_t*>(keys), grads,
      static_cast<size_t>(n));
}

long CacheEmbeddingPushPull(void* h, const unsigned long long* pull_keys,
                            long n_pull, float* dest,
                            const unsigned long long* push_keys,
                            const float* grads, long n_push) {
  return static_cast<hetucache::CacheBase*>(h)->push_pull_async(
      reinterpret_cast<const hetucache::cache_key_t*>(pull_keys),
      static_cast<size_t>(n_pull), dest,
      reinterpret_cast<const hetucache::cache_key_t*>(push_keys), grads,
      static_cast<size_t>(n_push));
}

// returns 0 on success, sets CacheLastError otherwise
int CacheWait(void* h, long ticket) {
  std::string err = static_cast<hetucache::CacheBase*>(h)->wait(ticket);
  if (err.empty()) return 0;
  t_cache_error = err;
  return -1;
}

long CacheSize(void* h) {
  auto* c = static_cast<hetucache::CacheBase*>(h);
  std::lock_guard<std::mutex> g(c->mtx);
  return static_cast<long>(c->size());
}

long CacheLimit(void* h) {
  return static_cast<long>(static_cast<hetucache::CacheBase*>(h)->limit());
}

void CacheBypass(void* h, int enable) {
  static_cast<hetucache::CacheBase*>(h)->set_bypass(enable != 0);
}

// enable: 0 = off, 1 = full per-batch log + rollup (the reference perf
// surface), 2 = rollup-only (bounded memory; what telemetry arms)
void CachePerfEnabled(void* h, int enable) {
  auto* c = static_cast<hetucache::CacheBase*>(h);
  c->set_perf_enabled(enable != 0);
  c->set_perf_log(enable != 2);
}

// O(1) cumulative perf rollup: fills up to n of [batches, evictions,
// pull_miss, pull_uniq, transfered, num_all] — the telemetry poll's
// cheap alternative to re-serializing the whole per-batch log below
void CachePerfRollup(void* h, long long* out, int n) {
  auto v = static_cast<hetucache::CacheBase*>(h)->perf_rollup();
  for (int i = 0; i < n && i < static_cast<int>(v.size()); ++i) out[i] = v[i];
}

// JSON array of per-batch perf dicts (reference cstable.py perf property)
const char* CachePerfJson(void* h) {
  static thread_local std::string out;
  auto perf = static_cast<hetucache::CacheBase*>(h)->perf();
  std::ostringstream os;
  os << "[";
  for (size_t i = 0; i < perf.size(); ++i) {
    const auto& p = perf[i];
    if (i) os << ",";
    os << "{\"type\":\"" << p.type << "\",\"is_full\":"
       << (p.is_full ? "true" : "false") << ",\"num_all\":" << p.num_all
       << ",\"num_unique\":" << p.num_unique << ",\"num_miss\":" << p.num_miss
       << ",\"num_evict\":" << p.num_evict
       << ",\"num_transfered\":" << p.num_transfered
       << ",\"time\":" << p.time_ms << "}";
  }
  os << "]";
  out = os.str();
  return out.c_str();
}

int CacheCount(void* h, unsigned long long key) {
  auto* c = static_cast<hetucache::CacheBase*>(h);
  std::lock_guard<std::mutex> g(c->mtx);
  return c->count(key);
}

// returns 1 if present; fills out/version/updates (each nullable)
int CacheLookupOne(void* h, unsigned long long key, float* out, long* version,
                   long* updates) {
  hetucache::version_t v, u;
  bool found = static_cast<hetucache::CacheBase*>(h)->lookup_one(key, out, &v,
                                                                &u);
  if (!found) return 0;
  if (version) *version = v;
  if (updates) *updates = u;
  return 1;
}

void CacheInsertOne(void* h, unsigned long long key, const float* data) {
  static_cast<hetucache::CacheBase*>(h)->insert_one(key, data);
}

// fills up to cap keys, returns the total count
long CacheKeys(void* h, unsigned long long* out, long cap) {
  auto* c = static_cast<hetucache::CacheBase*>(h);
  std::lock_guard<std::mutex> g(c->mtx);
  auto ks = c->keys();
  long n = static_cast<long>(ks.size());
  for (long i = 0; i < n && i < cap; ++i) out[i] = ks[i];
  return n;
}

const char* CacheRepr(void* h) {
  static thread_local std::string out;
  out = static_cast<hetucache::CacheBase*>(h)->repr();
  return out.c_str();
}

}  // extern "C"
