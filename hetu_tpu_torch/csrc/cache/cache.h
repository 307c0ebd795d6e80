// Client-side embedding cache with bounded staleness.
//
// Capability parity with the reference's src/hetu_cache (~1.2k LoC C++):
//  - versioned cache lines: data value, locally-accumulated grad, version
//    (-1 = never synced), update count (include/embedding.h:19-40)
//  - eviction policies LRU / LFU / LFUOpt (src/{lru,lfu,lfuopt}_cache.cc);
//    LFUOpt promotes lines that reach a frequency cap into a permanent store
//  - batched, deduplicated lookup/update; dirty evicted lines are buffered
//    and flushed with the next push (src/cache.cc:140-166)
//  - bounded-staleness sync protocol with the PS server: lookups pull only
//    rows the server has advanced more than `pull_bound` updates past the
//    local version; updates push only rows with more than `push_bound` local
//    updates (src/hetu_client.cc, ps-lite cachetable.h)
//  - async API: ops run on the cache's worker thread and return tickets;
//    perf counters per batch (num_all/num_unique/num_miss/num_evict/
//    num_transfered/time — cstable.py:126-187)
//
// Redesigned: no pybind11 (ctypes C API instead), one worker thread per cache
// (ops on one cache serialize anyway under the reference's mutex), and the
// transport is the hetups::PsWorker agent rather than ps-lite.
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <thread>
#include <unordered_map>
#include <vector>

#include "ps/worker.h"

namespace hetucache {

using cache_key_t = uint64_t;
using version_t = int64_t;

// One cached embedding row (reference Line<T>, embedding.h:19).
struct Line {
  cache_key_t key;
  version_t version = -1;  // -1: never synced with the server
  version_t updates = 0;   // local updates not yet pushed
  std::vector<float> data;
  std::vector<float> grad;
  bool has_data = true;

  Line(cache_key_t k, size_t width, bool init_data = true)
      : key(k), has_data(init_data) {
    if (init_data) data.assign(width, 0.0f);
  }

  void accumulate(const float* g, size_t width) {
    if (grad.empty()) grad.assign(width, 0.0f);
    for (size_t i = 0; i < width; ++i) grad[i] += g[i];
    if (has_data)
      for (size_t i = 0; i < width; ++i) data[i] += g[i];
    ++updates;
  }

  // re-apply unpushed local grads after the server value overwrote data
  void addup() {
    if (!grad.empty())
      for (size_t i = 0; i < data.size(); ++i) data[i] += grad[i];
  }

  void zero_grad() {
    std::fill(grad.begin(), grad.end(), 0.0f);
    updates = 0;
  }
};

using LinePtr = std::shared_ptr<Line>;

struct PerfRecord {
  const char* type;  // "Pull" or "Push"
  bool is_full;
  size_t num_all, num_unique, num_miss, num_evict, num_transfered;
  double time_ms;
};

class CacheBase {
 public:
  CacheBase(size_t limit, size_t length, size_t width, int node_id,
            hetups::PsWorker* ps)
      : limit_(limit), len_(length), width_(width), node_id_(node_id),
        ps_(ps) {
    worker_ = std::thread([this] { loop(); });
  }

  virtual ~CacheBase() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> g(qmu_);
      if (stopping_) return;
      stopping_ = true;
    }
    qcv_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  size_t limit() const { return limit_; }
  size_t width() const { return width_; }
  version_t pull_bound = 100;
  version_t push_bound = 100;

  void set_bypass(bool v) { bypass_ = v; }
  void set_perf_enabled(bool v) { perf_enabled_ = v; }
  // rollup-only mode: keep the O(1) counters but skip the per-batch
  // perf_ append — the telemetry poll arms THIS for long runs, where an
  // unbounded record vector would grow for the life of the process
  void set_perf_log(bool v) { perf_log_ = v; }

  // -- policy interface --------------------------------------------------
  virtual size_t size() = 0;
  virtual int count(cache_key_t k) = 0;
  virtual void insert(LinePtr e) = 0;
  virtual LinePtr lookup(cache_key_t k) = 0;
  virtual std::vector<cache_key_t> keys() = 0;

  // -- async API: enqueue, get a ticket; wait(ticket) joins --------------
  using ticket_t = int64_t;

  // INPUT buffers (keys, grads) are COPIED at enqueue time: callers may
  // free them immediately, ticket kept or not — a fire-and-forget
  // update_async must never read a buffer the caller has released (the
  // use-after-free shows up as astronomically large "gradients" pushed to
  // the server under concurrency). OUTPUT buffers (lookup dest) inherently
  // must outlive the op — the result lands there; wait() before reading.

  ticket_t lookup_async(const cache_key_t* keys, size_t n, float* dest) {
    std::vector<cache_key_t> k(keys, keys + n);
    return enqueue([this, k = std::move(k), n, dest] {
      do_lookup(k.data(), n, dest);
    });
  }

  ticket_t update_async(const cache_key_t* keys, const float* grads,
                        size_t n) {
    std::vector<cache_key_t> k(keys, keys + n);
    std::vector<float> g(grads, grads + n * width_);
    return enqueue([this, k = std::move(k), g = std::move(g), n] {
      do_update(k.data(), n, g.data());
    });
  }

  ticket_t push_pull_async(const cache_key_t* pull_keys, size_t n_pull,
                           float* dest, const cache_key_t* push_keys,
                           const float* grads, size_t n_push) {
    std::vector<cache_key_t> pk(pull_keys, pull_keys + n_pull);
    std::vector<cache_key_t> uk(push_keys, push_keys + n_push);
    std::vector<float> g(grads, grads + n_push * width_);
    return enqueue([this, pk = std::move(pk), uk = std::move(uk),
                    g = std::move(g), n_pull, dest, n_push] {
      do_push_pull(pk.data(), n_pull, dest, uk.data(), g.data(), n_push);
    });
  }

  // Returns empty string on success, the error message otherwise.
  std::string wait(ticket_t t) {
    std::unique_lock<std::mutex> g(qmu_);
    done_cv_.wait(g, [&] { return completed_ >= t; });
    auto it = errors_.find(t);
    if (it == errors_.end()) return "";
    std::string e = it->second;
    errors_.erase(it);
    return e;
  }

  // -- single-key debug API (reference cstable.py:150-161) ---------------
  std::mutex mtx;  // guards the policy structures

  bool lookup_one(cache_key_t k, float* out, version_t* version,
                  version_t* updates) {
    std::lock_guard<std::mutex> g(mtx);
    LinePtr p = lookup(k);
    if (!p) return false;
    if (out && p->has_data) std::memcpy(out, p->data.data(), width_ * 4);
    if (version) *version = p->version;
    if (updates) *updates = p->updates;
    return true;
  }

  void insert_one(cache_key_t k, const float* data) {
    auto line = std::make_shared<Line>(k, width_);
    std::memcpy(line->data.data(), data, width_ * 4);
    line->version = 0;
    std::lock_guard<std::mutex> g(mtx);
    insert(line);
  }

  std::vector<PerfRecord> perf() {
    std::lock_guard<std::mutex> g(perf_mu_);
    return perf_;
  }

  // O(1) cumulative rollup maintained alongside the per-batch log:
  // [batches, evictions, pull_miss, pull_uniq, transfered, num_all].
  // The telemetry poll reads THIS every N steps — re-serializing the
  // whole perf_ vector as JSON would cost O(batches) per poll.
  std::vector<long long> perf_rollup() {
    std::lock_guard<std::mutex> g(perf_mu_);
    return {rollup_batches_, rollup_evictions_, rollup_pull_miss_,
            rollup_pull_uniq_, rollup_transfered_, rollup_num_all_};
  }

  std::string repr() {
    std::ostringstream os;
    os << "<hetu_tpu.CacheSparseTable limit=" << limit_ << " size=" << size()
       << " width=" << width_ << " node=" << node_id_ << ">";
    return os.str();
  }

 protected:
  // -- batched core (runs on the cache worker thread) --------------------
  struct Uniqued {
    std::vector<cache_key_t> uniq;
    std::vector<size_t> inv;  // original slot -> uniq slot
  };

  static Uniqued unique_keys(const cache_key_t* keys, size_t n) {
    Uniqued u;
    u.inv.resize(n);
    std::unordered_map<cache_key_t, size_t> first;
    first.reserve(n * 2);
    for (size_t i = 0; i < n; ++i) {
      auto it = first.find(keys[i]);
      if (it == first.end()) {
        first.emplace(keys[i], u.uniq.size());
        u.inv[i] = u.uniq.size();
        u.uniq.push_back(keys[i]);
      } else {
        u.inv[i] = it->second;
      }
    }
    return u;
  }

  std::vector<LinePtr> batched_lookup(const std::vector<cache_key_t>& ks) {
    std::lock_guard<std::mutex> g(mtx);
    std::vector<LinePtr> out(ks.size());
    if (bypass_) return out;
    for (size_t i = 0; i < ks.size(); ++i) out[i] = lookup(ks[i]);
    return out;
  }

  void batched_insert(std::vector<LinePtr>& lines) {
    std::lock_guard<std::mutex> g(mtx);
    if (bypass_) return;
    for (auto& l : lines) insert(l);
  }

  // Pull path (reference cache.cc:60-110 _embeddingLookup).
  void do_lookup(const cache_key_t* keys, size_t n, float* dest) {
    auto t0 = std::chrono::steady_clock::now();
    auto u = unique_keys(keys, n);
    auto lines = batched_lookup(u.uniq);
    std::vector<LinePtr> should_insert;
    for (size_t i = 0; i < u.uniq.size(); ++i) {
      if (!lines[i]) {
        lines[i] = std::make_shared<Line>(u.uniq[i], width_);
        should_insert.push_back(lines[i]);
      }
    }
    // bounded-staleness sync: server returns only stale/never-seen rows
    std::vector<int64_t> vers(lines.size());
    for (size_t i = 0; i < lines.size(); ++i) vers[i] = lines[i]->version;
    std::vector<size_t> pos;
    std::vector<float> rows;
    std::vector<int64_t> new_vers;
    ps_->sync_embedding(node_id_, u.uniq.data(), vers.data(), u.uniq.size(),
                        pull_bound, &pos, &rows, &new_vers);
    for (size_t i = 0; i < pos.size(); ++i) {
      LinePtr& l = lines[pos[i]];
      l->version = new_vers[i];
      std::memcpy(l->data.data(), rows.data() + i * width_, width_ * 4);
      l->addup();
    }
    for (size_t i = 0; i < n; ++i)
      std::memcpy(dest + i * width_, lines[u.inv[i]]->data.data(),
                  width_ * 4);
    batched_insert(should_insert);
    if (perf_enabled_) {
      auto t1 = std::chrono::steady_clock::now();
      note_perf({"Pull", size() == limit_, n, u.uniq.size(),
                 should_insert.size(), 0, pos.size(),
                 std::chrono::duration<double, std::milli>(t1 - t0)
                     .count()});
    }
  }

  // Push path (reference cache.cc:131-197 _embeddingUpdate).
  void do_update(const cache_key_t* keys, size_t n, const float* grads) {
    auto t0 = std::chrono::steady_clock::now();
    auto u = unique_keys(keys, n);
    auto lines = batched_lookup(u.uniq);
    size_t miss = 0;
    std::vector<LinePtr> evicted;
    {
      std::lock_guard<std::mutex> g(mtx);
      evicted = std::move(evict_);
      evict_.clear();
    }
    for (size_t i = 0; i < n; ++i) {
      LinePtr& l = lines[u.inv[i]];
      if (!l) {
        // grad-only line: value unknown locally, must push
        l = std::make_shared<Line>(u.uniq[u.inv[i]], width_, false);
        ++miss;
      }
      l->accumulate(grads + i * width_, width_);
    }
    // rows over the push bound (or with no local value) + dirty evictions
    std::vector<LinePtr> should_push;
    for (auto& l : evicted) should_push.push_back(l);
    for (auto& l : lines)
      if (l->updates > push_bound || !l->has_data) should_push.push_back(l);
    if (!should_push.empty()) {
      std::vector<cache_key_t> pkeys(should_push.size());
      std::vector<float> pgrads(should_push.size() * width_);
      std::vector<int64_t> pups(should_push.size());
      for (size_t i = 0; i < should_push.size(); ++i) {
        pkeys[i] = should_push[i]->key;
        pups[i] = should_push[i]->updates;
        if (!should_push[i]->grad.empty())
          std::memcpy(pgrads.data() + i * width_,
                      should_push[i]->grad.data(), width_ * 4);
      }
      ps_->push_embedding(node_id_, pkeys.data(), pgrads.data(), pups.data(),
                          pkeys.size());
      // pushed lines that stay cached advance their version by their own
      // update count (the server did the same) and reset local grads
      for (auto& l : should_push) {
        if (l->has_data) {
          l->version += l->updates;
          l->zero_grad();
        }
      }
    }
    if (perf_enabled_) {
      auto t1 = std::chrono::steady_clock::now();
      note_perf({"Push", size() == limit_, n, u.uniq.size(), miss,
                 evicted.size(), should_push.size(),
                 std::chrono::duration<double, std::milli>(t1 - t0)
                     .count()});
    }
  }

  // Combined path (reference cache.cc _embeddingPushPull): accumulate the
  // push grads, then ONE kPushSyncEmbedding RPC per server applies the
  // over-bound pushes and returns the stale pull rows.
  void do_push_pull(const cache_key_t* pull_keys, size_t n_pull, float* dest,
                    const cache_key_t* push_keys, const float* grads,
                    size_t n_push) {
    auto t0 = std::chrono::steady_clock::now();
    // push side: accumulate into cached lines
    auto up = unique_keys(push_keys, n_push);
    auto push_lines = batched_lookup(up.uniq);
    std::vector<LinePtr> evicted;
    {
      std::lock_guard<std::mutex> g(mtx);
      evicted = std::move(evict_);
      evict_.clear();
    }
    size_t miss = 0;
    for (size_t i = 0; i < n_push; ++i) {
      LinePtr& l = push_lines[up.inv[i]];
      if (!l) {
        l = std::make_shared<Line>(up.uniq[up.inv[i]], width_, false);
        ++miss;
      }
      l->accumulate(grads + i * width_, width_);
    }
    std::vector<LinePtr> should_push;
    for (auto& l : evicted) should_push.push_back(l);
    for (auto& l : push_lines)
      if (l->updates > push_bound || !l->has_data) should_push.push_back(l);

    // pull side: cached lines + fresh lines for misses
    auto uq = unique_keys(pull_keys, n_pull);
    auto lines = batched_lookup(uq.uniq);
    std::vector<LinePtr> should_insert;
    for (size_t i = 0; i < uq.uniq.size(); ++i) {
      if (!lines[i]) {
        lines[i] = std::make_shared<Line>(uq.uniq[i], width_);
        should_insert.push_back(lines[i]);
      }
    }
    std::vector<int64_t> vers(lines.size());
    for (size_t i = 0; i < lines.size(); ++i) vers[i] = lines[i]->version;

    // one combined RPC per server
    std::vector<cache_key_t> pkeys(should_push.size());
    std::vector<float> pgrads(should_push.size() * width_, 0.0f);
    std::vector<int64_t> pups(should_push.size());
    for (size_t i = 0; i < should_push.size(); ++i) {
      pkeys[i] = should_push[i]->key;
      pups[i] = should_push[i]->updates;
      if (!should_push[i]->grad.empty())
        std::memcpy(pgrads.data() + i * width_, should_push[i]->grad.data(),
                    width_ * 4);
    }
    std::vector<size_t> pos;
    std::vector<float> rows;
    std::vector<int64_t> new_vers;
    ps_->push_sync_embedding(node_id_, pkeys.data(), pgrads.data(),
                             pups.data(), pkeys.size(), uq.uniq.data(),
                             vers.data(), uq.uniq.size(), pull_bound, &pos,
                             &rows, &new_vers);
    for (auto& l : should_push) {
      if (l->has_data) {
        l->version += l->updates;
        l->zero_grad();
      }
    }
    for (size_t i = 0; i < pos.size(); ++i) {
      LinePtr& l = lines[pos[i]];
      l->version = new_vers[i];
      std::memcpy(l->data.data(), rows.data() + i * width_, width_ * 4);
      l->addup();
    }
    for (size_t i = 0; i < n_pull; ++i)
      std::memcpy(dest + i * width_, lines[uq.inv[i]]->data.data(),
                  width_ * 4);
    batched_insert(should_insert);
    if (perf_enabled_) {
      auto t1 = std::chrono::steady_clock::now();
      note_perf({"Push", size() == limit_, n_push, up.uniq.size(), miss,
                 evicted.size(), should_push.size(),
                 std::chrono::duration<double, std::milli>(t1 - t0)
                     .count()});
      note_perf({"Pull", size() == limit_, n_pull, uq.uniq.size(),
                 should_insert.size(), 0, pos.size(), 0.0});
    }
  }

  ticket_t enqueue(std::function<void()> f) {
    std::lock_guard<std::mutex> g(qmu_);
    ticket_t t = ++next_ticket_;
    q_.push_back({t, std::move(f)});
    qcv_.notify_one();
    return t;
  }

  void loop() {
    for (;;) {
      std::pair<ticket_t, std::function<void()>> item;
      {
        std::unique_lock<std::mutex> g(qmu_);
        qcv_.wait(g, [this] { return stopping_ || !q_.empty(); });
        if (q_.empty()) {
          if (stopping_) return;
          continue;
        }
        item = std::move(q_.front());
        q_.pop_front();
      }
      try {
        item.second();
      } catch (const std::exception& e) {
        std::lock_guard<std::mutex> g(qmu_);
        errors_[item.first] = e.what();
      }
      {
        std::lock_guard<std::mutex> g(qmu_);
        completed_ = item.first;
      }
      done_cv_.notify_all();
    }
  }

  size_t limit_, len_, width_;
  int node_id_;
  hetups::PsWorker* ps_;
  bool bypass_ = false;
  bool perf_enabled_ = false;
  bool perf_log_ = true;   // per-batch records (the reference perf surface)
  std::vector<LinePtr> evict_;  // dirty evicted lines awaiting flush

  std::mutex perf_mu_;
  std::vector<PerfRecord> perf_;
  long long rollup_batches_ = 0, rollup_evictions_ = 0,
            rollup_pull_miss_ = 0, rollup_pull_uniq_ = 0,
            rollup_transfered_ = 0, rollup_num_all_ = 0;

  // single entry point for perf accounting: appends the per-batch record
  // AND folds it into the rollup counters under one lock acquisition
  void note_perf(PerfRecord r) {
    std::lock_guard<std::mutex> g(perf_mu_);
    rollup_batches_++;
    rollup_evictions_ += static_cast<long long>(r.num_evict);
    if (r.type[2] == 'l') {  // "Pull" (vs "Push")
      rollup_pull_miss_ += static_cast<long long>(r.num_miss);
      rollup_pull_uniq_ += static_cast<long long>(r.num_unique);
    }
    rollup_transfered_ += static_cast<long long>(r.num_transfered);
    rollup_num_all_ += static_cast<long long>(r.num_all);
    if (perf_log_) perf_.push_back(r);
  }

  std::thread worker_;
  std::mutex qmu_;
  std::condition_variable qcv_, done_cv_;
  std::deque<std::pair<ticket_t, std::function<void()>>> q_;
  std::unordered_map<ticket_t, std::string> errors_;
  ticket_t next_ticket_ = 0;
  ticket_t completed_ = 0;
  bool stopping_ = false;
};

// ---------------------------------------------------------------------------
// LRU: hash + recency list (reference lru_cache.cc).
// ---------------------------------------------------------------------------
class LRUCache : public CacheBase {
 public:
  using CacheBase::CacheBase;
  ~LRUCache() override { stop(); }  // join worker before members/vtable die

  size_t size() override { return map_.size(); }
  int count(cache_key_t k) override { return map_.count(k); }

  void insert(LinePtr e) override {
    auto it = map_.find(e->key);
    if (it != map_.end()) list_.erase(it->second);
    list_.push_front(e);
    map_[e->key] = list_.begin();
    if (map_.size() > limit_) {
      LinePtr victim = list_.back();
      map_.erase(victim->key);
      list_.pop_back();
      if (victim->updates != 0) evict_.push_back(victim);
    }
  }

  LinePtr lookup(cache_key_t k) override {
    auto it = map_.find(k);
    if (it == map_.end()) return nullptr;
    LinePtr e = *it->second;
    list_.erase(it->second);
    list_.push_front(e);
    map_[k] = list_.begin();
    return e;
  }

  std::vector<cache_key_t> keys() override {
    std::vector<cache_key_t> out;
    for (auto& kv : map_) out.push_back(kv.first);
    std::sort(out.begin(), out.end());
    return out;
  }

 private:
  std::list<LinePtr> list_;  // front = most recent
  std::unordered_map<cache_key_t, std::list<LinePtr>::iterator> map_;
};

// ---------------------------------------------------------------------------
// LFU: frequency buckets, each an LRU list (reference lfu_cache.cc).
// Evicts from the lowest-frequency bucket's tail.
// ---------------------------------------------------------------------------
class LFUCache : public CacheBase {
 public:
  using CacheBase::CacheBase;
  ~LFUCache() override { stop(); }

  size_t size() override { return map_.size(); }
  int count(cache_key_t k) override { return map_.count(k); }

  void insert(LinePtr e) override {
    auto it = map_.find(e->key);
    if (it != map_.end()) {
      it->second.second->ptr = e;
      touch(it);
      return;
    }
    if (map_.size() >= limit_) evict_one();
    auto& bucket = buckets_[1];
    bucket.push_front({e, 1});
    map_[e->key] = {1, bucket.begin()};
  }

  LinePtr lookup(cache_key_t k) override {
    auto it = map_.find(k);
    if (it == map_.end()) return nullptr;
    LinePtr e = it->second.second->ptr;
    touch(it);
    return e;
  }

  std::vector<cache_key_t> keys() override {
    std::vector<cache_key_t> out;
    for (auto& kv : map_) out.push_back(kv.first);
    std::sort(out.begin(), out.end());
    return out;
  }

 private:
  struct Block {
    LinePtr ptr;
    size_t freq;
  };
  using Bucket = std::list<Block>;
  // freq -> bucket; std::map so begin() is the lowest frequency
  std::map<size_t, Bucket> buckets_;
  std::unordered_map<cache_key_t, std::pair<size_t, Bucket::iterator>> map_;

  void touch(decltype(map_)::iterator it) {
    auto [freq, bit] = it->second;
    LinePtr e = bit->ptr;
    buckets_[freq].erase(bit);
    if (buckets_[freq].empty()) buckets_.erase(freq);
    auto& nb = buckets_[freq + 1];
    nb.push_front({e, freq + 1});
    it->second = {freq + 1, nb.begin()};
  }

  void evict_one() {
    if (buckets_.empty()) return;
    auto& [freq, bucket] = *buckets_.begin();
    LinePtr victim = bucket.back().ptr;
    bucket.pop_back();
    map_.erase(victim->key);
    if (victim->updates != 0) evict_.push_back(victim);
    if (bucket.empty()) buckets_.erase(buckets_.begin());
  }
};

// ---------------------------------------------------------------------------
// LFUOpt: LFU with a frequency cap; lines that reach the cap are promoted to
// a permanent store exempt from eviction (reference lfuopt_cache.cc).
// ---------------------------------------------------------------------------
class LFUOptCache : public CacheBase {
 public:
  using CacheBase::CacheBase;
  ~LFUOptCache() override { stop(); }
  static constexpr size_t kUseCntMax = 10;

  size_t size() override { return map_.size() + store_.size(); }
  int count(cache_key_t k) override {
    return map_.count(k) + store_.count(k);
  }

  void insert(LinePtr e) override {
    if (store_.count(e->key)) {
      store_[e->key] = e;
      return;
    }
    auto it = map_.find(e->key);
    if (it != map_.end()) {
      it->second.second->ptr = e;
      return;
    }
    if (size() >= limit_) {
      if (!map_.empty())
        evict_one();
      else
        return;  // everything is permanent: drop the insert
    }
    auto& bucket = buckets_[1];
    bucket.push_front({e, 1});
    map_[e->key] = {1, bucket.begin()};
  }

  LinePtr lookup(cache_key_t k) override {
    auto sit = store_.find(k);
    if (sit != store_.end()) return sit->second;
    auto it = map_.find(k);
    if (it == map_.end()) return nullptr;
    LinePtr e = it->second.second->ptr;
    auto [freq, bit] = it->second;
    if (freq + 1 >= kUseCntMax) {
      // promote to the permanent store
      buckets_[freq].erase(bit);
      if (buckets_[freq].empty()) buckets_.erase(freq);
      map_.erase(it);
      store_[k] = e;
    } else {
      buckets_[freq].erase(bit);
      if (buckets_[freq].empty()) buckets_.erase(freq);
      auto& nb = buckets_[freq + 1];
      nb.push_front({e, freq + 1});
      map_[k] = {freq + 1, nb.begin()};
    }
    return e;
  }

  std::vector<cache_key_t> keys() override {
    std::vector<cache_key_t> out;
    for (auto& kv : store_) out.push_back(kv.first);
    for (auto& kv : map_) out.push_back(kv.first);
    std::sort(out.begin(), out.end());
    return out;
  }

 private:
  struct Block {
    LinePtr ptr;
    size_t freq;
  };
  using Bucket = std::list<Block>;
  std::map<size_t, Bucket> buckets_;
  std::unordered_map<cache_key_t, std::pair<size_t, Bucket::iterator>> map_;
  std::unordered_map<cache_key_t, LinePtr> store_;

  void evict_one() {
    if (buckets_.empty()) return;
    auto& [freq, bucket] = *buckets_.begin();
    LinePtr victim = bucket.back().ptr;
    bucket.pop_back();
    map_.erase(victim->key);
    if (victim->updates != 0) evict_.push_back(victim);
    if (bucket.empty()) buckets_.erase(buckets_.begin());
  }
};

}  // namespace hetucache
