// Worker-side PS agent: key-range partitioning, async push/pull on a thread
// pool, per-tensor completion tracking.
//
// Capability parity with the reference's PSAgent/Worker
// (ps-lite/include/ps/worker/PSAgent.h: registerTensor key-range partitioning
// :104-122, dedup-by-key sparse push/pull :124-160; src/worker.cc: thread-pool
// push :27-36, rank-0 parameter_init + barrier :6-17) and the partitioner
// (include/ps/partitioner.h: dense average split, sparse row-wise split).
#pragma once

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <sstream>
#include <thread>
#include <unordered_map>
#include <vector>

#include "chaos.h"
#include "net.h"
#include "store.h"

namespace hetups {

class ThreadPool {
 public:
  explicit ThreadPool(size_t n) {
    for (size_t i = 0; i < n; ++i)
      threads_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() { shutdown(); }

  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> g(mu_);
      q_.push_back(std::move(f));
    }
    cv_.notify_one();
  }

  void shutdown() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (stop_) return;
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stop_ || !q_.empty(); });
        if (q_.empty()) {
          if (stop_) return;
          continue;
        }
        f = std::move(q_.front());
        q_.pop_front();
      }
      f();
    }
  }

  std::vector<std::thread> threads_;
  std::deque<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

// Tracks outstanding async operations per tensor id (reference Worker::wait
// per node_name) and per data-query id (wait_data).
class PendingTracker {
 public:
  void add(int32_t key, int n = 1) {
    std::lock_guard<std::mutex> g(mu_);
    pending_[key] += n;
  }
  void done(int32_t key) {
    std::lock_guard<std::mutex> g(mu_);
    if (--pending_[key] <= 0) cv_.notify_all();
  }
  void wait(int32_t key) {
    std::unique_lock<std::mutex> g(mu_);
    cv_.wait(g, [&] { return pending_[key] <= 0; });
    // surface async worker errors at the Wait() call site
    auto it = errors_.find(key);
    if (it != errors_.end()) {
      std::string e = it->second;
      errors_.erase(it);
      throw std::runtime_error(e);
    }
  }
  void fail(int32_t key, const std::string& what) {
    std::lock_guard<std::mutex> g(mu_);
    errors_[key] = what;
    if (--pending_[key] <= 0) cv_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::unordered_map<int32_t, int> pending_;
  std::unordered_map<int32_t, std::string> errors_;
};

struct TensorMeta {
  ParamKind kind = ParamKind::kDense;
  size_t len = 0;    // dense total length
  size_t rows = 0;   // sparse rows
  size_t width = 0;  // sparse width
};

class PsWorker {
 public:
  PsWorker(int rank, int num_workers, const std::string& sched_host,
           int sched_port, int n_threads = 4)
      : rank_(rank), num_workers_(num_workers), sched_host_(sched_host),
        sched_port_(sched_port), pool_(n_threads) {
    recv_timeout_ms_ = env_int_or("DMLC_PS_RECV_TIMEOUT_MS", 15000);
    max_retry_ = env_int_or("DMLC_PS_MAX_RETRY", 3);
    // hetutrail: client-side RPC spans into a bounded ring, drained by the
    // Python runtime (DrainTrailSpans) into trail-client-r<rank>.jsonl.
    // Armed by HETU_TRAIL_DIR like the server side; when off the rpc path
    // pays one relaxed atomic load and nothing else.
    if (const char* td = std::getenv("HETU_TRAIL_DIR"))
      trail_on_.store(td[0] != '\0');
    trail_cap_ = static_cast<size_t>(
        env_int_or("HETU_TRAIL_RING", 65536));
    // hetuq: quantize push/pull value payloads (ArgType::kQI8 — row-wise
    // int8 for sparse, kQuantWireBlock blocks for dense). Env default so a
    // bare PSClient inherits the run's knob; SetCommQuant overrides.
    if (const char* q = std::getenv("HETU_COMM_QUANT"))
      quant_ = (std::string(q) == "int8" || std::string(q) == "fp8" ||
                std::string(q) == "1");
    // opt-in failover: after the fast retries exhaust, block-with-deadline
    // for a replacement server to register instead of throwing (0 = off)
    failover_ms_ = env_int_or("DMLC_PS_FAILOVER_DEADLINE_MS", 0);
    failover_poll_ms_ = env_int_or("DMLC_PS_FAILOVER_POLL_MS", 500);
    // hetuchaos transport hardening (docs/FAULT_TOLERANCE.md): retries
    // back off exponentially with deterministic jitter instead of
    // hammering a struggling server in a tight loop, and an optional
    // per-RPC wall deadline bounds the whole retry phase (0 = the retry
    // count alone bounds it, the pre-chaos semantics).
    backoff_base_ms_ = env_int_or("DMLC_PS_BACKOFF_BASE_MS", 10);
    backoff_cap_ms_ = env_int_or("DMLC_PS_BACKOFF_CAP_MS", 2000);
    rpc_timeout_ms_ = env_int_or("DMLC_PS_RPC_TIMEOUT_MS", 0);
    // CRC32C end-to-end payload checksums, default ON (HETU_PS_CRC=0 opts
    // out): requests checksum their args and ask the server (kFlagCrc) to
    // reject mismatches before any apply and to checksum its response.
    {
      const char* c = std::getenv("HETU_PS_CRC");
      crc_on_.store(!(c && *c == '0'));
    }
    // chaos engine env arming (SetChaos is the runtime path). Doubly
    // gated: a leaked HETU_CHAOS_SPEC is inert without HETU_TEST_MODE.
    if (const char* cs = std::getenv("HETU_CHAOS_SPEC"))
      if (*cs && env_test_mode()) set_chaos(cs);
    sched_ = std::make_unique<Conn>(connect_to(sched_host, sched_port));
    // register with the scheduler, receive the server address book
    Message reg;
    reg.head.type = static_cast<int32_t>(PsfType::kRegister);
    int32_t meta[3] = {1, rank, 0};
    reg.args.push_back(Arg::i32(meta, 3));
    reg.args.push_back(Arg::str("127.0.0.1"));
    sched_->send(reg);
    Message book;
    if (!sched_->recv(&book))
      throw std::runtime_error("scheduler closed during registration");
    if (book.args.size() > 1 && book.args[1].as_i32()[0] > 0) {
      // scheduler-issued incarnation epoch in the high bits: strictly
      // increasing per rank across worker restarts regardless of clock
      // steps, and (epoch >= 1) always above the pure-wall-clock ids a
      // pre-epoch snapshot's ledger may hold (wall-µs stays < 2^51
      // until ~2041)
      next_req_id_ = boot_req_id() +
                     (static_cast<uint64_t>(book.args[1].as_i32()[0]) << 51);
    }
    std::istringstream ss(book.args[0].as_str());
    std::string line;
    while (std::getline(ss, line)) {
      if (line.empty()) continue;
      server_addrs_.push_back(line);
      // TWO connections per server — a BULK channel for gradient-payload
      // messages and a FAST channel for pulls/control — so a small pull is
      // never head-of-line-blocked behind a megabyte push on the same
      // socket. TPU-native equivalent of the reference's priority p3 van
      // (ps-lite/src/p3_van.h:1-71, selected at van.cc:29-42): instead of
      // slicing big messages into priority-scheduled chunks, the two
      // classes ride separate TCP streams served by separate server
      // threads (per-param shared_mutex still orders conflicting applies).
      servers_.push_back(std::make_unique<Conn>(connect_addr(line)));
      servers_fast_.push_back(std::make_unique<Conn>(connect_addr(line)));
    }
    if (servers_.empty()) throw std::runtime_error("no servers in address book");
  }

  ~PsWorker() { finalize(); }

  void finalize() {
    if (finalized_) return;
    finalized_ = true;
    pool_.shutdown();
    Message bye;
    bye.head.type = static_cast<int32_t>(PsfType::kShutdown);
    for (auto* chan : {&servers_, &servers_fast_}) {
      for (auto& s : *chan) {
        try {
          s->send(bye);
        } catch (...) {
        }
        s->close();
      }
    }
    // identity-tagged checkout: the scheduler's bounded teardown wait can
    // then name the ranks that never made it here
    int32_t who[2] = {1, rank_};
    bye.args.push_back(Arg::i32(who, 2));
    try {
      sched_->send(bye);
    } catch (...) {
    }
    sched_->close();
  }

  int rank() const { return rank_; }
  int nrank() const { return num_workers_; }
  size_t num_servers() const { return servers_.size(); }

  // -- partitioner (reference partitioner.h:18-24) -----------------------
  // dense: average split of [0, len); sparse: row-wise average split.
  std::pair<size_t, size_t> dense_range(size_t len, size_t s) const {
    size_t S = servers_.size();
    return {s * len / S, (s + 1) * len / S};
  }
  std::pair<size_t, size_t> row_range(size_t rows, size_t s) const {
    size_t S = servers_.size();
    return {s * rows / S, (s + 1) * rows / S};
  }
  size_t row_owner(size_t rows, size_t r) const {
    size_t S = servers_.size();
    // inverse of row_range: smallest s with (s+1)*rows/S > r
    size_t s = (r * S) / rows;
    while ((s + 1) * rows / S <= r) ++s;
    while (s > 0 && s * rows / S > r) --s;
    return s;
  }

  // -- tensor registration / init (reference worker.cc:6-17) -------------
  void parameter_init(int32_t key, ParamKind kind, size_t len, size_t width,
                      InitType itype, double a, double b, uint64_t seed,
                      OptType otype, const float* lrs, size_t n_lr) {
    {
      std::lock_guard<std::mutex> g(meta_mu_);
      TensorMeta& m = metas_[key];
      m.kind = kind;
      if (kind == ParamKind::kDense) {
        m.len = len;
        m.width = 1;
      } else {
        m.rows = len;
        m.width = width;
        m.len = len * width;
      }
    }
    // synchronous init on every server shard (idempotent server-side, so no
    // rank-0-only dance is needed; the reference barriers instead)
    for (size_t s = 0; s < servers_.size(); ++s) {
      size_t shard = (kind == ParamKind::kDense)
                         ? dense_range(len, s).second - dense_range(len, s).first
                         : row_range(len, s).second - row_range(len, s).first;
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kParamInit);
      req.head.tensor_id = key;
      int64_t meta[6] = {static_cast<int64_t>(kind),
                         static_cast<int64_t>(shard),
                         static_cast<int64_t>(width),
                         static_cast<int64_t>(itype),
                         static_cast<int64_t>(otype),
                         static_cast<int64_t>(n_lr)};
      double ab[2] = {a, b};
      uint64_t sd = seed + s * 131071u;
      req.args.push_back(Arg::i64(meta, 6));
      req.args.push_back(Arg::f64(ab, 2));
      req.args.push_back(Arg::u64(&sd, 1));
      req.args.push_back(Arg::f32(lrs, n_lr));
      rpc(s, req);
    }
  }

  // -- per-step optimizer overrides --------------------------------------
  // [lr, l2reg, weight_decay] attached as a trailing f32 arg to this
  // tensor's subsequent push RPCs (server parse_opts -> store.h UpdateOpts).
  // How lr schedules + regularization reach stateful SERVER-side optimizers:
  // the worker refreshes lr(step) before each step's pushes. lr < 0 with
  // zero l2/wd clears the override.
  void set_push_opts(int32_t key, float lr, float l2reg, float wd) {
    std::lock_guard<std::mutex> g(opts_mu_);
    if (lr < 0.0f && l2reg == 0.0f && wd == 0.0f)
      push_opts_.erase(key);
    else
      push_opts_[key] = {lr, l2reg, wd};
  }

  bool get_push_opts(int32_t key, std::array<float, 3>* out) {
    std::lock_guard<std::mutex> g(opts_mu_);
    auto it = push_opts_.find(key);
    if (it == push_opts_.end()) return false;
    *out = it->second;
    return true;
  }

  // -- hetuq quantized wire (docs/COMM_QUANT.md) --------------------------
  void set_quant(bool on) { quant_.store(on); }
  bool quant_enabled() const { return quant_.load(); }

  // -- hetu-elastic membership (docs/FAULT_TOLERANCE.md) ------------------
  void set_world_version(uint64_t v) { world_version_.store(v); }
  uint64_t world_version() const { return world_version_.load(); }

  // -- hetuchaos (docs/FAULT_TOLERANCE.md "Chaos testing") ----------------
  // Arm a seeded fault schedule ("" disarms). Gating on HETU_TEST_MODE
  // lives in capi.cc / the env-arming ctor path; this setter is the
  // mechanism. Retired engines are kept until finalize so a concurrent
  // RPC that loaded the old pointer never dereferences freed memory.
  void set_chaos(const std::string& spec) {
    if (spec.empty()) {
      chaos_.store(nullptr, std::memory_order_release);
      return;
    }
    auto eng = ChaosEngine::parse(spec);
    ChaosEngine* raw = eng.get();
    {
      std::lock_guard<std::mutex> g(chaos_mu_);
      chaos_owned_.push_back(std::move(eng));
    }
    chaos_.store(raw, std::memory_order_release);
  }

  // Drain injected-fault events (6-wide i64 rows, oldest first) across
  // EVERY engine armed this session, in arming order — a test that
  // re-arms per phase (or disarms before reading) still gets the full
  // log. Returns 0 when no engine was ever armed.
  size_t drain_chaos(int64_t* out, size_t max_rows) {
    std::lock_guard<std::mutex> g(chaos_mu_);
    size_t n = 0;
    for (auto& eng : chaos_owned_) {
      if (n >= max_rows) break;
      n += eng->drain(out + n * ChaosEngine::kEventCols, max_rows - n);
    }
    return n;
  }

  uint64_t chaos_faults() const {
    // injected-fault total across every engine armed this session (0
    // with none armed): reading through chaos_ alone would go blind the
    // moment a test disarms or re-arms
    std::lock_guard<std::mutex> g(chaos_mu_);
    uint64_t n = 0;
    for (const auto& eng : chaos_owned_) n += eng->fault_count();
    return n;
  }

  // CRC32C payload checksums on/off for this worker's traffic (the env
  // default is HETU_PS_CRC at Init; the bench A/B toggles it live).
  void set_crc(bool on) { crc_on_.store(on); }
  bool crc_enabled() const { return crc_on_.load(); }

  // Re-sync the server set with the scheduler's address book after a
  // committed resize: joined servers get fresh bulk+fast connections and
  // the partitioner denominator (servers_.size()) grows to match.
  // PRECONDITION: the caller drained — no RPCs in flight on any channel
  // (the ElasticAgent calls this between kCommitResize returning and the
  // first post-resize push). Relocated servers reconnect lazily via the
  // existing retry path, so only NEW entries connect here.
  size_t refresh_servers() {
    Conn c(connect_to(sched_host_, sched_port_, /*retries=*/50,
                      /*wait_ms=*/100));
    set_recv_timeout(c.fd(), recv_timeout_ms_);
    Message q;
    q.head.type = static_cast<int32_t>(PsfType::kQueryServers);
    c.send(q);
    Message rsp;
    if (!c.recv(&rsp) || rsp.args.empty())
      throw std::runtime_error(
          "refresh_servers: scheduler at " + sched_host_ + ":" +
          std::to_string(sched_port_) + " returned no address book");
    std::vector<std::string> addrs;
    std::istringstream ss(rsp.args[0].as_str());
    std::string line;
    while (std::getline(ss, line))
      if (!line.empty()) addrs.push_back(line);
    if (addrs.size() > kMaxServers)
      throw std::runtime_error(
          "refresh_servers: " + std::to_string(addrs.size()) +
          " servers exceed the per-worker connection table (" +
          std::to_string(kMaxServers) + ")");
    std::lock_guard<std::mutex> g(addr_mu_);
    if (addrs.size() < server_addrs_.size())
      throw std::runtime_error(
          "refresh_servers: the address book shrank (" +
          std::to_string(addrs.size()) + " < " +
          std::to_string(server_addrs_.size()) +
          ") — server scale-down is not supported");
    for (size_t i = 0; i < addrs.size(); ++i) {
      if (i < server_addrs_.size()) {
        server_addrs_[i] = addrs[i];  // relocations reconnect on retry
      } else {
        server_addrs_.push_back(addrs[i]);
        servers_.push_back(std::make_unique<Conn>(connect_addr(addrs[i])));
        servers_fast_.push_back(
            std::make_unique<Conn>(connect_addr(addrs[i])));
      }
    }
    return servers_.size();
  }

  // test hook (capi gates it on HETU_TEST_MODE): corrupt the scale bytes of
  // the NEXT quantized value payload (optionally only for `tensor`), to
  // prove the server's length/scale validation rejects the message instead
  // of applying garbage. One-shot.
  void arm_quant_corrupt(int32_t tensor) {
    corrupt_tensor_.store(tensor);
    corrupt_armed_.store(true);
  }

  const TensorMeta& meta(int32_t key) {
    std::lock_guard<std::mutex> g(meta_mu_);
    auto it = metas_.find(key);
    if (it == metas_.end())
      throw std::runtime_error("tensor " + std::to_string(key) +
                               " not registered (InitTensor first)");
    return it->second;
  }

  // -- dense ops ---------------------------------------------------------
  // Async: returns immediately; caller's buffers must stay alive until
  // wait(key) (same contract as the reference's Push/Pull + Wait).
  void check_len(const TensorMeta& m, int32_t key, size_t len) const {
    if (len != m.len)
      throw std::runtime_error(
          "tensor " + std::to_string(key) + ": buffer has " +
          std::to_string(len) + " f32s but " + std::to_string(m.len) +
          " were registered via InitTensor");
  }

  void push(int32_t key, const float* grad, size_t len) {
    auto m = meta(key);
    check_len(m, key, len);
    std::array<float, 3> uo;
    const bool has_uo = get_push_opts(key, &uo);  // snapshot in caller thread
    pending_.add(key, static_cast<int>(servers_.size()));
    for (size_t s = 0; s < servers_.size(); ++s) {
      auto [lo, hi] = dense_range(m.len, s);
      pool_.submit([=] {
        guarded(key, [&] {
          Message req;
          req.head.type = static_cast<int32_t>(PsfType::kDensePush);
          req.head.tensor_id = key;
          req.args.push_back(value_arg(key, grad + lo, hi - lo,
                                       kQuantWireBlock));
          if (has_uo) req.args.push_back(Arg::f32(uo.data(), 3));
          rpc(s, req);
          record("push", (hi - lo) * 4);
        });
      });
    }
  }

  void pull(int32_t key, float* out, size_t len) {
    auto m = meta(key);
    check_len(m, key, len);
    pending_.add(key, static_cast<int>(servers_.size()));
    for (size_t s = 0; s < servers_.size(); ++s) {
      auto [lo, hi] = dense_range(m.len, s);
      pool_.submit([=] {
        guarded(key, [&] {
          Message req;
          req.head.type = static_cast<int32_t>(PsfType::kDensePull);
          req.head.tensor_id = key;
          Message rsp = rpc(s, req);
          std::memcpy(out + lo, rsp.args[0].as_f32(), (hi - lo) * 4);
          record("pull", (hi - lo) * 4);
        });
      });
    }
  }

  void dd_pushpull(int32_t key, const float* grad, float* out, size_t len) {
    auto m = meta(key);
    check_len(m, key, len);
    std::array<float, 3> uo;
    const bool has_uo = get_push_opts(key, &uo);
    pending_.add(key, static_cast<int>(servers_.size()));
    for (size_t s = 0; s < servers_.size(); ++s) {
      auto [lo, hi] = dense_range(m.len, s);
      pool_.submit([=] {
        guarded(key, [&] {
          Message req;
          req.head.type = static_cast<int32_t>(PsfType::kDDPushPull);
          req.head.tensor_id = key;
          mark_quant_rsp(&req);
          req.args.push_back(value_arg(key, grad + lo, hi - lo,
                                       kQuantWireBlock));
          if (has_uo) req.args.push_back(Arg::f32(uo.data(), 3));
          Message rsp = rpc(s, req);
          std::vector<float> scratch;
          std::memcpy(out + lo, rsp_view(rsp.args[0], &scratch),
                      (hi - lo) * 4);
          record("ddpushpull", (hi - lo) * 8);
        });
      });
    }
  }

  // -- sparse ops --------------------------------------------------------
  // Dedup-by-key then split per server (reference PSAgent.h:124-160).
  struct ShardedKeys {
    std::vector<std::vector<int64_t>> local;     // per-server local row ids
    std::vector<std::vector<size_t>> positions;  // per-server original slots
  };

  ShardedKeys shard_rows(const TensorMeta& m, const int64_t* keys, size_t n,
                         std::vector<int64_t>* uniq_out = nullptr,
                         std::vector<size_t>* inv_out = nullptr) {
    // dedup: uniq keys + inverse map original position -> uniq slot
    std::unordered_map<int64_t, size_t> first;
    std::vector<int64_t> uniq;
    std::vector<size_t> inv(n);
    for (size_t i = 0; i < n; ++i) {
      auto it = first.find(keys[i]);
      if (it == first.end()) {
        first[keys[i]] = uniq.size();
        inv[i] = uniq.size();
        uniq.push_back(keys[i]);
      } else {
        inv[i] = it->second;
      }
    }
    ShardedKeys sk;
    sk.local.resize(servers_.size());
    sk.positions.resize(servers_.size());
    for (size_t u = 0; u < uniq.size(); ++u) {
      // ids come straight from user data; an out-of-range id would index
      // past sk.local below (row_owner returns an invalid server slot)
      if (uniq[u] < 0 || static_cast<size_t>(uniq[u]) >= m.rows)
        throw std::runtime_error(
            "row id " + std::to_string(uniq[u]) + " out of range [0, " +
            std::to_string(m.rows) + ")");
      size_t s = row_owner(m.rows, static_cast<size_t>(uniq[u]));
      sk.local[s].push_back(uniq[u] -
                            static_cast<int64_t>(row_range(m.rows, s).first));
      sk.positions[s].push_back(u);
    }
    if (uniq_out) *uniq_out = std::move(uniq);
    if (inv_out) *inv_out = std::move(inv);
    return sk;
  }

  void sparse_push(int32_t key, const int64_t* keys, const float* vals,
                   size_t n) {
    auto m = meta(key);
    // dedup with accumulation: duplicate rows in one push sum their grads
    std::vector<int64_t> uniq;
    std::vector<size_t> inv;
    auto sk = shard_rows(m, keys, n, &uniq, &inv);
    auto acc = std::make_shared<std::vector<float>>(uniq.size() * m.width, 0.0f);
    for (size_t i = 0; i < n; ++i) {
      float* dst = acc->data() + inv[i] * m.width;
      const float* src = vals + i * m.width;
      for (size_t j = 0; j < m.width; ++j) dst[j] += src[j];
    }
    std::array<float, 3> uo;
    const bool has_uo = get_push_opts(key, &uo);
    pending_.add(key, static_cast<int>(servers_.size()));
    auto sk_p = std::make_shared<ShardedKeys>(std::move(sk));
    for (size_t s = 0; s < servers_.size(); ++s) {
      pool_.submit([=] {
        guarded(key, [&] {
          const auto& loc = sk_p->local[s];
          if (loc.empty()) return;
          std::vector<float> shard_vals(loc.size() * m.width);
          for (size_t i = 0; i < loc.size(); ++i)
            std::memcpy(shard_vals.data() + i * m.width,
                        acc->data() + sk_p->positions[s][i] * m.width,
                        m.width * 4);
          Message req;
          req.head.type = static_cast<int32_t>(PsfType::kSparsePush);
          req.head.tensor_id = key;
          req.args.push_back(Arg::i64(loc.data(), loc.size()));
          req.args.push_back(value_arg(key, shard_vals.data(),
                                       shard_vals.size(), m.width));
          if (has_uo) req.args.push_back(Arg::f32(uo.data(), 3));
          rpc(s, req);
          record("sparse_push", shard_vals.size() * 4);
        });
      });
    }
  }

  void sparse_pull(int32_t key, const int64_t* keys, float* out, size_t n) {
    auto m = meta(key);
    std::vector<int64_t> uniq;
    auto inv = std::make_shared<std::vector<size_t>>();
    auto sk = shard_rows(m, keys, n, &uniq, inv.get());
    auto uniq_vals = std::make_shared<std::vector<float>>(uniq.size() * m.width);
    auto sk_p = std::make_shared<ShardedKeys>(std::move(sk));
    auto remain = std::make_shared<std::atomic<int>>(
        static_cast<int>(servers_.size()));
    pending_.add(key, static_cast<int>(servers_.size()));
    for (size_t s = 0; s < servers_.size(); ++s) {
      pool_.submit([=] {
        guarded(key, [&] {
          const auto& loc = sk_p->local[s];
          if (!loc.empty()) {
            Message req;
            req.head.type = static_cast<int32_t>(PsfType::kSparsePull);
            req.head.tensor_id = key;
            mark_quant_rsp(&req);
            req.args.push_back(Arg::i64(loc.data(), loc.size()));
            Message rsp = rpc(s, req);
            std::vector<float> scratch;
            const float* rows = rsp_view(rsp.args[0], &scratch);
            for (size_t i = 0; i < loc.size(); ++i)
              std::memcpy(uniq_vals->data() + sk_p->positions[s][i] * m.width,
                          rows + i * m.width, m.width * 4);
            record("sparse_pull", loc.size() * m.width * 4);
          }
          // last shard scatters uniq -> caller positions
          if (remain->fetch_sub(1) == 1) {
            for (size_t i = 0; i < n; ++i)
              std::memcpy(out + i * m.width,
                          uniq_vals->data() + (*inv)[i] * m.width, m.width * 4);
          }
        });
      });
    }
  }

  void sd_pushpull(int32_t key, const int64_t* keys, const float* vals,
                   size_t n, float* out_dense) {
    sparse_push(key, keys, vals, n);
    wait(key);
    // dense view of a sparse table: pull all rows in order
    auto m = meta(key);
    pending_.add(key, static_cast<int>(servers_.size()));
    for (size_t s = 0; s < servers_.size(); ++s) {
      auto [lo, hi] = row_range(m.rows, s);
      pool_.submit([=] {
        guarded(key, [&] {
          Message req;
          req.head.type = static_cast<int32_t>(PsfType::kDensePull);
          req.head.tensor_id = key;
          Message rsp = rpc(s, req);
          std::memcpy(out_dense + lo * m.width, rsp.args[0].as_f32(),
                      (hi - lo) * m.width * 4);
        });
      });
    }
  }

  void ss_pushpull(int32_t key, const int64_t* push_keys, const float* vals,
                   const int64_t* pull_keys, float* out, size_t n) {
    // BSP-correct ordering: apply the push, then pull (possibly different)
    // rows. The reference overlaps these per-server (SSPushPull PSF); we
    // conservatively order globally, which also avoids cross-server skew.
    sparse_push(key, push_keys, vals, n);
    wait(key);
    sparse_pull(key, pull_keys, out, n);
  }

  // -- raw assignment (host-side init values; reference initializers push
  // through InitTensor's server-side init — here explicit values bypass the
  // optimizer entirely) -------------------------------------------------
  void assign_dense(int32_t key, const float* data, size_t len) {
    auto m = meta(key);
    check_len(m, key, len);
    for (size_t s = 0; s < servers_.size(); ++s) {
      auto [lo, hi] = (m.kind == ParamKind::kDense)
                          ? dense_range(m.len, s)
                          : std::pair<size_t, size_t>(
                                row_range(m.rows, s).first * m.width,
                                row_range(m.rows, s).second * m.width);
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kParamAssign);
      req.head.tensor_id = key;
      req.args.push_back(Arg::f32(data + lo, hi - lo));
      rpc(s, req);
    }
  }

  void assign_rows(int32_t key, const int64_t* keys, const float* vals,
                   size_t n) {
    auto m = meta(key);
    auto sk = shard_rows(m, keys, n);
    for (size_t s = 0; s < servers_.size(); ++s) {
      const auto& loc = sk.local[s];
      if (loc.empty()) continue;
      std::vector<float> shard_vals(loc.size() * m.width);
      for (size_t i = 0; i < loc.size(); ++i)
        std::memcpy(shard_vals.data() + i * m.width,
                    vals + sk.positions[s][i] * m.width, m.width * 4);
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kParamAssignRows);
      req.head.tensor_id = key;
      req.args.push_back(Arg::i64(loc.data(), loc.size()));
      req.args.push_back(Arg::f32(shard_vals.data(), shard_vals.size()));
      rpc(s, req);
    }
  }

  // -- cache-table ops (used by the C++ embedding cache) ------------------
  // Bounded-staleness pull (reference hetu_client.cc:6-37): returns rows of
  // `keys` the client has never seen (cver == -1) or whose server version ran
  // more than `bound` updates ahead. out_* are filled synchronously (callers
  // run on the cache's own worker thread).
  void sync_embedding(int32_t key, const uint64_t* keys, const int64_t* cvers,
                      size_t n, int64_t bound, std::vector<size_t>* out_pos,
                      std::vector<float>* out_rows,
                      std::vector<int64_t>* out_vers) {
    auto m = meta(key);
    std::vector<int64_t> ikeys(keys, keys + n);
    auto sk = shard_rows(m, ikeys.data(), n);
    out_pos->clear();
    out_rows->clear();
    out_vers->clear();
    for (size_t s = 0; s < servers_.size(); ++s) {
      const auto& loc = sk.local[s];
      if (loc.empty()) continue;
      std::vector<int64_t> shard_vers(loc.size());
      for (size_t i = 0; i < loc.size(); ++i)
        shard_vers[i] = cvers[sk.positions[s][i]];
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kSyncEmbedding);
      req.head.tensor_id = key;
      mark_quant_rsp(&req);
      req.args.push_back(Arg::i64(loc.data(), loc.size()));
      req.args.push_back(Arg::i64(shard_vers.data(), shard_vers.size()));
      req.args.push_back(Arg::i64(&bound, 1));
      Message rsp = rpc(s, req);
      const int32_t* sel = rsp.args[0].as_i32();
      size_t nsel = rsp.args[0].size() / 4;
      std::vector<float> scratch;
      const float* rows = rsp_view(rsp.args[1], &scratch);
      const int64_t* vers = rsp.args[2].as_i64();
      for (size_t i = 0; i < nsel; ++i) {
        out_pos->push_back(sk.positions[s][sel[i]]);
        out_rows->insert(out_rows->end(), rows + i * m.width,
                         rows + (i + 1) * m.width);
        out_vers->push_back(vers[i]);
      }
      record("sync_embedding", nsel * m.width * 4);
    }
  }

  void push_embedding(int32_t key, const uint64_t* keys, const float* grads,
                      const int64_t* updates, size_t n) {
    auto m = meta(key);
    std::vector<int64_t> ikeys(keys, keys + n);
    auto sk = shard_rows(m, ikeys.data(), n);
    for (size_t s = 0; s < servers_.size(); ++s) {
      const auto& loc = sk.local[s];
      if (loc.empty()) continue;
      std::vector<float> shard_grads(loc.size() * m.width);
      std::vector<int64_t> shard_ups(loc.size());
      for (size_t i = 0; i < loc.size(); ++i) {
        std::memcpy(shard_grads.data() + i * m.width,
                    grads + sk.positions[s][i] * m.width, m.width * 4);
        shard_ups[i] = updates[sk.positions[s][i]];
      }
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kPushEmbedding);
      req.head.tensor_id = key;
      req.args.push_back(Arg::i64(loc.data(), loc.size()));
      req.args.push_back(value_arg(key, shard_grads.data(),
                                   shard_grads.size(), m.width));
      req.args.push_back(Arg::i64(shard_ups.data(), shard_ups.size()));
      rpc(s, req);
      record("push_embedding", shard_grads.size() * 4);
    }
  }

  // Combined push+sync in ONE round trip per server (reference
  // kPushSyncEmbedding, PSFhandle_embedding.cc:67-81).
  void push_sync_embedding(int32_t key, const uint64_t* push_keys,
                           const float* grads, const int64_t* updates,
                           size_t n_push, const uint64_t* sync_keys,
                           const int64_t* cvers, size_t n_sync, int64_t bound,
                           std::vector<size_t>* out_pos,
                           std::vector<float>* out_rows,
                           std::vector<int64_t>* out_vers) {
    auto m = meta(key);
    std::vector<int64_t> ipush(push_keys, push_keys + n_push);
    std::vector<int64_t> isync(sync_keys, sync_keys + n_sync);
    auto skp = shard_rows(m, ipush.data(), n_push);
    auto sks = shard_rows(m, isync.data(), n_sync);
    out_pos->clear();
    out_rows->clear();
    out_vers->clear();
    for (size_t s = 0; s < servers_.size(); ++s) {
      const auto& locp = skp.local[s];
      const auto& locs = sks.local[s];
      if (locp.empty() && locs.empty()) continue;
      std::vector<float> shard_grads(locp.size() * m.width);
      std::vector<int64_t> shard_ups(locp.size());
      for (size_t i = 0; i < locp.size(); ++i) {
        std::memcpy(shard_grads.data() + i * m.width,
                    grads + skp.positions[s][i] * m.width, m.width * 4);
        shard_ups[i] = updates[skp.positions[s][i]];
      }
      std::vector<int64_t> shard_vers(locs.size());
      for (size_t i = 0; i < locs.size(); ++i)
        shard_vers[i] = cvers[sks.positions[s][i]];
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kPushSyncEmbedding);
      req.head.tensor_id = key;
      mark_quant_rsp(&req);
      req.args.push_back(Arg::i64(locp.data(), locp.size()));
      req.args.push_back(value_arg(key, shard_grads.data(),
                                   shard_grads.size(), m.width));
      req.args.push_back(Arg::i64(shard_ups.data(), shard_ups.size()));
      req.args.push_back(Arg::i64(locs.data(), locs.size()));
      req.args.push_back(Arg::i64(shard_vers.data(), shard_vers.size()));
      req.args.push_back(Arg::i64(&bound, 1));
      Message rsp = rpc(s, req);
      const int32_t* sel = rsp.args[0].as_i32();
      size_t nsel = rsp.args[0].size() / 4;
      std::vector<float> scratch;
      const float* rows = rsp_view(rsp.args[1], &scratch);
      const int64_t* vers = rsp.args[2].as_i64();
      for (size_t i = 0; i < nsel; ++i) {
        out_pos->push_back(sks.positions[s][sel[i]]);
        out_rows->insert(out_rows->end(), rows + i * m.width,
                         rows + (i + 1) * m.width);
        out_vers->push_back(vers[i]);
      }
      record("push_sync_embedding", (shard_grads.size() + nsel * m.width) * 4);
    }
  }

  // -- data blobs (reference PushData/PullData) ---------------------------
  using query_t = int64_t;

  query_t push_data(int32_t key, const uint64_t* ids, size_t n,
                    const float* vals, const int64_t* lens) {
    return data_op(PsfType::kDataPush, key, ids, n, const_cast<float*>(vals),
                   lens);
  }

  query_t pull_data(int32_t key, const uint64_t* ids, size_t n, float* vals,
                    const int64_t* lens) {
    return data_op(PsfType::kDataPull, key, ids, n, vals, lens);
  }

  void wait_data(query_t q) { pending_.wait(query_key(q)); }

  // -- control -----------------------------------------------------------
  void wait(int32_t key) { pending_.wait(key); }

  // -- hetutrail client spans (docs/OBSERVABILITY.md pillar 5) ------------
  // One span per successful RPC round trip, stamped with the worker's
  // current step (SetTrailStep) — the span context riding the wire is the
  // existing (client_id, req_id) pair, so server spans join back without
  // any wire-format change.
  struct TrailSpan {
    uint64_t req_id;
    int32_t client_id, server, psf, tensor;
    int64_t step;
    int64_t t0_us, dur_us;      // trail_mono_us at send / round-trip span
    int64_t req_bytes, rsp_bytes;
  };
  static constexpr size_t kTrailCols = 10;  // i64 row width for the drain

  void set_trail_step(int64_t step) {
    trail_step_.store(step, std::memory_order_relaxed);
  }

  // Explicit arm/disarm (the SetCommQuant pattern): the worker is a
  // process singleton, so an A/B of two executors must not inherit the
  // other leg's ring state. Disarming clears the ring.
  void set_trail(bool on) {
    trail_on_.store(on);
    if (!on) {
      std::lock_guard<std::mutex> g(trail_mu_);
      trail_ring_.clear();
    }
  }

  // Copy up to max_rows spans (oldest first) into out as kTrailCols-wide
  // i64 rows, removing them from the ring. Returns the row count.
  size_t drain_trail(int64_t* out, size_t max_rows) {
    std::lock_guard<std::mutex> g(trail_mu_);
    size_t n = std::min(max_rows, trail_ring_.size());
    for (size_t i = 0; i < n; ++i) {
      const TrailSpan& s = trail_ring_[i];
      int64_t* r = out + i * kTrailCols;
      r[0] = static_cast<int64_t>(s.req_id);
      r[1] = s.client_id;
      r[2] = s.server;
      r[3] = s.psf;
      r[4] = s.tensor;
      r[5] = s.step;
      r[6] = s.t0_us;
      r[7] = s.dur_us;
      r[8] = s.req_bytes;
      r[9] = s.rsp_bytes;
    }
    trail_ring_.erase(trail_ring_.begin(), trail_ring_.begin() + n);
    return n;
  }

  uint64_t trail_dropped() const { return trail_dropped_.load(); }

  // hetutrail test lever (capi gates on HETU_TEST_MODE, the server gates
  // again): delay the target server's NEXT optimizer apply by `ms`.
  void test_slow_apply(size_t server, int ms) {
    if (server >= servers_.size())
      throw std::runtime_error("test_slow_apply: server index " +
                               std::to_string(server) + " out of range");
    Message req;
    req.head.type = static_cast<int32_t>(PsfType::kTestSlowApply);
    req.head.tensor_id = -1;
    int64_t v = ms;
    req.args.push_back(Arg::i64(&v, 1));
    rpc(server, req);
  }

  // Worker-side RPC counters (telemetry: kServerStats' client-side twin):
  // [rpc round trips issued, fast-retry attempts, successful failover
  // re-issues, raw value-payload bytes, wire value-payload bytes,
  // recv/deadline timeouts, total backoff slept (ms), CRC rejects
  // observed (server rejections + local response-verify failures),
  // chaos faults injected, successful write-RPC round trips]. The two
  // byte counters cover every quantizable payload leg in BOTH modes
  // (raw == wire with quantization off), so raw/wire is the measured
  // compression ratio. `pushes_ok` counts each LOGICAL write RPC once no
  // matter how many retries/duplicates it took — with a fresh single-
  // worker cluster it must equal the sum of the servers' update counters
  // EXACTLY (the no-double-apply / no-lost-update accounting invariant
  // hetu_tpu.chaos checks). Relaxed atomics bumped on the rpc path —
  // counting costs nothing whether or not anyone ever reads them.
  std::vector<int64_t> client_stats() const {
    return {static_cast<int64_t>(rpc_count_.load()),
            static_cast<int64_t>(retry_count_.load()),
            static_cast<int64_t>(failover_count_.load()),
            static_cast<int64_t>(val_raw_bytes_.load()),
            static_cast<int64_t>(val_wire_bytes_.load()),
            static_cast<int64_t>(timeout_count_.load()),
            static_cast<int64_t>(backoff_ms_total_.load()),
            static_cast<int64_t>(crc_reject_count_.load()),
            static_cast<int64_t>(chaos_faults()),
            static_cast<int64_t>(push_ok_count_.load())};
  }

  // hetusave coordinated-snapshot trigger: ask one server to write an
  // epoch-stamped full-state snapshot NOW (synchronous — returns after the
  // snapshot is published and its LATEST pointer flipped). Reply:
  // [snapshot_version, covered_update_counter, update_count, epoch].
  std::vector<int64_t> snapshot_now(size_t server, int64_t epoch) {
    if (server >= servers_.size())
      throw std::runtime_error("snapshot_now: server index " +
                               std::to_string(server) + " out of range");
    Message req;
    req.head.type = static_cast<int32_t>(PsfType::kSnapshotNow);
    req.head.tensor_id = -1;
    req.args.push_back(Arg::i64(&epoch, 1));
    Message rsp = rpc(server, req);
    const int64_t* s = rsp.args[0].as_i64();
    return std::vector<int64_t>(s, s + rsp.args[0].n_i64());
  }

  // Per-server HA counters (kServerStats; rides the fast channel):
  // [updates, snapshot_updates, restored_updates(-1 fresh), snapshot_version,
  // n_params]. After a recovery, `updates acked before death -
  // restored_updates` is the exact lost-update count for that shard.
  std::vector<int64_t> server_stats(size_t server) {
    if (server >= servers_.size())
      throw std::runtime_error("server_stats: server index " +
                               std::to_string(server) + " out of range");
    Message req;
    req.head.type = static_cast<int32_t>(PsfType::kServerStats);
    req.head.tensor_id = -1;
    Message rsp = rpc(server, req);
    const int64_t* s = rsp.args[0].as_i64();
    return std::vector<int64_t>(s, s + rsp.args[0].n_i64());
  }

  void barrier() {
    std::lock_guard<std::mutex> g(sched_mu_);
    Message req;
    req.head.type = static_cast<int32_t>(PsfType::kBarrier);
    sched_->send(req);
    Message rsp;
    if (!sched_->recv(&rsp)) throw std::runtime_error("scheduler lost in barrier");
  }

  void clear(int32_t key) {
    std::lock_guard<std::mutex> g(meta_mu_);
    metas_.erase(key);
  }

  void clear_on_server(int32_t key) {
    for (size_t s = 0; s < servers_.size(); ++s) {
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kParamClear);
      req.head.tensor_id = key;
      rpc(s, req);
    }
  }

  void parameter_save(int32_t key, const std::string& dir) {
    for (size_t s = 0; s < servers_.size(); ++s) {
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kParamSave);
      req.head.tensor_id = key;
      req.args.push_back(Arg::str(dir));
      rpc(s, req);
    }
  }

  void parameter_load(int32_t key, const std::string& dir) {
    for (size_t s = 0; s < servers_.size(); ++s) {
      Message req;
      req.head.type = static_cast<int32_t>(PsfType::kParamLoad);
      req.head.tensor_id = key;
      req.args.push_back(Arg::str(dir));
      rpc(s, req);
    }
  }

  // -- load recording (reference PSAgent::startRecord/getLoads) ----------
  void start_record(const std::string& dir) {
    std::lock_guard<std::mutex> g(loads_mu_);
    record_dir_ = dir;
    loads_.clear();
  }

  std::string get_loads() {
    std::lock_guard<std::mutex> g(loads_mu_);
    std::ostringstream os;
    os << "{";
    bool fst = true;
    for (auto& kv : loads_) {
      if (!fst) os << ", ";
      fst = false;
      os << "\"" << kv.first << "\": " << kv.second;
    }
    os << "}";
    if (!record_dir_.empty()) {
      FILE* f = std::fopen((record_dir_ + "/ps_loads_w" +
                            std::to_string(rank_) + ".json").c_str(), "w");
      if (f) {
        std::string s = os.str();
        std::fwrite(s.data(), 1, s.size(), f);
        std::fclose(f);
      }
    }
    return os.str();
  }

 private:
  // One value payload of a push-side RPC: quantized (kQI8) when the knob is
  // on, plain f32 otherwise — with raw-vs-wire byte accounting either way,
  // so an off-vs-int8 A/B reads its compression ratio straight from
  // client_stats. `block` is the scale granularity (row width for sparse
  // payloads, kQuantWireBlock for dense).
  Arg value_arg(int32_t key, const float* vals, size_t n, size_t block) {
    val_raw_bytes_.fetch_add(n * 4, std::memory_order_relaxed);
    if (!quant_.load(std::memory_order_relaxed)) {
      val_wire_bytes_.fetch_add(n * 4, std::memory_order_relaxed);
      return Arg::f32(vals, n);
    }
    Arg a = make_qi8_arg(vals, n, block);
    if (corrupt_armed_.load(std::memory_order_relaxed)) {
      const int32_t t = corrupt_tensor_.load();
      bool mine = t < 0 || t == key;
      bool expected = true;
      if (mine && corrupt_armed_.compare_exchange_strong(expected, false) &&
          a.buf.size() >= sizeof(QI8Header) + 4) {
        // 0xFF-fill the first block's scale -> NaN: must be REJECTED by
        // the server's scale validation (see net.h dequant_qi8)
        std::memset(a.buf.data() + sizeof(QI8Header), 0xFF, 4);
      }
    }
    val_wire_bytes_.fetch_add(a.buf.size(), std::memory_order_relaxed);
    return a;
  }

  // f32 view of a response value payload (dequantizes kQI8 into `scratch`
  // — the bounded-staleness cache and every pull consumer see plain f32
  // rows, so caching/staleness semantics are untouched), with the same
  // raw/wire accounting as value_arg.
  const float* rsp_view(const Arg& a, std::vector<float>* scratch) {
    if (a.dtype == ArgType::kQI8) {
      dequant_qi8(a, scratch, 0);
      val_raw_bytes_.fetch_add(scratch->size() * 4,
                               std::memory_order_relaxed);
      val_wire_bytes_.fetch_add(a.buf.size(), std::memory_order_relaxed);
      return scratch->data();
    }
    val_raw_bytes_.fetch_add(a.buf.size(), std::memory_order_relaxed);
    val_wire_bytes_.fetch_add(a.buf.size(), std::memory_order_relaxed);
    return a.as_f32();
  }

  // request flag asking the server to quantize ITS response value payloads
  void mark_quant_rsp(Message* req) {
    if (quant_.load(std::memory_order_relaxed))
      req->head.flags |= kFlagQuantRsp;
  }

  int connect_addr(const std::string& addr, int retries = 600,
                   int wait_ms = 100) {
    auto colon = addr.rfind(':');
    int fd = connect_to(addr.substr(0, colon),
                        std::stoi(addr.substr(colon + 1)), retries, wait_ms);
    set_recv_timeout(fd, recv_timeout_ms_);
    return fd;
  }

  // Current address + liveness of one server, per the scheduler's heartbeat
  // ledger. Uses a fresh short-lived connection (the registered scheduler
  // connection may be parked inside a barrier).
  std::string cached_addr(size_t server) {
    std::lock_guard<std::mutex> g(addr_mu_);
    return server_addrs_[server];
  }

  // One liveness probe of `server` via the scheduler's heartbeat ledger.
  // `sched_ok` distinguishes the two unreachability shapes the escalation
  // logic must tell apart: scheduler reachable + heartbeat fresh + RPCs
  // failing = a DIRECTED PARTITION between this worker and that server;
  // scheduler unreachable = this worker may be the isolated one.
  struct ServerStatus {
    std::string addr;
    bool alive = true;
    bool sched_ok = false;
  };

  ServerStatus query_server_status(size_t server) {
    try {
      Conn c(connect_to(sched_host_, sched_port_, /*retries=*/20,
                        /*wait_ms=*/100));
      set_recv_timeout(c.fd(), recv_timeout_ms_);
      Message q;
      q.head.type = static_cast<int32_t>(PsfType::kQueryServers);
      c.send(q);
      Message rsp;
      if (!c.recv(&rsp) || rsp.args.size() < 2)
        return {cached_addr(server), true, false};
      std::vector<std::string> addrs;
      std::istringstream ss(rsp.args[0].as_str());
      std::string line;
      while (std::getline(ss, line))
        if (!line.empty()) addrs.push_back(line);
      const int32_t* alive = rsp.args[1].as_i32();
      if (server < addrs.size())
        return {addrs[server], alive[server] != 0, true};
      // beyond the scheduler's address book: the scheduler answered but
      // has NO heartbeat for this server — report not-alive, or the
      // partition diagnosis would claim a fresh heartbeat that does not
      // exist and steer recovery away from the departure path
      return {cached_addr(server), false, true};
    } catch (...) {
      // scheduler unreachable: fall back to the cached address and let the
      // reconnect below decide
    }
    return {cached_addr(server), true, false};
  }

  // One reliable request/response round trip (the role of the reference's
  // resender.h ack+timeout+resend): recv timeouts bound every wait, a dead
  // connection triggers reconnect (to the scheduler's current address for
  // that rank, so a recovered server is picked up) and a RESEND — servers
  // dedup on (client_id, req_id) so a request that executed but whose
  // response was lost is not applied twice.
  // Channel classification is by the size of EITHER leg: anything that can
  // carry a whole-tensor payload — in the request (pushes, assigns) or in
  // the response (kDensePull/kDataPull return full shards, kDDPushPull
  // both) — rides the bulk channel. The fast channel carries the latency-
  // critical per-batch row pulls (kSparsePull, kSyncEmbedding) and small
  // control messages, so they are never stuck behind a multi-MB transfer
  // (see the p3-van note in the constructor).
  static bool is_bulk(PsfType t) {
    switch (t) {
      case PsfType::kDensePush:
      case PsfType::kDensePull:
      case PsfType::kDDPushPull:
      case PsfType::kSparsePush:
      case PsfType::kSDPushPull:    // never sent by this worker (decomposed
      case PsfType::kSSPushPull:    // into push+pull) — kept bulk for any
                                    // external client of the wire protocol
      case PsfType::kPushEmbedding:
      case PsfType::kPushSyncEmbedding:
      case PsfType::kDataPush:
      case PsfType::kDataPull:
      case PsfType::kParamAssign:
      case PsfType::kParamAssignRows:
        return true;
      default:
        return false;
    }
  }

  // A server-side rejection that is SAFE to retry: the request was never
  // applied (CRC reject happens before any dedup/handle work) and the
  // stream is still in sync, so the client resends instead of surfacing
  // an application error. Distinguished from "server error:" (app-level,
  // no retry) by the server's "retryable:" message prefix.
  struct RetryableReject : std::runtime_error {
    using std::runtime_error::runtime_error;
  };

  // One send/recv over the current connection. Returns true with *rsp
  // filled on success; false (error recorded) on a transport failure or a
  // retryable server reject (the connection is closed only in the former
  // — a reject leaves a healthy, in-sync stream, and sets *rejected so
  // the retry loop resends immediately on it instead of paying backoff +
  // scheduler query + reconnect); rethrows app-level server errors (no
  // retry).
  bool try_roundtrip(std::vector<std::unique_ptr<Conn>>& conns, size_t server,
                     Message& req, Message* rsp, std::string* last_err,
                     size_t corrupt_arg = static_cast<size_t>(-1),
                     size_t corrupt_off = 0, bool* rejected = nullptr) {
    try {
      auto& conn = *conns[server];
      conn.send(req, corrupt_arg, corrupt_off);
      // cleared first: a clean peer close (recv() == 0) returns false
      // WITHOUT touching errno, and a stale EAGAIN from an earlier
      // timeout would misclassify a dead server as a timing-out one
      errno = 0;
      if (!conn.recv(rsp)) {
        // SO_RCVTIMEO expiry surfaces as EAGAIN/EWOULDBLOCK; anything else
        // is a closed/error'd peer. Counted apart (hetu_rpc_timeouts_total)
        // because a timing-out server and a dead one are different faults.
        const bool to = errno == EAGAIN || errno == EWOULDBLOCK;
        if (to) timeout_count_.fetch_add(1, std::memory_order_relaxed);
        throw std::runtime_error("server " + std::to_string(server) +
                                 (to ? " timed out" : " closed connection"));
      }
      if (rsp->head.flags == -1) {
        const std::string msg =
            rsp->args.empty() ? "(no diagnostic)" : rsp->args[0].as_str();
        if (msg.rfind("retryable:", 0) == 0) {
          if (msg.find("CRC") != std::string::npos)
            crc_reject_count_.fetch_add(1, std::memory_order_relaxed);
          throw RetryableReject("server " + std::to_string(server) +
                                " rejected: " + msg);
        }
        throw std::runtime_error("server error: " + msg);
      }
      // response integrity: a payload corrupted on the return leg must be
      // re-pulled, never handed to the caller (dedup makes resend safe)
      if (crc_on_.load(std::memory_order_relaxed) &&
          (rsp->head.flags & kFlagCrc)) {
        std::string cerr;
        if (!verify_msg_crc(*rsp, &cerr)) {
          crc_reject_count_.fetch_add(1, std::memory_order_relaxed);
          throw std::runtime_error("server " + std::to_string(server) +
                                   " response CRC mismatch: " + cerr);
        }
      }
      return true;
    } catch (const RetryableReject& e) {
      *last_err = e.what();
      if (rejected) *rejected = true;
      return false;  // stream intact — no close, just resend
    } catch (const std::exception& e) {
      std::string what = e.what();
      if (what.rfind("server error:", 0) == 0) throw;  // app-level: no retry
      *last_err = what;
      conns[server]->close();
      return false;
    }
  }

  // try_roundtrip plus the chaos engine's faults: `cd` is this MESSAGE's
  // scheduled fault (applied on the first attempt only — retries go
  // clean, like a real network where the fault hit one packet), while the
  // directed-partition check applies to EVERY attempt (a real partition
  // blocks retries too, until its window closes).
  bool try_roundtrip_chaos(std::vector<std::unique_ptr<Conn>>& conns,
                           size_t server, int ch, Message& req, Message* rsp,
                           std::string* last_err, const ChaosDecision& cd,
                           ChaosEngine* ce, bool* rejected = nullptr) {
    if (ce && ce->partition_blocked(static_cast<int32_t>(server), ch,
                                    req.head.type, req.head.tensor_id)) {
      *last_err = "chaos: directed partition to server " +
                  std::to_string(server) + " (injected)";
      conns[server]->close();  // a real partition kills the stream too
      return false;
    }
    // events are recorded HERE, when a fault actually fires — a decision
    // preempted by the partition block above (or a corrupt that degrades)
    // leaves no event, so the drained log never over-claims
    const auto applied = [&](ChaosKind k, int64_t arg) {
      ce->record_applied(k, static_cast<int32_t>(server), req.head.type,
                         req.head.tensor_id, cd.seq, arg);
    };
    switch (cd.kind) {
      case ChaosKind::kNone:
        return try_roundtrip(conns, server, req, rsp, last_err,
                             static_cast<size_t>(-1), 0, rejected);
      case ChaosKind::kDelay:
      case ChaosKind::kReorder:
        // the held request lets sibling RPCs (other servers, the other
        // channel) overtake it — delivery reordering at message level
        applied(cd.kind, cd.arg);
        std::this_thread::sleep_for(std::chrono::milliseconds(cd.arg));
        return try_roundtrip(conns, server, req, rsp, last_err,
                             static_cast<size_t>(-1), 0, rejected);
      case ChaosKind::kDrop:
        // request lost on the wire: never sent, stream untouched
        applied(cd.kind, cd.arg);
        *last_err = "chaos: request dropped (injected)";
        return false;
      case ChaosKind::kDropRsp: {
        // the applied-but-unacked window: the server executes, the
        // response is lost. The retry resends the SAME req_id and must be
        // answered from the dedup slot without a second apply. Recorded
        // only when the server actually executed (a transport failure
        // here means no response existed to drop).
        if (!try_roundtrip(conns, server, req, rsp, last_err,
                           static_cast<size_t>(-1), 0, rejected))
          return false;
        applied(cd.kind, cd.arg);
        *rsp = Message();
        *last_err = "chaos: response dropped after execution (injected)";
        return false;
      }
      case ChaosKind::kDup: {
        // duplicate delivery: the same req_id arrives twice back-to-back;
        // the second copy must be served from the dedup slot (we return
        // ITS response, so a divergence would surface immediately)
        if (!try_roundtrip(conns, server, req, rsp, last_err,
                           static_cast<size_t>(-1), 0, rejected))
          return false;
        applied(cd.kind, cd.arg);
        Message second;
        if (!try_roundtrip(conns, server, req, &second, last_err,
                           static_cast<size_t>(-1), 0, rejected))
          return false;
        *rsp = std::move(second);
        return true;
      }
      case ChaosKind::kCorrupt: {
        // flip one payload byte ON THE WIRE — after the checksums are
        // computed (net.h send_msg), exactly where a real bit-flip lands,
        // so the server's CRC verify is what must catch it; the clean
        // retry must then apply exactly once. Requires the CRC leg
        // (without it the corruption would be APPLIED, which is the
        // disease, not the test); with CRC off or no payload the fault
        // degrades to a clean send.
        size_t ai = 0, best = 0;
        for (size_t i = 0; i < req.args.size(); ++i)
          if (req.args[i].buf.size() > best) {
            best = req.args[i].buf.size();
            ai = i;
          }
        if (best == 0 || !crc_on_.load(std::memory_order_relaxed))
          return try_roundtrip(conns, server, req, rsp, last_err,
                               static_cast<size_t>(-1), 0, rejected);
        bool rej = false;
        const bool ok = try_roundtrip(conns, server, req, rsp, last_err, ai,
                                      static_cast<size_t>(cd.arg), &rej);
        // recorded only when the corrupted bytes actually REACHED a
        // receiver — a reject (the expected path) or, hypothetically, a
        // CRC collision that got through. A send that failed at the
        // transport (peer closed first) put nothing on the wire, and
        // logging it would over-claim; the clean retry resends anyway
        // (the corruption lived only in the wire buffer).
        if (ok || rej)
          ce->record_applied(ChaosKind::kCorrupt,
                             static_cast<int32_t>(server), req.head.type,
                             req.head.tensor_id, cd.seq,
                             static_cast<int64_t>(
                                 static_cast<uint64_t>(cd.arg) % best));
        if (rej && rejected) *rejected = true;
        return ok;
      }
      case ChaosKind::kPartition:
        break;  // never scheduled by decide(); handled per-attempt above
    }
    return try_roundtrip(conns, server, req, rsp, last_err,
                         static_cast<size_t>(-1), 0, rejected);
  }

  Message rpc(size_t server, Message& req) {
    // serialize the whole round trip per (server, channel) connection:
    // concurrency comes from the pool issuing to different servers — and
    // from fast-channel requests overtaking bulk transfers
    const int ch = is_bulk(static_cast<PsfType>(req.head.type)) ? 0 : 1;
    auto& conns = ch == 0 ? servers_ : servers_fast_;
    std::lock_guard<std::mutex> g(server_mu_[ch][server % kMaxServers]);
    rpc_count_.fetch_add(1, std::memory_order_relaxed);
    // hetutrail: span start AFTER the per-(server, channel) lock — the span
    // measures wire + server time, not local queueing behind a sibling RPC
    const bool trail = trail_on_.load(std::memory_order_relaxed);
    const int64_t tr0 = trail ? trail_mono_us() : 0;
    req.head.req_id = next_req_id_.fetch_add(1);
    // per-channel client identity: the server's resend-dedup slot assumes
    // monotonic req_ids per client, which holds per channel but not across
    // the two interleaved channels
    req.head.client_id = rank_ * 2 + ch;
    // hetu-elastic membership stamp: an armed server rejects a mismatched
    // non-zero epoch (a straggler that missed a resize commit); 0 (the
    // default, non-elastic runs) is always accepted
    req.head.world_ver = static_cast<int32_t>(
        world_version_.load(std::memory_order_relaxed));
    // hetuchaos hardening: checksum the payload and ask the server to
    // verify + checksum its response (net.h kFlagCrc)
    if (crc_on_.load(std::memory_order_relaxed)) req.head.flags |= kFlagCrc;
    // one scheduled-fault roll per logical RPC (off-mode: one relaxed load)
    ChaosEngine* ce = chaos_.load(std::memory_order_acquire);
    ChaosDecision cd;
    if (ce) cd = ce->decide(static_cast<int32_t>(server), req.head.type,
                            req.head.tensor_id);
    using Clock = std::chrono::steady_clock;
    const auto rpc_deadline =
        rpc_timeout_ms_ > 0
            ? Clock::now() + std::chrono::milliseconds(rpc_timeout_ms_)
            : Clock::time_point::max();
    std::string last_err;
    bool sched_saw_alive = false;  // partition-vs-dead classification
    Message rsp;
    // phase 1: bounded retries with exponential backoff + jitter. The
    // resend rides the (client_id, req_id) dedup ledger, so a request
    // that EXECUTED but whose response was lost is answered from the
    // slot, never applied twice — PR 4's re-issue proof generalized from
    // failover-only to every retry.
    bool was_reject = false;  // last failure was a retryable server reject
    for (int attempt = 0; attempt <= max_retry_; ++attempt) {
      if (attempt > 0) {
        retry_count_.fetch_add(1, std::memory_order_relaxed);
        // a retryable reject (CRC mismatch) came from a HEALTHY server
        // over an in-sync stream: resend immediately on the live socket —
        // backoff is a congestion/death signal, and the scheduler query +
        // reconnect would throw away the intact connection for nothing
        if (!was_reject) {
          const int64_t bo = backoff_ms(attempt, backoff_base_ms_,
                                        backoff_cap_ms_, req.head.req_id);
          backoff_ms_total_.fetch_add(static_cast<uint64_t>(bo),
                                      std::memory_order_relaxed);
          std::this_thread::sleep_for(std::chrono::milliseconds(bo));
          if (Clock::now() >= rpc_deadline) {
            timeout_count_.fetch_add(1, std::memory_order_relaxed);
            last_err += " (DMLC_PS_RPC_TIMEOUT_MS=" +
                        std::to_string(rpc_timeout_ms_) + " exhausted)";
            break;
          }
          auto st = query_server_status(server);
          sched_saw_alive = st.sched_ok && st.alive;
          {
            // both channels' retry paths may relocate the same server
            // concurrently (they hold different per-channel mutexes)
            std::lock_guard<std::mutex> ag(addr_mu_);
            server_addrs_[server] = st.addr;
          }
          if (!st.alive && attempt == max_retry_) break;  // declared dead
          try {
            conns[server] = std::make_unique<Conn>(
                connect_addr(st.addr, /*retries=*/30, /*wait_ms=*/100));
          } catch (const std::exception& e) {
            last_err = e.what();
            continue;
          }
        }
      }
      was_reject = false;
      if (try_roundtrip_chaos(conns, server, ch, req, &rsp, &last_err,
                              attempt == 0 ? cd : ChaosDecision(), ce,
                              &was_reject)) {
        if (trail) trail_record(req, rsp, server, tr0);
        if (is_write_apply(static_cast<PsfType>(req.head.type)))
          push_ok_count_.fetch_add(1, std::memory_order_relaxed);
        return rsp;
      }
    }
    // phase 2 (opt-in): the server is gone OR partitioned from this
    // worker — block-with-deadline until the supervisor's replacement
    // registers (or the partition heals), then re-issue the SAME request
    // (unchanged req_id: the server's (client_id, req_id) dedup — live
    // slot or snapshot-restored ledger — makes re-issue safe). On
    // deadline, fall through to the same error the non-failover path
    // raises, so supervise() still catches the unrecoverable case.
    if (failover_ms_ > 0) {
      const auto deadline =
          Clock::now() + std::chrono::milliseconds(failover_ms_);
      std::fprintf(stderr,
                   "[hetups worker %d] server %zu unreachable (%s); failover:"
                   " waiting up to %d ms for a replacement\n",
                   rank_, server, last_err.c_str(), failover_ms_);
      while (Clock::now() < deadline) {
        auto st = query_server_status(server);
        sched_saw_alive = st.sched_ok && st.alive;
        {
          std::lock_guard<std::mutex> ag(addr_mu_);
          server_addrs_[server] = st.addr;
        }
        if (st.alive) {  // heartbeat fresh: replacement or healed partition
          bool connected = false;
          try {
            conns[server] = std::make_unique<Conn>(
                connect_addr(st.addr, /*retries=*/5, /*wait_ms=*/100));
            connected = true;
          } catch (const std::exception& e) {
            last_err = e.what();
          }
          if (connected &&
              try_roundtrip_chaos(conns, server, ch, req, &rsp, &last_err,
                                  ChaosDecision(), ce)) {
            if (trail) trail_record(req, rsp, server, tr0);
            if (is_write_apply(static_cast<PsfType>(req.head.type)))
              push_ok_count_.fetch_add(1, std::memory_order_relaxed);
            failover_count_.fetch_add(1, std::memory_order_relaxed);
            std::fprintf(stderr,
                         "[hetups worker %d] server %zu recovered at %s; "
                         "request re-issued\n",
                         rank_, server, st.addr.c_str());
            return rsp;
          }
        }
        std::this_thread::sleep_for(
            std::chrono::milliseconds(failover_poll_ms_));
      }
      throw std::runtime_error(
          "PS server " + std::to_string(server) +
          " unreachable: no replacement within the failover deadline (" +
          std::to_string(failover_ms_) + " ms; " + last_err + ")" +
          partition_diag(server, sched_saw_alive));
    }
    throw std::runtime_error(
        "PS server " + std::to_string(server) + " unreachable after " +
        std::to_string(max_retry_ + 1) + " attempts (" + last_err + ")" +
        partition_diag(server, sched_saw_alive));
  }

  // Partial-partition escalation diagnosis: when the scheduler is
  // reachable and reports the server's heartbeat FRESH while this
  // worker's RPCs keep failing, the fault is a directed client<->server
  // partition, not a dead server — the caller should take the PR 4
  // failover / PR 11 departure path instead of blocking on a respawn
  // that will never come (the server isn't down). Scheduler-unreachable
  // keeps the plain error (the Python side's typed SchedulerUnreachable
  // owns that case).
  static std::string partition_diag(size_t server, bool sched_saw_alive) {
    if (!sched_saw_alive) return "";
    return " — directed partition suspected: the scheduler is reachable "
           "and server " +
           std::to_string(server) +
           "'s heartbeat is fresh, but this worker cannot complete an RPC "
           "to it; escalate via the failover/departure path "
           "(DMLC_PS_FAILOVER_DEADLINE_MS / hetu-elastic) instead of "
           "waiting for a respawn";
  }

  // PSF types whose success ticks the server's optimizer update counter
  // exactly once (begin_req) — the client-side half of the update-counter
  // accounting invariant (see client_stats).
  static bool is_write_apply(PsfType t) {
    switch (t) {
      case PsfType::kDensePush:
      case PsfType::kDDPushPull:
      case PsfType::kSparsePush:
      case PsfType::kSDPushPull:
      case PsfType::kSSPushPull:
      case PsfType::kPushEmbedding:
      case PsfType::kPushSyncEmbedding:
        return true;
      default:
        return false;
    }
  }

  // hetutrail: bounded ring append (drop-new + counter when full — the
  // always-on cost contract is a fixed memory ceiling, like the flight
  // recorder, never an unbounded buffer).
  void trail_record(const Message& req, const Message& rsp, size_t server,
                    int64_t t0_us) {
    TrailSpan s;
    s.req_id = req.head.req_id;
    s.client_id = req.head.client_id;
    s.server = static_cast<int32_t>(server);
    s.psf = req.head.type;
    s.tensor = req.head.tensor_id;
    s.step = trail_step_.load(std::memory_order_relaxed);
    s.t0_us = t0_us;
    s.dur_us = trail_mono_us() - t0_us;
    s.req_bytes = 0;
    for (const auto& a : req.args)
      s.req_bytes += static_cast<int64_t>(a.buf.size());
    s.rsp_bytes = 0;
    for (const auto& a : rsp.args)
      s.rsp_bytes += static_cast<int64_t>(a.buf.size());
    std::lock_guard<std::mutex> g(trail_mu_);
    if (trail_ring_.size() >= trail_cap_) {
      trail_dropped_.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    trail_ring_.push_back(s);
  }

  template <typename F>
  void guarded(int32_t key, F&& f) {
    try {
      f();
      pending_.done(key);
    } catch (const std::exception& e) {
      pending_.fail(key, e.what());
    }
  }

  static int32_t query_key(query_t q) {
    return static_cast<int32_t>(q % 1000000) + 1000000000;
  }

  query_t data_op(PsfType type, int32_t key, const uint64_t* ids, size_t n,
                  float* vals, const int64_t* lens) {
    query_t q = next_query_++;
    // shard by id hash across servers
    struct Shard {
      std::vector<uint64_t> ids;
      std::vector<int64_t> lens;
      std::vector<size_t> offs;  // offsets into vals
    };
    auto shards = std::make_shared<std::vector<Shard>>(servers_.size());
    size_t off = 0;
    for (size_t i = 0; i < n; ++i) {
      size_t s = ids[i] % servers_.size();
      (*shards)[s].ids.push_back(ids[i]);
      (*shards)[s].lens.push_back(lens[i]);
      (*shards)[s].offs.push_back(off);
      off += static_cast<size_t>(lens[i]);
    }
    pending_.add(query_key(q), static_cast<int>(servers_.size()));
    for (size_t s = 0; s < servers_.size(); ++s) {
      pool_.submit([=] {
        guarded(query_key(q), [&] {
          auto& sh = (*shards)[s];
          if (sh.ids.empty()) return;
          Message req;
          req.head.type = static_cast<int32_t>(type);
          req.head.tensor_id = key;
          req.args.push_back(Arg::u64(sh.ids.data(), sh.ids.size()));
          req.args.push_back(Arg::i64(sh.lens.data(), sh.lens.size()));
          if (type == PsfType::kDataPush) {
            std::vector<float> payload;
            for (size_t i = 0; i < sh.ids.size(); ++i)
              payload.insert(payload.end(), vals + sh.offs[i],
                             vals + sh.offs[i] + sh.lens[i]);
            req.args.push_back(Arg::f32(payload.data(), payload.size()));
            rpc(s, req);
          } else {
            Message rsp = rpc(s, req);
            const float* rows = rsp.args[0].as_f32();
            size_t roff = 0;
            for (size_t i = 0; i < sh.ids.size(); ++i) {
              std::memcpy(vals + sh.offs[i], rows + roff, sh.lens[i] * 4);
              roff += static_cast<size_t>(sh.lens[i]);
            }
          }
        });
      });
    }
    return q;
  }

  static constexpr size_t kMaxServers = 64;

  int rank_, num_workers_;
  bool finalized_ = false;
  std::string sched_host_;
  int sched_port_ = 0;
  int recv_timeout_ms_ = 15000;
  int max_retry_ = 3;
  int failover_ms_ = 0;        // DMLC_PS_FAILOVER_DEADLINE_MS (0 = off)
  int failover_poll_ms_ = 500;
  // Seeded from the wall clock, not 1: servers keep a per-client_id dedup
  // slot (live, and persisted across server restarts in the snapshot
  // ledger), and a RESTARTED worker process reuses its rank's client_id.
  // If its ids restarted at 1 they would sit below the slot's last_id and
  // every request would be dropped as a pre-reconnect straggler. The wall
  // clock alone is NOT monotonic across incarnations (NTP step-back), so
  // registration folds the scheduler's per-rank incarnation epoch into
  // bits 51+ — the scheduler observes every incarnation in order, making
  // the seed strictly increasing per rank no matter what the clock does.
  static uint64_t boot_req_id() {
    return static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::microseconds>(
            std::chrono::system_clock::now().time_since_epoch())
            .count());
  }
  std::atomic<uint64_t> next_req_id_{boot_req_id()};
  std::atomic<uint64_t> rpc_count_{0};       // telemetry (client_stats)
  std::atomic<uint64_t> retry_count_{0};
  std::atomic<uint64_t> failover_count_{0};
  // hetuchaos hardening counters + engine (docs/FAULT_TOLERANCE.md)
  std::atomic<uint64_t> timeout_count_{0};     // recv/deadline timeouts
  std::atomic<uint64_t> backoff_ms_total_{0};  // retry backoff slept
  std::atomic<uint64_t> crc_reject_count_{0};  // server rejects + rsp fails
  std::atomic<uint64_t> push_ok_count_{0};     // logical write RPCs landed
  std::atomic<bool> crc_on_{true};             // HETU_PS_CRC / SetPsCrc
  int backoff_base_ms_ = 10;                   // DMLC_PS_BACKOFF_BASE_MS
  int backoff_cap_ms_ = 2000;                  // DMLC_PS_BACKOFF_CAP_MS
  int rpc_timeout_ms_ = 0;                     // DMLC_PS_RPC_TIMEOUT_MS
  std::atomic<ChaosEngine*> chaos_{nullptr};
  mutable std::mutex chaos_mu_;                // guards chaos_owned_
  std::vector<std::unique_ptr<ChaosEngine>> chaos_owned_;
  // hetuq: quantized-wire state + raw-vs-wire accounting over every
  // quantizable value payload (pushes and pull responses; counted in BOTH
  // modes so off==raw is the A/B denominator)
  std::atomic<bool> quant_{false};
  std::atomic<bool> corrupt_armed_{false};
  // hetu-elastic: this worker's committed membership epoch (stamped onto
  // every request header; 0 until an ElasticAgent arms it)
  std::atomic<uint64_t> world_version_{0};
  std::atomic<int32_t> corrupt_tensor_{-1};
  std::atomic<uint64_t> val_raw_bytes_{0};
  std::atomic<uint64_t> val_wire_bytes_{0};
  std::unique_ptr<Conn> sched_;
  std::mutex sched_mu_;
  std::mutex addr_mu_;   // guards server_addrs_ (both channels' retries)
  std::vector<std::string> server_addrs_;
  std::vector<std::unique_ptr<Conn>> servers_;       // bulk channel
  std::vector<std::unique_ptr<Conn>> servers_fast_;  // pulls/control channel
  std::mutex server_mu_[2][kMaxServers];
  ThreadPool pool_;
  PendingTracker pending_;
  std::mutex meta_mu_;
  std::unordered_map<int32_t, TensorMeta> metas_;
  std::mutex opts_mu_;
  std::unordered_map<int32_t, std::array<float, 3>> push_opts_;
  // hetutrail client-span ring (armed by HETU_TRAIL_DIR)
  std::atomic<bool> trail_on_{false};
  std::atomic<int64_t> trail_step_{0};
  std::atomic<uint64_t> trail_dropped_{0};
  size_t trail_cap_ = 65536;
  std::mutex trail_mu_;
  // deque, not vector: the drain erases from the FRONT in 4096-row
  // batches while trail_mu_ blocks concurrent rpc records — a vector
  // would memmove the whole remaining ring per batch
  std::deque<TrailSpan> trail_ring_;
  std::atomic<query_t> next_query_{1};
  std::mutex loads_mu_;
  std::string record_dir_;
  std::unordered_map<std::string, uint64_t> loads_;

  void record(const char* op, size_t bytes) {
    std::lock_guard<std::mutex> g(loads_mu_);
    loads_[op] += bytes;
  }
};

}  // namespace hetups
