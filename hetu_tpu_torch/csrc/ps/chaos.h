// hetuchaos: deterministic message-level fault injection for the PS
// transport (docs/FAULT_TOLERANCE.md "Chaos testing & transport hardening").
//
// The engine sits INSIDE the worker's rpc path and injects the faults a
// real network inflicts — drop, delay, duplicate, reorder, corrupt-bytes,
// directed partitions — so the hardening that survives them (retry with
// backoff riding the req_id dedup ledger, CRC32C payload rejection,
// partition escalation) is proven by the same machinery that will face
// them in production. Three contracts:
//
//  - DETERMINISM. Every decision is a pure function of (seed, server, psf,
//    tensor, per-triple sequence number) — never of wall time or thread
//    interleaving — so a failing schedule replays bit-identically from its
//    seed: the canonical (sorted) chaos event log of two runs of the same
//    workload under the same spec is EQUAL (tests/test_chaos.py pins it).
//    The per-triple counters are deterministic because each tensor's RPC
//    stream to each server is issued in program order.
//  - OFF-MODE ZERO COST. With no spec armed the worker pays one relaxed
//    atomic pointer load per RPC and nothing else (the telemetry/scope
//    off-mode convention).
//  - GATED. Arming requires HETU_TEST_MODE (enforced in capi.cc AND at the
//    worker's env-arming path), like every destructive hook in this repo.
//
// Spec grammar (HETU_CHAOS_SPEC / SetChaos; mirrored by
// hetu_tpu.chaos.parse_spec):
//
//   spec      := entry ("," entry)*
//   entry     := "seed=" u64
//              | "drop=" p          # request never sent; client retries
//              | "droprsp=" p       # response discarded after the server
//                                   # executed — the applied-but-unacked
//                                   # window; retry must dedup-replay
//              | "dup=" p           # request sent twice; the second copy
//                                   # must be answered from the dedup slot
//              | "corrupt=" p       # one payload byte flipped on the wire;
//                                   # the receiver's CRC must reject it
//                                   # (skipped when the client runs CRC-off)
//              | "delay=" p [":" max_ms]    # sleep 1..max_ms before send
//              | "reorder=" p [":" max_ms]  # same mechanics, logged as
//                                   # reorder: the held request lets sibling
//                                   # RPCs (other servers / the other
//                                   # channel) overtake it
//              | "partition=" server ":" from ":" count
//                                   # every attempt (initial or retry) to
//                                   # `server` while the per-(server,
//                                   # channel) attempt counter is in
//                                   # [from, from+count) fails — a directed
//                                   # client<->server partition that heals
//                                   # deterministically, or escalates to
//                                   # the failover/departure path if it
//                                   # outlives the retry budget
//
// Probabilities are cumulative-walked in a fixed order (drop, droprsp, dup,
// corrupt, delay, reorder); at most ONE scheduled fault per message.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <deque>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace hetups {

// Mirrored by hetu_tpu.chaos.splitmix64 (the backoff-jitter tests pin both
// sides to the same values).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// Numeric kind ids are the wire/drain contract (hetu_tpu.chaos.KIND_NAMES).
enum class ChaosKind : int32_t {
  kNone = 0,
  kDrop = 1,
  kDelay = 2,
  kDup = 3,
  kReorder = 4,
  kCorrupt = 5,
  kPartition = 6,
  kDropRsp = 7,
};

struct ChaosDecision {
  ChaosKind kind = ChaosKind::kNone;
  int64_t arg = 0;  // delay/reorder: ms; corrupt: byte-offset selector
  int64_t seq = 0;  // the deciding per-triple sequence number
};

// One injected fault, drained as a 6-wide i64 row:
// [kind, server, psf, tensor, seq, arg].
struct ChaosEvent {
  int32_t kind, server, psf, tensor;
  int64_t seq, arg;
};

class ChaosEngine {
 public:
  static constexpr size_t kEventCols = 6;

  // Throws std::runtime_error naming the bad entry + the grammar on any
  // unknown key (the HETU_FAULT_SPEC reject-unknown-kinds convention).
  static std::unique_ptr<ChaosEngine> parse(const std::string& spec) {
    auto eng = std::unique_ptr<ChaosEngine>(new ChaosEngine());
    size_t pos = 0;
    while (pos <= spec.size()) {
      size_t comma = spec.find(',', pos);
      if (comma == std::string::npos) comma = spec.size();
      std::string ent = spec.substr(pos, comma - pos);
      pos = comma + 1;
      // trim
      while (!ent.empty() && (ent.front() == ' ')) ent.erase(0, 1);
      while (!ent.empty() && (ent.back() == ' ')) ent.pop_back();
      if (ent.empty()) continue;
      const size_t eq = ent.find('=');
      if (eq == std::string::npos)
        throw std::runtime_error("chaos spec entry '" + ent +
                                 "': expected key=value");
      const std::string key = ent.substr(0, eq);
      const std::string val = ent.substr(eq + 1);
      if (key == "seed") {
        char* end = nullptr;
        eng->seed_ = std::strtoull(val.c_str(), &end, 10);
        if (val.empty() || !end || *end != '\0')
          throw std::runtime_error("chaos spec entry '" + ent +
                                   "': seed must be an unsigned integer");
      } else if (key == "drop") {
        eng->p_drop_ = parse_p(ent, val);
      } else if (key == "droprsp") {
        eng->p_droprsp_ = parse_p(ent, val);
      } else if (key == "dup") {
        eng->p_dup_ = parse_p(ent, val);
      } else if (key == "corrupt") {
        eng->p_corrupt_ = parse_p(ent, val);
      } else if (key == "delay" || key == "reorder") {
        const size_t colon = val.find(':');
        const double p = parse_p(ent, val.substr(0, colon));
        // per-kind defaults match the member initializers AND the Python
        // mirror (ChaosSpec.delay_ms / .reorder_ms; a trailing ':' keeps
        // the default there too, a non-numeric ms raises on both sides)
        int64_t ms = key == "delay" ? 20 : 10;
        if (colon != std::string::npos && colon + 1 < val.size()) {
          char* end = nullptr;
          ms = std::strtoll(val.c_str() + colon + 1, &end, 10);
          if (!end || *end != '\0')
            throw std::runtime_error("chaos spec entry '" + ent +
                                     "': ms must be an integer");
        }
        if (ms < 1) ms = 1;
        if (key == "delay") {
          eng->p_delay_ = p;
          eng->delay_ms_ = ms;
        } else {
          eng->p_reorder_ = p;
          eng->reorder_ms_ = ms;
        }
      } else if (key == "partition") {
        // server:from:count
        Window w;
        char* end = nullptr;
        w.server = static_cast<int32_t>(std::strtol(val.c_str(), &end, 10));
        if (!end || *end != ':')
          throw std::runtime_error("chaos spec entry '" + ent +
                                   "': partition=SERVER:FROM:COUNT");
        w.from = std::strtoull(end + 1, &end, 10);
        if (!end || *end != ':')
          throw std::runtime_error("chaos spec entry '" + ent +
                                   "': partition=SERVER:FROM:COUNT");
        w.count = std::strtoull(end + 1, nullptr, 10);
        eng->partitions_.push_back(w);
      } else {
        throw std::runtime_error(
            "chaos spec entry '" + ent + "': unknown kind '" + key +
            "' — known: seed, drop, droprsp, dup, corrupt, delay[:ms], "
            "reorder[:ms], partition=SERVER:FROM:COUNT "
            "(docs/FAULT_TOLERANCE.md)");
      }
    }
    return eng;
  }

  // One scheduled-fault roll per logical RPC (retries of the same RPC do
  // NOT re-roll — the decision belongs to the message, not the attempt).
  // Decisions are NOT recorded here: the applier (worker.h
  // try_roundtrip_chaos) calls record_applied for the faults that
  // actually fire, so the event log never over-claims — a scheduled
  // fault preempted by a directed-partition block, or a corrupt that
  // degrades on a payload-less/CRC-off message, leaves no event. Every
  // degrade condition is itself deterministic (partition windows walk
  // per-(server, channel) attempt counters in program order; message
  // shape and the CRC setting are fixed per run), so replay equality
  // still holds.
  ChaosDecision decide(int32_t server, int32_t psf, int32_t tensor) {
    const uint64_t k = triple_key(server, psf, tensor);
    uint64_t seq;
    {
      std::lock_guard<std::mutex> g(mu_);
      seq = ++seq_[k];
    }
    const uint64_t h =
        splitmix64(seed_ ^ splitmix64(k) ^ (seq * 0x2545F4914F6CDD1Dull));
    // 53-bit uniform in [0, 1)
    const double u = static_cast<double>(h >> 11) / 9007199254740992.0;
    ChaosDecision d;
    d.seq = static_cast<int64_t>(seq);
    double c = 0.0;
    if (u < (c += p_drop_)) {
      d.kind = ChaosKind::kDrop;
    } else if (u < (c += p_droprsp_)) {
      d.kind = ChaosKind::kDropRsp;
    } else if (u < (c += p_dup_)) {
      d.kind = ChaosKind::kDup;
    } else if (u < (c += p_corrupt_)) {
      d.kind = ChaosKind::kCorrupt;
      d.arg = static_cast<int64_t>(splitmix64(h) >> 1);  // offset selector
    } else if (u < (c += p_delay_)) {
      d.kind = ChaosKind::kDelay;
      d.arg = 1 + static_cast<int64_t>(splitmix64(h) %
                                       static_cast<uint64_t>(delay_ms_));
    } else if (u < (c += p_reorder_)) {
      d.kind = ChaosKind::kReorder;
      d.arg = 1 + static_cast<int64_t>(splitmix64(h) %
                                       static_cast<uint64_t>(reorder_ms_));
    }
    return d;
  }

  // The applier's log entry for a fault that actually fired (see the
  // decide() contract above).
  void record_applied(ChaosKind kind, int32_t server, int32_t psf,
                      int32_t tensor, int64_t seq, int64_t arg) {
    record(kind, server, psf, tensor, seq, arg);
  }

  // Per-ATTEMPT partition check (unlike decide's per-message roll): a real
  // partition blocks retries too. The counter is per (server, channel) so
  // the WINDOW [from, from+count) is deterministic; WHICH message lands
  // in it depends on pool-thread interleaving when several tensors share
  // the channel — so the event records the deterministic fact (window
  // hit at attempt `a` on `channel`, carried in seq/arg) with psf/tensor
  // zeroed, keeping the canonical replay-log contract for partition
  // faults too (the racy victim identity is in last_err, not the log).
  bool partition_blocked(int32_t server, int32_t channel, int32_t psf,
                         int32_t tensor) {
    (void)psf;
    (void)tensor;
    if (partitions_.empty()) return false;
    bool targets = false;
    for (const Window& w : partitions_)
      if (w.server == server) targets = true;
    if (!targets) return false;
    uint64_t a;
    {
      std::lock_guard<std::mutex> g(mu_);
      a = att_[static_cast<uint64_t>(server) * 2 +
               static_cast<uint64_t>(channel)]++;
    }
    for (const Window& w : partitions_) {
      if (w.server == server && a >= w.from && a < w.from + w.count) {
        record(ChaosKind::kPartition, server, /*psf=*/0, /*tensor=*/0,
               static_cast<int64_t>(a), channel);
        return true;
      }
    }
    return false;
  }

  // Copy up to max_rows events (oldest first) out as kEventCols-wide i64
  // rows, removing them from the ring. Returns the row count.
  size_t drain(int64_t* out, size_t max_rows) {
    std::lock_guard<std::mutex> g(mu_);
    const size_t n = std::min(max_rows, ring_.size());
    for (size_t i = 0; i < n; ++i) {
      const ChaosEvent& e = ring_[i];
      int64_t* r = out + i * kEventCols;
      r[0] = e.kind;
      r[1] = e.server;
      r[2] = e.psf;
      r[3] = e.tensor;
      r[4] = e.seq;
      r[5] = e.arg;
    }
    ring_.erase(ring_.begin(), ring_.begin() + n);
    return n;
  }

  uint64_t fault_count() const {
    return fault_count_.load(std::memory_order_relaxed);
  }
  uint64_t dropped_events() const {
    return dropped_.load(std::memory_order_relaxed);
  }
  uint64_t seed() const { return seed_; }

 private:
  ChaosEngine() = default;

  static double parse_p(const std::string& ent, const std::string& val) {
    char* end = nullptr;
    const double p = std::strtod(val.c_str(), &end);
    // val.empty()/no-digits check: strtod("") "succeeds" at 0.0, which
    // the Python mirror rejects — the grammars must agree on rejection.
    // The negated range form also rejects NaN (every comparison with NaN
    // is false, so `p < 0 || p > 1` would let it through).
    if (val.empty() || end == val.c_str() || !end || *end != '\0' ||
        !(p >= 0.0 && p <= 1.0))
      throw std::runtime_error("chaos spec entry '" + ent +
                               "': probability must be in [0, 1]");
    return p;
  }

  static uint64_t triple_key(int32_t server, int32_t psf, int32_t tensor) {
    return static_cast<uint64_t>(static_cast<uint32_t>(server)) |
           (static_cast<uint64_t>(static_cast<uint32_t>(psf)) << 16) |
           (static_cast<uint64_t>(static_cast<uint32_t>(tensor)) << 32);
  }

  void record(ChaosKind kind, int32_t server, int32_t psf, int32_t tensor,
              int64_t seq, int64_t arg) {
    fault_count_.fetch_add(1, std::memory_order_relaxed);
    std::lock_guard<std::mutex> g(mu_);
    if (ring_.size() >= kRingCap) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    ring_.push_back({static_cast<int32_t>(kind), server, psf, tensor, seq,
                     arg});
  }

  struct Window {
    int32_t server = 0;
    uint64_t from = 0, count = 0;
  };

  static constexpr size_t kRingCap = 65536;

  uint64_t seed_ = 0;
  double p_drop_ = 0, p_droprsp_ = 0, p_dup_ = 0, p_corrupt_ = 0,
         p_delay_ = 0, p_reorder_ = 0;
  int64_t delay_ms_ = 20, reorder_ms_ = 10;
  std::vector<Window> partitions_;
  std::mutex mu_;
  std::unordered_map<uint64_t, uint64_t> seq_;  // triple -> message seq
  std::unordered_map<uint64_t, uint64_t> att_;  // (server, ch) -> attempts
  std::deque<ChaosEvent> ring_;
  std::atomic<uint64_t> fault_count_{0};
  std::atomic<uint64_t> dropped_{0};
};

// Deterministic retry backoff: exponential base<<(attempt-1) capped at
// `cap`, scaled by a jitter in [0.5, 1.0) derived from splitmix64 — pure
// integer math, mirrored bit-for-bit by hetu_tpu.chaos.backoff_ms (the
// fake-clock schedule tests pin both sides).
inline int64_t backoff_ms(int attempt, int64_t base, int64_t cap,
                          uint64_t key) {
  if (attempt < 1) attempt = 1;
  int64_t exp = base << std::min(attempt - 1, 20);
  if (exp > cap) exp = cap;
  const int64_t j =
      static_cast<int64_t>(splitmix64(key ^ static_cast<uint64_t>(attempt)) %
                           500ull);
  return exp * (500 + j) / 1000;
}

}  // namespace hetups
