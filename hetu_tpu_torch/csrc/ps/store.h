// Server-side parameter store + optimizers.
//
// Capability parity with the reference's ps-lite server:
//  - Key -> Param/Param2D/CacheTable store with shared-mutex read/write guards
//    (reference include/ps/server/PSFHandle.h:24, param.h).
//  - Server-side optimizers SGD/Momentum/Nesterov/AdaGrad/Adam with
//    ApplyDense/ApplySparse/ApplyCache and version increment on cache apply
//    (reference include/ps/server/optimizer.h:15-75).
//  - Initializers evaluated ON the server (reference initializers.py:28-39
//    init_on_ps -> InitTensor RPC).
#pragma once

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace hetups {

enum class ParamKind : int32_t { kDense = 0, kSparse = 1, kCacheTable = 2 };
enum class InitType : int32_t { kConstant = 0, kUniform = 1, kNormal = 2, kTruncatedNormal = 3 };
enum class OptType : int32_t { kSGD = 0, kMomentum = 1, kNesterov = 2, kAdaGrad = 3, kAdam = 4 };

// One stored parameter shard. Dense params are (len) vectors; sparse params
// and cache tables are (rows x width) row-major matrices, where `rows` is
// this server's row range after partitioning.
struct Param {
  ParamKind kind = ParamKind::kDense;
  size_t len = 0;    // dense: total f32s on this shard; sparse: rows*width
  size_t rows = 0;   // sparse/cache only
  size_t width = 0;  // sparse/cache only
  std::vector<float> data;

  // optimizer config + slots
  OptType otype = OptType::kSGD;
  std::vector<float> lrs;     // lrs[0] = lr; adam: lr,beta1,beta2,eps
  std::vector<float> accum;   // momentum buffer / adagrad accum / adam m
  std::vector<float> accum2;  // adam v
  uint64_t step = 0;          // adam bias-correction step

  // cache-table row versions (reference embedding.h:19-40 Line::version);
  // signed: the CLIENT uses -1 as the "never synced, always pull" sentinel
  // (reference PSFhandle_embedding.cc:49); server rows start at 0
  std::vector<int64_t> versions;

  // seq of the last applied write (guarded by mu, stamped by server.h's
  // mark lambda): take_snapshot compares it against the seq each shard
  // file was saved at to decide whether a client's last write made it
  // into the snapshot — the dedup-ledger provenance filter
  uint64_t last_write_seq = 0;

  mutable std::shared_mutex mu;
};

inline void init_values(std::vector<float>* out, InitType itype, double a,
                        double b, uint64_t seed) {
  std::mt19937_64 gen(seed);
  switch (itype) {
    case InitType::kConstant:
      std::fill(out->begin(), out->end(), static_cast<float>(a));
      break;
    case InitType::kUniform: {
      std::uniform_real_distribution<float> d(static_cast<float>(a),
                                              static_cast<float>(b));
      for (auto& v : *out) v = d(gen);
      break;
    }
    case InitType::kNormal: {
      std::normal_distribution<float> d(static_cast<float>(a),
                                        static_cast<float>(b));
      for (auto& v : *out) v = d(gen);
      break;
    }
    case InitType::kTruncatedNormal: {
      std::normal_distribution<float> d(static_cast<float>(a),
                                        static_cast<float>(b));
      for (auto& v : *out) {
        float x;
        do {
          x = d(gen);
        } while (std::fabs(x - a) > 2.0f * b);
        v = x;
      }
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// Optimizer application. `grad` covers `n` contiguous f32s starting at
// parameter offset `off` (dense) or one row (sparse/cache).
// Reference semantics (optimizer.h): SGD on the server applies raw `+= grad`
// because the worker pre-scales by -lr (ParameterServerCommunicate.py:24-25);
// stateful optimizers keep slots server-side.
//
// begin_update() MUST be called once per logical request before one-or-more
// apply_update() calls: it advances Adam's bias-correction step once per
// request (not once per row — a sparse push of N rows is ONE update).
// ---------------------------------------------------------------------------
inline void begin_update(Param& p) {
  if (p.otype == OptType::kAdam) p.step += 1;
}

// Per-REQUEST optimizer overrides, carried as an optional trailing f32 arg
// [lr, l2reg, weight_decay] on push messages. Lets workers honor lr
// schedules on stateful server optimizers (the init-time p.lrs[0] is only a
// fallback) and apply l2 regularization / decoupled weight decay against
// the CURRENT server value under the param lock — matching the device
// path's grad + l2reg*w (optimizer.py apply_gradient) and AdamW's
// w -= lr*wd*w. lr < 0 means "not provided".
struct UpdateOpts {
  float lr = -1.0f;
  float l2reg = 0.0f;
  float weight_decay = 0.0f;
};

inline void apply_update(Param& p, size_t off, const float* grad, size_t n,
                         const UpdateOpts& uo = {}) {
  float* w = p.data.data() + off;
  const float l2 = uo.l2reg;
  switch (p.otype) {
    case OptType::kSGD: {
      // grads arrive pre-scaled by -lr (worker-side schedule); the l2 term
      // needs an explicit lr — the per-request one if provided, else the
      // init-time fallback (consistent with the stateful optimizers below)
      if (l2 != 0.0f) {
        const float lr = uo.lr >= 0.0f ? uo.lr
                                       : (p.lrs.empty() ? 0.01f : p.lrs[0]);
        const float s = lr * l2;
        for (size_t i = 0; i < n; ++i) w[i] += grad[i] - s * w[i];
      } else {
        for (size_t i = 0; i < n; ++i) w[i] += grad[i];
      }
      break;
    }
    case OptType::kMomentum:
    case OptType::kNesterov: {
      const float lr = uo.lr >= 0.0f ? uo.lr
                                     : (p.lrs.empty() ? 0.01f : p.lrs[0]);
      const float mom = p.lrs.size() > 1 ? p.lrs[1] : 0.9f;
      float* v = p.accum.data() + off;
      if (p.otype == OptType::kMomentum) {
        for (size_t i = 0; i < n; ++i) {
          v[i] = mom * v[i] - lr * (grad[i] + l2 * w[i]);
          w[i] += v[i];
        }
      } else {
        for (size_t i = 0; i < n; ++i) {
          float prev = v[i];
          v[i] = mom * v[i] - lr * (grad[i] + l2 * w[i]);
          w[i] += -mom * prev + (1.0f + mom) * v[i];
        }
      }
      break;
    }
    case OptType::kAdaGrad: {
      const float lr = uo.lr >= 0.0f ? uo.lr
                                     : (p.lrs.empty() ? 0.01f : p.lrs[0]);
      const float eps = p.lrs.size() > 1 ? p.lrs[1] : 1e-7f;
      float* a = p.accum.data() + off;
      for (size_t i = 0; i < n; ++i) {
        const float g = grad[i] + l2 * w[i];
        a[i] += g * g;
        w[i] -= lr * g / (std::sqrt(a[i]) + eps);
      }
      break;
    }
    case OptType::kAdam: {
      const float lr = uo.lr >= 0.0f ? uo.lr
                                     : (p.lrs.empty() ? 0.01f : p.lrs[0]);
      const float b1 = p.lrs.size() > 1 ? p.lrs[1] : 0.9f;
      const float b2 = p.lrs.size() > 2 ? p.lrs[2] : 0.999f;
      const float eps = p.lrs.size() > 3 ? p.lrs[3] : 1e-7f;
      const float bc1 = 1.0f - std::pow(b1, static_cast<float>(p.step));
      const float bc2 = 1.0f - std::pow(b2, static_cast<float>(p.step));
      float* m = p.accum.data() + off;
      float* v = p.accum2.data() + off;
      for (size_t i = 0; i < n; ++i) {
        const float w_old = w[i];
        const float g = grad[i] + l2 * w_old;
        m[i] = b1 * m[i] + (1.0f - b1) * g;
        v[i] = b2 * v[i] + (1.0f - b2) * g * g;
        w[i] -= lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + eps);
        // decoupled weight decay (AdamW) against the PRE-update value —
        // mirrors optimizer.py's new_param -= lr * weight_decay * param
        if (uo.weight_decay != 0.0f) w[i] -= lr * uo.weight_decay * w_old;
      }
      break;
    }
  }
}

inline void alloc_slots(Param& p) {
  switch (p.otype) {
    case OptType::kSGD:
      break;
    case OptType::kMomentum:
    case OptType::kNesterov:
    case OptType::kAdaGrad:
      p.accum.assign(p.data.size(), 0.0f);
      break;
    case OptType::kAdam:
      p.accum.assign(p.data.size(), 0.0f);
      p.accum2.assign(p.data.size(), 0.0f);
      break;
  }
}

// The store: key -> Param, concurrent-safe (reference thread_safe_hash_map.h
// + per-param shared_mutex in PSFHandle.h:44-95).
class Store {
 public:
  Param* get(int32_t key) {
    std::shared_lock<std::shared_mutex> g(mu_);
    auto it = map_.find(key);
    return it == map_.end() ? nullptr : it->second.get();
  }

  Param* get_or_create(int32_t key) {
    {
      std::shared_lock<std::shared_mutex> g(mu_);
      auto it = map_.find(key);
      if (it != map_.end()) return it->second.get();
    }
    std::unique_lock<std::shared_mutex> g(mu_);
    auto& slot = map_[key];
    if (!slot) slot = std::make_unique<Param>();
    return slot.get();
  }

  void erase(int32_t key) {
    std::unique_lock<std::shared_mutex> g(mu_);
    map_.erase(key);
  }

  template <typename F>
  void for_each(F&& f) {
    std::shared_lock<std::shared_mutex> g(mu_);
    for (auto& kv : map_) f(kv.first, *kv.second);
  }

 private:
  std::shared_mutex mu_;
  std::unordered_map<int32_t, std::unique_ptr<Param>> map_;
};

}  // namespace hetups
