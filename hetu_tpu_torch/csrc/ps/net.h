// TCP transport for the hetu_tpu parameter server.
//
// Capability parity with the reference's ps-lite "van" layer
// (ps-lite/src/van.cc:29-42, zmq_van.h): a message-framed, connection-oriented
// transport. Redesigned: raw POSIX TCP with length-prefixed frames instead of
// ZMQ — no external dependency, same loopback/process-cluster test story
// (reference tests/pstests/local_s2_w2.yml).
#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace hetups {

// ---------------------------------------------------------------------------
// Wire format: fixed header + n_args payload arrays.
//   MsgHeader | {ArgHeader | bytes} * n_args
// Same-architecture cluster assumed (host byte order), like the reference van.
// ---------------------------------------------------------------------------

enum class PsfType : int32_t {
  // control plane
  kRegister = 0,       // node -> scheduler: {role, id, listen addr}
  kAddressBook = 1,    // scheduler -> node: server addresses
  kBarrier = 2,        // worker -> scheduler -> worker
  kShutdown = 3,
  kAck = 4,
  kHeartbeat = 5,      // server -> scheduler keepalive (reference van.cc:27,569)
  kQueryServers = 6,   // any -> scheduler: current address book + liveness
  kServerStats = 7,    // worker -> server: update/snapshot/restore counters
  // dense
  kDensePush = 10,
  kDensePull = 11,
  kDDPushPull = 12,
  // sparse (2D row-partitioned)
  kSparsePush = 20,
  kSparsePull = 21,
  kSDPushPull = 22,
  kSSPushPull = 23,
  // param management
  kParamInit = 30,
  kParamClear = 31,
  kParamSave = 32,
  kParamLoad = 33,
  kParamAssign = 34,       // raw value assignment (init push, no optimizer)
  kParamAssignRows = 35,
  // bounded-staleness cache table (reference ps-lite psf/cachetable.h:22-43)
  kSyncEmbedding = 40,
  kPushEmbedding = 41,
  kPushSyncEmbedding = 42,
  // arbitrary-length data blobs (reference PushData/PullData)
  kDataPush = 50,
  kDataPull = 51,
  // hetu-elastic: live membership changes (docs/FAULT_TOLERANCE.md
  // "Elastic membership"). Scheduler-side two-phase resize handshake:
  kProposeResize = 60,  // coordinator -> scheduler: pending world + capacity
  kResizeState = 61,    // any -> scheduler: world/pending/drain progress
  kCommitResize = 62,   // worker -> scheduler: drain barrier (parks until
                        // the coordinator finishes or aborts)
  kFinishResize = 63,   // coordinator -> scheduler: flip/abort the world
  kResizeLog = 64,      // any -> scheduler: committed era history
  // server-side membership surface:
  kListParams = 65,       // any -> server: param key/meta inventory
  kSetWorldVersion = 66,  // coordinator -> server: arm stale-epoch rejection
  // hetusave (docs/FAULT_TOLERANCE.md "Coordinated job snapshots"):
  // coordinator -> server inside the drain window: write one epoch-stamped
  // full-state snapshot NOW and reply {version, counter, updates, epoch}
  kSnapshotNow = 67,
  // hetutrail (docs/OBSERVABILITY.md pillar 5): deterministic test lever —
  // delay the server's NEXT optimizer apply by i64[ms] (inert without
  // HETU_TEST_MODE), so critical-path and straggler tests have a knowable
  // slow leg to attribute
  kTestSlowApply = 70,
};

struct MsgHeader {
  int32_t type = 0;       // PsfType
  int32_t tensor_id = 0;  // node_name in the reference C API
  uint64_t req_id = 0;    // per-client monotonic; servers dedup resends on it
  int32_t n_args = 0;
  int32_t flags = 0;
  int32_t client_id = -1; // rank*2 + channel (bulk=0/fast=1) — the server's
                          // resend-dedup slot key; ids must be monotonic
                          // PER client_id stream. -1 = untracked
  int32_t world_ver = 0;  // hetu-elastic membership epoch stamp: servers
                          // armed via kSetWorldVersion reject a mismatched
                          // non-zero stamp (a straggler that missed a
                          // resize commit). 0 = unversioned legacy
                          // traffic, always accepted. Occupies the former
                          // pad slot — the wire layout is unchanged.
};

enum class ArgType : int32_t { kF32 = 0, kI64 = 1, kF64 = 2, kBytes = 3, kI32 = 4, kU64 = 5,
                               // hetuq: blockwise-quantized f32 payload
                               // (int8 + one f32 scale per block)
                               kQI8 = 6 };

struct ArgHeader {
  int32_t dtype = 0;
  int32_t pad = 0;   // CRC32C of the arg bytes when the message carries
                     // kFlagCrc (crc_field below; wire layout unchanged —
                     // the slot was always there, always zero before)
  uint64_t nbytes = 0;
};

// One payload argument: a typed, sized view (owning buffer on receive).
struct Arg {
  ArgType dtype = ArgType::kBytes;
  uint32_t wire_crc = 0;  // ArgHeader.pad as received (never serialized
                          // from here; send_msg recomputes from buf)
  std::vector<uint8_t> buf;

  Arg() = default;
  Arg(ArgType t, const void* data, size_t nbytes) : dtype(t) {
    buf.resize(nbytes);
    if (nbytes) std::memcpy(buf.data(), data, nbytes);
  }
  static Arg f32(const float* p, size_t n) { return Arg(ArgType::kF32, p, n * 4); }
  static Arg i64(const int64_t* p, size_t n) { return Arg(ArgType::kI64, p, n * 8); }
  static Arg u64(const uint64_t* p, size_t n) { return Arg(ArgType::kU64, p, n * 8); }
  static Arg i32(const int32_t* p, size_t n) { return Arg(ArgType::kI32, p, n * 4); }
  static Arg f64(const double* p, size_t n) { return Arg(ArgType::kF64, p, n * 8); }
  static Arg str(const std::string& s) { return Arg(ArgType::kBytes, s.data(), s.size()); }

  const float* as_f32() const { return reinterpret_cast<const float*>(buf.data()); }
  const int64_t* as_i64() const { return reinterpret_cast<const int64_t*>(buf.data()); }
  const uint64_t* as_u64() const { return reinterpret_cast<const uint64_t*>(buf.data()); }
  const int32_t* as_i32() const { return reinterpret_cast<const int32_t*>(buf.data()); }
  const double* as_f64() const { return reinterpret_cast<const double*>(buf.data()); }
  float* mut_f32() { return reinterpret_cast<float*>(buf.data()); }
  std::string as_str() const { return std::string(buf.begin(), buf.end()); }
  size_t n_f32() const { return buf.size() / 4; }
  size_t n_i64() const { return buf.size() / 8; }
  size_t size() const { return buf.size(); }
};

struct Message {
  MsgHeader head;
  std::vector<Arg> args;
};

// ---------------------------------------------------------------------------
// hetuq wire container (ArgType::kQI8): a quantized stand-in for an f32
// value arg. Layout: u64 n_values | u64 block | f32 scales[ceil(n/block)]
// | int8 q[n]. Sparse row payloads use block == row width (one scale per
// row); dense payloads use a fixed block (kQuantWireBlock). Scheme:
// symmetric linear — scale = max(|block|)/127, q = lrintf(v/scale) clipped
// to [-127,127]; an all-zero block stores scale 0 (exact zeros). Matched
// bit-for-bit by hetu_tpu.comm_quant.np_quantize_blocks.
// ---------------------------------------------------------------------------

constexpr size_t kQuantWireBlock = 256;
// request-header flag: "quantize the value payloads of YOUR response"
// (pull rows / push-pull return legs). Responses self-describe via the
// arg dtype, so no response-side flag exists; flags == -1 stays the error
// marker.
constexpr int32_t kFlagQuantRsp = 1;
// hetuchaos transport hardening (docs/FAULT_TOLERANCE.md "Chaos testing &
// transport hardening"): "my payload args carry CRC32C checksums in their
// ArgHeader.pad slot — verify them, and checksum your response the same
// way". Per-request negotiation instead of a process knob so (a) a CRC-off
// client against a new server costs the server nothing, and (b) a bench
// A/B toggles it live on the singleton worker (SetPsCrc). Every flags
// check must exclude the -1 error marker first (it has all bits set).
constexpr int32_t kFlagCrc = 2;

struct QI8Header {
  uint64_t n = 0;
  uint64_t block = 0;
};

inline Arg make_qi8_arg(const float* vals, size_t n, size_t block) {
  if (block == 0) block = 1;
  const size_t nb = (n + block - 1) / block;
  Arg a;
  a.dtype = ArgType::kQI8;
  a.buf.resize(sizeof(QI8Header) + nb * 4 + n);
  QI8Header h{n, block};
  std::memcpy(a.buf.data(), &h, sizeof(h));
  float* scales = reinterpret_cast<float*>(a.buf.data() + sizeof(h));
  int8_t* q = reinterpret_cast<int8_t*>(a.buf.data() + sizeof(h) + nb * 4);
  for (size_t b = 0; b < nb; ++b) {
    const size_t lo = b * block, hi = std::min(n, lo + block);
    float amax = 0.0f;
    for (size_t i = lo; i < hi; ++i) {
      // per-element: NaN compares false against everything, so a plain
      // running max would silently drop it and quantize garbage. Fail at
      // the SENDER with a numeric diagnosis instead — letting a NaN/Inf
      // through would either corrupt the scale (receiver rejects it as
      // "malformed scale", a misleading wire-corruption error for what is
      // a numeric-gradient problem) or quantize NaN to an arbitrary int.
      if (!std::isfinite(vals[i]))
        throw std::runtime_error(
            "hetuq: non-finite value at element " + std::to_string(i) +
            " of quantized payload — the gradient/value itself is NaN/Inf");
      const float av = std::fabs(vals[i]);
      if (av > amax) amax = av;
    }
    const float scale = amax / 127.0f;
    scales[b] = scale;
    const float inv = scale > 0.0f ? scale : 1.0f;
    for (size_t i = lo; i < hi; ++i) {
      long v = lrintf(vals[i] / inv);
      if (v > 127) v = 127;
      if (v < -127) v = -127;
      q[i] = static_cast<int8_t>(v);
    }
  }
  return a;
}

// Validate + dequantize a kQI8 arg into `out`. `expect_n` > 0 enforces the
// element count the handler derived from its OTHER args (row count x
// width, shard length): a mismatch, a torn container, or a non-finite /
// negative scale is a protocol error — the server answers with an error
// response instead of applying garbage.
inline void dequant_qi8(const Arg& a, std::vector<float>* out,
                        size_t expect_n) {
  if (a.buf.size() < sizeof(QI8Header))
    throw std::runtime_error("quantized arg: truncated header");
  QI8Header h;
  std::memcpy(&h, a.buf.data(), sizeof(h));
  if (h.block == 0 || h.block > (1u << 20))
    throw std::runtime_error("quantized arg: bad block size " +
                             std::to_string(h.block));
  const size_t nb = (h.n + h.block - 1) / h.block;
  if (a.buf.size() != sizeof(QI8Header) + nb * 4 + h.n)
    throw std::runtime_error(
        "quantized arg: length mismatch (" + std::to_string(a.buf.size()) +
        " bytes for " + std::to_string(h.n) + " values x block " +
        std::to_string(h.block) + ")");
  if (expect_n > 0 && h.n != expect_n)
    throw std::runtime_error(
        "quantized arg: carries " + std::to_string(h.n) + " values, " +
        std::to_string(expect_n) + " expected");
  const float* scales =
      reinterpret_cast<const float*>(a.buf.data() + sizeof(h));
  const int8_t* q =
      reinterpret_cast<const int8_t*>(a.buf.data() + sizeof(h) + nb * 4);
  for (size_t b = 0; b < nb; ++b)
    if (!(scales[b] >= 0.0f) || !std::isfinite(scales[b]))
      throw std::runtime_error(
          "quantized arg: malformed scale in block " + std::to_string(b));
  out->resize(h.n);
  for (size_t i = 0; i < h.n; ++i)
    (*out)[i] = static_cast<float>(q[i]) * scales[i / h.block];
}

// Element count of an f32-or-quantized value arg (what n_f32 is to kF32).
inline size_t value_count(const Arg& a) {
  if (a.dtype != ArgType::kQI8) return a.n_f32();
  if (a.buf.size() < sizeof(QI8Header)) return 0;
  QI8Header h;
  std::memcpy(&h, a.buf.data(), sizeof(h));
  return h.n;
}

// ---------------------------------------------------------------------------
// End-to-end payload integrity: CRC32C (Castagnoli) over every arg's bytes,
// carried in the ArgHeader.pad slot when the message's kFlagCrc is set.
// Covers the path TCP's 16-bit checksum does not meaningfully protect —
// multi-MB gradient payloads through proxies/userland copies — and gives the
// chaos engine's corrupt-bytes fault a detector to prove. The 32-byte
// MsgHeader itself is NOT covered (that would change the wire layout); a
// corrupted header surfaces as an unknown-psf/length error instead.
// ---------------------------------------------------------------------------

// Shared Castagnoli byte/slicing tables: t[0] is the classic byte-at-a-
// time table (also the seed for the interleave shift tables below),
// t[1..7] extend it to slicing-by-8.
inline const uint32_t (*crc32c_tables())[256] {
  static const auto* tables = [] {
    static uint32_t t[8][256];
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0x82F63B78u & (~(c & 1u) + 1u));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    return &t;
  }();
  return *tables;
}

// Software path: slicing-by-8 (8 x 256 tables, 8 bytes per iteration,
// ~GB/s) — a plain byte-at-a-time table loop measured 35%/step on the
// bench cell, blowing the <= 2% hardening budget by itself.
inline uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  const auto* t = crc32c_tables();
  crc = ~crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    v ^= crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^
          t[0][(v >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// Zero-extension operator for the interleaved hardware path below:
// shift[i][b] tables such that 4 lookups advance a raw (un-inverted) CRC
// register past kCrcBlk zero bytes. Feeding one zero byte to the raw
// register is linear in the register (crc' = t0[crc & 0xFF] ^ (crc >> 8)),
// so the shift-by-N operator is built from the 1-byte table by doubling —
// log2(kCrcBlk) squarings of a 4x256 table, a one-time lazy init.
constexpr size_t kCrcBlk = 1024;  // bytes per interleave stream segment

inline uint32_t crc32c_shift_blk(uint32_t x);

inline const uint32_t (*crc32c_shift_tables())[256] {
  static const auto* tables = [] {
    static uint32_t t[4][256];
    const auto* byte_t = crc32c_tables();
    // shift-by-1-byte operator applied to each basis byte of the register
    for (uint32_t b = 0; b < 256; ++b)
      for (int i = 0; i < 4; ++i) {
        uint32_t x = b << (8 * i);
        t[i][b] = byte_t[0][x & 0xFF] ^ (x >> 8);
      }
    auto apply = [](uint32_t x) {
      return t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF] ^
             t[2][(x >> 16) & 0xFF] ^ t[3][(x >> 24) & 0xFF];
    };
    for (size_t len = 1; len < kCrcBlk; len *= 2) {   // double: N -> 2N
      uint32_t sq[4][256];
      for (uint32_t b = 0; b < 256; ++b)
        for (int i = 0; i < 4; ++i) sq[i][b] = apply(apply(b << (8 * i)));
      std::memcpy(t, sq, sizeof(sq));
    }
    return &t;
  }();
  return *tables;
}

// Advance a raw CRC register past kCrcBlk zero bytes (4 table lookups).
inline uint32_t crc32c_shift_blk(uint32_t x) {
  const auto* t = crc32c_shift_tables();
  return t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF] ^ t[2][(x >> 16) & 0xFF] ^
         t[3][(x >> 24) & 0xFF];
}

#if defined(__x86_64__)
// Hardware path (x86-64 only: __builtin_ia32_crc32di does not exist in
// 32-bit mode, where the software path below serves instead): the
// SSE4.2 crc32 instruction implements exactly the
// Castagnoli polynomial, but its 3-cycle latency serializes a single
// register chain at ~6 GB/s — still ~3%/step on the bench cell. Three
// independent streams hide that latency (~3x); each 3*kCrcBlk block is
// merged with the zero-extension tables (crc(A||B) = shift(crcA) ^ crcB
// by linearity). Runtime-selected so the same .so runs on older CPUs.
__attribute__((target("sse4.2"))) inline uint32_t crc32c_hw(
    const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 3 * kCrcBlk) {
    uint32_t a = crc, b = 0, c = 0;
    const uint8_t* pb = p + kCrcBlk;
    const uint8_t* pc = p + 2 * kCrcBlk;
    for (size_t i = 0; i < kCrcBlk; i += 8) {
      uint64_t va, vb, vc;
      std::memcpy(&va, p + i, 8);
      std::memcpy(&vb, pb + i, 8);
      std::memcpy(&vc, pc + i, 8);
      a = static_cast<uint32_t>(__builtin_ia32_crc32di(a, va));
      b = static_cast<uint32_t>(__builtin_ia32_crc32di(b, vb));
      c = static_cast<uint32_t>(__builtin_ia32_crc32di(c, vc));
    }
    crc = crc32c_shift_blk(crc32c_shift_blk(a) ^ b) ^ c;
    p += 3 * kCrcBlk;
    n -= 3 * kCrcBlk;
  }
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    crc = static_cast<uint32_t>(__builtin_ia32_crc32di(crc, v));
    p += 8;
    n -= 8;
  }
  while (n--) crc = __builtin_ia32_crc32qi(crc, *p++);
  return ~crc;
}

inline bool crc32c_has_hw() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#endif

inline uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc = 0) {
#if defined(__x86_64__)
  if (crc32c_has_hw()) return crc32c_hw(p, n, crc);
#endif
  return crc32c_sw(p, n, crc);
}

// The on-wire CRC field: 0 means "sender did not checksum" (every pre-CRC
// message — pad was always written as 0), so a genuinely-zero CRC maps to 1.
// Collides 0 and 1 onto one value; detection probability is unchanged at
// the 2^-32 scale.
inline uint32_t crc_field(const uint8_t* p, size_t n) {
  const uint32_t c = crc32c(p, n);
  return c ? c : 1u;
}

// Verify every arg of a kFlagCrc message against its carried checksum.
// Returns true when all match; fills *err with a diagnosis otherwise.
inline bool verify_msg_crc(const Message& m, std::string* err) {
  for (size_t i = 0; i < m.args.size(); ++i) {
    const Arg& a = m.args[i];
    if (a.wire_crc == 0) continue;  // sender predates CRC / disabled leg
    const uint32_t got = crc_field(a.buf.data(), a.buf.size());
    if (got != a.wire_crc) {
      if (err)
        *err = "arg " + std::to_string(i) + " (" +
               std::to_string(a.buf.size()) + " bytes) checksum " +
               std::to_string(got) + " != carried " +
               std::to_string(a.wire_crc);
      return false;
    }
  }
  return true;
}

// The single truthy-env convention shared with the Python side
// (resilience.env_truthy): destructive test hooks are inert without it.
// Lives here (not server.h) so the worker's chaos arming shares it.
inline bool env_test_mode() {
  const char* v = std::getenv("HETU_TEST_MODE");
  if (!v) return false;
  std::string s(v);
  for (auto& c : s) c = static_cast<char>(std::tolower(c));
  return s == "1" || s == "true" || s == "yes" || s == "on";
}

// ---------------------------------------------------------------------------
// Socket helpers
// ---------------------------------------------------------------------------

inline void send_all(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) throw std::runtime_error("hetups: send failed (peer closed?)");
    p += k;
    n -= static_cast<size_t>(k);
  }
}

inline bool recv_all(int fd, void* data, size_t n) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;  // closed or error
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

// Sends header+args as one buffered write (one syscall for small messages).
// kFlagCrc messages (and only those — flags == -1 error responses never
// carry it) get a CRC32C per arg in the ArgHeader.pad slot.
// `corrupt_arg`/`corrupt_off` are the chaos engine's wire-corruption
// lever: flip one byte of that arg's payload AFTER the checksums are
// computed — i.e. on the wire, exactly where a real bit-flip lands, so
// the receiver's CRC is what must catch it (csrc/ps/chaos.h kCorrupt).
inline void send_msg(int fd, const Message& m,
                     size_t corrupt_arg = static_cast<size_t>(-1),
                     size_t corrupt_off = 0) {
  MsgHeader h = m.head;
  h.n_args = static_cast<int32_t>(m.args.size());
  const bool crc = h.flags != -1 && (h.flags & kFlagCrc);
  size_t total = sizeof(MsgHeader);
  for (const auto& a : m.args) total += sizeof(ArgHeader) + a.buf.size();
  std::vector<uint8_t> out(total);
  uint8_t* p = out.data();
  std::memcpy(p, &h, sizeof(h));
  p += sizeof(h);
  for (size_t i = 0; i < m.args.size(); ++i) {
    const Arg& a = m.args[i];
    ArgHeader ah{static_cast<int32_t>(a.dtype), 0, a.buf.size()};
    if (crc)
      ah.pad = static_cast<int32_t>(crc_field(a.buf.data(), a.buf.size()));
    std::memcpy(p, &ah, sizeof(ah));
    p += sizeof(ah);
    if (!a.buf.empty()) std::memcpy(p, a.buf.data(), a.buf.size());
    if (i == corrupt_arg && !a.buf.empty())
      p[corrupt_off % a.buf.size()] ^= 0xFF;
    p += a.buf.size();
  }
  send_all(fd, out.data(), out.size());
}

inline bool recv_msg(int fd, Message* m) {
  if (!recv_all(fd, &m->head, sizeof(MsgHeader))) return false;
  m->args.clear();
  m->args.resize(m->head.n_args);
  for (auto& a : m->args) {
    ArgHeader ah;
    if (!recv_all(fd, &ah, sizeof(ah))) return false;
    a.dtype = static_cast<ArgType>(ah.dtype);
    a.wire_crc = static_cast<uint32_t>(ah.pad);
    a.buf.resize(ah.nbytes);
    if (ah.nbytes && !recv_all(fd, a.buf.data(), ah.nbytes)) return false;
  }
  return true;
}

// Bound every blocking recv so a dead peer surfaces as an error instead of a
// hang (the role of the reference's resender timeouts, resender.h:116).
inline void set_recv_timeout(int fd, int ms) {
  if (ms <= 0) return;
  timeval tv{ms / 1000, (ms % 1000) * 1000};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

inline int env_int_or(const char* name, int dflt) {
  const char* v = ::getenv(name);
  return v && *v ? std::atoi(v) : dflt;
}

// hetutrail: ONE monotonic-µs clock for every trail span on both sides of
// the wire. CLOCK_MONOTONIC (what steady_clock reads on Linux) counts from
// boot and is shared by every process on a host, so client and server spans
// are directly comparable without wall-clock re-anchoring — immune to the
// NTP steps that motivated the PR 4 req_id epoch machinery.
inline int64_t trail_mono_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

inline int listen_on(const std::string& host, int port, int backlog = 128) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) throw std::runtime_error("hetups: socket() failed");
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = host.empty() ? INADDR_ANY : ::inet_addr(host.c_str());
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
    throw std::runtime_error("hetups: bind failed on port " + std::to_string(port));
  if (::listen(fd, backlog) != 0) throw std::runtime_error("hetups: listen failed");
  return fd;
}

// Resolve a dotted-quad IP or hostname (reference vans resolve via
// network_utils.h; DMLC_PS_ROOT_URI may be a hostname in cluster ymls).
inline in_addr_t resolve_host(const std::string& host) {
  in_addr_t ip = ::inet_addr(host.c_str());
  if (ip != INADDR_NONE) return ip;
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (::getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
    throw std::runtime_error("hetups: cannot resolve host '" + host + "'");
  in_addr_t out =
      reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr.s_addr;
  ::freeaddrinfo(res);
  return out;
}

// Connect with retry — nodes race the scheduler/servers at startup
// (the reference's van retries similarly via resender.h timeouts).
inline int connect_to(const std::string& host, int port, int retries = 600,
                      int wait_ms = 100) {
  in_addr_t ip = resolve_host(host);
  for (int i = 0; i < retries; ++i) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) throw std::runtime_error("hetups: socket() failed");
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    addr.sin_addr.s_addr = ip;
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    ::close(fd);
    struct timespec ts = {wait_ms / 1000, (wait_ms % 1000) * 1000000L};
    nanosleep(&ts, nullptr);
  }
  throw std::runtime_error("hetups: connect to " + host + ":" +
                           std::to_string(port) + " timed out");
}

// Connection-thread registry that reaps finished threads as new connections
// arrive: short-lived connections (scheduler liveness queries, worker
// reconnects) would otherwise accumulate joinable thread handles for the
// life of the process.
class ConnThreads {
 public:
  template <typename F>
  void spawn(F&& f) {
    reap();
    auto done = std::make_shared<std::atomic<bool>>(false);
    std::lock_guard<std::mutex> g(mu_);
    threads_.push_back(
        {std::thread([fn = std::forward<F>(f), done]() mutable {
           fn();
           *done = true;
         }),
         done});
  }

  void reap() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto it = threads_.begin(); it != threads_.end();) {
      if (it->done->load()) {
        it->t.join();
        it = threads_.erase(it);
      } else {
        ++it;
      }
    }
  }

  void join_all() {
    std::lock_guard<std::mutex> g(mu_);
    for (auto& e : threads_)
      if (e.t.joinable()) e.t.join();
    threads_.clear();
  }

 private:
  struct Entry {
    std::thread t;
    std::shared_ptr<std::atomic<bool>> done;
  };
  std::mutex mu_;
  std::vector<Entry> threads_;
};

// A connection whose requests may be issued from many threads: writes are
// serialized by a mutex; responses are matched by req_id by a reader thread.
class Conn {
 public:
  explicit Conn(int fd) : fd_(fd) {}
  ~Conn() {
    if (fd_ >= 0) ::close(fd_);
  }
  Conn(const Conn&) = delete;

  void send(const Message& m, size_t corrupt_arg = static_cast<size_t>(-1),
            size_t corrupt_off = 0) {
    std::lock_guard<std::mutex> g(send_mu_);
    send_msg(fd_, m, corrupt_arg, corrupt_off);
  }
  bool recv(Message* m) { return recv_msg(fd_, m); }
  int fd() const { return fd_; }
  void close() {
    if (fd_ >= 0) {
      ::shutdown(fd_, SHUT_RDWR);
      ::close(fd_);
      fd_ = -1;
    }
  }

 private:
  int fd_;
  std::mutex send_mu_;
};

}  // namespace hetups
