// extern "C" surface of the hetu_tpu parameter server, consumed via ctypes.
//
// Capability parity with the reference's ps-lite/src/python_binding.cc
// (Init/Finalize :8-16, Push/Pull/DDPushPull :18-30, Sparse*/S*PushPull
// :32-66, PushData/PullData :72-88, Wait/WaitData/BarrierWorker :82-92,
// InitTensor :94, Clear/ClearOnServer/SaveParam/LoadParam :104-119,
// startRecord/getLoads :121-127, StartServer :129, rank/nrank :134-140).
// Arrays cross the boundary as raw pointers + lengths instead of DLArray
// structs: the TPU frontend's NDArray is a jax.Array, so the Python client
// stages through pinned numpy buffers (hetu_tpu/ps/client.py).
//
// Role selection via DMLC_ROLE / DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT /
// DMLC_NUM_WORKER / DMLC_NUM_SERVER / WORKER_ID / SERVER_ID /
// DMLC_PS_SERVER_PORT, matching the reference launcher's env plumbing
// (python/runner.py:186-190, tests/pstests/local_s2_w2.yml).

#include <cstdlib>
#include <cstring>
#include <memory>
#include <atomic>
#include <chrono>
#include <string>
#include <thread>

#include "ring.h"
#include "scheduler.h"
#include "server.h"
#include "worker.h"

namespace {

std::unique_ptr<hetups::Scheduler> g_scheduler;
std::unique_ptr<hetups::PsServer> g_server;
std::unique_ptr<hetups::RingComm> g_ring;
std::shared_ptr<hetups::Conn> g_server_sched_conn;  // server's scheduler link
std::shared_ptr<std::atomic<bool>> g_server_hb_stop;  // keepalive kill switch
std::unique_ptr<hetups::PsWorker> g_worker;
std::string g_last_error;
std::string g_loads;

const char* env_or(const char* k, const char* dflt) {
  const char* v = std::getenv(k);
  return v ? v : dflt;
}

using hetups::env_int_or;  // shared with net.h (empty value -> default)

template <typename F>
void guard(F&& f) {
  try {
    f();
  } catch (const std::exception& e) {
    g_last_error = e.what();
    std::fprintf(stderr, "[hetups] %s\n", e.what());
  }
}

hetups::PsWorker& worker() {
  if (!g_worker)
    throw std::runtime_error(
        "no worker agent: Init() not called with DMLC_ROLE=worker, or "
        "already finalized");
  return *g_worker;
}

}  // namespace

namespace hetups {
// Shared with the embedding cache (cache/cache_capi.cc).
PsWorker* global_worker() { return g_worker.get(); }
}  // namespace hetups

extern "C" {

// Returns-and-clears: the caller observes each failure once.
const char* LastError() {
  static std::string report;
  report = g_last_error;
  g_last_error.clear();
  return report.c_str();
}

void Init() {
  guard([] {
    std::string role = env_or("DMLC_ROLE", "worker");
    std::string root = env_or("DMLC_PS_ROOT_URI", "127.0.0.1");
    int root_port = env_int_or("DMLC_PS_ROOT_PORT", 13200);
    int n_workers = env_int_or("DMLC_NUM_WORKER", 1);
    int n_servers = env_int_or("DMLC_NUM_SERVER", 1);
    if (role == "scheduler") {
      if (g_scheduler) return;
      g_scheduler = std::make_unique<hetups::Scheduler>(root_port, n_servers,
                                                        n_workers);
      g_scheduler->start();
    } else if (role == "server") {
      if (g_server) return;
      int id = env_int_or("SERVER_ID", 0);
      // default 0 = OS-assigned: the server binds before anyone learns the
      // number and registers the ACTUAL port with the scheduler, so stale
      // clusters can never wedge a new launch on a port collision
      int port = env_int_or("DMLC_PS_SERVER_PORT", 0);
      std::string host = env_or("DMLC_PS_SERVER_URI", "127.0.0.1");
      g_server = std::make_unique<hetups::PsServer>(id, host, port);
      // recovery-restores-state: a replacement server rebuilds its store
      // from the last ParamSave directory BEFORE it starts serving — a
      // reconnecting worker (racing via the scheduler's address book or a
      // pinned port) must never observe the empty pre-restore store (the
      // worker does NOT re-init; see server.h load_param_file)
      const char* restore_dir = std::getenv("DMLC_PS_RESTORE_DIR");
      if (restore_dir && *restore_dir) g_server->restore_from(restore_dir);
      g_server->start();
      port = g_server->port();  // actual bound port when OS-assigned
      // register the listen address with the scheduler
      g_server_sched_conn = std::make_shared<hetups::Conn>(
          hetups::connect_to(root, root_port));
      hetups::Message reg;
      reg.head.type = static_cast<int32_t>(hetups::PsfType::kRegister);
      int32_t meta[3] = {0, id, port};
      reg.args.push_back(hetups::Arg::i32(meta, 3));
      reg.args.push_back(hetups::Arg::str(host));
      g_server_sched_conn->send(reg);
      hetups::Message book;
      if (!g_server_sched_conn->recv(&book))
        throw std::runtime_error("scheduler closed during server registration");
      // periodic keepalive so the scheduler can report this server dead to
      // workers when it stops arriving (reference van.cc:27,569). Detached,
      // with shared ownership of the conn and stop flag: a server process
      // that exits without Finalize must not std::terminate in a joinable
      // thread's destructor.
      int hb_ms = env_int_or("DMLC_PS_HEARTBEAT_MS", 1000);
      g_server_hb_stop = std::make_shared<std::atomic<bool>>(false);
      std::thread([id, hb_ms, conn = g_server_sched_conn,
                   stop = g_server_hb_stop] {
        while (!*stop) {
          std::this_thread::sleep_for(std::chrono::milliseconds(hb_ms));
          if (*stop) break;
          hetups::Message hb;
          hb.head.type = static_cast<int32_t>(hetups::PsfType::kHeartbeat);
          int32_t meta[2] = {0, id};
          hb.args.push_back(hetups::Arg::i32(meta, 2));
          try {
            conn->send(hb);
          } catch (...) {
            break;  // scheduler gone; nothing to keep alive for
          }
        }
      }).detach();
    } else {  // worker
      if (g_worker) return;
      int id = env_int_or("WORKER_ID", 0);
      g_worker = std::make_unique<hetups::PsWorker>(id, n_workers, root,
                                                    root_port);
    }
  });
}

void StartServer() { /* folded into Init() by role; kept for API parity */ }

void SchedulerWait() {
  guard([] {
    if (g_scheduler) g_scheduler->wait();
  });
}

void Finalize() {
  guard([] {
    if (g_worker) {
      g_worker->finalize();
      g_worker.reset();
    }
    if (g_server) {
      if (g_server_hb_stop) *g_server_hb_stop = true;
      if (g_server_sched_conn) {
        hetups::Message bye;
        bye.head.type = static_cast<int32_t>(hetups::PsfType::kShutdown);
        // identity-tagged checkout (scheduler wait() diagnostics)
        int32_t who[2] = {0, g_server->rank()};
        bye.args.push_back(hetups::Arg::i32(who, 2));
        try {
          g_server_sched_conn->send(bye);
        } catch (...) {
        }
        g_server_sched_conn->close();
        g_server_sched_conn.reset();
      }
      g_server->stop();
      g_server.reset();
    }
    if (g_scheduler) {
      // a timed-out SchedulerWait() already gave up (wait() returns
      // immediately then); a first-time timeout here must still tear down
      try {
        g_scheduler->wait();
      } catch (const std::exception& e) {
        g_last_error = e.what();
        std::fprintf(stderr, "[hetups] %s\n", e.what());
      }
      g_scheduler->stop();
      g_scheduler.reset();
    }
  });
}

// -- dense ------------------------------------------------------------------
void Push(int node, const float* grad, long len) {
  guard([&] { worker().push(node, grad, static_cast<size_t>(len)); });
}

// Per-step optimizer overrides for subsequent pushes of `node`:
// lr(step) schedule value, l2 regularization, decoupled weight decay.
// lr < 0 with l2reg == wd == 0 clears the override.
void SetPushOpts(int node, float lr, float l2reg, float weight_decay) {
  guard([&] { worker().set_push_opts(node, lr, l2reg, weight_decay); });
}

void Pull(int node, float* out, long len) {
  guard([&] { worker().pull(node, out, static_cast<size_t>(len)); });
}

void DDPushPull(int node, const float* grad, float* out, long len) {
  guard([&] { worker().dd_pushpull(node, grad, out, static_cast<size_t>(len)); });
}

// -- sparse -----------------------------------------------------------------
void SparsePush(int node, const long* idx, const float* vals, long nidx) {
  guard([&] {
    worker().sparse_push(node, reinterpret_cast<const int64_t*>(idx), vals,
                          static_cast<size_t>(nidx));
  });
}

void SparsePull(int node, const long* idx, float* vals, long nidx) {
  guard([&] {
    worker().sparse_pull(node, reinterpret_cast<const int64_t*>(idx), vals,
                          static_cast<size_t>(nidx));
  });
}

void SDPushPull(int node, const long* idx, const float* vals, long nidx,
                float* out) {
  guard([&] {
    worker().sd_pushpull(node, reinterpret_cast<const int64_t*>(idx), vals,
                          static_cast<size_t>(nidx), out);
  });
}

void SSPushPull(int node, const long* in_idx, const float* vals,
                const long* out_idx, float* out, long nidx) {
  guard([&] {
    worker().ss_pushpull(node, reinterpret_cast<const int64_t*>(in_idx), vals,
                          reinterpret_cast<const int64_t*>(out_idx), out,
                          static_cast<size_t>(nidx));
  });
}

void AssignDense(int node, const float* data, long len) {
  guard([&] { worker().assign_dense(node, data, static_cast<size_t>(len)); });
}

void AssignRows(int node, const long* idx, const float* vals, long nidx) {
  guard([&] {
    worker().assign_rows(node, reinterpret_cast<const int64_t*>(idx), vals,
                         static_cast<size_t>(nidx));
  });
}

// -- data blobs -------------------------------------------------------------
long PushData(int node, const unsigned long long* ids, int n,
              const float* vals, const long* lens) {
  long q = -1;
  guard([&] {
    q = worker().push_data(node, reinterpret_cast<const uint64_t*>(ids),
                            static_cast<size_t>(n), vals,
                            reinterpret_cast<const int64_t*>(lens));
  });
  return q;
}

long PullData(int node, const unsigned long long* ids, int n, float* vals,
              const long* lens) {
  long q = -1;
  guard([&] {
    q = worker().pull_data(node, reinterpret_cast<const uint64_t*>(ids),
                            static_cast<size_t>(n), vals,
                            reinterpret_cast<const int64_t*>(lens));
  });
  return q;
}

void WaitData(long query) {
  guard([&] { worker().wait_data(query); });
}

// -- control ----------------------------------------------------------------
void Wait(int node) {
  guard([&] { worker().wait(node); });
}

void BarrierWorker() {
  guard([] { worker().barrier(); });
}

void InitTensor(int node, int ptype, long len, long width, int init_type,
                double init_a, double init_b, unsigned long long seed,
                int otype, float* lrs, int nlr) {
  guard([&] {
    worker().parameter_init(
        node, static_cast<hetups::ParamKind>(ptype), static_cast<size_t>(len),
        static_cast<size_t>(width), static_cast<hetups::InitType>(init_type),
        init_a, init_b, seed, static_cast<hetups::OptType>(otype), lrs,
        static_cast<size_t>(nlr));
  });
}

void Clear(int node) {
  guard([&] { worker().clear(node); });
}

void ClearOnServer(int node) {
  guard([&] { worker().clear_on_server(node); });
}

void SaveParam(int node, const char* dir) {
  guard([&] { worker().parameter_save(node, dir); });
}

void LoadParam(int node, const char* dir) {
  guard([&] { worker().parameter_load(node, dir); });
}

void startRecord(const char* dir) {
  guard([&] { worker().start_record(dir); });
}

const char* getLoads() {
  guard([] { g_loads = worker().get_loads(); });
  return g_loads.c_str();
}

// Per-server HA + health counters: fills up to n of [updates,
// snapshot_updates, restored_updates (-1 = fresh), snapshot_version,
// n_params, requests, apply_ns, apply_count, snapshot_age_ms (-1 = none),
// dedup_clients, crc_rejects] (server.h kServerStats).
void QueryServerStats(int server, long long* out, int n) {
  guard([&] {
    auto v = worker().server_stats(static_cast<size_t>(server));
    for (int i = 0; i < n && i < static_cast<int>(v.size()); ++i)
      out[i] = static_cast<long long>(v[i]);
  });
}

// hetusave (docs/FAULT_TOLERANCE.md "Coordinated job snapshots"): drive one
// server's epoch-stamped snapshot NOW; fills out with up to n of
// [snapshot_version, covered_update_counter, update_count, epoch].
// Synchronous — returns only after the snapshot is on disk and its LATEST
// pointer flipped. A production checkpoint primitive: NOT test-gated.
void ServerSnapshotNow(int server, long long epoch, long long* out, int n) {
  guard([&] {
    auto v = worker().snapshot_now(static_cast<size_t>(server),
                                   static_cast<int64_t>(epoch));
    for (int i = 0; i < n && i < static_cast<int>(v.size()); ++i)
      out[i] = static_cast<long long>(v[i]);
  });
}

// -- hetu-elastic membership (docs/FAULT_TOLERANCE.md) ----------------------

// Stamp this worker's committed membership epoch onto every subsequent
// request (servers armed via kSetWorldVersion reject mismatches).
void SetWorldVersion(unsigned long long v) {
  guard([&] { worker().set_world_version(static_cast<uint64_t>(v)); });
}

unsigned long long GetWorldVersion() {
  return g_worker ? worker().world_version() : 0ull;
}

// Re-sync the server connection set + partitioner denominator with the
// scheduler's address book after a committed resize (caller must have
// drained all in-flight traffic). Returns the new server count, -1 on
// error (stashed in LastError).
int RefreshServers() {
  int n = -1;
  guard([&] { n = static_cast<int>(worker().refresh_servers()); });
  return n;
}

// hetuq: toggle quantized value payloads (ArgType::kQI8) for this worker's
// push/pull traffic. mode != 0 enables; the env default is HETU_COMM_QUANT.
void SetCommQuant(int mode) {
  guard([&] { worker().set_quant(mode != 0); });
}

// -- hetuchaos (docs/FAULT_TOLERANCE.md "Chaos testing") --------------------

// CRC32C payload checksums on this worker's PS traffic (default ON; the
// env default is HETU_PS_CRC at Init — 0 disables). The server side needs
// no knob: it verifies and checksums per request via the kFlagCrc
// negotiation, so a live A/B toggles both legs from the client alone.
void SetPsCrc(int on) {
  guard([&] { worker().set_crc(on != 0); });
}

// Arm a seeded chaos schedule on this worker's transport (empty/NULL spec
// disarms). Destructive by design, so arming requires HETU_TEST_MODE —
// the HETU_CHAOS_SPEC env arming in the worker ctor is gated the same way.
// Grammar: csrc/ps/chaos.h / hetu_tpu.chaos.parse_spec.
void SetChaos(const char* spec) {
  guard([&] {
    const std::string s = spec ? spec : "";
    if (!s.empty() && !hetups::env_test_mode())
      throw std::runtime_error("SetChaos requires HETU_TEST_MODE");
    worker().set_chaos(s);
  });
}

// Drain up to max_rows injected-fault events (oldest first) into out as
// 6-wide i64 rows: [kind, server, psf, tensor, seq, arg] — kind ids in
// csrc/ps/chaos.h (mirrored by hetu_tpu.chaos.KIND_NAMES). Deterministic
// given the spec's seed and the workload: the SORTED log of a replay is
// identical. Returns the row count (0 when chaos was never armed).
long DrainChaosEvents(long long* out, int max_rows) {
  long n = 0;
  guard([&] {
    n = static_cast<long>(worker().drain_chaos(
        reinterpret_cast<int64_t*>(out),
        max_rows > 0 ? static_cast<size_t>(max_rows) : 0));
  });
  return n;
}

// hetuq test hook (inert without HETU_TEST_MODE): corrupt the scale bytes
// of the next quantized payload (node < 0 = any tensor) to prove the
// server's validation rejects malformed quantized args.
void TestCorruptNextQuant(int node) {
  guard([&] {
    if (!hetups::env_test_mode())
      throw std::runtime_error(
          "TestCorruptNextQuant requires HETU_TEST_MODE");
    worker().arm_quant_corrupt(node);
  });
}

// -- hetutrail (docs/OBSERVABILITY.md pillar 5) -----------------------------

// Stamp the worker's current training step onto subsequent client RPC spans
// (the span context riding the wire stays the existing client_id/req_id).
void SetTrailStep(long long step) {
  guard([&] { worker().set_trail_step(static_cast<int64_t>(step)); });
}

// Arm/disarm the client span ring at runtime (the env default is
// HETU_TRAIL_DIR at Init; an A/B of two executors on one live worker needs
// the explicit toggle, like SetCommQuant). Disarming clears the ring.
void SetTrail(int on) {
  guard([&] { worker().set_trail(on != 0); });
}

// Drain up to max_rows client spans (oldest first) into out as 10-wide i64
// rows: [req_id, client_id, server, psf, tensor, step, t0_us, dur_us,
// req_bytes, rsp_bytes]. t0_us is CLOCK_MONOTONIC µs (net.h trail_mono_us),
// directly comparable with server-side spans on the same host. Returns the
// row count (0 when the ring is empty or trail is off).
long DrainTrailSpans(long long* out, int max_rows) {
  long n = 0;
  guard([&] {
    n = static_cast<long>(worker().drain_trail(
        reinterpret_cast<int64_t*>(out),
        max_rows > 0 ? static_cast<size_t>(max_rows) : 0));
  });
  return n;
}

// Spans dropped because the bounded ring was full (monotonic counter).
long long TrailDropped() {
  return g_worker ? static_cast<long long>(worker().trail_dropped()) : 0;
}

// hetutrail test lever (inert without HETU_TEST_MODE): delay server
// `server`'s NEXT optimizer apply by `ms` — the deterministic slow leg the
// critical-path and straggler tests attribute.
void TestSlowApply(int server, int ms) {
  guard([&] {
    if (!hetups::env_test_mode())
      throw std::runtime_error("TestSlowApply requires HETU_TEST_MODE");
    worker().test_slow_apply(static_cast<size_t>(server), ms);
  });
}

// Worker-side RPC counters: fills up to n of [rpcs, retries, failovers,
// quant raw value bytes, quant wire value bytes, rpc timeouts, backoff ms
// slept, crc rejects observed, chaos faults injected, write RPCs landed]
// (worker.h client_stats — the telemetry twin of QueryServerStats).
void QueryClientStats(long long* out, int n) {
  guard([&] {
    auto v = worker().client_stats();
    for (int i = 0; i < n && i < static_cast<int>(v.size()); ++i)
      out[i] = static_cast<long long>(v[i]);
  });
}

int rank() { return g_worker ? worker().rank() : 0; }
int nrank() { return g_worker ? worker().nrank() : 1; }
int num_servers() {
  return g_worker ? static_cast<int>(worker().num_servers()) : 0;
}

// -- ring collectives (reference c_communication_nthread.cc legacy path) ----

void RingInit(int rank, int nranks, const char* host, int base_port) {
  guard([&] {
    g_ring = std::make_unique<hetups::RingComm>(rank, nranks, host,
                                                base_port);
  });
}

void RingAllReduce(float* data, long n) {
  guard([&] {
    if (!g_ring) throw std::runtime_error("RingInit not called");
    g_ring->allreduce_sum(data, static_cast<size_t>(n));
  });
}

void RingAllGather(const float* in, float* out, long n_per) {
  guard([&] {
    if (!g_ring) throw std::runtime_error("RingInit not called");
    g_ring->allgather(in, out, static_cast<size_t>(n_per));
  });
}

void RingBarrier() {
  guard([&] {
    if (!g_ring) throw std::runtime_error("RingInit not called");
    g_ring->barrier();
  });
}

void RingFinalize() {
  guard([] { g_ring.reset(); });
}

}  // extern "C"
