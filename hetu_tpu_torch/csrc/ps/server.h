// The parameter server process: TCP accept loop + per-connection handler
// threads serving PSF requests against the Store.
//
// Capability parity with the reference's KVServer + PSFHandle
// (ps-lite/include/ps/server/PSFHandle.h: DensePull :31, DensePush :51
// (+= accumulate), DDPushPull :78, SparsePull :106, cachetable.h kSync*).
// Concurrency: connections are handled in parallel; per-param shared_mutex
// guards give the reference's ASP lock-granularity (PSFHandle.h:44-95).
#pragma once

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <filesystem>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "net.h"
#include "store.h"

namespace hetups {

// hetutrail per-request apply timing: begin_req/mark run on the SAME serve
// thread as serve_conn's span record, so a thread_local pair carries the
// true apply window (optimizer math only — param-lock wait and response
// serialization excluded) out of handle() without threading a context
// through every PSF case. Zeroed per request in serve_conn; stays 0 for
// reads and when trail is off.
inline thread_local int64_t g_trail_apply_t0 = 0;
inline thread_local int64_t g_trail_apply_us = 0;

// The dedup slot this dispatch thread holds locked while executing the
// current request. take_snapshot's ledger walk locks EVERY client slot,
// so no caller may enter it while holding one: serve_conn drops the
// requester's slot BEFORE kSnapshotNow's handle() (holding it while
// take_snapshot waits on snap_take_mu_ would ABBA-deadlock against the
// periodic snapshot_loop thread, which holds snap_take_mu_ and then
// locks slots during the ledger walk). This thread_local remains as
// belt-and-braces: if a future caller does reach take_snapshot with a
// slot held, the walk reads that one slot lock-free instead of
// self-deadlocking.
inline thread_local const void* g_dedup_slot_held = nullptr;

// env_test_mode (the single truthy-env gate for destructive test hooks)
// moved to net.h so the worker's chaos arming shares it.

class PsServer {
 public:
  PsServer(int rank, const std::string& host, int port)
      : rank_(rank), host_(host), port_(port) {
    const char* v = std::getenv("DMLC_PS_VALIDATE");
    validate_ = v && *v && *v != '0';
    const char* sd = std::getenv("DMLC_PS_SNAPSHOT_DIR");
    if (sd && *sd) snapshot_dir_ = sd;
    snapshot_ms_ = env_int_or("DMLC_PS_SNAPSHOT_MS", 5000);
    // deterministic fault hook for the dedup-proof tests: _Exit right after
    // the Nth optimizer update completes but BEFORE its response is sent
    // (the applied-but-unacked window resend dedup exists for). Optional
    // ":snap" takes a final synchronous snapshot first, so the apply AND its
    // dedup-ledger entry are on disk for the replacement. Inert without
    // HETU_TEST_MODE (same gate as resolve_test_kill_index).
    const char* tx = std::getenv("HETU_PS_TEST_EXIT_AFTER_UPDATES");
    if (tx && *tx && env_test_mode()) {
      std::string spec(tx);
      auto colon = spec.find(':');
      test_exit_snap_ = colon != std::string::npos &&
                        spec.substr(colon + 1) == "snap";
      test_exit_after_updates_ = std::atol(spec.c_str());
    }
    // hetutrail (docs/OBSERVABILITY.md pillar 5): per-request timelines
    // into a bounded ring, flushed as JSONL the offline analyzer joins to
    // client spans by (client_id, req_id). Armed by HETU_TRAIL_DIR — the
    // server is a light ctypes process with no Python telemetry, so the
    // C++ side owns the file.
    const char* td = std::getenv("HETU_TRAIL_DIR");
    if (td && *td) {
      trail_path_ = std::string(td) + "/trail-server-s" +
                    std::to_string(rank_) + ".jsonl";
      trail_cap_ = static_cast<size_t>(env_int_or("HETU_TRAIL_RING", 65536));
      // bounded file growth, like the Python TrailWriter: rotate to one
      // .1 backup past the cap (0 disables)
      trail_max_bytes_ = static_cast<int64_t>(
          env_int_or("HETU_TRAIL_MAX_MB", 512)) * 1000000;
    }
  }

  ~PsServer() { stop(); }

  void start() {
    listen_fd_ = listen_on("", port_);
    if (port_ == 0) {
      // OS-assigned port (race-free: bound before anyone learns it; the
      // actual number reaches workers via the scheduler's address book)
      sockaddr_in addr{};
      socklen_t len = sizeof(addr);
      if (::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
                        &len) != 0)
        throw std::runtime_error("hetups: getsockname failed");
      port_ = ntohs(addr.sin_port);
    }
    running_ = true;
    accept_thread_ = std::thread([this] { accept_loop(); });
    if (!snapshot_dir_.empty() && snapshot_ms_ > 0)
      snapshot_thread_ = std::thread([this] { snapshot_loop(); });
  }

  int port() const { return port_; }

  void stop() {
    running_ = false;
    trail_flush(/*force=*/true);
    {
      std::lock_guard<std::mutex> g(snap_mu_);
      snap_stop_ = true;
    }
    snap_cv_.notify_all();
    if (snapshot_thread_.joinable()) snapshot_thread_.join();
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    {
      std::lock_guard<std::mutex> g(fds_mu_);
      for (int fd : live_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    conn_threads_.join_all();
    trail_flush(/*force=*/true);  // spans the serve threads added late
    {
      std::lock_guard<std::mutex> g(trail_mu_);
      if (trail_f_) {
        std::fclose(trail_f_);
        trail_f_ = nullptr;
      }
    }
  }

  int rank() const { return rank_; }

 private:
  void accept_loop() {
    while (running_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      conn_threads_.spawn([this, fd] { serve_conn(fd); });
    }
  }

  // Per-client resend dedup (the server half of the reference's resender.h
  // contract): a worker that resends after a lost response must not have the
  // request applied twice. One slot per client_id suffices because each
  // worker CHANNEL serializes its requests to one server (client_id encodes
  // rank*2 + channel — the bulk and fast channels are independent streams
  // with independently monotonic req_ids).
  struct ClientSlot {
    std::mutex mu;
    uint64_t last_id = 0;
    Message rsp;
    // false when last_id was restored from a snapshot's dedup ledger: the
    // request already APPLIED (it is inside the restored state) but the
    // response payload was never persisted — a resend re-executes with
    // skip_apply so reads are answered without double-applying the write.
    bool has_rsp = false;
    // provenance of the last request's applied write (0 = read-only or
    // restored-from-snapshot): take_snapshot's ledger filter compares
    // write_seq against the seq its target param's file was saved at, so
    // a write that landed AFTER the file was written is left out of the
    // ledger (re-issue re-applies it) instead of being silently acked as
    // a skip_apply duplicate — see the kManifestMagic comment
    uint64_t write_seq = 0;
    int32_t write_key = -1;
  };

  ClientSlot* client_slot(int32_t client_id) {
    std::lock_guard<std::mutex> g(clients_mu_);
    auto& p = clients_[client_id];
    if (!p) p = std::make_unique<ClientSlot>();
    return p.get();
  }

  void serve_conn(int fd) {
    {
      std::lock_guard<std::mutex> g(fds_mu_);
      live_fds_.push_back(fd);
    }
    Message req;
    const bool trail = !trail_path_.empty();
    while (recv_msg(fd, &req)) {
      if (static_cast<PsfType>(req.head.type) == PsfType::kShutdown) break;
      req_count_.fetch_add(1, std::memory_order_relaxed);
      const int64_t tr_recv = trail ? trail_mono_us() : 0;
      // hetu-elastic stale-epoch rejection: once armed (kSetWorldVersion),
      // a request stamped with a DIFFERENT non-zero world version comes
      // from a worker that missed a resize commit — its view of the key
      // ranges is stale, so applying it would scatter updates across the
      // old partition. Rejected the same way resend-dedup rejects
      // duplicates: an error response, counters and params untouched.
      // world_ver == 0 is unversioned legacy traffic, always accepted.
      {
        const uint64_t wv = world_version_.load(std::memory_order_relaxed);
        const uint64_t rv = static_cast<uint64_t>(
            static_cast<uint32_t>(req.head.world_ver));
        if (wv != 0 && rv != 0 && rv != wv &&
            static_cast<PsfType>(req.head.type) !=
                PsfType::kSetWorldVersion) {
          Message rej;
          rej.head.type = static_cast<int32_t>(PsfType::kAck);
          rej.head.tensor_id = req.head.tensor_id;
          rej.head.req_id = req.head.req_id;
          rej.head.flags = -1;
          rej.args.push_back(Arg::str(
              "stale world epoch " + std::to_string(rv) +
              " (server at world v" + std::to_string(wv) +
              ") — re-sync membership before issuing traffic"));
          try {
            send_msg(fd, rej);
          } catch (...) {
            break;
          }
          continue;
        }
      }
      // hetuchaos transport hardening: verify payload CRCs BEFORE the
      // dedup slot and BEFORE any handling — a corrupted request must
      // leave params, update counters, AND the dedup ledger untouched
      // (advancing slot->last_id on garbage would make the clean resend
      // look like a stale straggler and silently drop it). The reject is
      // an error response marked "retryable:" so the client resends
      // instead of surfacing an app-level failure — exactly the malformed
      // kQI8 contract, applied to every payload.
      if (req.head.flags != -1 && (req.head.flags & kFlagCrc)) {
        std::string cerr;
        if (!verify_msg_crc(req, &cerr)) {
          crc_reject_count_.fetch_add(1, std::memory_order_relaxed);
          Message rej;
          rej.head.type = static_cast<int32_t>(PsfType::kAck);
          rej.head.tensor_id = req.head.tensor_id;
          rej.head.req_id = req.head.req_id;
          rej.head.flags = -1;
          rej.args.push_back(Arg::str(
              "retryable: payload CRC mismatch on psf " +
              std::to_string(req.head.type) + " tensor " +
              std::to_string(req.head.tensor_id) + " (" + cerr +
              ") — request not applied; resend"));
          try {
            send_msg(fd, rej);
          } catch (...) {
            break;
          }
          continue;
        }
      }
      ClientSlot* slot =
          (req.head.client_id >= 0 && req.head.req_id > 0)
              ? client_slot(req.head.client_id)
              : nullptr;
      std::unique_lock<std::mutex> slot_g;
      bool skip_apply = false;
      if (slot) {
        slot_g = std::unique_lock<std::mutex>(slot->mu);
        if (req.head.req_id == slot->last_id && slot->last_id > 0) {
          if (slot->has_rsp) {
            // duplicate of the last executed request: replay the response
            try {
              send_msg(fd, slot->rsp);
            } catch (...) {
              break;
            }
            continue;
          }
          // restored-ledger duplicate: the write already landed before the
          // snapshot — re-execute read-only (fall through with skip_apply)
          skip_apply = true;
        }
        if (req.head.req_id < slot->last_id) {
          // stale straggler from a pre-reconnect stream (a newer request
          // already executed): applying it now would double-apply — drop;
          // the worker stopped waiting on that stream long ago
          continue;
        }
      }
      Message rsp;
      rsp.head.type = static_cast<int32_t>(PsfType::kAck);
      rsp.head.tensor_id = req.head.tensor_id;
      rsp.head.req_id = req.head.req_id;
      uint64_t wseq = 0;
      // trail timeline: recv -> (queue + dedup-slot lock wait) -> handle
      // (param lock wait + apply + serialize) -> respond; the apply
      // window alone rides the begin_req/mark thread_locals
      if (trail) {
        g_trail_apply_t0 = 0;   // clear any stale window (error paths)
        g_trail_apply_us = 0;
      }
      const int64_t tr_h0 = trail ? trail_mono_us() : 0;
      const auto handle_t0 = std::chrono::steady_clock::now();
      // kSnapshotNow's handle() acquires snap_take_mu_ and then walks
      // every dedup slot; the periodic snapshot_loop thread takes those
      // same locks in that order. Holding this requester's slot across
      // handle() would close an ABBA cycle (dispatch: slot ->
      // snap_take_mu_; periodic: snap_take_mu_ -> slot), so the snapshot
      // path releases the slot for the handle() window and re-locks it to
      // record the response. A concurrent resend executing meanwhile is
      // harmless: take_snapshot serializes on snap_take_mu_, both
      // snapshots are complete, and the last recorded response wins.
      const bool drop_slot_for_snapshot =
          slot != nullptr &&
          req.head.type == static_cast<int32_t>(PsfType::kSnapshotNow);
      if (drop_slot_for_snapshot) slot_g.unlock();
      g_dedup_slot_held = drop_slot_for_snapshot ? nullptr : slot;
      try {
        handle(req, &rsp, skip_apply, &wseq);
      } catch (const std::exception& e) {
        std::fprintf(stderr, "[hetups server %d] error on psf %d tensor %d: %s\n",
                     rank_, req.head.type, req.head.tensor_id, e.what());
        rsp.head.flags = -1;
        rsp.args.clear();
        rsp.args.push_back(Arg::str(e.what()));
      }
      g_dedup_slot_held = nullptr;
      if (drop_slot_for_snapshot) slot_g.lock();
      // answer a CRC-speaking client in kind: send_msg checksums the
      // response args so the client can reject a corrupted return leg
      // (error responses stay flags == -1, never checksummed)
      if (req.head.flags != -1 && (req.head.flags & kFlagCrc) &&
          rsp.head.flags != -1)
        rsp.head.flags |= kFlagCrc;
      if (wseq != 0) {
        // apply latency (kServerStats): wall time of requests that applied
        // a write, accumulated as ns + count so the client derives the avg
        apply_ns_.fetch_add(
            std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - handle_t0)
                .count(),
            std::memory_order_relaxed);
        apply_count_.fetch_add(1, std::memory_order_relaxed);
      }
      // req_id >= last_id always holds on the normal path (the lock was
      // held since the dedup check); on the snapshot path a newer request
      // may have executed while the slot was dropped — never regress the
      // ledger below it (the reply still goes out from rsp directly).
      bool recorded = false;
      if (slot && req.head.req_id >= slot->last_id) {
        slot->last_id = req.head.req_id;
        slot->rsp = std::move(rsp);  // no payload copy; slot mutex still held
        slot->has_rsp = true;
        slot->write_seq = wseq;
        slot->write_key = req.head.tensor_id;
        recorded = true;
      }
      if (test_exit_after_updates_ >= 0 &&
          update_count_.load() >=
              static_cast<uint64_t>(test_exit_after_updates_)) {
        // fault hook: die applied-but-unacked (see constructor). The slot
        // lock must drop first — the final snapshot reads the dedup ledger.
        if (slot_g.owns_lock()) slot_g.unlock();
        if (test_exit_snap_) {
          try {
            take_snapshot();
          } catch (...) {
          }
        }
        std::fprintf(stderr,
                     "[hetups server %d] TEST exit after %ld updates "
                     "(response for req %llu never sent)\n",
                     rank_, test_exit_after_updates_,
                     (unsigned long long)req.head.req_id);
        std::_Exit(137);
      }
      const int64_t tr_h1 = trail ? trail_mono_us() : 0;
      bool sent = true;
      try {
        send_msg(fd, recorded ? slot->rsp : rsp);
      } catch (...) {
        sent = false;  // peer gone mid-reply
      }
      if (trail) {
        SrvSpan s;
        s.client_id = req.head.client_id;
        s.req_id = req.head.req_id;
        s.psf = req.head.type;
        s.tensor = req.head.tensor_id;
        s.t0_us = tr_recv;
        s.q_us = tr_h0 - tr_recv;
        s.handle_us = tr_h1 - tr_h0;
        s.apply_us = g_trail_apply_us;   // optimizer math only; 0 = read
        s.send_us = trail_mono_us() - tr_h1;
        trail_record(s);
      }
      if (!sent) break;
    }
    {
      std::lock_guard<std::mutex> g(fds_mu_);
      live_fds_.erase(std::remove(live_fds_.begin(), live_fds_.end(), fd),
                      live_fds_.end());
    }
    ::close(fd);
  }

  // ---------------------------------------------------------------------
  // Optional per-request optimizer overrides: push messages may carry a
  // trailing f32 [lr, l2reg, weight_decay] arg beyond their base arg count
  // (store.h UpdateOpts) — how workers honor lr schedules and l2/weight
  // decay on stateful server-side optimizers.
  static UpdateOpts parse_opts(const Message& req, size_t base_args) {
    UpdateOpts uo;
    if (req.args.size() > base_args) {
      const Arg& a = req.args[base_args];
      if (a.dtype == ArgType::kF32 && a.n_f32() >= 3) {
        const float* f = a.as_f32();
        uo.lr = f[0];
        uo.l2reg = f[1];
        uo.weight_decay = f[2];
      }
    }
    return uo;
  }

  // One logical optimizer update is ONE counter tick (a sparse push of N
  // rows is one update, matching begin_update's Adam-step contract). The
  // counter is what snapshot manifests stamp — recovery reports exactly how
  // many updates the restored state is behind.
  void begin_req(Param& p) {
    // hetutrail ps_slow fault (kTestSlowApply, HETU_TEST_MODE-gated):
    // one-shot delay of the next apply, taken while the param's exclusive
    // lock is held — exactly the lock-wait shape a genuinely slow apply
    // inflicts on concurrent requests, which is what the critical-path
    // and straggler tests must attribute.
    // apply-window start BEFORE the slow hook's sleep: the injected delay
    // stands in for a genuinely slow apply, so it must read as apply time
    if (!trail_path_.empty()) g_trail_apply_t0 = trail_mono_us();
    const int64_t slow = test_slow_ms_.exchange(0, std::memory_order_relaxed);
    if (slow > 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(slow));
    begin_update(p);
    update_count_.fetch_add(1, std::memory_order_relaxed);
  }

  // -- hetutrail span ring (bounded; see the flight-recorder precedent) ---
  struct SrvSpan {
    uint64_t req_id;
    int32_t client_id, psf, tensor;
    int64_t t0_us, q_us, handle_us, apply_us, send_us;
  };

  void trail_record(const SrvSpan& s) {
    bool do_flush = false;
    {
      std::lock_guard<std::mutex> g(trail_mu_);
      if (trail_ring_.size() >= trail_cap_) {
        ++trail_dropped_;
        do_flush = true;  // drain to disk so the ring frees up
      } else {
        trail_ring_.push_back(s);
        do_flush = trail_ring_.size() >= kTrailFlushEvery;
      }
    }
    if (do_flush) trail_flush(false);
  }

  // Append the ring to trail-server-s<rank>.jsonl. The first write of each
  // file handle emits an anchor record pairing this host's monotonic clock
  // with the wall clock, so offline tools can place spans in absolute time
  // without trusting wall-clock stamps taken mid-run (NTP steps).
  void trail_flush(bool force) {
    if (trail_path_.empty()) return;
    std::lock_guard<std::mutex> g(trail_mu_);
    if (trail_ring_.empty() && !force) return;
    if (!trail_f_) {
      trail_f_ = std::fopen(trail_path_.c_str(), "a");
      if (!trail_f_) {
        trail_ring_.clear();  // unwritable dir must not grow the ring
        return;
      }
      // count what a predecessor incarnation already wrote, so the size
      // bound holds across restarts too
      if (std::fseek(trail_f_, 0, SEEK_END) == 0)
        trail_file_bytes_ = std::ftell(trail_f_);
      const double wall = std::chrono::duration_cast<std::chrono::duration<
          double>>(std::chrono::system_clock::now().time_since_epoch())
          .count();
      std::fprintf(trail_f_,
                   "{\"kind\":\"anchor\",\"server\":%d,\"mono_us\":%lld,"
                   "\"wall_s\":%.3f}\n",
                   rank_, (long long)trail_mono_us(), wall);
    }
    for (const SrvSpan& s : trail_ring_) {
      int k = std::fprintf(
          trail_f_,
          "{\"kind\":\"srv\",\"server\":%d,\"client\":%d,"
          "\"req_id\":%llu,\"psf\":%d,\"tensor\":%d,"
          "\"t0_us\":%lld,\"q_us\":%lld,\"handle_us\":%lld,"
          "\"apply_us\":%lld,\"send_us\":%lld}\n",
          rank_, s.client_id, (unsigned long long)s.req_id, s.psf,
          s.tensor, (long long)s.t0_us, (long long)s.q_us,
          (long long)s.handle_us, (long long)s.apply_us,
          (long long)s.send_us);
      if (k > 0) trail_file_bytes_ += k;
    }
    if (trail_dropped_) {
      std::fprintf(trail_f_,
                   "{\"kind\":\"dropped\",\"server\":%d,\"n\":%llu}\n",
                   rank_, (unsigned long long)trail_dropped_);
      trail_dropped_ = 0;
    }
    trail_ring_.clear();
    std::fflush(trail_f_);
    if (trail_max_bytes_ > 0 && trail_file_bytes_ >= trail_max_bytes_) {
      // rotate to ONE .1 backup (bounded growth, the TrailWriter/JsonlSink
      // convention); the next flush reopens and writes a fresh anchor
      std::fclose(trail_f_);
      trail_f_ = nullptr;
      std::rename(trail_path_.c_str(), (trail_path_ + ".1").c_str());
      trail_file_bytes_ = 0;
    }
  }

  // hetuq: f32 view of a value arg that may ride the wire quantized
  // (ArgType::kQI8). Dequantizes into `scratch` with full length/scale
  // validation — a malformed quantized payload becomes an error response
  // (the param untouched), never an applied-garbage write. `expect_n` > 0
  // pins the element count the handler derived from its other args.
  static const float* value_f32(const Arg& a, std::vector<float>* scratch,
                                size_t expect_n) {
    if (a.dtype == ArgType::kQI8) {
      dequant_qi8(a, scratch, expect_n);
      return scratch->data();
    }
    if (expect_n > 0 && a.n_f32() != expect_n)
      throw std::runtime_error(
          "value arg carries " + std::to_string(a.n_f32()) + " f32s, " +
          std::to_string(expect_n) + " expected");
    return a.as_f32();
  }

  // hetuq: response value payload, quantized iff the request asked for it
  // (kFlagQuantRsp). `block` is the scale granularity — row width for
  // sparse rows, kQuantWireBlock for dense payloads.
  static Arg rsp_value(const Message& req, const float* vals, size_t n,
                       size_t block) {
    if (req.head.flags & kFlagQuantRsp)
      return make_qi8_arg(vals, n, block ? block : kQuantWireBlock);
    return Arg::f32(vals, n);
  }

  // `skip_apply`: re-execution of a request whose write already landed in
  // the restored snapshot (dedup-ledger duplicate) — perform reads, answer
  // normally, but never mutate. `write_seq` (when non-null) receives the
  // seq stamped on this request's applied write, 0 for read-only requests.
  void handle(Message& req, Message* rsp, bool skip_apply = false,
              uint64_t* write_seq = nullptr) {
    const auto type = static_cast<PsfType>(req.head.type);
    const int32_t key = req.head.tensor_id;
    std::vector<float> qscratch;  // dequant buffer for quantized value args
    // stamp an applied write while the param's exclusive lock is held —
    // the lock is what orders the stamp against save_param_file's read of
    // last_write_seq, making the snapshot's ledger filter race-free
    auto mark = [&](Param& pm) {
      pm.last_write_seq =
          write_seq_gen_.fetch_add(1, std::memory_order_relaxed) + 1;
      if (write_seq) *write_seq = pm.last_write_seq;
      // close the hetutrail apply window opened by begin_req (mark runs
      // right after the case's apply loop); cases that mark without
      // begin_req (init/assign/clear/load) leave t0 at 0 — no apply span
      if (g_trail_apply_t0) {
        g_trail_apply_us = trail_mono_us() - g_trail_apply_t0;
        g_trail_apply_t0 = 0;
      }
    };
    switch (type) {
      case PsfType::kParamInit: {
        // deliberately NOT skip_apply-gated: init is idempotent (re-init of
        // a sized param is a no-op below), and a param created between the
        // snapshot's key scan and its ledger capture exists in the ledger
        // but not on disk — suppressing the re-issued init would make that
        // key permanently uninitializable on the replacement
        // args: i64[kind, len, width, init_type, otype, n_lr],
        //       f64[a, b], u64[seed], f32 lrs
        const int64_t* meta = req.args[0].as_i64();
        const double* ab = req.args[1].as_f64();
        uint64_t seed = req.args[2].as_u64()[0];
        const float* lrs = req.args[3].as_f32();
        size_t n_lr = req.args[3].n_f32();
        Param* p = store_.get_or_create(key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        size_t want = static_cast<size_t>(meta[1]) *
                      (meta[0] == 0 ? 1 : static_cast<size_t>(meta[2]));
        if (p->data.size() == want && want > 0) break;  // idempotent re-init
        p->kind = static_cast<ParamKind>(meta[0]);
        if (p->kind == ParamKind::kDense) {
          p->len = static_cast<size_t>(meta[1]);
          p->rows = 0;
          p->width = 1;
        } else {
          p->rows = static_cast<size_t>(meta[1]);
          p->width = static_cast<size_t>(meta[2]);
          p->len = p->rows * p->width;
        }
        p->otype = static_cast<OptType>(meta[4]);
        p->lrs.assign(lrs, lrs + n_lr);
        p->data.assign(p->len, 0.0f);
        init_values(&p->data, static_cast<InitType>(meta[3]), ab[0], ab[1],
                    seed + static_cast<uint64_t>(rank_) * 0x9e3779b9u);
        alloc_slots(*p);
        if (p->kind == ParamKind::kCacheTable)
          p->versions.assign(p->rows, 0);
        mark(*p);
        break;
      }
      case PsfType::kDensePush: {
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        if (skip_apply) break;
        const size_t n = value_count(req.args[0]);
        if (n > p->data.size())
          throw std::runtime_error(
              "DensePush carries " + std::to_string(n) + " values for a " +
              std::to_string(p->data.size()) + "-element shard");
        const float* v = value_f32(req.args[0], &qscratch, n);
        begin_req(*p);
        apply_update(*p, 0, v, n, parse_opts(req, 1));
        mark(*p);
        break;
      }
      case PsfType::kDensePull: {
        Param* p = store_.get(key);
        check(p, key);
        std::shared_lock<std::shared_mutex> g(p->mu);
        rsp->args.push_back(Arg::f32(p->data.data(), p->data.size()));
        break;
      }
      case PsfType::kDDPushPull: {
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        if (!skip_apply) {
          const size_t n = value_count(req.args[0]);
          if (n > p->data.size())
            throw std::runtime_error(
                "DDPushPull carries " + std::to_string(n) + " values for a " +
                std::to_string(p->data.size()) + "-element shard");
          const float* v = value_f32(req.args[0], &qscratch, n);
          begin_req(*p);
          apply_update(*p, 0, v, n, parse_opts(req, 1));
          mark(*p);
        }
        rsp->args.push_back(rsp_value(req, p->data.data(), p->data.size(),
                                      kQuantWireBlock));
        break;
      }
      case PsfType::kSparsePush: {
        // args: i64 local row ids (deduped), f32 vals (nidx x width)
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        check_rows(*p, idx, nidx);  // before any mutation
        if (skip_apply) break;
        // length/scale validation BEFORE begin_req: a rejected quantized
        // payload must leave the param (and the update counter) untouched
        const float* vals = value_f32(req.args[1], &qscratch,
                                      nidx * p->width);
        begin_req(*p);
        const UpdateOpts uo = parse_opts(req, 2);
        for (size_t i = 0; i < nidx; ++i)
          apply_update(*p, static_cast<size_t>(idx[i]) * p->width,
                       vals + i * p->width, p->width, uo);
        mark(*p);
        break;
      }
      case PsfType::kSparsePull: {
        Param* p = store_.get(key);
        check(p, key);
        std::shared_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        check_rows(*p, idx, nidx);
        std::vector<float> out(nidx * p->width);
        for (size_t i = 0; i < nidx; ++i)
          std::memcpy(out.data() + i * p->width,
                      p->data.data() + static_cast<size_t>(idx[i]) * p->width,
                      p->width * 4);
        rsp->args.push_back(rsp_value(req, out.data(), out.size(),
                                      p->width));
        break;
      }
      case PsfType::kSDPushPull: {
        // sparse push + dense pull (grads are sparse, want full table back)
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        check_rows(*p, idx, nidx);  // before any mutation
        if (!skip_apply) {
          const float* vals = value_f32(req.args[1], &qscratch,
                                        nidx * p->width);
          begin_req(*p);
          const UpdateOpts uo = parse_opts(req, 2);
          for (size_t i = 0; i < nidx; ++i)
            apply_update(*p, static_cast<size_t>(idx[i]) * p->width,
                         vals + i * p->width, p->width, uo);
          mark(*p);
        }
        rsp->args.push_back(rsp_value(req, p->data.data(), p->data.size(),
                                      kQuantWireBlock));
        break;
      }
      case PsfType::kSSPushPull: {
        // sparse push + sparse pull of (possibly different) rows
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        const int64_t* oidx = req.args[2].as_i64();
        size_t no = req.args[2].n_i64();
        // validate BOTH sides before any mutation: a rejected request must
        // leave the param untouched or a client retry double-applies
        check_rows(*p, idx, nidx);
        check_rows(*p, oidx, no);
        if (!skip_apply) {
          const float* vals = value_f32(req.args[1], &qscratch,
                                        nidx * p->width);
          begin_req(*p);
          const UpdateOpts uo = parse_opts(req, 3);
          for (size_t i = 0; i < nidx; ++i)
            apply_update(*p, static_cast<size_t>(idx[i]) * p->width,
                         vals + i * p->width, p->width, uo);
          mark(*p);
        }
        std::vector<float> out(no * p->width);
        for (size_t i = 0; i < no; ++i)
          std::memcpy(out.data() + i * p->width,
                      p->data.data() + static_cast<size_t>(oidx[i]) * p->width,
                      p->width * 4);
        rsp->args.push_back(rsp_value(req, out.data(), out.size(),
                                      p->width));
        break;
      }
      case PsfType::kParamAssign: {
        // raw overwrite of this shard (host-side initializers push values
        // through here so server optimizers never see them as gradients)
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        if (req.args[0].n_f32() != p->data.size())
          throw std::runtime_error("ParamAssign size mismatch");
        if (skip_apply) break;
        std::memcpy(p->data.data(), req.args[0].as_f32(),
                    p->data.size() * 4);
        mark(*p);
        break;
      }
      case PsfType::kParamAssignRows: {
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        check_rows(*p, idx, nidx);
        if (skip_apply) break;
        const float* vals = req.args[1].as_f32();
        for (size_t i = 0; i < nidx; ++i)
          std::memcpy(p->data.data() + static_cast<size_t>(idx[i]) * p->width,
                      vals + i * p->width, p->width * 4);
        mark(*p);
        break;
      }
      case PsfType::kParamClear: {
        Param* p = store_.get(key);
        if (!p || skip_apply) break;
        std::unique_lock<std::shared_mutex> g(p->mu);
        std::fill(p->data.begin(), p->data.end(), 0.0f);
        std::fill(p->accum.begin(), p->accum.end(), 0.0f);
        std::fill(p->accum2.begin(), p->accum2.end(), 0.0f);
        p->step = 0;
        if (!p->versions.empty()) std::fill(p->versions.begin(), p->versions.end(), 0);
        mark(*p);
        break;
      }
      case PsfType::kParamSave: {
        Param* p = store_.get(key);
        check(p, key);
        save_param_file(*p, shard_path(req.args[0].as_str(), key));
        break;
      }
      case PsfType::kParamLoad: {
        // unlike the reference's LoadParam, the param need not pre-exist:
        // the shard file carries full meta (+optimizer slots), so a blank
        // replacement server restores state without any worker-side re-init
        load_param_file(key, shard_path(req.args[0].as_str(), key));
        if (Param* lp = store_.get(key)) {
          std::unique_lock<std::shared_mutex> g(lp->mu);
          mark(*lp);
        }
        break;
      }
      case PsfType::kSyncEmbedding: {
        // Bounded-staleness pull (reference PSFhandle_embedding.cc:30-65):
        // return rows never seen by the client (cver == -1) or whose server
        // version ran more than `bound` updates ahead of the client's.
        // args: i64 local rows, i64 client versions, i64[bound]
        Param* p = store_.get(key);
        check(p, key);
        std::shared_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        const int64_t* cver = req.args[1].as_i64();
        int64_t bound = req.args[2].as_i64()[0];
        size_t nidx = req.args[0].n_i64();
        check_rows(*p, idx, nidx);
        std::vector<int32_t> sel;
        std::vector<float> rows;
        std::vector<int64_t> vers;
        for (size_t i = 0; i < nidx; ++i) {
          size_t r = static_cast<size_t>(idx[i]);
          if (cver[i] == -1 || p->versions[r] - cver[i] > bound) {
            sel.push_back(static_cast<int32_t>(i));
            rows.insert(rows.end(), p->data.begin() + r * p->width,
                        p->data.begin() + (r + 1) * p->width);
            vers.push_back(p->versions[r]);
          }
        }
        rsp->args.push_back(Arg::i32(sel.data(), sel.size()));
        rsp->args.push_back(rsp_value(req, rows.data(), rows.size(),
                                      p->width));
        rsp->args.push_back(Arg::i64(vers.data(), vers.size()));
        break;
      }
      case PsfType::kPushEmbedding: {
        // args: i64 local rows, f32 grads, i64 per-row update counts
        // (reference PSFhandle_embedding.cc:5-28: accumulate + ver += updates)
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        check_rows(*p, idx, nidx);  // before any mutation
        if (value_count(req.args[1]) != nidx * p->width ||
            req.args[2].n_i64() != nidx)
          throw std::runtime_error(
              "kPushEmbedding arg length mismatch: " +
              std::to_string(value_count(req.args[1])) + " grads / " +
              std::to_string(req.args[2].n_i64()) + " ups for " +
              std::to_string(nidx) + " rows x width " +
              std::to_string(p->width));
        if (skip_apply) break;
        const float* grads = value_f32(req.args[1], &qscratch,
                                       nidx * p->width);
        begin_req(*p);
        const int64_t* ups = req.args[2].as_i64();
        for (size_t i = 0; i < nidx; ++i) {
          size_t r = static_cast<size_t>(idx[i]);
          if (validate_)
            for (size_t j = 0; j < p->width; ++j)
              if (!(std::fabs(grads[i * p->width + j]) < 1e3f))
                std::fprintf(stderr,
                             "[hetups VALIDATE] push tensor %d row %lld "
                             "grad[%zu]=%g nidx=%zu ups=%lld\n",
                             key, (long long)idx[i], j,
                             (double)grads[i * p->width + j], nidx,
                             (long long)ups[i]);
          apply_update(*p, r * p->width, grads + i * p->width, p->width);
          p->versions[r] += ups[i];
        }
        mark(*p);
        break;
      }
      case PsfType::kPushSyncEmbedding: {
        // push grads for rows A, then bounded-staleness sync rows B.
        // args: i64 pushA, f32 gradsA, u64 upsA, i64 syncB, u64 cverB, u64[bound]
        Param* p = store_.get(key);
        check(p, key);
        std::unique_lock<std::shared_mutex> g(p->mu);
        const int64_t* idx = req.args[0].as_i64();
        size_t nidx = req.args[0].n_i64();
        const int64_t* sidx = req.args[3].as_i64();
        const int64_t* cver = req.args[4].as_i64();
        int64_t bound = req.args[5].as_i64()[0];
        size_t ns = req.args[3].n_i64();
        // validate BOTH sides before any mutation (rejected => untouched)
        check_rows(*p, idx, nidx);
        check_rows(*p, sidx, ns);
        if (value_count(req.args[1]) != nidx * p->width ||
            req.args[2].n_i64() != nidx)
          throw std::runtime_error(
              "kPushSyncEmbedding arg length mismatch: " +
              std::to_string(value_count(req.args[1])) + " grads / " +
              std::to_string(req.args[2].n_i64()) + " ups for " +
              std::to_string(nidx) + " rows x width " +
              std::to_string(p->width));
        if (!skip_apply) {
          const float* grads = value_f32(req.args[1], &qscratch,
                                         nidx * p->width);
          begin_req(*p);
          const int64_t* ups = req.args[2].as_i64();
          for (size_t i = 0; i < nidx; ++i) {
            size_t r = static_cast<size_t>(idx[i]);
            if (validate_)
              for (size_t j = 0; j < p->width; ++j)
                if (!(std::fabs(grads[i * p->width + j]) < 1e3f))
                  std::fprintf(stderr,
                               "[hetups VALIDATE] push_sync tensor %d row "
                               "%lld grad[%zu]=%g nidx=%zu ups=%lld\n",
                               key, (long long)idx[i], j,
                               (double)grads[i * p->width + j], nidx,
                               (long long)ups[i]);
            apply_update(*p, r * p->width, grads + i * p->width, p->width);
            p->versions[r] += ups[i];
          }
          mark(*p);
        }
        std::vector<int32_t> sel;
        std::vector<float> rows;
        std::vector<int64_t> vers;
        for (size_t i = 0; i < ns; ++i) {
          size_t r = static_cast<size_t>(sidx[i]);
          if (cver[i] == -1 || p->versions[r] - cver[i] > bound) {
            sel.push_back(static_cast<int32_t>(i));
            rows.insert(rows.end(), p->data.begin() + r * p->width,
                        p->data.begin() + (r + 1) * p->width);
            vers.push_back(p->versions[r]);
          }
        }
        rsp->args.push_back(Arg::i32(sel.data(), sel.size()));
        rsp->args.push_back(rsp_value(req, rows.data(), rows.size(),
                                      p->width));
        rsp->args.push_back(Arg::i64(vers.data(), vers.size()));
        break;
      }
      case PsfType::kDataPush: {
        // arbitrary-length blob rows keyed by u64 (reference PushData — used
        // for GNN graph data). args: u64 keys, i64 lens, f32 concat values
        if (skip_apply) break;
        std::unique_lock<std::shared_mutex> g(data_mu_);
        const uint64_t* keys = req.args[0].as_u64();
        size_t nk = req.args[0].n_i64();
        const int64_t* lens = req.args[1].as_i64();
        const float* vals = req.args[2].as_f32();
        size_t off = 0;
        for (size_t i = 0; i < nk; ++i) {
          auto& blob = data_store_[{key, keys[i]}];
          blob.assign(vals + off, vals + off + lens[i]);
          off += static_cast<size_t>(lens[i]);
        }
        // data blobs are never snapshotted: flag the write as absent from
        // every snapshot so a failover re-issue re-applies it
        if (write_seq) *write_seq = ~0ull;
        break;
      }
      case PsfType::kDataPull: {
        std::shared_lock<std::shared_mutex> g(data_mu_);
        const uint64_t* keys = req.args[0].as_u64();
        size_t nk = req.args[0].n_i64();
        std::vector<float> out;
        for (size_t i = 0; i < nk; ++i) {
          auto it = data_store_.find({key, keys[i]});
          if (it == data_store_.end())
            throw std::runtime_error("DataPull: missing key");
          out.insert(out.end(), it->second.begin(), it->second.end());
        }
        rsp->args.push_back(Arg::f32(out.data(), out.size()));
        break;
      }
      case PsfType::kListParams: {
        // hetu-elastic migration inventory: flat i64 rows of
        // {key, kind, rows|len, width, otype} per stored param — what the
        // coordinator iterates to kParamSave/kParamLoad every key across
        // a key-range move
        std::vector<int64_t> flat;
        store_.for_each([&](int32_t k, Param& p) {
          std::shared_lock<std::shared_mutex> pg(p.mu);
          flat.push_back(k);
          flat.push_back(static_cast<int64_t>(p.kind));
          flat.push_back(static_cast<int64_t>(
              p.kind == ParamKind::kDense ? p.len : p.rows));
          flat.push_back(static_cast<int64_t>(p.width));
          flat.push_back(static_cast<int64_t>(p.otype));
        });
        rsp->args.push_back(Arg::i64(flat.data(), flat.size()));
        break;
      }
      case PsfType::kSetWorldVersion: {
        // arm/advance stale-epoch rejection (see serve_conn): the
        // coordinator stamps every server inside the drain window, before
        // workers resume traffic under the new membership
        if (req.args.empty() || req.args[0].size() < 8)
          throw std::runtime_error("kSetWorldVersion needs i64[version]");
        world_version_.store(
            static_cast<uint64_t>(req.args[0].as_i64()[0]),
            std::memory_order_relaxed);
        break;
      }
      case PsfType::kTestSlowApply: {
        // hetutrail fault lever (ps_slow@step[:ms]): arm a one-shot delay
        // of the next optimizer apply. Doubly gated — capi refuses to send
        // without HETU_TEST_MODE, and this server refuses to arm without
        // it, so a stray message can never slow a production server.
        if (!env_test_mode())
          throw std::runtime_error("kTestSlowApply requires HETU_TEST_MODE");
        if (req.args.empty() || req.args[0].size() < 8)
          throw std::runtime_error("kTestSlowApply needs i64[ms]");
        test_slow_ms_.store(req.args[0].as_i64()[0],
                            std::memory_order_relaxed);
        break;
      }
      case PsfType::kSnapshotNow: {
        // hetusave coordinated snapshot epoch: inside the drain window
        // (workers parked, pushes_ok == updates proven by the coordinator)
        // write one full-state snapshot NOW and report exactly which
        // version the job manifest should pin. The optional i64[epoch]
        // stamp is recorded for telemetry/ServerStats cross-checks. NOT
        // test-gated — this is the production checkpoint path.
        if (snapshot_dir_.empty())
          throw std::runtime_error(
              "kSnapshotNow: server has no DMLC_PS_SNAPSHOT_DIR");
        const int64_t epoch =
            (!req.args.empty() && req.args[0].size() >= 8)
                ? req.args[0].as_i64()[0]
                : -1;
        const uint64_t version = take_snapshot();
        last_snapshot_epoch_.store(epoch, std::memory_order_relaxed);
        const int64_t out[4] = {
            static_cast<int64_t>(version),
            static_cast<int64_t>(last_snapshot_counter_.load()),
            static_cast<int64_t>(update_count_.load()),
            epoch};
        rsp->args.push_back(Arg::i64(out, 4));
        break;
      }
      case PsfType::kServerStats: {
        // reply: i64[updates applied, updates covered by latest snapshot,
        // update counter restored from (-1 = fresh start), snapshot version,
        // live param count, requests served, apply ns total, apply count,
        // snapshot age ms (-1 = none taken by THIS incarnation), dedup-
        // ledger occupancy, CRC-rejected requests]. Slots 0-4 are the PR-4
        // lost-update accounting surface; 5-9 the telemetry health
        // extension; 10 the hetuchaos transport-hardening counter (clients
        // that ask for fewer slots still get a valid prefix — the reply is
        // length-prefixed and QueryServerStats copies min(n, len)).
        int64_t n_params = 0;
        store_.for_each([&](int32_t, Param&) { ++n_params; });
        int64_t dedup_clients;
        {
          std::lock_guard<std::mutex> cg(clients_mu_);
          dedup_clients = static_cast<int64_t>(clients_.size());
        }
        const int64_t snap_at = last_snapshot_steady_ms_.load();
        const int64_t age_ms = snap_at ? steady_now_ms() - snap_at : -1;
        int64_t stats[11] = {
            static_cast<int64_t>(update_count_.load()),
            static_cast<int64_t>(last_snapshot_counter_.load()),
            restored_counter_.load(),
            static_cast<int64_t>(snapshot_version_.load()),
            n_params,
            static_cast<int64_t>(req_count_.load()),
            static_cast<int64_t>(apply_ns_.load()),
            static_cast<int64_t>(apply_count_.load()),
            age_ms,
            dedup_clients,
            static_cast<int64_t>(crc_reject_count_.load())};
        rsp->args.push_back(Arg::i64(stats, 11));
        break;
      }
      default:
        throw std::runtime_error("server: unknown psf type " +
                                 std::to_string(req.head.type));
    }
  }

  static int64_t steady_now_ms() {
    return std::chrono::duration_cast<std::chrono::milliseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  static void check(Param* p, int32_t key) {
    if (!p)
      throw std::runtime_error("param " + std::to_string(key) +
                               " not initialized (call InitTensor first)");
  }

  // Client-supplied row ids come straight from user data; an out-of-range id
  // must become an error response to the worker, not an OOB read/write here.
  static void check_rows(const Param& p, const int64_t* idx, size_t nidx) {
    for (size_t i = 0; i < nidx; ++i)
      if (idx[i] < 0 || static_cast<size_t>(idx[i]) >= p.rows)
        throw std::runtime_error(
            "row id " + std::to_string(idx[i]) + " out of range [0, " +
            std::to_string(p.rows) + ")");
  }

  std::string shard_path(const std::string& dir, int32_t key) const {
    return dir + "/param_" + std::to_string(key) + "_shard" +
           std::to_string(rank_) + ".bin";
  }

  // Full-state shard format (v2): a dead server's replacement can rebuild
  // its store from disk with no worker cooperation (recovery-restores-state;
  // the intent of reference van.cc:47 recovery + psf/PSFunc.h:25-28
  // ParamSave/Load). Layout: i64 meta[8] = {MAGIC(-2), kind, rows|len,
  // width, otype, step, n_lrs, n_versions}, f32 lrs[], f32 data[],
  // f32 accum[], f32 accum2[], i64 versions[].
  static constexpr int64_t kShardMagicV2 = -2;

  // Returns the param's last_write_seq as of the save (read under the same
  // shared lock as the data): every write stamped <= that seq is inside the
  // file, every later one is not — take_snapshot's ledger filter key.
  uint64_t save_param_file(Param& p, const std::string& path) {
    std::shared_lock<std::shared_mutex> g(p.mu);
    // tmp + rename: a crash mid-save (the very fault this recovers from)
    // must not destroy the previous good checkpoint
    const std::string tmp = path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) throw std::runtime_error("cannot open " + tmp);
    int64_t meta[8] = {kShardMagicV2,
                       static_cast<int64_t>(p.kind),
                       static_cast<int64_t>(p.rows ? p.rows : p.len),
                       static_cast<int64_t>(p.width),
                       static_cast<int64_t>(p.otype),
                       static_cast<int64_t>(p.step),
                       static_cast<int64_t>(p.lrs.size()),
                       static_cast<int64_t>(p.versions.size())};
    std::fwrite(meta, sizeof(meta), 1, f);
    std::fwrite(p.lrs.data(), 4, p.lrs.size(), f);
    std::fwrite(p.data.data(), 4, p.data.size(), f);
    std::fwrite(p.accum.data(), 4, p.accum.size(), f);
    std::fwrite(p.accum2.data(), 4, p.accum2.size(), f);
    std::fwrite(p.versions.data(), 8, p.versions.size(), f);
    std::fclose(f);
    if (std::rename(tmp.c_str(), path.c_str()) != 0)
      throw std::runtime_error("cannot rename " + tmp + " -> " + path);
    return p.last_write_seq;
  }

  void load_param_file(int32_t key, const std::string& path) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) throw std::runtime_error("cannot open " + path);
    struct Closer { FILE* f; ~Closer() { std::fclose(f); } } closer{f};
    int64_t head;
    if (std::fread(&head, sizeof(head), 1, f) != 1)
      throw std::runtime_error("truncated " + path);
    if (head != kShardMagicV2) {
      // v1 layout: {kind, rows|len, width} + data only, into an existing
      // param (pre-v2 checkpoints)
      int64_t rest[2];
      if (std::fread(rest, sizeof(rest), 1, f) != 1)
        throw std::runtime_error("truncated " + path);
      Param* p1 = store_.get(key);
      if (!p1 || p1->data.empty())
        throw std::runtime_error(
            "v1 shard " + path + " cannot restore an uninitialized param");
      std::unique_lock<std::shared_mutex> g(p1->mu);
      std::vector<float> data(p1->data.size());
      if (std::fread(data.data(), 4, data.size(), f) != data.size())
        throw std::runtime_error("size mismatch loading " + path);
      p1->data = std::move(data);
      return;
    }
    // parse EVERYTHING into locals first: a truncated file must not leave a
    // phantom half-restored param in the store (check() would then pass and
    // pushes would write through empty buffers)
    int64_t meta[7];
    if (std::fread(meta, sizeof(meta), 1, f) != 1)
      throw std::runtime_error("truncated " + path);
    Param tmp;
    tmp.kind = static_cast<ParamKind>(meta[0]);
    if (tmp.kind == ParamKind::kDense) {
      tmp.len = static_cast<size_t>(meta[1]);
      tmp.rows = 0;
      tmp.width = 1;
    } else {
      tmp.rows = static_cast<size_t>(meta[1]);
      tmp.width = static_cast<size_t>(meta[2]);
      tmp.len = tmp.rows * tmp.width;
    }
    tmp.otype = static_cast<OptType>(meta[3]);
    tmp.step = static_cast<uint64_t>(meta[4]);
    tmp.lrs.assign(static_cast<size_t>(meta[5]), 0.0f);
    tmp.data.assign(tmp.len, 0.0f);
    auto read_f32 = [&](std::vector<float>& v) {
      if (!v.empty() && std::fread(v.data(), 4, v.size(), f) != v.size())
        throw std::runtime_error("size mismatch loading " + path);
    };
    read_f32(tmp.lrs);
    read_f32(tmp.data);
    alloc_slots(tmp);
    read_f32(tmp.accum);
    read_f32(tmp.accum2);
    tmp.versions.assign(static_cast<size_t>(meta[6]), 0);
    if (!tmp.versions.empty() &&
        std::fread(tmp.versions.data(), 8, tmp.versions.size(), f) !=
            tmp.versions.size())
      throw std::runtime_error("size mismatch loading " + path);
    Param* p = store_.get_or_create(key);
    std::unique_lock<std::shared_mutex> g(p->mu);
    p->kind = tmp.kind;
    p->len = tmp.len;
    p->rows = tmp.rows;
    p->width = tmp.width;
    p->otype = tmp.otype;
    p->step = tmp.step;
    p->lrs = std::move(tmp.lrs);
    p->data = std::move(tmp.data);
    p->accum = std::move(tmp.accum);
    p->accum2 = std::move(tmp.accum2);
    p->versions = std::move(tmp.versions);
  }

 public:
  // Restore this rank's state from `dir` (invoked at startup when
  // DMLC_PS_RESTORE_DIR is set). Two layouts:
  //  - a continuous-snapshot root (this server's LATEST_s<rank> pointer
  //    exists): follow it to the freshest COMPLETE snapshot — params +
  //    optimizer slots + row versions + the update-counter stamp + the
  //    per-client dedup ledger (so an in-flight resend of an already-
  //    snapshotted request is not double-applied);
  //  - a plain ParamSave directory: scan for shard files (legacy path).
  int restore_from(const std::string& dir) {
    namespace fs = std::filesystem;
    const fs::path ptr = fs::path(dir) / ("LATEST_s" + std::to_string(rank_));
    std::error_code ec;
    if (!fs::exists(ptr, ec)) return restore_scan_dir(dir);
    std::string name;
    {
      FILE* f = std::fopen(ptr.string().c_str(), "rb");
      if (!f) return restore_scan_dir(dir);
      char buf[256] = {0};
      size_t k = std::fread(buf, 1, sizeof(buf) - 1, f);
      std::fclose(f);
      name.assign(buf, k);
      while (!name.empty() && (name.back() == '\n' || name.back() == ' '))
        name.pop_back();
    }
    const fs::path snap = fs::path(dir) / name;
    if (!fs::exists(snap, ec)) {
      std::fprintf(stderr,
                   "[hetups] server %d: LATEST pointer names missing "
                   "snapshot %s; falling back to directory scan\n",
                   rank_, name.c_str());
      return restore_scan_dir(dir);
    }
    int n = restore_scan_dir(snap.string());
    load_manifest((snap / "manifest.bin").string());
    std::fprintf(stderr,
                 "[hetups] server %d restored %d param shard(s) from "
                 "snapshot %s (version %llu, update counter %lld)\n",
                 rank_, n, name.c_str(),
                 (unsigned long long)snapshot_version_.load(),
                 (long long)restored_counter_.load());
    return n;
  }

 private:
  int restore_scan_dir(const std::string& dir) {
    namespace fs = std::filesystem;
    const std::string suffix = "_shard" + std::to_string(rank_) + ".bin";
    int n = 0;
    std::error_code ec;
    for (const auto& ent : fs::directory_iterator(dir, ec)) {
      const std::string name = ent.path().filename().string();
      if (name.rfind("param_", 0) != 0) continue;
      if (name.size() <= suffix.size() + 6 ||
          name.compare(name.size() - suffix.size(), suffix.size(), suffix))
        continue;
      const std::string key_str =
          name.substr(6, name.size() - suffix.size() - 6);
      if (key_str.empty() ||
          key_str.find_first_not_of("0123456789") != std::string::npos)
        continue;  // stray file; not one of ours
      try {
        load_param_file(std::stoi(key_str), ent.path().string());
        ++n;
      } catch (const std::exception& e) {
        // one bad shard must not keep the replacement out of the cluster;
        // the affected param surfaces as "not initialized" to workers
        std::fprintf(stderr, "[hetups] server %d: skipping shard %s: %s\n",
                     rank_, name.c_str(), e.what());
      }
    }
    return n;
  }

  // Snapshot manifest (binary): i64 magic, u64 version, u64 update counter,
  // u64 n_params, u64 n_clients, then {i64 client_id, u64 last_req_id} per
  // client. The counter stamp is the lost-update ledger; the client map is
  // the resend-dedup ledger, captured AFTER the param files and filtered by
  // write provenance: a client whose last applied write is provably absent
  // from the saved shard files (its ClientSlot::write_seq is newer than the
  // seq its param's file was saved at) is left OUT, so a failover re-issue
  // re-applies the write; every entry that IS present implies its write is
  // inside the files, so a re-issue can skip_apply safely. Net: never a
  // double-apply, and never a silently-acked lost write.
  static constexpr int64_t kManifestMagic = -7001;

  void load_manifest(const std::string& path) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) {
      std::fprintf(stderr, "[hetups] server %d: snapshot has no manifest %s"
                   " (counters start at 0)\n", rank_, path.c_str());
      return;
    }
    struct Closer { FILE* f; ~Closer() { std::fclose(f); } } closer{f};
    int64_t magic;
    uint64_t head[4];
    if (std::fread(&magic, 8, 1, f) != 1 || magic != kManifestMagic ||
        std::fread(head, sizeof(head), 1, f) != 1) {
      std::fprintf(stderr, "[hetups] server %d: bad manifest %s\n", rank_,
                   path.c_str());
      return;
    }
    snapshot_version_.store(head[0]);
    update_count_.store(head[1]);
    last_snapshot_counter_.store(head[1]);
    restored_counter_.store(static_cast<int64_t>(head[1]));
    for (uint64_t i = 0; i < head[3]; ++i) {
      int64_t cid;
      uint64_t last_id;
      if (std::fread(&cid, 8, 1, f) != 1 || std::fread(&last_id, 8, 1, f) != 1)
        break;
      ClientSlot* slot = client_slot(static_cast<int32_t>(cid));
      std::lock_guard<std::mutex> g(slot->mu);
      slot->last_id = last_id;
      slot->has_rsp = false;  // payload not persisted; resend => skip_apply
      slot->write_seq = 0;    // the write is inside the restored params
    }
  }

  void snapshot_loop() {
    using Clock = std::chrono::steady_clock;
    // wake faster than the snapshot cadence: a param-SET change (Executor
    // init, late sparse-table registration) must reach disk promptly —
    // with a plain snapshot_ms_ wait, a server killed inside the first
    // interval after init would hand its replacement a snapshot with
    // whole tensors missing (or none at all), an unrecoverable
    // unknown-tensor failover instead of interval-bounded lost updates
    const auto poll = std::chrono::milliseconds(std::min(snapshot_ms_, 250));
    auto last_tick = Clock::now();
    std::unique_lock<std::mutex> g(snap_mu_);
    while (!snap_cv_.wait_for(g, poll, [this] { return snap_stop_; })) {
      g.unlock();
      const auto now = Clock::now();
      const bool interval_elapsed =
          now - last_tick >= std::chrono::milliseconds(snapshot_ms_);
      if (interval_elapsed) last_tick = now;
      try {
        maybe_snapshot(interval_elapsed);
      } catch (const std::exception& e) {
        // snapshotting must never take the serving path down with it
        std::fprintf(stderr, "[hetups] server %d: snapshot failed: %s\n",
                     rank_, e.what());
      }
      g.lock();
    }
  }

  void maybe_snapshot(bool interval_elapsed) {
    uint64_t counter = update_count_.load();
    size_t n_params = 0;
    store_.for_each([&](int32_t, Param&) { ++n_params; });
    // a changed param set snapshots NOW (between interval ticks); pure
    // update traffic keeps the configured DMLC_PS_SNAPSHOT_MS cadence
    const bool params_changed =
        n_params != last_snapshot_params_.load() ||
        (snapshot_version_.load() == 0 && n_params > 0);
    if (!params_changed && !interval_elapsed)
      return;
    // idle skip: nothing new since the last complete snapshot. The write
    // generation is what catches mutations that do NOT tick the update
    // counter (ParamAssign/AssignRows/Clear/Load) — keying on the counter
    // alone would leave an acked assign unsnapshotted forever, a silently
    // lost write on failover. Param-count change alone (init-only, zero
    // updates) still snapshots, so a replacement never comes up without
    // the tables' init state.
    if (!params_changed &&
        counter == last_snapshot_counter_.load() &&
        write_seq_gen_.load() == last_snapshot_write_seq_ &&
        snapshot_version_.load() > 0)
      return;
    take_snapshot();
  }

  // One atomic, versioned snapshot: write everything into a hidden tmp dir,
  // rename it into place, then flip the LATEST pointer (tmp+rename as well).
  // A crash at ANY point leaves either the previous complete snapshot or a
  // garbage .tmp dir that restore never looks at. Runs entirely under the
  // per-param shared locks — the serving path is never paused. Returns the
  // published version (hetusave's kSnapshotNow reports it to the
  // coordinator so the job manifest can pin this exact snapshot).
  uint64_t take_snapshot() {
    namespace fs = std::filesystem;
    // serializes the periodic thread against the test hook's final snapshot
    std::lock_guard<std::mutex> take_g(snap_take_mu_);
    const uint64_t counter = update_count_.load();  // BEFORE params: the
    // stamp may under-claim coverage (updates landing mid-snapshot) but
    // never over-claim — reported lost-update counts never understate.
    const uint64_t wseq_at_start = write_seq_gen_.load();  // same logic:
    // a write landing mid-snapshot bumps the gen past this sample, so the
    // next idle check sees it and snapshots again
    const uint64_t version = snapshot_version_.fetch_add(1) + 1;
    const std::string name = "snap_s" + std::to_string(rank_) + "_v" +
                             std::to_string(version);
    const fs::path root(snapshot_dir_);
    const fs::path tmp = root / ("." + name + ".tmp");
    std::error_code ec;
    // a predecessor that died mid-cycle may have left this very tmp dir
    // (it restored from the same LATEST and picked the same next version);
    // stale shard files mixed into the fresh dump would corrupt it
    fs::remove_all(tmp, ec);
    fs::create_directories(tmp, ec);
    if (ec)
      throw std::runtime_error("cannot create snapshot dir " + tmp.string());
    std::vector<int32_t> keys;
    store_.for_each([&](int32_t k, Param&) { keys.push_back(k); });
    std::unordered_map<int32_t, uint64_t> file_seq;  // key -> seq-at-save
    for (int32_t k : keys) {
      Param* p = store_.get(k);
      if (p && !p->data.empty())
        file_seq[k] = save_param_file(
            *p, (tmp / ("param_" + std::to_string(k) + "_shard" +
                        std::to_string(rank_) + ".bin"))
                    .string());
    }
    // dedup ledger AFTER params (see kManifestMagic comment for why)
    std::vector<std::pair<int64_t, uint64_t>> ledger;
    {
      std::vector<std::pair<int32_t, ClientSlot*>> slots;
      {
        std::lock_guard<std::mutex> g(clients_mu_);
        for (auto& kv : clients_) slots.push_back({kv.first, kv.second.get()});
      }
      for (auto& [cid, slot] : slots) {
        // No live caller reaches here holding a slot mutex (serve_conn
        // drops the kSnapshotNow requester's slot before handle() — the
        // ABBA-deadlock fix against the periodic snapshot thread), so
        // every slot locks normally; the in-flight requester's last_id
        // still names the last RECORDED request, which is exactly right.
        // g_dedup_slot_held stays as same-thread self-deadlock defense
        // for any future caller that does hold one: read that slot
        // lock-free instead of re-locking.
        std::unique_lock<std::mutex> g;
        if (static_cast<const void*>(slot) != g_dedup_slot_held)
          g = std::unique_lock<std::mutex>(slot->mu);
        if (slot->last_id == 0) continue;
        if (slot->write_seq > 0) {
          // provenance filter: the client's last write landed AFTER its
          // param's file was saved (or the param was never saved) — it is
          // provably NOT in this snapshot, so leave the client out of the
          // ledger and let a failover re-issue RE-APPLY it. Including it
          // would make the re-issue a skip_apply duplicate: a silently
          // acked lost update.
          auto it = file_seq.find(slot->write_key);
          if (it == file_seq.end() || slot->write_seq > it->second) continue;
        }
        ledger.push_back({cid, slot->last_id});
      }
    }
    {
      FILE* f = std::fopen((tmp / "manifest.bin").string().c_str(), "wb");
      if (!f) throw std::runtime_error("cannot write snapshot manifest");
      int64_t magic = kManifestMagic;
      uint64_t head[4] = {version, counter, keys.size(), ledger.size()};
      std::fwrite(&magic, 8, 1, f);
      std::fwrite(head, sizeof(head), 1, f);
      for (auto& [cid, last_id] : ledger) {
        std::fwrite(&cid, 8, 1, f);
        std::fwrite(&last_id, 8, 1, f);
      }
      std::fclose(f);
    }
    // a predecessor may have published this version but died before
    // flipping LATEST — no reader ever saw it, and renaming onto a
    // non-empty directory fails
    fs::remove_all(root / name, ec);
    fs::rename(tmp, root / name, ec);
    if (ec) throw std::runtime_error("cannot publish snapshot " + name);
    // crash-window fault hook pinning the pointer-flip atomicity contract:
    // die AFTER the snapshot dir is published but BEFORE the pointer moves,
    // exactly when the matching version lands. Restore must then follow the
    // still-pointing-at-the-predecessor LATEST to a COMPLETE snapshot —
    // tests/test_recovery.py holds this. Inert without HETU_TEST_MODE.
    if (env_test_mode()) {
      const char* kill_v = std::getenv("HETU_PS_TEST_KILL_BEFORE_POINTER");
      if (kill_v && std::strtoull(kill_v, nullptr, 10) == version)
        std::_Exit(137);
    }
    // flip the pointer
    const fs::path ptr_tmp = root / (".LATEST_s" + std::to_string(rank_) +
                                     ".tmp");
    {
      FILE* f = std::fopen(ptr_tmp.string().c_str(), "wb");
      if (!f) throw std::runtime_error("cannot write snapshot pointer");
      std::fwrite(name.data(), 1, name.size(), f);
      std::fclose(f);
    }
    fs::rename(ptr_tmp, root / ("LATEST_s" + std::to_string(rank_)), ec);
    if (ec) throw std::runtime_error("cannot flip snapshot pointer");
    last_snapshot_counter_.store(counter);
    last_snapshot_params_ = keys.size();
    last_snapshot_write_seq_ = wseq_at_start;
    last_snapshot_steady_ms_.store(steady_now_ms());
    // prune: keep this snapshot and its predecessor (the pointer flip and a
    // racing reader of the old snapshot both stay safe); also sweep stale
    // .tmp dirs a crashed predecessor abandoned — each holds a full copy of
    // PS state and nothing else ever cleans them
    const std::string prefix = "snap_s" + std::to_string(rank_) + "_v";
    const std::string tprefix = "." + prefix;
    for (const auto& ent : fs::directory_iterator(root, ec)) {
      const std::string n = ent.path().filename().string();
      const bool is_tmp = n.size() > tprefix.size() + 4 &&
                          n.rfind(tprefix, 0) == 0 &&
                          n.compare(n.size() - 4, 4, ".tmp") == 0;
      const std::string v =
          is_tmp ? n.substr(tprefix.size(), n.size() - tprefix.size() - 4)
          : n.rfind(prefix, 0) == 0 ? n.substr(prefix.size())
                                    : std::string();
      if (v.empty() || v.find_first_not_of("0123456789") != std::string::npos)
        continue;
      if (is_tmp ? std::stoull(v) < version : std::stoull(v) + 1 < version)
        fs::remove_all(ent.path(), ec);
    }
    return version;
  }

  struct PairHash {
    size_t operator()(const std::pair<int32_t, uint64_t>& p) const {
      return std::hash<uint64_t>()(p.second * 1315423911u ^
                                   static_cast<uint64_t>(p.first));
    }
  };

  int rank_;
  std::string host_;
  int port_;
  bool validate_ = false;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  std::thread accept_thread_;

  // -- continuous snapshots / HA bookkeeping ------------------------------
  std::string snapshot_dir_;             // DMLC_PS_SNAPSHOT_DIR ("" = off)
  int snapshot_ms_ = 5000;               // DMLC_PS_SNAPSHOT_MS
  std::thread snapshot_thread_;
  std::mutex snap_mu_;
  std::condition_variable snap_cv_;
  std::mutex snap_take_mu_;
  bool snap_stop_ = false;
  std::atomic<uint64_t> update_count_{0};          // optimizer updates applied
  std::atomic<uint64_t> last_snapshot_counter_{0}; // covered by latest snap
  std::atomic<uint64_t> snapshot_version_{0};
  std::atomic<uint64_t> write_seq_gen_{0};         // write-provenance stamps
  std::atomic<int64_t> restored_counter_{-1};      // -1 = fresh start
  // atomics, not snapshot-thread-private: the HETU_PS_TEST_EXIT hook runs
  // take_snapshot on a serve thread concurrently with maybe_snapshot's
  // idle-check reads (take_snapshot itself serializes via snap_take_mu_)
  std::atomic<size_t> last_snapshot_params_{0};
  std::atomic<uint64_t> last_snapshot_write_seq_{0};
  // -- telemetry health counters (kServerStats slots 5-10) -----------------
  std::atomic<uint64_t> req_count_{0};      // requests served (all types)
  std::atomic<uint64_t> crc_reject_count_{0};  // hetuchaos: CRC rejects
  std::atomic<uint64_t> apply_ns_{0};       // wall ns spent in write applies
  std::atomic<uint64_t> apply_count_{0};
  std::atomic<int64_t> last_snapshot_steady_ms_{0};  // 0 = none yet
  std::atomic<int64_t> last_snapshot_epoch_{-1};  // hetusave epoch stamp on
  // the latest kSnapshotNow-driven snapshot; -1 = none this incarnation
  long test_exit_after_updates_ = -1;              // test hook (gated)
  bool test_exit_snap_ = false;
  // hetutrail: per-request span ring + ps_slow fault state
  static constexpr size_t kTrailFlushEvery = 256;
  std::string trail_path_;                         // "" = trail off
  size_t trail_cap_ = 65536;
  int64_t trail_max_bytes_ = 0;                    // HETU_TRAIL_MAX_MB
  int64_t trail_file_bytes_ = 0;                   // guarded by trail_mu_
  std::mutex trail_mu_;
  std::vector<SrvSpan> trail_ring_;
  uint64_t trail_dropped_ = 0;                     // guarded by trail_mu_
  FILE* trail_f_ = nullptr;                        // guarded by trail_mu_
  std::atomic<int64_t> test_slow_ms_{0};           // kTestSlowApply (gated)
  // hetu-elastic membership epoch (0 = rejection unarmed); set via
  // kSetWorldVersion, compared against MsgHeader::world_ver in serve_conn
  std::atomic<uint64_t> world_version_{0};
  ConnThreads conn_threads_;
  std::mutex fds_mu_;
  std::vector<int> live_fds_;
  std::mutex clients_mu_;
  std::unordered_map<int32_t, std::unique_ptr<ClientSlot>> clients_;
  Store store_;
  std::shared_mutex data_mu_;
  std::unordered_map<std::pair<int32_t, uint64_t>, std::vector<float>, PairHash>
      data_store_;
};

}  // namespace hetups
