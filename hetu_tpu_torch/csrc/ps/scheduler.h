// Scheduler: node registry + address-book broadcast + worker barriers.
//
// Capability parity with the reference's ps-lite Postoffice/scheduler role
// (src/postoffice.cc, van.cc ProcessAddNodeCommandAtScheduler :47): nodes
// join, the scheduler assembles the cluster view and broadcasts it; workers
// use the scheduler for group barriers (Postoffice::Barrier).
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "net.h"

namespace hetups {

class Scheduler {
 public:
  Scheduler(int port, int num_servers, int num_workers)
      : port_(port), num_servers_(num_servers), num_workers_(num_workers) {}

  ~Scheduler() { stop(); }

  void start() {
    listen_fd_ = listen_on("", port_);
    running_ = true;
    accept_thread_ = std::thread([this] { accept_loop(); });
  }

  void stop() {
    running_ = false;
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    {
      // release any workers parked in the kCommitResize drain barrier —
      // their conn threads otherwise wait on resize_cv_ forever and
      // join_all() below never returns
      std::lock_guard<std::mutex> g(mu_);
      ++resize_gen_;
      resize_cv_.notify_all();
    }
    {
      std::lock_guard<std::mutex> g(fds_mu_);
      for (int fd : live_fds_) ::shutdown(fd, SHUT_RDWR);
    }
    conn_threads_.join_all();
  }

  // Blocks until every node has sent kShutdown (clean cluster teardown) —
  // bounded by DMLC_PS_SCHED_WAIT_TIMEOUT_MS (default 5 min; <= 0 waits
  // forever). The clock arms when teardown BEGINS (the first kShutdown
  // arrives) and re-arms on every further checkout: wait() is entered at
  // cluster STARTUP, so a timeout measured from entry would kill any
  // healthy run longer than the knob mid-training. A rank that died before
  // checkout shows up as no progress within one window once the others
  // check out, and the timeout throws a diagnostic naming it. (A cluster
  // where NOBODY checks out is the launcher's reap path — workers send no
  // heartbeats, so the scheduler cannot tell that from a long quiet run.)
  // A second call after a timeout returns immediately so Finalize() can
  // still tear the scheduler down.
  void wait() {
    std::unique_lock<std::mutex> g(mu_);
    if (gave_up_) return;
    auto pred = [this] { return shutdowns_ >= num_servers_ + num_workers_; };
    if (wait_timeout_ms_ <= 0) {
      done_cv_.wait(g, pred);
      return;
    }
    done_cv_.wait(g, [this] { return shutdowns_ > 0; });
    int last = shutdowns_;
    while (!pred()) {
      done_cv_.wait_for(g, std::chrono::milliseconds(wait_timeout_ms_),
                        [&] { return pred() || shutdowns_ != last; });
      if (shutdowns_ == last && !pred()) break;  // window expired, no progress
      last = shutdowns_;
    }
    if (pred()) return;
    gave_up_ = true;
    auto seen = [this](int role, int id) {
      for (auto& p : checked_out_)
        if (p.first == role && p.second == id) return true;
      return false;
    };
    std::string sv, wk;
    for (int i = 0; i < num_servers_; ++i)
      if (!seen(0, i)) sv += (sv.empty() ? "" : ",") + std::to_string(i);
    // after an elastic resize the live worker ranks are members_, not
    // necessarily 0..num_workers_-1
    ensure_members_locked();
    for (int32_t i : members_)
      if (!seen(1, i)) wk += (wk.empty() ? "" : ",") + std::to_string(i);
    throw std::runtime_error(
        "hetups scheduler: teardown wait timed out after " +
        std::to_string(wait_timeout_ms_) + " ms (" +
        std::to_string(shutdowns_) + "/" +
        std::to_string(num_servers_ + num_workers_) +
        " shutdowns received); never checked out: servers [" + sv +
        "] workers [" + wk + "] — those ranks likely died before teardown");
  }

 private:
  void accept_loop() {
    while (running_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      conn_threads_.spawn([this, fd] { serve_conn(fd); });
    }
  }

  void serve_conn(int fd) {
    {
      std::lock_guard<std::mutex> g(fds_mu_);
      live_fds_.push_back(fd);
    }
    Message req;
    while (recv_msg(fd, &req)) {
      switch (static_cast<PsfType>(req.head.type)) {
        case PsfType::kRegister: {
          // args: i32[role(0=server,1=worker), id, port], str host
          const int32_t* meta = req.args[0].as_i32();
          std::string host = req.args[1].as_str();
          std::unique_lock<std::mutex> g(mu_);
          int32_t epoch = 0;
          if (meta[0] == 0) {
            // capacity may exceed num_servers_ while a grow is pending
            // (kProposeResize resizes the book so joining servers can
            // register before the world flips)
            const int cap = std::max(
                num_servers_, pending_version_ ? pending_ns_ : 0);
            if (meta[1] < 0 || meta[1] >= cap) {
              std::fprintf(stderr,
                           "[hetups scheduler] SERVER_ID %d out of range "
                           "[0, %d) — check DMLC_NUM_SERVER\n",
                           meta[1], cap);
              break;
            }
            if (server_addrs_.size() < static_cast<size_t>(cap)) {
              server_addrs_.resize(cap);
              last_hb_.resize(cap);
            }
            bool readd = !server_addrs_[meta[1]].empty();
            server_addrs_[meta[1]] = host + ":" + std::to_string(meta[2]);
            last_hb_[meta[1]] = Clock::now();
            if (readd) {
              // recovery re-add (reference van.cc:47's recovery-node path):
              // the cluster is already assembled, answer immediately so the
              // replacement can start serving
              std::fprintf(stderr,
                           "[hetups scheduler] server %d re-registered "
                           "(recovery) at %s\n",
                           meta[1], server_addrs_[meta[1]].c_str());
              Message rsp;
              rsp.head.type = static_cast<int32_t>(PsfType::kAddressBook);
              rsp.head.req_id = req.head.req_id;
              std::string book;
              for (auto& a : server_addrs_) book += a + "\n";
              rsp.args.push_back(Arg::str(book));
              g.unlock();
              try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;  // peer vanished; drop the connection, not the scheduler
          }
              break;
            }
            ++servers_seen_;
          } else {
            ++workers_seen_;
            // per-rank incarnation epoch: a RESTARTED worker reuses its
            // rank's client_id, and the servers' dedup slots (live or
            // snapshot-restored) outlive it. The scheduler is the one
            // party that observes every incarnation in order, so its
            // counter — not the worker's wall clock, which NTP can step
            // backwards — is what guarantees each incarnation's req_ids
            // start above the previous one's.
            if (meta[1] >= 0 && meta[1] < num_workers_) {
              if (worker_incarnations_.size() <
                  static_cast<size_t>(num_workers_))
                worker_incarnations_.resize(num_workers_, 0);
              epoch = ++worker_incarnations_[meta[1]];
            }
          }
          reg_cv_.notify_all();
          reg_cv_.wait(g, [this] {
            return servers_seen_ >= num_servers_ && workers_seen_ >= num_workers_;
          });
          std::string book;
          for (auto& a : server_addrs_) book += a + "\n";
          Message rsp;
          rsp.head.type = static_cast<int32_t>(PsfType::kAddressBook);
          rsp.head.req_id = req.head.req_id;
          rsp.args.push_back(Arg::str(book));
          rsp.args.push_back(Arg::i32(&epoch, 1));  // 0 for servers
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;  // peer vanished; drop the connection, not the scheduler
          }
          break;
        }
        case PsfType::kHeartbeat: {
          // args: i32[role, id] — one-way keepalive (reference van.cc:569)
          const int32_t* meta = req.args[0].as_i32();
          std::lock_guard<std::mutex> g(mu_);
          if (meta[0] == 0 && meta[1] >= 0 &&
              static_cast<size_t>(meta[1]) < last_hb_.size())
            last_hb_[meta[1]] = Clock::now();
          break;
        }
        case PsfType::kQueryServers: {
          // reply: str book, i32 alive[num_servers] (1 = heartbeat fresh)
          std::unique_lock<std::mutex> g(mu_);
          std::string book;
          for (auto& a : server_addrs_) book += a + "\n";
          std::vector<int32_t> alive(server_addrs_.size(), 0);
          auto now = Clock::now();
          for (size_t i = 0; i < server_addrs_.size(); ++i) {
            auto age = std::chrono::duration_cast<std::chrono::milliseconds>(
                           now - last_hb_[i])
                           .count();
            alive[i] = (!server_addrs_[i].empty() && age <= hb_timeout_ms_)
                           ? 1
                           : 0;
          }
          Message rsp;
          rsp.head.type = static_cast<int32_t>(PsfType::kAddressBook);
          rsp.head.req_id = req.head.req_id;
          rsp.args.push_back(Arg::str(book));
          rsp.args.push_back(Arg::i32(alive.data(), alive.size()));
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;  // peer vanished; drop the connection, not the scheduler
          }
          break;
        }
        case PsfType::kBarrier: {
          std::unique_lock<std::mutex> g(mu_);
          uint64_t my_gen = barrier_gen_;
          ++barrier_count_;
          if (barrier_count_ >= num_workers_) {
            barrier_count_ = 0;
            ++barrier_gen_;
            barrier_cv_.notify_all();
          } else {
            barrier_cv_.wait(g, [this, my_gen] { return barrier_gen_ > my_gen; });
          }
          Message rsp;
          rsp.head.type = static_cast<int32_t>(PsfType::kAck);
          rsp.head.req_id = req.head.req_id;
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;  // peer vanished; drop the connection, not the scheduler
          }
          break;
        }
        case PsfType::kProposeResize: {
          // phase 1 (hetu-elastic): record the pending world and grow the
          // registry CAPACITY so joining servers can register/restore —
          // nothing else changes until kFinishResize.
          // args: i32[new_nw, new_ns, removed_ranks...],
          //       optional i64 removed_last_steps (-1 = unknown progress)
          // (size-guarded: these PSFs are reachable from hand-packed raw
          // sockets, and a short frame must not index past empty args)
          if (req.args.empty() || req.args[0].size() < 8) {
            Message rsp = error_reply(req.head.req_id,
                                      "kProposeResize needs at least "
                                      "[new_n_workers, new_n_servers]");
            try {
              send_msg(fd, rsp);
            } catch (...) {
              goto out;
            }
            break;
          }
          const int32_t* a = req.args[0].as_i32();
          const size_t n = req.args[0].size() / 4;
          std::unique_lock<std::mutex> g(mu_);
          ensure_members_locked();
          Message rsp;
          rsp.head.type = static_cast<int32_t>(PsfType::kAck);
          rsp.head.req_id = req.head.req_id;
          if (n < 2) {
            rsp = error_reply(req.head.req_id, "kProposeResize needs at "
                              "least [new_n_workers, new_n_servers]");
          } else {
            const int nw = a[0], ns = a[1];
            std::vector<int32_t> removed(a + 2, a + n);
            if (pending_version_ != 0) {
              if (nw == pending_nw_ && ns == pending_ns_ &&
                  removed == pending_removed_) {
                // idempotent re-propose of the identical resize
                int64_t v = static_cast<int64_t>(pending_version_);
                rsp.args.push_back(Arg::i64(&v, 1));
              } else {
                rsp = error_reply(
                    req.head.req_id,
                    "a different resize (world v" +
                    std::to_string(pending_version_) +
                    ") is already pending — finish or abort it first");
              }
            } else if (ns < num_servers_) {
              rsp = error_reply(
                  req.head.req_id,
                  "server scale-down is not supported (a lost server is a "
                  "FAULT — the HA snapshot/respawn path owns it)");
            } else if (nw < 1) {
              rsp = error_reply(req.head.req_id,
                                "a world needs at least one worker");
            } else {
              pending_version_ = world_version_ + 1;
              pending_nw_ = nw;
              pending_ns_ = ns;
              pending_removed_ = std::move(removed);
              pending_removed_steps_.assign(pending_removed_.size(), -1);
              if (req.args.size() > 1) {
                const int64_t* st = req.args[1].as_i64();
                const size_t ns_ = req.args[1].n_i64();
                for (size_t i = 0;
                     i < ns_ && i < pending_removed_steps_.size(); ++i)
                  pending_removed_steps_[i] = st[i];
              }
              drained_.clear();
              if (server_addrs_.size() < static_cast<size_t>(ns)) {
                server_addrs_.resize(ns);
                last_hb_.resize(ns);
              }
              if (worker_incarnations_.size() < static_cast<size_t>(nw))
                worker_incarnations_.resize(nw, 0);
              std::fprintf(stderr,
                           "[hetups scheduler] resize proposed: world v%llu "
                           "-> %dw/%ds\n",
                           (unsigned long long)pending_version_, nw, ns);
              int64_t v = static_cast<int64_t>(pending_version_);
              rsp.args.push_back(Arg::i64(&v, 1));
            }
          }
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;
          }
          break;
        }
        case PsfType::kResizeState: {
          std::unique_lock<std::mutex> g(mu_);
          ensure_members_locked();
          const auto survivors = survivors_locked();
          int64_t vals[13] = {
              static_cast<int64_t>(world_version_),
              static_cast<int64_t>(pending_version_),
              num_workers_,
              num_servers_,
              pending_nw_,
              pending_ns_,
              static_cast<int64_t>(drained_survivors_locked(survivors)),
              pending_version_ ? static_cast<int64_t>(survivors.size()) : 0,
              new_servers_ready_locked() ? 1 : 0,
              static_cast<int64_t>(members_.size()),
              // slot 10 (hetusave): completed coordinated-snapshot epochs
              // this scheduler incarnation — a pure suffix extension, so
              // pre-hetusave clients reading 10 slots stay valid
              static_cast<int64_t>(snapshot_epochs_),
              // slots 11-12 (hetupilot): actuation eras sealed with a
              // commit / rollback verdict tag — the same suffix-extension
              // discipline, so hetusave-era clients reading 11 stay valid
              static_cast<int64_t>(pilot_commit_epochs_),
              static_cast<int64_t>(pilot_rollback_epochs_)};
          Message rsp;
          rsp.head.type = static_cast<int32_t>(PsfType::kAck);
          rsp.head.req_id = req.head.req_id;
          rsp.args.push_back(Arg::i64(vals, 13));
          rsp.args.push_back(Arg::i32(members_.data(), members_.size()));
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;
          }
          break;
        }
        case PsfType::kCommitResize: {
          // the drain barrier: a surviving worker reports its current step
          // and PARKS here until the coordinator finishes (or aborts) the
          // pending resize. With no resize pending it returns the current
          // world immediately (covers retried commits after a finish).
          if (req.args.empty() || req.args[0].size() < 8) {
            Message rsp = error_reply(req.head.req_id,
                                      "kCommitResize needs [role, rank]");
            try {
              send_msg(fd, rsp);
            } catch (...) {
              goto out;
            }
            break;
          }
          const int32_t* who = req.args[0].as_i32();
          const int32_t rank = who[1];
          const int64_t step =
              (req.args.size() > 1 && req.args[1].n_i64() >= 1)
                  ? req.args[1].as_i64()[0]
                  : 0;
          std::unique_lock<std::mutex> g(mu_);
          ensure_members_locked();
          if (pending_version_ != 0) {
            drained_[rank] = step;
            const uint64_t my_gen = resize_gen_;
            resize_cv_.wait(g, [this, my_gen] {
              return resize_gen_ > my_gen;
            });
          }
          Message rsp = world_reply_locked(req.head.req_id, rank);
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;
          }
          break;
        }
        case PsfType::kFinishResize: {
          // phase 2: flip the world atomically (or abort — the safety
          // valve after a failed migration / drain timeout: the pending
          // proposal clears and every parked worker is released under the
          // OLD world, state untouched).
          const bool abort =
              !req.args.empty() && req.args[0].size() >= 4 &&
              req.args[0].as_i32()[0] != 0;
          // optional second i32 (suffix extension): the actuation tag —
          // WHY the coordinator ran this identity-resize barrier era.
          // 0/absent: plain resize or untagged abort (counted nowhere);
          // 1: hetusave committed a snapshot epoch; 2/3: hetupilot sealed
          // an actuation era with a commit/rollback verdict. Only tagged
          // aborts advance an era counter — shape inference (identical
          // world, nobody removed) would miscount a genuine same-size
          // resize aborted after a drain timeout, or a failed snapshot's
          // best-effort release, as a completed epoch.
          const int32_t actuation_tag =
              (abort && req.args[0].size() >= 8)
                  ? req.args[0].as_i32()[1]
                  : 0;
          std::unique_lock<std::mutex> g(mu_);
          ensure_members_locked();
          Message rsp;
          if (pending_version_ == 0) {
            rsp = error_reply(req.head.req_id, "no resize is pending");
          } else if (abort) {
            // hetusave and hetupilot both ride propose-identical-world ->
            // drain-park -> abort as their quiesce barrier; when the
            // coordinator tagged this abort as the release AFTER its
            // outcome durably committed (job manifest / actuation
            // verdict), stamp the matching era counter so kResizeState
            // exposes monotonic, cause-attributed counters.
            if (actuation_tag == 1) ++snapshot_epochs_;
            else if (actuation_tag == 2) ++pilot_commit_epochs_;
            else if (actuation_tag == 3) ++pilot_rollback_epochs_;
            std::fprintf(stderr,
                         "[hetups scheduler] resize v%llu ABORTED; world "
                         "v%llu continues\n",
                         (unsigned long long)pending_version_,
                         (unsigned long long)world_version_);
            pending_version_ = 0;
            pending_removed_.clear();
            pending_removed_steps_.clear();
            drained_.clear();
            ++resize_gen_;
            resize_cv_.notify_all();
            rsp.head.type = static_cast<int32_t>(PsfType::kAck);
            rsp.head.req_id = req.head.req_id;
            int64_t v = static_cast<int64_t>(world_version_);
            rsp.args.push_back(Arg::i64(&v, 1));
          } else {
            const auto survivors = survivors_locked();
            const size_t sdrained = drained_survivors_locked(survivors);
            if (sdrained < survivors.size()) {
              rsp = error_reply(
                  req.head.req_id,
                  "drain barrier incomplete (" +
                  std::to_string(sdrained) + "/" +
                  std::to_string(survivors.size()) + " survivors parked)");
            } else if (!new_servers_ready_locked()) {
              rsp = error_reply(req.head.req_id,
                                "joining server(s) not yet registered");
            } else {
              // close the open era with per-member end steps: survivors
              // reported theirs at drain; removed ranks ride the
              // proposal's progress records (-1 = unknown -> max survivor
              // step, which may LOSE the dead rank's in-era tail but
              // never double-applies it)
              int64_t max_step = 0;
              for (auto& kv : drained_) max_step = std::max(max_step,
                                                            kv.second);
              if (!world_log_.empty()) {
                for (auto& m : world_log_.back().members) {
                  auto it = drained_.find(m.rank);
                  if (it != drained_.end()) {
                    m.end_step = it->second;
                    continue;
                  }
                  // a rank that never drained (removed, or vanished):
                  // with a progress record its exact tail redistributes;
                  // WITHOUT one the only end step that can never
                  // double-apply is "assume it consumed its whole chunk"
                  // (-2 sentinel; era_partitions treats the chunk as
                  // fully consumed) — its unconsumed tail is LOST, which
                  // is the documented at-most-once fallback. Guessing the
                  // max survivor step would replay batches a fast dead
                  // rank already pushed.
                  m.end_step = -2;
                  for (size_t i = 0; i < pending_removed_.size(); ++i)
                    if (pending_removed_[i] == m.rank &&
                        pending_removed_steps_[i] >= 0)
                      m.end_step = pending_removed_steps_[i];
                }
              }
              members_ = survivors;
              // joiners take the lowest free ranks (dedup-safe: the
              // per-rank incarnation epoch covers rank reuse)
              while (static_cast<int>(members_.size()) < pending_nw_) {
                int32_t cand = 0;
                while (std::find(members_.begin(), members_.end(), cand) !=
                       members_.end())
                  ++cand;
                members_.push_back(cand);
              }
              std::sort(members_.begin(), members_.end());
              if (static_cast<int>(members_.size()) > pending_nw_)
                members_.resize(pending_nw_);  // unnamed shrink: drop
                                               // the highest ranks
              num_workers_ = pending_nw_;
              num_servers_ = pending_ns_;
              world_version_ = pending_version_;
              Era e{world_version_, num_workers_, num_servers_, {}};
              for (int32_t r : members_) {
                auto it = drained_.find(r);
                e.members.push_back(
                    {r, it != drained_.end() ? it->second : max_step, -1});
              }
              world_log_.push_back(std::move(e));
              pending_version_ = 0;
              pending_removed_.clear();
              pending_removed_steps_.clear();
              drained_.clear();
              ++resize_gen_;
              resize_cv_.notify_all();
              std::fprintf(stderr,
                           "[hetups scheduler] world v%llu committed: "
                           "%dw/%ds\n",
                           (unsigned long long)world_version_, num_workers_,
                           num_servers_);
              rsp.head.type = static_cast<int32_t>(PsfType::kAck);
              rsp.head.req_id = req.head.req_id;
              int64_t v = static_cast<int64_t>(world_version_);
              rsp.args.push_back(Arg::i64(&v, 1));
            }
          }
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;
          }
          break;
        }
        case PsfType::kResizeLog: {
          // flat i64 rows: per era {version, nw, ns, n_members,
          // (rank, start_step, end_step) * n_members}
          std::unique_lock<std::mutex> g(mu_);
          ensure_members_locked();
          std::vector<int64_t> flat;
          for (const auto& e : world_log_) {
            flat.push_back(static_cast<int64_t>(e.version));
            flat.push_back(e.nw);
            flat.push_back(e.ns);
            flat.push_back(static_cast<int64_t>(e.members.size()));
            for (const auto& m : e.members) {
              flat.push_back(m.rank);
              flat.push_back(m.start_step);
              flat.push_back(m.end_step);
            }
          }
          Message rsp;
          rsp.head.type = static_cast<int32_t>(PsfType::kAck);
          rsp.head.req_id = req.head.req_id;
          rsp.args.push_back(Arg::i64(flat.data(), flat.size()));
          g.unlock();
          try {
            send_msg(fd, rsp);
          } catch (...) {
            goto out;
          }
          break;
        }
        case PsfType::kShutdown: {
          // optional args: i32[role, id] — who is checking out (lets the
          // bounded wait() name the ranks that never did)
          std::unique_lock<std::mutex> g(mu_);
          ++shutdowns_;
          if (!req.args.empty() && req.args[0].size() >= 8) {
            const int32_t* m = req.args[0].as_i32();
            checked_out_.push_back({m[0], m[1]});
          }
          done_cv_.notify_all();
          goto out;
        }
        default:
          break;
      }
    }
  out:
    {
      std::lock_guard<std::mutex> g(fds_mu_);
      live_fds_.erase(std::remove(live_fds_.begin(), live_fds_.end(), fd),
                      live_fds_.end());
    }
    ::close(fd);
  }

  int port_;
  int num_servers_;
  int num_workers_;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  std::thread accept_thread_;
  ConnThreads conn_threads_;

  std::mutex fds_mu_;
  std::vector<int> live_fds_;
  using Clock = std::chrono::steady_clock;
  std::mutex mu_;
  std::condition_variable reg_cv_, barrier_cv_, done_cv_;
  std::vector<std::string> server_addrs_;
  std::vector<Clock::time_point> last_hb_;
  // a server whose last heartbeat is older than this is reported dead to
  // kQueryServers clients (reference heartbeat_timeout, van.cc:27)
  int hb_timeout_ms_ = env_int_or("DMLC_PS_HEARTBEAT_TIMEOUT_MS", 10000);
  int servers_seen_ = 0, workers_seen_ = 0;
  std::vector<uint32_t> worker_incarnations_;  // per-rank kRegister count

  // -- hetu-elastic membership registry (guarded by mu_) ------------------
  // The world log: one era per committed membership, with PER-MEMBER
  // start/end steps — survivors drain at different local steps, and the
  // per-member bounds are what keep the exactly-once dataloader
  // accounting honest (hetu_tpu/elastic.py era_partitions).
  struct EraMember {
    int32_t rank;
    int64_t start_step;
    int64_t end_step;  // -1 while the era is open
  };
  struct Era {
    uint64_t version;
    int32_t nw, ns;
    std::vector<EraMember> members;
  };
  uint64_t world_version_ = 1;
  std::vector<int32_t> members_;  // current worker ranks (sorted)
  std::vector<Era> world_log_;
  uint64_t pending_version_ = 0;  // 0 = no resize pending
  int pending_nw_ = 0, pending_ns_ = 0;
  std::vector<int32_t> pending_removed_;
  std::vector<int64_t> pending_removed_steps_;  // -1 = unknown progress
  std::map<int32_t, int64_t> drained_;  // rank -> step at drain commit
  uint64_t resize_gen_ = 0;             // bumps at finish/abort
  std::condition_variable resize_cv_;   // parks kCommitResize callers
  uint64_t snapshot_epochs_ = 0;        // hetusave: completed coordinated
                                        // snapshot epochs (snapshot-tagged
                                        // kFinishResize aborts only)
  uint64_t pilot_commit_epochs_ = 0;    // hetupilot: actuation eras sealed
  uint64_t pilot_rollback_epochs_ = 0;  // with a commit/rollback verdict
                                        // (tag 2/3 kFinishResize aborts)

  // members_/world_log_ materialize lazily — the launch world is fixed by
  // config, so this is valid whether it runs before or after assembly
  void ensure_members_locked() {
    if (members_.empty() && num_workers_ > 0)
      for (int i = 0; i < num_workers_; ++i) members_.push_back(i);
    if (world_log_.empty() && !members_.empty()) {
      Era e{1, num_workers_, num_servers_, {}};
      for (int32_t r : members_) e.members.push_back({r, 0, -1});
      world_log_.push_back(std::move(e));
    }
  }

  std::vector<int32_t> survivors_locked() {
    ensure_members_locked();
    std::vector<int32_t> out;
    for (int32_t r : members_)
      if (std::find(pending_removed_.begin(), pending_removed_.end(), r) ==
          pending_removed_.end())
        out.push_back(r);
    return out;
  }

  // drained SURVIVORS only: a removed-but-alive rank that parks must not
  // satisfy the barrier while a true survivor still has traffic in flight
  size_t drained_survivors_locked(const std::vector<int32_t>& survivors) {
    size_t n = 0;
    for (int32_t r : survivors)
      if (drained_.count(r)) ++n;
    return n;
  }

  bool new_servers_ready_locked() const {
    if (pending_version_ == 0) return true;
    for (int i = num_servers_;
         i < pending_ns_ && i < static_cast<int>(server_addrs_.size()); ++i)
      if (server_addrs_[i].empty()) return false;
    return pending_ns_ <= static_cast<int>(server_addrs_.size());
  }

  // shared reply body for kCommitResize (and its no-pending fast path):
  // the released worker learns the now-current world in one message
  Message world_reply_locked(uint64_t req_id, int32_t rank) {
    Message rsp;
    rsp.head.type = static_cast<int32_t>(PsfType::kAck);
    rsp.head.req_id = req_id;
    int64_t dp_rank = -1, start_step = 0;
    if (!world_log_.empty()) {
      const Era& cur = world_log_.back();
      for (size_t j = 0; j < cur.members.size(); ++j)
        if (cur.members[j].rank == rank) {
          dp_rank = static_cast<int64_t>(j);
          start_step = cur.members[j].start_step;
        }
    }
    int64_t vals[5] = {static_cast<int64_t>(world_version_), num_workers_,
                       num_servers_, dp_rank, start_step};
    rsp.args.push_back(Arg::i64(vals, 5));
    rsp.args.push_back(Arg::i32(members_.data(), members_.size()));
    std::string book;
    for (auto& a : server_addrs_) book += a + "\n";
    rsp.args.push_back(Arg::str(book));
    return rsp;
  }

  static Message error_reply(uint64_t req_id, const std::string& what) {
    Message rsp;
    rsp.head.type = static_cast<int32_t>(PsfType::kAck);
    rsp.head.req_id = req_id;
    rsp.head.flags = -1;
    rsp.args.push_back(Arg::str(what));
    return rsp;
  }
  int barrier_count_ = 0;
  uint64_t barrier_gen_ = 0;
  int shutdowns_ = 0;
  std::vector<std::pair<int, int>> checked_out_;  // (role, id) per kShutdown
  int wait_timeout_ms_ = env_int_or("DMLC_PS_SCHED_WAIT_TIMEOUT_MS", 300000);
  bool gave_up_ = false;
};

}  // namespace hetups
