// Host-side ring allreduce/allgather over raw TCP (reference
// src/communication/c_communication_nthread.cc:32,145-506 — the legacy
// multi-threaded ZMQ REQ/REP ring used for CPU data parallelism without
// NCCL). Same capability, redesigned on this van's socket helpers: each rank
// listens at base_port+rank, connects to its right neighbor, and runs the
// classic 2-phase chunked ring (N-1 scatter-reduce steps, N-1 allgather
// steps). Every step sends on a helper thread while receiving on the caller
// thread, so a full ring of simultaneous large sends cannot deadlock on
// socket buffers (the role the reference's worker threads play).
//
// On TPU the real DP path is GSPMD psum over ICI; this exists for API/
// capability parity and for host-only (accelerator-less) workers.
#ifndef HETUPS_RING_H_
#define HETUPS_RING_H_

#include <poll.h>
#include <sys/socket.h>

#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "net.h"

namespace hetups {

class RingComm {
 public:
  RingComm(int rank, int nranks, const std::string& host, int base_port)
      : rank_(rank), n_(nranks) {
    if (n_ < 1) throw std::runtime_error("ring: nranks must be >= 1");
    if (n_ == 1) return;
    // every blocking socket op is bounded so a dead peer surfaces as an
    // error, never a hang (same policy as the PS van, net.h:183)
    const int timeout_ms = env_int_or("DMLC_PS_RING_TIMEOUT_MS", 60000);
    try {
      listen_fd_ = listen_on("", base_port + rank_);
      // accept the left neighbor while connecting to the right one: the
      // ring is a cycle, so doing either first on every rank would deadlock
      std::exception_ptr acc_err;
      std::thread acc([&] {
        try {
          recv_fd_ = accept_with_timeout(listen_fd_, timeout_ms);
        } catch (...) {
          acc_err = std::current_exception();
        }
      });
      try {
        send_fd_ = connect_to(host, base_port + (rank_ + 1) % n_);
      } catch (...) {
        acc.join();  // bounded: accept_with_timeout gives up on its own
        throw;
      }
      acc.join();
      if (acc_err) std::rethrow_exception(acc_err);
      set_recv_timeout(recv_fd_, timeout_ms);
      timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
      ::setsockopt(send_fd_, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    } catch (...) {
      close_all();
      throw;
    }
  }

  ~RingComm() { close_all(); }
  RingComm(const RingComm&) = delete;

  int rank() const { return rank_; }
  int nranks() const { return n_; }

  // In-place sum-allreduce (reference _RingAllreduce_*_nthread :217/:388).
  void allreduce_sum(float* data, size_t n) {
    if (n_ == 1 || n == 0) return;
    std::vector<size_t> start(n_ + 1);
    for (int i = 0; i <= n_; ++i)
      start[i] = n * static_cast<size_t>(i) / n_;
    auto seg_len = [&](int s) { return start[s + 1] - start[s]; };
    auto mod = [&](int x) { return ((x % n_) + n_) % n_; };
    std::vector<float> buf((n + n_ - 1) / n_);  // ceil: the largest segment

    // phase 1: scatter-reduce — after step s, segment (rank-s-1) holds the
    // partial sum of s+2 ranks; after n-1 steps each rank owns the full sum
    // of segment (rank+1)
    for (int s = 0; s < n_ - 1; ++s) {
      int snd = mod(rank_ - s), rcv = mod(rank_ - s - 1);
      exchange(data + start[snd], seg_len(snd) * 4,
               buf.data(), seg_len(rcv) * 4);
      float* dst = data + start[rcv];
      for (size_t i = 0; i < seg_len(rcv); ++i) dst[i] += buf[i];
    }
    // phase 2: allgather — circulate the completed segments
    for (int s = 0; s < n_ - 1; ++s) {
      int snd = mod(rank_ + 1 - s), rcv = mod(rank_ - s);
      exchange(data + start[snd], seg_len(snd) * 4,
               data + start[rcv], seg_len(rcv) * 4);
    }
  }

  // out[(r*n_per) .. ] = rank r's in (reference DL_Communicate allgather).
  void allgather(const float* in, float* out, size_t n_per) {
    std::memcpy(out + static_cast<size_t>(rank_) * n_per, in, n_per * 4);
    if (n_ == 1) return;
    auto mod = [&](int x) { return ((x % n_) + n_) % n_; };
    for (int s = 0; s < n_ - 1; ++s) {
      int snd = mod(rank_ - s), rcv = mod(rank_ - s - 1);
      exchange(out + static_cast<size_t>(snd) * n_per, n_per * 4,
               out + static_cast<size_t>(rcv) * n_per, n_per * 4);
    }
  }

  void barrier() {
    float token = 0.0f;
    allreduce_sum(&token, 1);
  }

 private:
  static int accept_with_timeout(int listen_fd, int timeout_ms) {
    pollfd pfd{listen_fd, POLLIN, 0};
    int r = ::poll(&pfd, 1, timeout_ms);
    if (r == 0)
      throw std::runtime_error("ring: timed out waiting for left neighbor");
    if (r < 0) throw std::runtime_error("ring: poll failed");
    int fd = ::accept(listen_fd, nullptr, nullptr);
    if (fd < 0) throw std::runtime_error("ring: accept failed");
    return fd;
  }

  void close_all() {
    if (send_fd_ >= 0) ::close(send_fd_);
    if (recv_fd_ >= 0) ::close(recv_fd_);
    if (listen_fd_ >= 0) ::close(listen_fd_);
    send_fd_ = recv_fd_ = listen_fd_ = -1;
  }

  // Concurrent send-to-right / recv-from-left: the send rides a helper
  // thread so a ring of blocking sends can't wedge on full socket buffers.
  // Both directions carry SO_SNDTIMEO/SO_RCVTIMEO, so a collapsed ring
  // (dead or wedged neighbor) errors out instead of hanging the join.
  void exchange(const void* send_buf, size_t send_bytes,
                void* recv_buf, size_t recv_bytes) {
    std::exception_ptr send_err;
    std::thread t([&] {
      try {
        send_all(send_fd_, send_buf, send_bytes);
      } catch (...) {
        send_err = std::current_exception();
      }
    });
    bool ok = recv_all(recv_fd_, recv_buf, recv_bytes);
    t.join();
    if (send_err) std::rethrow_exception(send_err);
    if (!ok)
      throw std::runtime_error("ring: left neighbor closed or timed out");
  }

  int rank_;
  int n_;
  int listen_fd_ = -1;
  int send_fd_ = -1;
  int recv_fd_ = -1;
};

}  // namespace hetups

#endif  // HETUPS_RING_H_
