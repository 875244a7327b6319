// Cross-process tensor channel: bounded TCP frame queue.
//
// Native transport for the heterogeneous pipeline's stage boundaries —
// the reference's heter RPC (`paddle/fluid/distributed/ps/service/
// heter_client.h:83` SendAndRecv, heter_server.h request handlers,
// sendrecv.proto:133-137): a CPU-stage process streams micro-batch
// variables to a device-stage process over TCP. Design differences from
// the reference's brpc service: frames are opaque bytes (Python owns
// tensor serialization), and backpressure is physical — the server
// stops reading sockets when its bounded queue is full, so TCP flow
// control throttles the sender exactly like the reference's
// credit-based section queues.
//
// Threading: one accept loop + one reader thread per connection; frames
// from all connections merge into one MPMC queue (multiple upstream
// workers, multiple downstream consumers — HeterSectionWorker
// concurrency). All blocking ops honor a timeout.
//
// This is paddle_tpu_torch's own copy of paddle_tpu/csrc/tensor_channel.cc
// (paddle_tpu_torch/parallel/heter_channel.py binds it); it builds into the
// port's host library.
//
// Lock hierarchy: the queue's mu
// and the server's conn_mu are LEAF locks — each critical section holds
// exactly one of them and never acquires the other (the reader thread
// releases conn_mu before blocking on a queue push). Any future nesting
// must add a LOCK ORDER decl here and LOCK tags at the sites.
// LOCK ORDER: conn_mu < queue_mu

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FrameQueue {
  std::deque<std::string> q;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t capacity;
  bool closed = false;

  explicit FrameQueue(size_t cap) : capacity(cap) {}

  bool push(std::string&& f) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return q.size() < capacity || closed; });
    if (closed) return false;
    q.push_back(std::move(f));
    cv_pop.notify_one();
    return true;
  }

  // 0 ok, -1 timeout, -2 closed-and-drained
  int pop(std::string* out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    auto pred = [&] { return !q.empty() || closed; };
    if (timeout_ms < 0) {
      cv_pop.wait(lk, pred);
    } else if (!cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                pred)) {
      return -1;
    }
    if (q.empty()) return closed ? -2 : -1;
    *out = std::move(q.front());
    q.pop_front();
    cv_push.notify_one();
    return 0;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu);
    closed = true;
    cv_pop.notify_all();
    cv_push.notify_all();
  }
};

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

constexpr uint64_t kMaxFrame = 1ull << 33;  // 8 GiB sanity bound

struct ChannelServer {
  int listen_fd = -1;
  int port = 0;
  FrameQueue queue;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::mutex conn_mu;
  std::vector<std::thread> readers;
  std::vector<int> conn_fds;

  explicit ChannelServer(size_t cap) : queue(cap) {}

  bool start(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return false;
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    if (::listen(listen_fd, 16) < 0) return false;
    accept_thread = std::thread([this] { accept_loop(); });
    return true;
  }

  void accept_loop() {
    while (!stopping.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stopping.load() || errno == EBADF || errno == EINVAL) break;
        // transient (EINTR/ECONNABORTED/EMFILE...): keep serving
        if (errno == EMFILE || errno == ENFILE)
          std::this_thread::sleep_for(std::chrono::milliseconds(50));
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(conn_mu);
      if (stopping.load()) {  // raced stop(): it already swept conn_fds
        ::close(fd);
        break;
      }
      conn_fds.push_back(fd);
      readers.emplace_back([this, fd] { reader_loop(fd); });
    }
  }

  void reader_loop(int fd) {
    while (!stopping.load()) {
      uint64_t n = 0;
      if (!read_exact(fd, &n, sizeof(n)) || n > kMaxFrame) break;
      std::string frame(n, '\0');
      if (n && !read_exact(fd, frame.data(), n)) break;
      if (!queue.push(std::move(frame))) break;
    }
    {
      // deregister before close: stop() must never shutdown() a
      // recycled fd number belonging to someone else
      std::lock_guard<std::mutex> lk(conn_mu);
      for (auto it = conn_fds.begin(); it != conn_fds.end(); ++it)
        if (*it == fd) {
          conn_fds.erase(it);
          break;
        }
    }
    ::close(fd);
  }

  void stop() {
    if (stopping.exchange(true)) return;
    ::shutdown(listen_fd, SHUT_RDWR);
    ::close(listen_fd);
    {
      std::lock_guard<std::mutex> lk(conn_mu);
      for (int fd : conn_fds) ::shutdown(fd, SHUT_RDWR);
    }
    queue.close();
    if (accept_thread.joinable()) accept_thread.join();
    // swap readers out before joining: reader_loop takes conn_mu to
    // deregister its fd, so joining under the lock would deadlock
    std::vector<std::thread> rs;
    {
      std::lock_guard<std::mutex> lk(conn_mu);
      rs.swap(readers);
    }
    for (auto& t : rs)
      if (t.joinable()) t.join();
  }

  ~ChannelServer() { stop(); }
};

struct ChannelConn {
  int fd = -1;
  std::mutex mu;  // interleaved sends from multiple threads stay framed
};

thread_local std::string t_recv_buf;

}  // namespace

extern "C" {

void* tch_listen(int port, int64_t capacity) {
  auto* s = new ChannelServer(static_cast<size_t>(capacity > 0 ? capacity : 8));
  if (!s->start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int tch_port(void* h) { return static_cast<ChannelServer*>(h)->port; }

// 0 ok (frame in thread-local buffer), -1 timeout, -2 closed
int tch_recv(void* h, int timeout_ms) {
  return static_cast<ChannelServer*>(h)->queue.pop(&t_recv_buf, timeout_ms);
}

int64_t tch_frame_len(void*) { return static_cast<int64_t>(t_recv_buf.size()); }

void tch_frame_copy(void*, void* out) {
  std::memcpy(out, t_recv_buf.data(), t_recv_buf.size());
}

void tch_server_close(void* h) { static_cast<ChannelServer*>(h)->stop(); }

void tch_server_destroy(void* h) { delete static_cast<ChannelServer*>(h); }

void* tch_connect(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new ChannelConn();
  c->fd = fd;
  return c;
}

int tch_send(void* h, const void* data, int64_t len) {
  auto* c = static_cast<ChannelConn*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  uint64_t n = static_cast<uint64_t>(len);
  if (!write_exact(c->fd, &n, sizeof(n))) return -1;
  if (len && !write_exact(c->fd, data, static_cast<size_t>(len))) return -1;
  return 0;
}

void tch_conn_close(void* h) {
  auto* c = static_cast<ChannelConn*>(h);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

}  // extern "C"
