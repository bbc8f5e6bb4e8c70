// Native (C++) server data plane for the framed tensor RPC protocol.
//
// The reference's runtime is pure Python; this framework's server data
// plane can instead run GIL-free: one epoll thread owns accept/read/write
// of length-prefixed frames (wire format identical to
// utils/serialization.py: uint32_le(len) payload, 1 GiB cap), handing
// complete frames to Python workers through a mutex+condvar inbox and
// taking replies back through per-connection write queues.  Python only
// touches whole frames — per-byte socket work, short-read bookkeeping, and
// flow control all happen here, off the GIL and off the asyncio loop.
//
// ABI (ctypes, see native/__init__.py):
//   void*  lah_pump_create(const char* host, int port, int* out_port);
//   int    lah_pump_next(void*, int timeout_ms, uint64_t* conn,
//                        uint8_t** buf, uint64_t* len);   // 1 frame / 0 timeout / -1 stopped
//   int    lah_pump_send(void*, uint64_t conn, const uint8_t* buf, uint64_t len);
//   void   lah_pump_buffree(uint8_t* buf);
//   void   lah_pump_shutdown(void*);
//
// Build: g++ -O2 -shared -fPIC -pthread framepump.cpp -o _framepump.so

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint64_t kMaxFrame = 1ull << 30;  // matches MAX_FRAME_BYTES
constexpr int kBacklog = 128;
// Backpressure: the asyncio transport gets it for free from TCP + serial
// per-connection reads; here we bound the inbox (stop reading every socket
// past the high-water mark, resume below the low-water mark) and bound each
// connection's reply queue (a peer that won't read replies gets closed).
constexpr size_t kInboxHighFrames = 1024;
constexpr size_t kInboxLowFrames = 256;
constexpr uint64_t kInboxHighBytes = 256ull << 20;
constexpr uint64_t kConnOutMaxBytes = 256ull << 20;

struct Frame {
  uint64_t conn;
  uint8_t* data;
  uint64_t len;
};

struct OutBuf {
  std::vector<uint8_t> data;
  size_t off = 0;
};

struct Conn {
  int fd = -1;
  uint64_t id = 0;
  // read state machine: 4-byte LE length prefix, then body.  The body is
  // a malloc'd buffer recv'd into directly and handed to the inbox whole
  // (ownership transfers; freed by lah_pump_buffree) — no intermediate
  // copies on the hot path.
  uint8_t lenbuf[4];
  size_t lenoff = 0;
  uint8_t* body = nullptr;
  uint64_t need = 0;
  uint64_t got = 0;
  bool reading_body = false;
  // write state (out/out_bytes/want_write guarded by Pump::mu)
  std::deque<OutBuf> out;
  uint64_t out_bytes = 0;
  bool want_write = false;

  ~Conn() { free(body); }
};

struct Pump {
  int listen_fd = -1;
  int epfd = -1;
  int evfd = -1;
  std::thread thr;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Frame> inbox;
  std::unordered_map<uint64_t, Conn*> by_id;  // guarded by mu
  std::unordered_map<int, Conn*> by_fd;       // pump thread only
  std::unordered_set<uint64_t> dirty;         // conns with queued output (mu)
  uint64_t next_id = 1;
  uint64_t inbox_bytes = 0;                   // guarded by mu
  bool paused = false;                        // reads paused (mu)
  bool stopping = false;
};

void set_nonblock(int fd) { fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK); }

void close_conn(Pump* p, Conn* c) {
  epoll_ctl(p->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  p->by_fd.erase(c->fd);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->by_id.erase(c->id);
    p->dirty.erase(c->id);
  }
  delete c;
}

void epoll_update(Pump* p, Conn* c, bool want_write, bool paused) {
  epoll_event ev{};
  ev.events = (paused ? 0u : EPOLLIN) | (want_write ? EPOLLOUT : 0u);
  ev.data.fd = c->fd;
  epoll_ctl(p->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// Re-arm every connection's read interest after a pause state change.
// Pump thread only.
void apply_pause(Pump* p, bool paused) {
  for (auto& [fd, c] : p->by_fd) {
    bool want;
    {
      std::lock_guard<std::mutex> lk(p->mu);
      want = c->want_write;
    }
    epoll_update(p, c, want, paused);
  }
}

// Drain as much queued output as the socket accepts; returns false on error.
bool flush_out(Pump* p, Conn* c) {
  std::unique_lock<std::mutex> lk(p->mu);
  while (!c->out.empty()) {
    OutBuf& ob = c->out.front();
    const uint8_t* base = ob.data.data() + ob.off;
    size_t left = ob.data.size() - ob.off;
    lk.unlock();  // write() without the lock: senders may queue meanwhile
    ssize_t n = send(c->fd, base, left, MSG_NOSIGNAL);
    lk.lock();
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      return false;
    }
    ob.off += static_cast<size_t>(n);
    if (ob.off == ob.data.size()) {
      c->out_bytes -= ob.data.size();
      c->out.pop_front();
    }
  }
  bool want = !c->out.empty();
  bool paused = p->paused;
  if (want != c->want_write) {
    c->want_write = want;
    lk.unlock();
    epoll_update(p, c, want, paused);
    return true;
  }
  return true;
}

// Read everything available; push complete frames into the inbox.
bool pump_read(Pump* p, Conn* c) {
  while (true) {
    ssize_t n;
    if (!c->reading_body) {
      n = recv(c->fd, c->lenbuf + c->lenoff, 4 - c->lenoff, 0);
      if (n == 0) return false;
      if (n < 0) return errno == EAGAIN || errno == EWOULDBLOCK;
      c->lenoff += static_cast<size_t>(n);
      if (c->lenoff < 4) continue;
      uint32_t len;
      memcpy(&len, c->lenbuf, 4);  // wire is little-endian; so are we (x86/arm64)
      c->lenoff = 0;
      if (len > kMaxFrame) return false;  // oversized: drop the peer
      // Allocation failure must drop the peer, never kill the process
      // (the asyncio transport's equivalent is a per-connection error).
      uint8_t* body = static_cast<uint8_t*>(malloc(len ? len : 1));
      if (body == nullptr) return false;
      c->body = body;
      c->need = len;
      c->got = 0;
      c->reading_body = true;
      if (len != 0) continue;
      // zero-length frame: deliver immediately
    } else {
      // recv straight into the frame buffer: zero intermediate copies
      n = recv(c->fd, c->body + c->got,
               static_cast<size_t>(c->need - c->got), 0);
      if (n == 0) return false;
      if (n < 0) return errno == EAGAIN || errno == EWOULDBLOCK;
      c->got += static_cast<uint64_t>(n);
      if (c->got < c->need) continue;
    }
    // complete frame: ownership of c->body moves to the inbox
    bool hit_high_water;
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->inbox.push_back(Frame{c->id, c->body, c->need});
      p->inbox_bytes += c->need;
      hit_high_water = !p->paused &&
                       (p->inbox.size() >= kInboxHighFrames ||
                        p->inbox_bytes >= kInboxHighBytes);
      if (hit_high_water) p->paused = true;
    }
    p->cv.notify_one();
    c->body = nullptr;
    c->reading_body = false;
    c->need = c->got = 0;
    if (hit_high_water) {
      apply_pause(p, true);
      return true;  // stop reading until workers drain the inbox
    }
  }
}

void pump_loop(Pump* p) {
  epoll_event evs[64];
  while (true) {
    int n = epoll_wait(p->epfd, evs, 64, 200);
    {
      std::lock_guard<std::mutex> lk(p->mu);
      if (p->stopping) break;
    }
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == p->listen_fd) {
        while (true) {
          int cfd = accept(p->listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          set_nonblock(cfd);
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* c = new Conn();
          c->fd = cfd;
          {
            std::lock_guard<std::mutex> lk(p->mu);
            c->id = p->next_id++;
            p->by_id[c->id] = c;
          }
          p->by_fd[cfd] = c;
          bool paused;
          {
            std::lock_guard<std::mutex> lk(p->mu);
            paused = p->paused;
          }
          epoll_event ev{};
          ev.events = paused ? 0u : EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(p->epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      if (fd == p->evfd) {
        uint64_t junk;
        while (read(p->evfd, &junk, 8) == 8) {
        }
        // workers drained the inbox below the low-water mark: resume reads
        bool unpause = false;
        {
          std::lock_guard<std::mutex> lk(p->mu);
          if (p->paused && p->inbox.size() <= kInboxLowFrames &&
              p->inbox_bytes < kInboxHighBytes) {
            p->paused = false;
            unpause = true;
          }
        }
        if (unpause) apply_pause(p, false);
        // senders queued output: pick up every dirty connection
        std::vector<Conn*> todo;
        {
          std::lock_guard<std::mutex> lk(p->mu);
          for (uint64_t id : p->dirty) {
            auto it = p->by_id.find(id);
            if (it != p->by_id.end()) todo.push_back(it->second);
          }
          p->dirty.clear();
        }
        for (Conn* c : todo)
          if (!flush_out(p, c)) close_conn(p, c);
        continue;
      }
      auto it = p->by_fd.find(fd);
      if (it == p->by_fd.end()) continue;
      Conn* c = it->second;
      bool ok = true;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) ok = false;
      if (ok && (evs[i].events & EPOLLIN)) ok = pump_read(p, c);
      if (ok && (evs[i].events & EPOLLOUT)) ok = flush_out(p, c);
      if (!ok) close_conn(p, c);
    }
  }
  // teardown ORDER: unpublish every Conn from by_id UNDER mu first, so a
  // concurrent lah_pump_send can never find a Conn* we are about to free
  // (it either mutated the conn while we waited for mu — harmless — or
  // finds nothing); only then is it safe to delete.
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->by_id.clear();
    p->dirty.clear();
    for (Frame& f : p->inbox) free(f.data);
    p->inbox.clear();
  }
  for (auto& [fd, c] : p->by_fd) {
    close(fd);
    delete c;
  }
  p->by_fd.clear();
  p->cv.notify_all();
}

}  // namespace

extern "C" {

void* lah_pump_create(const char* host, int port, int* out_port) {
  Pump* p = new Pump();
  p->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (p->listen_fd < 0) {
    delete p;
    return nullptr;
  }
  int one = 1;
  setsockopt(p->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr =
      (host && *host) ? inet_addr(host) : htonl(INADDR_ANY);
  if (bind(p->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(p->listen_fd, kBacklog) < 0) {
    close(p->listen_fd);
    delete p;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(p->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  if (out_port) *out_port = ntohs(addr.sin_port);
  set_nonblock(p->listen_fd);

  p->epfd = epoll_create1(0);
  p->evfd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = p->listen_fd;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->listen_fd, &ev);
  ev.data.fd = p->evfd;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->evfd, &ev);
  p->thr = std::thread(pump_loop, p);
  return p;
}

int lah_pump_next(void* h, int timeout_ms, uint64_t* conn, uint8_t** buf,
                  uint64_t* len) {
  Pump* p = static_cast<Pump*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  if (!p->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [&] { return p->stopping || !p->inbox.empty(); }))
    return 0;
  if (p->inbox.empty()) return -1;  // stopping
  Frame f = p->inbox.front();
  p->inbox.pop_front();
  p->inbox_bytes -= f.len;
  bool wake = p->paused && p->inbox.size() <= kInboxLowFrames &&
              p->inbox_bytes < kInboxHighBytes;
  lk.unlock();
  if (wake) {  // tell the pump thread to resume reading
    uint64_t one = 1;
    ssize_t ignored = write(p->evfd, &one, 8);
    (void)ignored;
  }
  *conn = f.conn;
  *buf = f.data;
  *len = f.len;
  return 1;
}

int lah_pump_send(void* h, uint64_t conn, const uint8_t* buf, uint64_t len) {
  Pump* p = static_cast<Pump*>(h);
  if (len > kMaxFrame) return -2;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->by_id.find(conn);
    if (it == p->by_id.end()) return -1;  // peer gone: reply dropped
    Conn* c = it->second;
    if (c->out_bytes + 4 + len > kConnOutMaxBytes)
      return -3;  // peer not reading replies; caller should treat as gone
    try {
      OutBuf ob;
      ob.data.resize(4 + len);
      uint32_t l32 = static_cast<uint32_t>(len);
      memcpy(ob.data.data(), &l32, 4);
      if (len) memcpy(ob.data.data() + 4, buf, len);
      c->out_bytes += ob.data.size();
      c->out.push_back(std::move(ob));
      p->dirty.insert(conn);
    } catch (const std::bad_alloc&) {
      return -3;  // OOM queueing the reply: treat the peer as gone;
                  // never let a C++ exception cross the ctypes boundary
    }
  }
  uint64_t one = 1;
  ssize_t ignored = write(p->evfd, &one, 8);
  (void)ignored;
  return 0;
}

void lah_pump_buffree(uint8_t* buf) { free(buf); }

void lah_pump_shutdown(void* h) {
  Pump* p = static_cast<Pump*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
  uint64_t one = 1;
  ssize_t ignored = write(p->evfd, &one, 8);
  (void)ignored;
  p->cv.notify_all();
  if (p->thr.joinable()) p->thr.join();
  close(p->listen_fd);
  close(p->epfd);
  close(p->evfd);
  delete p;
}

}  // extern "C"
