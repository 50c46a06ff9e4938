// Native KV-store rendezvous/coordination wire.
//
// Role of the reference's HTTP rendezvous + gloo store pair
// (horovod/run/http/http_server.py:108-210 server side,
// horovod/common/gloo/http_store.{h,cc} client side): a tiny TCP
// key-value service the launcher hosts and every rank's background
// thread talks to for controller negotiation (request/response lists
// keyed by round) and bootstrap topology.  C++ for the same reason the
// reference's store client is C++: the background comm thread must not
// fight the Python GIL of the framework process.
//
// Protocol (all little-endian).  Connections are authenticated first
// with an HMAC-SHA256 challenge-response keyed by a per-job secret —
// the role of the reference's HMAC-signed service wire
// (horovod/run/common/util/secret.py:26, used by every launcher
// service message): a stray TCP client that does not hold the job
// secret cannot mutate (or read) negotiation state.
//
//   handshake: server -> "HVK2" + nonce[16]
//              client -> hmac_sha256(secret, nonce)[32]
//              server -> u8 ok (0 = authenticated; else closes)
//   request : u8 op | u32 klen | key bytes | u32 vlen | value bytes
//   response: u8 status | u32 vlen | value bytes
//   ops     : 1=SET 2=SET_ONCE 3=GET_WAIT(value=u32 timeout_ms)
//             4=TRY_GET 5=DELETE 6=PING
//   status  : 0=OK 1=NOT_FOUND/TIMEOUT 2=EXISTS 3=BAD_REQUEST
//
// An empty server secret disables verification (single-user unit-test
// mode); the launcher always generates one per job.
//
// Built at first use by horovod_tpu_torch/_build.py (load_host_library):
// g++ -O2 -fPIC -std=c++17 -pthread -shared -o libhvdtorchkv_<hash>.so kvstore.cc

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t OP_SET = 1, OP_SET_ONCE = 2, OP_GET_WAIT = 3,
                  OP_TRY_GET = 4, OP_DELETE = 5, OP_PING = 6;
constexpr uint8_t ST_OK = 0, ST_NOT_FOUND = 1, ST_EXISTS = 2, ST_BAD = 3;

// ---- SHA-256 + HMAC (FIPS 180-4 / RFC 2104; no external deps) ----

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_n = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    std::memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
        0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
        0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
        0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
        0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
        0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
        0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
        0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
        0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
        0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
        0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                    (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                    (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const void* data, size_t n) {
    const uint8_t* p = static_cast<const uint8_t*>(data);
    len += n;
    while (n > 0) {
      size_t take = 64 - buf_n < n ? 64 - buf_n : n;
      std::memcpy(buf + buf_n, p, take);
      buf_n += take; p += take; n -= take;
      if (buf_n == 64) { block(buf); buf_n = 0; }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buf_n != 56) update(&zero, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; ++i) lb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lb, 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void hmac_sha256(const std::string& key, const uint8_t* msg, size_t msg_n,
                 uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (key.size() > 64) {
    Sha256 kh;
    kh.update(key.data(), key.size());
    kh.final(k);
  } else {
    std::memcpy(k, key.data(), key.size());
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; ++i) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 si;
  si.update(ipad, 64);
  si.update(msg, msg_n);
  si.final(inner);
  Sha256 so;
  so.update(opad, 64);
  so.update(inner, 32);
  so.final(out);
}

bool ct_equal(const uint8_t* a, const uint8_t* b, size_t n) {
  uint8_t d = 0;
  for (size_t i = 0; i < n; ++i) d |= a[i] ^ b[i];
  return d == 0;
}

void fill_nonce(uint8_t* out, size_t n) {
  FILE* f = std::fopen("/dev/urandom", "rb");
  if (f) {
    size_t got = std::fread(out, 1, n, f);
    std::fclose(f);
    if (got == n) return;
  }
  // fallback: std::random_device (nonce only needs uniqueness)
  std::random_device rd;
  for (size_t i = 0; i < n; ++i) out[i] = uint8_t(rd());
}

bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> data;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::vector<std::thread> workers;
  std::vector<int> conn_fds;  // live connections, for teardown
  std::mutex workers_mu;
  Store store;
  std::string secret;  // empty = auth disabled (unit-test mode)
  // Load gauges (hvd_kv_server_connections / _pending_gets): at
  // simulated world >= 256 the rendezvous server is the scaling
  // bottleneck, and these are how an operator sees it loaded rather
  // than inferring from client retry storms.
  std::atomic<long> pending_gets{0};
};

// Challenge-response: no op is served until the client proves it holds
// the job secret.  Returns false (caller closes fd) on auth failure.
bool server_handshake(Server* s, int fd) {
  uint8_t challenge[20];  // "HVK2" + 16-byte nonce
  std::memcpy(challenge, "HVK2", 4);
  fill_nonce(challenge + 4, 16);
  if (!write_exact(fd, challenge, sizeof(challenge))) return false;
  uint8_t mac[32];
  if (!read_exact(fd, mac, sizeof(mac))) return false;
  uint8_t ok = 0;
  if (!s->secret.empty()) {
    uint8_t expect[32];
    hmac_sha256(s->secret, challenge + 4, 16, expect);
    if (!ct_equal(mac, expect, 32)) return false;  // close, no hint
  }
  return write_exact(fd, &ok, 1);
}

void handle_conn(Server* s, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (!server_handshake(s, fd)) {
    ::close(fd);
    return;
  }
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_exact(fd, &op, 1) || !read_exact(fd, &klen, 4)) break;
    if (klen > (1u << 20)) break;
    std::string key(klen, '\0');
    if (klen && !read_exact(fd, key.data(), klen)) break;
    if (!read_exact(fd, &vlen, 4)) break;
    if (vlen > (1u << 28)) break;
    std::string val(vlen, '\0');
    if (vlen && !read_exact(fd, val.data(), vlen)) break;

    uint8_t status = ST_BAD;
    std::string out;
    switch (op) {
      case OP_SET: {
        std::lock_guard<std::mutex> lk(s->store.mu);
        s->store.data[key] = std::move(val);
        s->store.cv.notify_all();
        status = ST_OK;
        break;
      }
      case OP_SET_ONCE: {
        std::lock_guard<std::mutex> lk(s->store.mu);
        auto it = s->store.data.find(key);
        if (it != s->store.data.end()) {
          status = ST_EXISTS;
        } else {
          s->store.data[key] = std::move(val);
          s->store.cv.notify_all();
          status = ST_OK;
        }
        break;
      }
      case OP_GET_WAIT: {
        uint32_t timeout_ms = 0;
        if (vlen == 4) std::memcpy(&timeout_ms, val.data(), 4);
        auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(timeout_ms);
        std::unique_lock<std::mutex> lk(s->store.mu);
        s->pending_gets.fetch_add(1, std::memory_order_relaxed);
        bool found = s->store.cv.wait_until(lk, deadline, [&] {
          return s->stopping.load() ||
                 s->store.data.find(key) != s->store.data.end();
        });
        s->pending_gets.fetch_sub(1, std::memory_order_relaxed);
        auto it = s->store.data.find(key);
        if (found && it != s->store.data.end()) {
          out = it->second;
          status = ST_OK;
        } else {
          status = ST_NOT_FOUND;
        }
        break;
      }
      case OP_TRY_GET: {
        std::lock_guard<std::mutex> lk(s->store.mu);
        auto it = s->store.data.find(key);
        if (it != s->store.data.end()) {
          out = it->second;
          status = ST_OK;
        } else {
          status = ST_NOT_FOUND;
        }
        break;
      }
      case OP_DELETE: {
        std::lock_guard<std::mutex> lk(s->store.mu);
        s->store.data.erase(key);
        status = ST_OK;
        break;
      }
      case OP_PING:
        status = ST_OK;
        break;
      default:
        status = ST_BAD;
    }
    uint32_t olen = static_cast<uint32_t>(out.size());
    if (!write_exact(fd, &status, 1) || !write_exact(fd, &olen, 4)) break;
    if (olen && !write_exact(fd, out.data(), olen)) break;
  }
  {
    // Deregister before close: once closed, the fd number can be
    // reused, and a later stop() must not shut down a stranger.
    std::lock_guard<std::mutex> lk(s->workers_mu);
    auto it = std::find(s->conn_fds.begin(), s->conn_fds.end(), fd);
    if (it != s->conn_fds.end()) s->conn_fds.erase(it);
  }
  ::close(fd);
}

void accept_loop(Server* s) {
  for (;;) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stopping.load()) return;
      continue;
    }
    std::lock_guard<std::mutex> lk(s->workers_mu);
    s->conn_fds.push_back(fd);
    s->workers.emplace_back(handle_conn, s, fd);
  }
}

struct Client {
  int fd = -1;
};

// Bounded exponential backoff with ±25% jitter for connect retries:
// 50ms, 100ms, ... capped at 2s.  Jitter decorrelates a whole job's
// ranks hammering a recovering rendezvous server in lockstep.
int backoff_ms(int attempt) {
  thread_local std::mt19937 rng{std::random_device{}()};
  long base = 50L << (attempt < 6 ? attempt : 6);
  if (base > 2000) base = 2000;
  std::uniform_int_distribution<long> jitter(-base / 4, base / 4);
  return static_cast<int>(base + jitter(rng));
}

// Client half of the handshake.
enum HandshakeResult { HS_OK = 0, HS_TRANSIENT = 1, HS_DENIED = 2 };

HandshakeResult client_handshake(int fd, const std::string& secret) {
  uint8_t challenge[20];
  // Failure to even receive the challenge is a wire problem (server
  // backlog teardown, RST), not an auth verdict — retryable.
  if (!read_exact(fd, challenge, sizeof(challenge))) return HS_TRANSIENT;
  if (std::memcmp(challenge, "HVK2", 4) != 0) return HS_DENIED;
  uint8_t mac[32];
  hmac_sha256(secret, challenge + 4, 16, mac);
  // After the MAC is sent, a close without the ok byte is the server
  // rejecting the proof — retrying with the same secret cannot help.
  if (!write_exact(fd, mac, sizeof(mac))) return HS_DENIED;
  uint8_t ok;
  if (!read_exact(fd, &ok, 1) || ok != 0) return HS_DENIED;
  return HS_OK;
}

bool client_roundtrip(Client* c, uint8_t op, const std::string& key,
                      const std::string& val, uint8_t* status,
                      std::string* out) {
  uint32_t klen = static_cast<uint32_t>(key.size());
  uint32_t vlen = static_cast<uint32_t>(val.size());
  if (!write_exact(c->fd, &op, 1) || !write_exact(c->fd, &klen, 4) ||
      (klen && !write_exact(c->fd, key.data(), klen)) ||
      !write_exact(c->fd, &vlen, 4) ||
      (vlen && !write_exact(c->fd, val.data(), vlen)))
    return false;
  uint32_t olen;
  if (!read_exact(c->fd, status, 1) || !read_exact(c->fd, &olen, 4))
    return false;
  out->assign(olen, '\0');
  if (olen && !read_exact(c->fd, out->data(), olen)) return false;
  return true;
}

}  // namespace

extern "C" {

// ---- server ----

void* hvd_kv_server_start(int port, const char* secret, int secret_len) {
  auto* s = new Server();
  if (secret && secret_len > 0) s->secret.assign(secret, secret_len);
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  // Backlog sized for a whole simulated/elastic fleet connecting at
  // once: at world >= 256 the old 128 silently refused the burst and
  // surfaced only as an unexplained client retry storm.  The kernel
  // clamps to net.core.somaxconn, so oversizing is free.
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(s->listen_fd, 4096) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread(accept_loop, s);
  return s;
}

int hvd_kv_server_port(void* handle) {
  return handle ? static_cast<Server*>(handle)->port : -1;
}

long hvd_kv_server_connections(void* handle) {
  if (!handle) return -1;
  auto* s = static_cast<Server*>(handle);
  std::lock_guard<std::mutex> lk(s->workers_mu);
  return static_cast<long>(s->conn_fds.size());
}

long hvd_kv_server_pending_gets(void* handle) {
  if (!handle) return -1;
  return static_cast<Server*>(handle)->pending_gets.load(
      std::memory_order_relaxed);
}

void hvd_kv_server_stop(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Server*>(handle);
  s->stopping.store(true);
  {
    std::lock_guard<std::mutex> lk(s->store.mu);
    s->store.cv.notify_all();
  }
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // Sever every live connection and JOIN the workers (the old detach
  // left them touching the Server after delete — a use-after-free —
  // and kept clients of a "stopped" server happily served).  shutdown
  // wakes blocked recv()s; the stopping flag + notify above wakes
  // GET_WAITers; each worker then exits its loop promptly.
  std::vector<std::thread> workers;
  {
    std::lock_guard<std::mutex> lk(s->workers_mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
    workers.swap(s->workers);
  }
  for (auto& t : workers)
    if (t.joinable()) t.join();
  delete s;
}

// ---- client ----

void* hvd_kv_connect(const char* host, int port, int timeout_ms,
                     const char* secret, int secret_len) {
  auto* c = new Client();
  std::string sec;
  if (secret && secret_len > 0) sec.assign(secret, secret_len);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  int attempt = 0;
  for (;;) {
    c->fd = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(c->fd);
      delete c;
      return nullptr;
    }
    if (::connect(c->fd, reinterpret_cast<sockaddr*>(&addr),
                  sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(c->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      HandshakeResult hs = client_handshake(c->fd, sec);
      if (hs == HS_OK) return c;
      ::close(c->fd);
      if (hs == HS_DENIED) {
        // wrong secret: the server closes without a hint; retrying
        // cannot help, so fail the connect immediately
        delete c;
        return nullptr;
      }
      // HS_TRANSIENT: fall through to the retry/backoff below
      if (std::chrono::steady_clock::now() > deadline) {
        delete c;
        return nullptr;
      }
      std::this_thread::sleep_for(
          std::chrono::milliseconds(backoff_ms(attempt++)));
      continue;
    }
    ::close(c->fd);
    if (std::chrono::steady_clock::now() > deadline) {
      delete c;
      return nullptr;
    }
    std::this_thread::sleep_for(
        std::chrono::milliseconds(backoff_ms(attempt++)));
  }
}

void hvd_kv_close(void* handle) {
  if (!handle) return;
  auto* c = static_cast<Client*>(handle);
  ::close(c->fd);
  delete c;
}

// returns status (ST_*), or -1 on wire error
int hvd_kv_set(void* handle, const char* key, const char* val, int vlen,
               int once) {
  auto* c = static_cast<Client*>(handle);
  uint8_t status;
  std::string out;
  if (!client_roundtrip(c, once ? OP_SET_ONCE : OP_SET, key,
                        std::string(val, vlen), &status, &out))
    return -1;
  return status;
}

// out buffer malloc'd; caller frees via hvd_kv_free.  returns status.
int hvd_kv_get(void* handle, const char* key, int timeout_ms, int try_only,
               char** out_buf, int* out_len) {
  auto* c = static_cast<Client*>(handle);
  uint8_t status;
  std::string out;
  std::string arg;
  uint8_t op = OP_TRY_GET;
  if (!try_only) {
    op = OP_GET_WAIT;
    uint32_t t = static_cast<uint32_t>(timeout_ms);
    arg.assign(reinterpret_cast<char*>(&t), 4);
  }
  if (!client_roundtrip(c, op, key, arg, &status, &out)) return -1;
  if (status == ST_OK) {
    *out_len = static_cast<int>(out.size());
    *out_buf = static_cast<char*>(std::malloc(out.size() + 1));
    std::memcpy(*out_buf, out.data(), out.size());
    (*out_buf)[out.size()] = '\0';
  } else {
    *out_buf = nullptr;
    *out_len = 0;
  }
  return status;
}

int hvd_kv_delete(void* handle, const char* key) {
  auto* c = static_cast<Client*>(handle);
  uint8_t status;
  std::string out;
  if (!client_roundtrip(c, OP_DELETE, key, "", &status, &out)) return -1;
  return status;
}

int hvd_kv_ping(void* handle) {
  auto* c = static_cast<Client*>(handle);
  uint8_t status;
  std::string out;
  if (!client_roundtrip(c, OP_PING, std::string(), std::string(), &status,
                        &out))
    return -1;
  return status;
}

void hvd_kv_free(char* buf) { std::free(buf); }

}  // extern "C"
