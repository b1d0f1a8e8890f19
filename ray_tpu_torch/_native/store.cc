// Native shared-memory object store core.
//
// Role-equivalent of the reference's Plasma store internals
// (src/ray/object_manager/plasma/store.h, object_store.h, eviction_policy.h,
// dlmalloc-over-mmap arenas): ONE file-backed mmap arena per node, a
// first-fit free-list allocator with coalescing, an object table with
// pin counts and primary-copy protection, and LRU eviction of sealed,
// unpinned objects when an allocation needs space.
//
// Exposed as a C API consumed via ctypes from the raylet process (the only
// writer of the table); workers mmap the same arena file and read/write at
// offsets handed to them over the raylet RPC — the zero-copy path the
// reference gets from fd-passing (plasma fling.cc).
//
// Build: g++ -O2 -shared -fPIC -o libray_tpu_store.so store.cc

#include <cstdint>
#include <cstring>
#include <ctime>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
  uint64_t offset = 0;
  uint64_t size = 0;       // padded (allocation) size
  uint64_t true_size = 0;  // caller-requested payload size
  bool sealed = false;
  bool primary = false;
  int32_t pins = 0;
  uint64_t last_access = 0;  // monotonically increasing logical clock
};

struct Arena {
  int fd = -1;
  uint8_t* base = nullptr;
  uint64_t capacity = 0;
  uint64_t used = 0;
  uint64_t clock = 0;
  std::string path;
  // free list keyed by offset -> length; invariant: no two adjacent blocks
  std::map<uint64_t, uint64_t> free_blocks;
  std::unordered_map<std::string, Entry> objects;
  std::mutex mu;
};

std::mutex g_mu;
std::vector<Arena*> g_arenas;

constexpr uint64_t kAlign = 64;  // cache-line align objects

uint64_t align_up(uint64_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

Arena* arena(int h) {
  std::lock_guard<std::mutex> l(g_mu);
  if (h < 0 || h >= static_cast<int>(g_arenas.size())) return nullptr;
  return g_arenas[h];
}

// first-fit allocation from the free list
int64_t alloc_block(Arena* a, uint64_t need) {
  for (auto it = a->free_blocks.begin(); it != a->free_blocks.end(); ++it) {
    if (it->second >= need) {
      uint64_t off = it->first;
      uint64_t len = it->second;
      a->free_blocks.erase(it);
      if (len > need) a->free_blocks.emplace(off + need, len - need);
      a->used += need;
      return static_cast<int64_t>(off);
    }
  }
  return -1;
}

// return a block, coalescing with neighbors
void free_block(Arena* a, uint64_t off, uint64_t len) {
  a->used -= len;
  auto next = a->free_blocks.lower_bound(off);
  // merge with previous block if adjacent
  if (next != a->free_blocks.begin()) {
    auto prev = std::prev(next);
    if (prev->first + prev->second == off) {
      off = prev->first;
      len += prev->second;
      a->free_blocks.erase(prev);
    }
  }
  // merge with next block if adjacent
  if (next != a->free_blocks.end() && off + len == next->first) {
    len += next->second;
    a->free_blocks.erase(next);
  }
  a->free_blocks.emplace(off, len);
}

// evict sealed, unpinned, non-primary objects in LRU order until a block of
// `need` bytes can be carved (reference: EvictionPolicy::ChooseObjectsToEvict)
bool evict_until(Arena* a, uint64_t need) {
  while (true) {
    // retry after every eviction: coalescing may have opened a large block
    for (auto& kv : a->free_blocks)
      if (kv.second >= need) return true;
    const std::string* victim = nullptr;
    uint64_t oldest = UINT64_MAX;
    for (auto& kv : a->objects) {
      const Entry& e = kv.second;
      if (e.sealed && e.pins == 0 && !e.primary && e.last_access < oldest) {
        oldest = e.last_access;
        victim = &kv.first;
      }
    }
    if (victim == nullptr) return false;
    auto it = a->objects.find(*victim);
    free_block(a, it->second.offset, it->second.size);
    a->objects.erase(it);
  }
}

}  // namespace

extern "C" {

// Create (or overwrite) the arena file and mmap it shared. Returns a handle
// >= 0, or -1 on failure.
int rt_store_open(const char* path, uint64_t capacity) {
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return -1;
  if (::ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    ::close(fd);
    return -1;
  }
  void* base =
      ::mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return -1;
  }
  Arena* a = new Arena();
  a->fd = fd;
  a->base = static_cast<uint8_t*>(base);
  a->capacity = capacity;
  a->path = path;
  a->free_blocks.emplace(0, capacity);
  std::lock_guard<std::mutex> l(g_mu);
  g_arenas.push_back(a);
  return static_cast<int>(g_arenas.size()) - 1;
}

void rt_store_close(int h) {
  Arena* a = arena(h);
  if (!a) return;
  ::munmap(a->base, a->capacity);
  ::close(a->fd);
  ::unlink(a->path.c_str());
  {
    std::lock_guard<std::mutex> l(g_mu);
    g_arenas[h] = nullptr;
  }
  delete a;
}

// Allocate space for an object. Returns the offset, or:
//   -1 out of memory (even after eviction), -2 already exists
int64_t rt_create(int h, const char* oid, uint64_t size) {
  Arena* a = arena(h);
  if (!a) return -1;
  std::lock_guard<std::mutex> l(a->mu);
  std::string key(oid);
  if (a->objects.count(key)) return -2;
  uint64_t need = align_up(size == 0 ? 1 : size);
  if (need > a->capacity) return -1;
  int64_t off = alloc_block(a, need);
  if (off < 0) {
    if (!evict_until(a, need)) return -1;
    off = alloc_block(a, need);
    if (off < 0) return -1;
  }
  Entry e;
  e.offset = static_cast<uint64_t>(off);
  e.size = need;
  e.true_size = size;
  e.last_access = ++a->clock;
  a->objects.emplace(std::move(key), e);
  return off;
}

int rt_seal(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return -1;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it == a->objects.end()) return -1;
  it->second.sealed = true;
  it->second.last_access = ++a->clock;
  return 0;
}

// Pin + locate. 0 ok, -1 missing, -2 not sealed yet.
int rt_get(int h, const char* oid, uint64_t* offset, uint64_t* size) {
  Arena* a = arena(h);
  if (!a) return -1;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it == a->objects.end()) return -1;
  if (!it->second.sealed) return -2;
  it->second.pins++;
  it->second.last_access = ++a->clock;
  *offset = it->second.offset;
  *size = it->second.size;
  return 0;
}

void rt_release(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it != a->objects.end() && it->second.pins > 0) it->second.pins--;
}

void rt_pin_primary(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it != a->objects.end()) it->second.primary = true;
}

int rt_contains(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return 0;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  return (it != a->objects.end() && it->second.sealed) ? 1 : 0;
}

int rt_free(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return -1;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it == a->objects.end()) return -1;
  free_block(a, it->second.offset, it->second.size);
  a->objects.erase(it);
  return 0;
}

// Free only when no reader holds a pin: the spill path must not reallocate
// a block a concurrent get just handed out. 0 freed, -1 missing, -2 pinned.
int rt_free_if_unpinned(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return -1;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it == a->objects.end()) return -1;
  if (it->second.pins > 0) return -2;
  free_block(a, it->second.offset, it->second.size);
  a->objects.erase(it);
  return 0;
}

uint64_t rt_used(int h) {
  Arena* a = arena(h);
  if (!a) return 0;
  std::lock_guard<std::mutex> l(a->mu);
  return a->used;
}

uint64_t rt_num_objects(int h) {
  Arena* a = arena(h);
  if (!a) return 0;
  std::lock_guard<std::mutex> l(a->mu);
  return a->objects.size();
}

// True payload size of a sealed object (0 if missing/unsealed).
uint64_t rt_true_size(int h, const char* oid) {
  Arena* a = arena(h);
  if (!a) return 0;
  std::lock_guard<std::mutex> l(a->mu);
  auto it = a->objects.find(oid);
  if (it == a->objects.end() || !it->second.sealed) return 0;
  return it->second.true_size;
}

// LRU spill victim: primary copies are exempt from eviction, so when the
// arena fills with live primaries the raylet spills them to disk instead
// (reference: LocalObjectManager::SpillObjects, local_object_manager.h:115).
// Writes the victim's id into out (NUL-terminated). Returns 1 if found.
int rt_lru_spillable(int h, char* out, int out_len) {
  Arena* a = arena(h);
  if (!a) return 0;
  std::lock_guard<std::mutex> l(a->mu);
  const std::string* victim = nullptr;
  uint64_t oldest = UINT64_MAX;
  for (auto& kv : a->objects) {
    const Entry& e = kv.second;
    if (e.sealed && e.pins == 0 && e.primary && e.last_access < oldest) {
      oldest = e.last_access;
      victim = &kv.first;
    }
  }
  if (victim == nullptr ||
      static_cast<int>(victim->size()) + 1 > out_len)
    return 0;
  std::memcpy(out, victim->c_str(), victim->size() + 1);
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Node-to-node object transfer plane.
//
// Role-equivalent of the reference's ObjectManager push/pull data path
// (src/ray/object_manager/object_manager.h:128, pull_manager.h:50,
// push_manager.h:28 — chunked gRPC there; a dedicated TCP stream here,
// which moves the raylet's bulk-byte path out of the Python RPC framing).
//
// Wire protocol (little-endian, same-arch cluster):
//   request : u32 magic "RTX1" | u16 token_len | token | u16 key_len | key
//   response: u8 status (0 ok, 1 not found, 2 auth) | u64 payload_size | raw
//
// The server pins the object (rt_get) for the whole send, so LRU eviction
// and free_if_unpinned cannot reallocate the block mid-stream. The client
// allocates straight into its local arena (rt_create) and streams into the
// mapping — no intermediate userland copies on either side beyond the
// kernel socket buffers.

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <thread>

namespace {

constexpr uint32_t kMagic = 0x31585452;  // "RTX1"

struct TransferServer {
  int listen_fd = -1;
  int arena_handle = -1;
  int port = 0;
  std::string token;
  std::thread accept_thread;
  std::atomic<bool> stopping{false};
  // live connection handlers: rt_transfer_stop must not return (and the
  // caller must not munmap the arena) while one is still streaming
  std::atomic<int> active{0};
};

std::mutex g_tmu;
std::vector<TransferServer*> g_tservers;

bool send_all(int fd, const void* buf, size_t len) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n <= 0) return false;
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t len) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) return false;
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

void set_io_timeout(int fd, int seconds) {
  struct timeval tv = {seconds, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

void handle_conn(int fd, TransferServer* s) {
  // accept_loop incremented `active` before spawning us; every exit path
  // must decrement it or rt_transfer_stop spins its full drain backoff
  struct ActiveGuard {
    TransferServer* srv;
    ~ActiveGuard() { srv->active.fetch_sub(1); }
  } guard{s};
  const int arena_handle = s->arena_handle;
  const std::string& token = s->token;
  set_io_timeout(fd, 60);
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  uint32_t magic = 0;
  uint16_t tlen = 0, klen = 0;
  std::string req_token, key;
  bool ok = recv_all(fd, &magic, 4) && magic == kMagic &&
            recv_all(fd, &tlen, 2) && tlen <= 512;
  if (ok) {
    req_token.resize(tlen);
    ok = (tlen == 0 || recv_all(fd, &req_token[0], tlen)) &&
         recv_all(fd, &klen, 2) && klen > 0 && klen <= 256;
  }
  if (ok) {
    key.resize(klen);
    ok = recv_all(fd, &key[0], klen);
  }
  if (!ok) {
    ::close(fd);
    return;
  }
  uint8_t status;
  uint64_t payload = 0;
  if (req_token != token) {
    status = 2;
    send_all(fd, &status, 1) && send_all(fd, &payload, 8);
    ::close(fd);
    return;
  }
  uint64_t off = 0, padded = 0;
  if (rt_get(arena_handle, key.c_str(), &off, &padded) != 0) {
    status = 1;
    send_all(fd, &status, 1) && send_all(fd, &payload, 8);
    ::close(fd);
    return;
  }
  // pinned from here: stream straight out of the arena mapping
  Arena* a = arena(arena_handle);
  payload = rt_true_size(arena_handle, key.c_str());
  status = 0;
  if (a != nullptr && send_all(fd, &status, 1) && send_all(fd, &payload, 8)) {
    send_all(fd, a->base + off, payload);
  }
  rt_release(arena_handle, key.c_str());
  ::close(fd);
}

void accept_loop(TransferServer* s) {
  while (!s->stopping.load()) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stopping.load()) return;
      // persistent failure (e.g. EMFILE under fd exhaustion): back off
      // instead of spinning a core
      ::usleep(10000);
      continue;
    }
    // count BEFORE spawning: stop must see the handler even if the thread
    // hasn't started running yet
    s->active.fetch_add(1);
    std::thread(handle_conn, fd, s).detach();
  }
}

}  // namespace

extern "C" {

// Start a transfer server for an open arena. port 0 = ephemeral. Binds the
// given host (the address the raylet itself serves on) — NOT INADDR_ANY:
// the payload plane must never be reachable on interfaces the control
// plane isn't. Null/empty/unparseable host falls back to loopback.
// Returns the bound port (> 0) or -1.
int rt_transfer_serve(int h, const char* token, int port, const char* host) {
  if (arena(h) == nullptr) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (host == nullptr || host[0] == '\0' ||
      ::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  TransferServer* s = new TransferServer();
  s->listen_fd = fd;
  s->arena_handle = h;
  s->port = ntohs(addr.sin_port);
  s->token = token ? token : "";
  s->accept_thread = std::thread(accept_loop, s);
  std::lock_guard<std::mutex> l(g_tmu);
  g_tservers.push_back(s);
  return s->port;
}

void rt_transfer_stop(int port) {
  TransferServer* victim = nullptr;
  {
    std::lock_guard<std::mutex> l(g_tmu);
    for (auto*& s : g_tservers) {
      if (s != nullptr && s->port == port) {
        victim = s;
        s = nullptr;
        break;
      }
    }
  }
  if (victim == nullptr) return;
  victim->stopping.store(true);
  ::shutdown(victim->listen_fd, SHUT_RDWR);
  ::close(victim->listen_fd);
  if (victim->accept_thread.joinable()) victim->accept_thread.join();
  // wait for in-flight handlers: the caller munmaps the arena right after
  // this returns. Handler IO timeouts cap each at ~60s; wait a bit longer,
  // then leak the server struct rather than free memory a wedged thread
  // still references.
  for (int i = 0; i < 6500 && victim->active.load() > 0; ++i) {
    ::usleep(10000);
  }
  if (victim->active.load() == 0) delete victim;
}

// Fetch an object from a peer's transfer server straight into the local
// arena. On success writes (offset, true_size) and returns 0. Errors:
//   -1 connect/protocol failure   -2 peer does not have the object
//   -3 local allocation failed    -4 object already present locally
//   -5 peer rejected the auth token
int rt_transfer_fetch(int h, const char* host, int port, const char* oid,
                      const char* token, uint64_t* out_off,
                      uint64_t* out_size) {
  Arena* a = arena(h);
  if (a == nullptr) return -1;
  struct addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%d", port);
  if (::getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr)
    return -1;
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    ::freeaddrinfo(res);
    return -1;
  }
  // bounded connect (10s): a stale cached port on a hung host must fail
  // fast so the caller can fall back to the RPC path, not block minutes
  // in the kernel's default connect timeout
  int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int crc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  if (crc != 0 && errno == EINPROGRESS) {
    struct pollfd pfd = {fd, POLLOUT, 0};
    int prc = ::poll(&pfd, 1, 10000);
    int soerr = 0;
    socklen_t slen = sizeof(soerr);
    if (prc <= 0 ||
        ::getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &slen) != 0 ||
        soerr != 0)
      crc = -1;
    else
      crc = 0;
  }
  ::fcntl(fd, F_SETFL, flags);
  ::freeaddrinfo(res);
  if (crc != 0) {
    ::close(fd);
    return -1;
  }
  set_io_timeout(fd, 60);
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::string tok = token ? token : "";
  std::string key = oid ? oid : "";
  uint16_t tlen = static_cast<uint16_t>(tok.size());
  uint16_t klen = static_cast<uint16_t>(key.size());
  bool ok = send_all(fd, &kMagic, 4) && send_all(fd, &tlen, 2) &&
            (tlen == 0 || send_all(fd, tok.data(), tlen)) &&
            send_all(fd, &klen, 2) && send_all(fd, key.data(), klen);
  uint8_t status = 0;
  uint64_t payload = 0;
  ok = ok && recv_all(fd, &status, 1) && recv_all(fd, &payload, 8);
  if (!ok) {
    ::close(fd);
    return -1;
  }
  if (status == 1) {
    ::close(fd);
    return -2;
  }
  if (status == 2) {
    ::close(fd);
    return -5;
  }
  int64_t off = rt_create(h, oid, payload);
  if (off == -2) {
    ::close(fd);
    return -4;
  }
  if (off < 0) {
    ::close(fd);
    return -3;
  }
  if (!recv_all(fd, a->base + off, payload)) {
    ::close(fd);
    rt_free(h, oid);
    return -1;
  }
  ::close(fd);
  *out_off = static_cast<uint64_t>(off);
  *out_size = payload;
  return 0;  // caller seals (it also maintains python-side mirrors/waiters)
}

}  // extern "C"
