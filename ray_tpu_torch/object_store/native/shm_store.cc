// Shared-memory object store — the plasma equivalent, redesigned.
//
// Reference: src/ray/object_manager/plasma/ (object_store.cc,
// plasma_allocator.cc, eviction_policy.cc): a store daemon owns an mmap
// arena and clients speak a unix-socket protocol to receive fds.
//
// TPU-era redesign: there is no store daemon and no socket protocol.
// One POSIX shm segment holds a fixed-layout header (robust process-shared
// mutex + open-addressing object table + free-span allocator state) and the
// data arena; every process on the node maps the same segment and operates
// on it directly under the robust lock. A crashed holder cannot wedge the
// store: robust-mutex EOWNERDEAD recovery marks the state consistent.
// Reads are zero-copy (Python maps the same pages; Get returns a pointer
// into this process's mapping, pinned by a refcount until Release).
//
// Eviction: LRU over sealed refcount-0 objects, triggered on allocation
// failure, exactly the role of plasma's eviction_policy.cc.
//
// Build: g++ -O2 -fPIC -shared -o libshm_store.so shm_store.cc -lpthread -lrt

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545053544f5246ULL;  // "RTPSTORF" (layout v2)
constexpr uint32_t kIdBytes = 32;
constexpr uint32_t kTableSize = 1 << 16;       // open addressing, power of 2
constexpr uint32_t kMaxFreeSpans = 8192;

struct Entry {
  uint8_t used;            // 0 empty, 1 live, 2 tombstone
  uint8_t sealed;
  uint8_t pending_delete;  // deleted while pinned: reap on last release
  uint8_t id_len;
  uint8_t id[kIdBytes];
  uint32_t refcount;
  uint64_t offset;
  uint64_t size;        // logical payload bytes (may be 0)
  uint64_t alloc;       // arena bytes actually reserved (>= 1)
  uint64_t lru_tick;
};

struct FreeSpan {
  uint64_t offset;
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;       // data arena bytes
  uint64_t used_bytes;
  uint64_t lru_clock;
  uint64_t num_objects;
  pthread_mutex_t lock;
  uint32_t num_free_spans;
  FreeSpan free_spans[kMaxFreeSpans];
  Entry table[kTableSize];
  // data arena follows, 64-byte aligned
};

constexpr uint64_t kDataOffset = (sizeof(Header) + 63) & ~uint64_t(63);

struct Store {
  Header* hdr;
  uint8_t* base;     // mapping base
  uint64_t map_size;
  // Per-process policy: when 0, a full arena fails the allocation with
  // -ENOSPC instead of silently dropping LRU objects — the caller then
  // SPILLS victims to disk first (object_store/shm.py spill-on-evict),
  // so primary copies are demoted, never lost.  Mirrors plasma's
  // spill-before-evict contract (reference plasma_store_runner +
  // local_object_manager.cc SpillObjects).
  int autoevict = 1;
};

constexpr int kMaxStores = 64;
Store g_stores[kMaxStores];
int g_num_stores = 0;

// A slot whose hdr is null was closed (rts_close) and may be reused by
// the next rts_create; every accessor must reject it.
bool ValidHandle(int h) {
  return h >= 0 && h < g_num_stores && g_stores[h].hdr != nullptr;
}

uint64_t HashId(const uint8_t* id, uint8_t len) {
  // FNV-1a
  uint64_t h = 1469598103934665603ULL;
  for (uint8_t i = 0; i < len; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// Robust lock acquire: recover from a holder that died mid-critical-section.
int LockHeld(Header* hdr) {
  int rc = pthread_mutex_lock(&hdr->lock);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&hdr->lock);
    return 0;
  }
  return rc;
}

// Entries in pending_delete state are "zombies": logically deleted
// (invisible to get/contains/duplicate checks, their id immediately
// reusable by a fresh put) but their span stays allocated until the
// last pin releases. Probing continues past them, so chains stay valid.
Entry* FindEntry(Header* hdr, const uint8_t* id, uint8_t id_len) {
  uint64_t h = HashId(id, id_len);
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    Entry& e = hdr->table[(h + probe) & (kTableSize - 1)];
    if (e.used == 0) return nullptr;
    if (e.used == 1 && !e.pending_delete && e.id_len == id_len &&
        memcmp(e.id, id, id_len) == 0)
      return &e;
  }
  return nullptr;
}

Entry* FindSlot(Header* hdr, const uint8_t* id, uint8_t id_len) {
  uint64_t h = HashId(id, id_len);
  Entry* tomb = nullptr;
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    Entry& e = hdr->table[(h + probe) & (kTableSize - 1)];
    if (e.used == 0) return tomb ? tomb : &e;
    if (e.used == 2 && !tomb) tomb = &e;
    if (e.used == 1 && !e.pending_delete && e.id_len == id_len &&
        memcmp(e.id, id, id_len) == 0)
      return nullptr;  // exists
  }
  return tomb;
}

// ---- allocator: sorted free-span list, first fit, coalescing free ----

uint64_t AllocSpan(Header* hdr, uint64_t size) {
  for (uint32_t i = 0; i < hdr->num_free_spans; i++) {
    FreeSpan& s = hdr->free_spans[i];
    if (s.size >= size) {
      uint64_t off = s.offset;
      s.offset += size;
      s.size -= size;
      if (s.size == 0) {
        memmove(&hdr->free_spans[i], &hdr->free_spans[i + 1],
                (hdr->num_free_spans - i - 1) * sizeof(FreeSpan));
        hdr->num_free_spans--;
      }
      return off;
    }
  }
  return UINT64_MAX;
}

void FreeSpanInsert(Header* hdr, uint64_t offset, uint64_t size) {
  // insert sorted by offset, coalesce with neighbors
  uint32_t i = 0;
  while (i < hdr->num_free_spans && hdr->free_spans[i].offset < offset) i++;
  // coalesce left
  if (i > 0 && hdr->free_spans[i - 1].offset + hdr->free_spans[i - 1].size ==
                   offset) {
    hdr->free_spans[i - 1].size += size;
    // maybe also right
    if (i < hdr->num_free_spans &&
        hdr->free_spans[i - 1].offset + hdr->free_spans[i - 1].size ==
            hdr->free_spans[i].offset) {
      hdr->free_spans[i - 1].size += hdr->free_spans[i].size;
      memmove(&hdr->free_spans[i], &hdr->free_spans[i + 1],
              (hdr->num_free_spans - i - 1) * sizeof(FreeSpan));
      hdr->num_free_spans--;
    }
    return;
  }
  // coalesce right
  if (i < hdr->num_free_spans &&
      offset + size == hdr->free_spans[i].offset) {
    hdr->free_spans[i].offset = offset;
    hdr->free_spans[i].size += size;
    return;
  }
  if (hdr->num_free_spans >= kMaxFreeSpans) return;  // leak span (rare)
  memmove(&hdr->free_spans[i + 1], &hdr->free_spans[i],
          (hdr->num_free_spans - i) * sizeof(FreeSpan));
  hdr->free_spans[i] = {offset, size};
  hdr->num_free_spans++;
}

void DeleteEntryLocked(Header* hdr, Entry* e) {
  FreeSpanInsert(hdr, e->offset, e->alloc);
  hdr->used_bytes -= e->alloc;
  hdr->num_objects--;
  e->used = 2;  // tombstone keeps probe chains intact
  e->refcount = 0;
  e->sealed = 0;
  e->pending_delete = 0;
}

// Evict LRU sealed refcount-0 objects until at least `need` bytes could be
// allocated (best effort). Returns 1 if anything was evicted.
int EvictLocked(Header* hdr, uint64_t need) {
  int evicted_any = 0;
  while (true) {
    // would an allocation of `need` succeed now?
    for (uint32_t i = 0; i < hdr->num_free_spans; i++)
      if (hdr->free_spans[i].size >= need) return evicted_any;
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < kTableSize; i++) {
      Entry& e = hdr->table[i];
      if (e.used == 1 && e.sealed && e.refcount == 0 &&
          (!victim || e.lru_tick < victim->lru_tick))
        victim = &e;
    }
    if (!victim) return evicted_any;
    DeleteEntryLocked(hdr, victim);
    evicted_any = 1;
  }
}

}  // namespace

extern "C" {

// Create (or open existing) store; returns handle >= 0, or -errno.
// Handle slots freed by rts_close are reused — long-lived processes
// that repeatedly open/close arenas (test harnesses, notebooks) must
// not exhaust the fixed table.
int rts_create(const char* name, uint64_t capacity) {
  int slot = -1;
  for (int i = 0; i < g_num_stores; i++) {
    if (g_stores[i].hdr == nullptr) {
      slot = i;
      break;
    }
  }
  if (slot < 0 && g_num_stores >= kMaxStores) return -ENOMEM;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0666);
  bool creator = fd >= 0;
  if (!creator) {
    if (errno != EEXIST) return -errno;
    fd = shm_open(name, O_RDWR, 0666);
    if (fd < 0) return -errno;
    // wait for creator to size + init it; bail if it never does
    // (creator crashed between shm_open and magic write)
    struct stat st;
    bool initialized = false;
    for (int spin = 0; spin < 10000; spin++) {
      if (fstat(fd, &st) == 0 && (uint64_t)st.st_size >= sizeof(Header)) {
        Header probe;
        if (pread(fd, &probe, sizeof(uint64_t), 0) == sizeof(uint64_t) &&
            probe.magic == kMagic) {
          initialized = true;
          break;
        }
      }
      usleep(1000);
    }
    if (!initialized) {
      close(fd);
      return -EAGAIN;
    }
  }
  uint64_t map_size = kDataOffset + capacity;
  if (creator && ftruncate(fd, map_size) != 0) {
    int err = errno;
    close(fd);
    shm_unlink(name);
    return -err;
  }
  if (!creator) {
    struct stat st;
    fstat(fd, &st);
    map_size = st.st_size;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -errno;
  Header* hdr = (Header*)mem;
  if (creator) {
    memset(hdr, 0, sizeof(Header));
    hdr->capacity = map_size - kDataOffset;
    hdr->num_free_spans = 1;
    hdr->free_spans[0] = {0, hdr->capacity};
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->lock, &attr);
    pthread_mutexattr_destroy(&attr);
    __sync_synchronize();
    hdr->magic = kMagic;
  }
  int h = slot >= 0 ? slot : g_num_stores++;
  g_stores[h] = {hdr, (uint8_t*)mem + kDataOffset, map_size};
  return h;
}

int rts_open(const char* name) {
  // open-only: fail if the segment doesn't exist
  int fd = shm_open(name, O_RDWR, 0666);
  if (fd < 0) return -errno;
  close(fd);
  return rts_create(name, 0);
}

// Unmap this process's view of the store and free the handle slot for
// reuse. The shared segment itself (and other processes' mappings) are
// untouched — pair with rts_unlink to destroy the segment. Any pins
// this process still holds are abandoned; callers release them first.
int rts_close(int h) {
  if (!ValidHandle(h)) return -EINVAL;
  Store& st = g_stores[h];
  munmap((void*)st.hdr, st.map_size);
  st.hdr = nullptr;
  st.base = nullptr;
  st.map_size = 0;
  st.autoevict = 1;
  return 0;
}

// 0 ok; -EEXIST; -ENOSPC (even after eviction); -EINVAL.
int rts_put(int h, const uint8_t* id, uint32_t id_len,
            const uint8_t* data, uint64_t size) {
  if (!ValidHandle(h) || id_len > kIdBytes) return -EINVAL;
  Store& st = g_stores[h];
  Header* hdr = st.hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  if (FindEntry(hdr, id, (uint8_t)id_len)) {
    pthread_mutex_unlock(&hdr->lock);
    return -EEXIST;
  }
  uint64_t sz = size ? size : 1;  // zero-size objects occupy 1 byte
  uint64_t off = AllocSpan(hdr, sz);
  if (off == UINT64_MAX && st.autoevict) {
    EvictLocked(hdr, sz);
    off = AllocSpan(hdr, sz);
  }
  if (off == UINT64_MAX) {
    pthread_mutex_unlock(&hdr->lock);
    return -ENOSPC;
  }
  Entry* e = FindSlot(hdr, id, (uint8_t)id_len);
  if (!e) {  // table full or duplicate
    FreeSpanInsert(hdr, off, sz);
    pthread_mutex_unlock(&hdr->lock);
    return -ENOSPC;
  }
  memcpy(st.base + off, data, size);
  e->used = 1;
  e->sealed = 1;
  e->pending_delete = 0;
  e->id_len = (uint8_t)id_len;
  memcpy(e->id, id, id_len);
  e->refcount = 0;
  e->offset = off;
  e->size = size;
  e->alloc = sz;
  e->lru_tick = ++hdr->lru_clock;
  hdr->used_bytes += sz;
  hdr->num_objects++;
  pthread_mutex_unlock(&hdr->lock);
  return 0;
}

// Two-phase create/seal (plasma CreateObject/Seal): the writer serializes
// DIRECTLY into the arena — no staging buffer, no extra memcpy. The entry
// is invisible to readers (and to eviction) until rts_seal; rts_abort
// frees the span of a failed write.
uint8_t* rts_create_unsealed(int h, const uint8_t* id, uint32_t id_len,
                             uint64_t size) {
  if (!ValidHandle(h) || id_len > kIdBytes) return nullptr;
  Store& st = g_stores[h];
  Header* hdr = st.hdr;
  if (LockHeld(hdr) != 0) return nullptr;
  if (FindEntry(hdr, id, (uint8_t)id_len)) {
    pthread_mutex_unlock(&hdr->lock);
    return nullptr;  // EEXIST
  }
  uint64_t sz = size ? size : 1;
  uint64_t off = AllocSpan(hdr, sz);
  if (off == UINT64_MAX && st.autoevict) {
    EvictLocked(hdr, sz);
    off = AllocSpan(hdr, sz);
  }
  if (off == UINT64_MAX) {
    pthread_mutex_unlock(&hdr->lock);
    return nullptr;  // ENOSPC
  }
  Entry* e = FindSlot(hdr, id, (uint8_t)id_len);
  if (!e) {
    FreeSpanInsert(hdr, off, sz);
    pthread_mutex_unlock(&hdr->lock);
    return nullptr;
  }
  e->used = 1;
  e->sealed = 0;  // invisible to rts_get and EvictLocked until sealed
  e->pending_delete = 0;
  e->id_len = (uint8_t)id_len;
  memcpy(e->id, id, id_len);
  e->refcount = 0;
  e->offset = off;
  e->size = size;
  e->alloc = sz;
  e->lru_tick = ++hdr->lru_clock;
  hdr->used_bytes += sz;
  hdr->num_objects++;
  uint8_t* ptr = st.base + off;
  pthread_mutex_unlock(&hdr->lock);
  return ptr;
}

int rts_seal(int h, const uint8_t* id, uint32_t id_len) {
  if (!ValidHandle(h)) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  Entry* e = FindEntry(hdr, id, (uint8_t)id_len);
  if (!e) {
    pthread_mutex_unlock(&hdr->lock);
    return -ENOENT;
  }
  e->sealed = 1;
  e->lru_tick = ++hdr->lru_clock;
  pthread_mutex_unlock(&hdr->lock);
  return 0;
}

int rts_abort(int h, const uint8_t* id, uint32_t id_len) {
  if (!ValidHandle(h)) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  Entry* e = FindEntry(hdr, id, (uint8_t)id_len);
  if (!e || e->sealed) {
    pthread_mutex_unlock(&hdr->lock);
    return -ENOENT;
  }
  DeleteEntryLocked(hdr, e);
  pthread_mutex_unlock(&hdr->lock);
  return 0;
}

// Returns pointer into this process's mapping (pinned), or NULL.
const uint8_t* rts_get(int h, const uint8_t* id, uint32_t id_len,
                       uint64_t* size_out) {
  if (!ValidHandle(h) || id_len > kIdBytes) return nullptr;
  Store& st = g_stores[h];
  Header* hdr = st.hdr;
  if (LockHeld(hdr) != 0) return nullptr;
  Entry* e = FindEntry(hdr, id, (uint8_t)id_len);
  if (!e || !e->sealed) {
    pthread_mutex_unlock(&hdr->lock);
    return nullptr;
  }
  e->refcount++;
  e->lru_tick = ++hdr->lru_clock;
  *size_out = e->size;
  const uint8_t* ptr = st.base + e->offset;
  pthread_mutex_unlock(&hdr->lock);
  return ptr;
}

int rts_release(int h, const uint8_t* id, uint32_t id_len) {
  if (!ValidHandle(h)) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  Entry* e = FindEntry(hdr, id, (uint8_t)id_len);
  if (!e || e->refcount == 0) {
    // The pin may belong to an entry deleted while pinned (now a
    // zombie that id lookups skip — possibly shadowed by a fresh live
    // entry under the same id). Zombies keep their id, so they sit on
    // the id's probe chain: walk it instead of scanning the table. If
    // the same id cycled through delete-while-pinned more than once
    // the counts alias across its zombies; each zombie is still reaped
    // exactly when its own count reaches zero.
    e = nullptr;
    uint64_t hh = HashId(id, (uint8_t)id_len);
    for (uint32_t probe = 0; probe < kTableSize; probe++) {
      Entry& z = hdr->table[(hh + probe) & (kTableSize - 1)];
      if (z.used == 0) break;
      if (z.used == 1 && z.pending_delete && z.refcount > 0 &&
          z.id_len == (uint8_t)id_len && memcmp(z.id, id, id_len) == 0) {
        e = &z;
        break;
      }
    }
  }
  if (e && e->refcount > 0) {
    e->refcount--;
    if (e->refcount == 0 && e->pending_delete) DeleteEntryLocked(hdr, e);
  }
  pthread_mutex_unlock(&hdr->lock);
  return e ? 0 : -ENOENT;
}

// Exact-pin release by (id, mapped address). The address disambiguates
// which generation of the id the pin belongs to when the object was
// deleted and re-put while the reader held its view; the id makes the
// lookup a hash-chain probe rather than a table scan.
int rts_release_addr(int h, const uint8_t* id, uint32_t id_len,
                     const uint8_t* ptr) {
  if (!ValidHandle(h) || id_len > kIdBytes) return -EINVAL;
  Store& st = g_stores[h];
  Header* hdr = st.hdr;
  if (ptr < st.base) return -EINVAL;
  uint64_t offset = (uint64_t)(ptr - st.base);
  if (LockHeld(hdr) != 0) return -EINVAL;
  uint64_t hh = HashId(id, (uint8_t)id_len);
  for (uint32_t probe = 0; probe < kTableSize; probe++) {
    Entry& e = hdr->table[(hh + probe) & (kTableSize - 1)];
    if (e.used == 0) break;
    if (e.used == 1 && e.offset == offset && e.refcount > 0 &&
        e.id_len == (uint8_t)id_len && memcmp(e.id, id, id_len) == 0) {
      e.refcount--;
      if (e.refcount == 0 && e.pending_delete) DeleteEntryLocked(hdr, &e);
      pthread_mutex_unlock(&hdr->lock);
      return 0;
    }
  }
  pthread_mutex_unlock(&hdr->lock);
  return -ENOENT;
}

int rts_contains(int h, const uint8_t* id, uint32_t id_len) {
  if (!ValidHandle(h)) return 0;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return 0;
  int found = FindEntry(hdr, id, (uint8_t)id_len) != nullptr;
  pthread_mutex_unlock(&hdr->lock);
  return found;
}

int rts_delete(int h, const uint8_t* id, uint32_t id_len) {
  if (!ValidHandle(h)) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  Entry* e = FindEntry(hdr, id, (uint8_t)id_len);
  if (!e) {
    pthread_mutex_unlock(&hdr->lock);
    return -ENOENT;
  }
  if (e->refcount > 0) {
    // Pinned by a zero-copy reader: logically deleted now (invisible to
    // get/contains), pages reclaimed when the last pin releases.
    e->pending_delete = 1;
    pthread_mutex_unlock(&hdr->lock);
    return 0;
  }
  DeleteEntryLocked(hdr, e);
  pthread_mutex_unlock(&hdr->lock);
  return 0;
}

// Per-process: disable (0) / enable (1) silent LRU drop on full arena.
// With it disabled the caller runs the spill-before-evict loop (shm.py):
// rts_lru_candidate -> copy bytes to disk -> rts_delete -> retry.
int rts_set_autoevict(int h, int enabled) {
  if (!ValidHandle(h)) return -EINVAL;
  g_stores[h].autoevict = enabled ? 1 : 0;
  return 0;
}

// Id of the current LRU sealed refcount-0 object (the next eviction
// victim).  0 on success; -ENOENT when nothing is evictable.
int rts_lru_candidate(int h, uint8_t* out_id, uint32_t* out_id_len) {
  if (!ValidHandle(h)) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  Entry* victim = nullptr;
  for (uint32_t i = 0; i < kTableSize; i++) {
    Entry& e = hdr->table[i];
    if (e.used == 1 && e.sealed && !e.pending_delete && e.refcount == 0 &&
        (!victim || e.lru_tick < victim->lru_tick))
      victim = &e;
  }
  if (!victim) {
    pthread_mutex_unlock(&hdr->lock);
    return -ENOENT;
  }
  memcpy(out_id, victim->id, victim->id_len);
  *out_id_len = victim->id_len;
  pthread_mutex_unlock(&hdr->lock);
  return 0;
}

// Batched victim selection for the spill engine: up to `max_n` LRU
// sealed refcount-0 victims, oldest first, stopping early once their
// combined arena allocation reaches `need_bytes` (0 = no byte target,
// fill max_n).  One lock acquisition and one ctypes crossing replace a
// per-victim rts_lru_candidate loop — the demotion path's lock traffic
// under arena pressure was one acquisition per victim per failed put.
// out_ids is max_n * 32 bytes (kIdBytes per slot); out_id_lens is
// max_n u32s.  Returns the number of victims written (0 = nothing
// evictable), or -errno.
int rts_lru_candidates(int h, uint8_t* out_ids, uint32_t* out_id_lens,
                       uint32_t max_n, uint64_t need_bytes) {
  if (!ValidHandle(h) || max_n == 0) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  uint32_t n = 0;
  uint64_t gathered = 0;
  // selection sort over the (small) victim set: repeatedly take the
  // oldest not-yet-taken victim. max_n is small (spill batches), so the
  // quadratic scan stays cheap relative to the disk writes it feeds.
  uint64_t last_tick = 0;
  while (n < max_n && (need_bytes == 0 || gathered < need_bytes)) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < kTableSize; i++) {
      Entry& e = hdr->table[i];
      if (e.used == 1 && e.sealed && !e.pending_delete && e.refcount == 0 &&
          (n == 0 || e.lru_tick > last_tick) &&
          (!victim || e.lru_tick < victim->lru_tick))
        victim = &e;
    }
    if (!victim) break;
    memcpy(out_ids + (uint64_t)n * kIdBytes, victim->id, victim->id_len);
    out_id_lens[n] = victim->id_len;
    last_tick = victim->lru_tick;
    gathered += victim->alloc;
    n++;
  }
  pthread_mutex_unlock(&hdr->lock);
  return (int)n;
}

int rts_stats(int h, uint64_t* capacity, uint64_t* used,
              uint64_t* num_objects) {
  if (!ValidHandle(h)) return -EINVAL;
  Header* hdr = g_stores[h].hdr;
  if (LockHeld(hdr) != 0) return -EINVAL;
  *capacity = hdr->capacity;
  *used = hdr->used_bytes;
  *num_objects = hdr->num_objects;
  pthread_mutex_unlock(&hdr->lock);
  return 0;
}

int rts_unlink(const char* name) {
  return shm_unlink(name) == 0 ? 0 : -errno;
}

}  // extern "C"
