// Mutable shared-memory channel — compiled-graph transport.
//
// Reference: src/ray/core_worker/experimental_mutable_object_manager.cc and
// python/ray/experimental/channel/shared_memory_channel.py: a mutable
// plasma buffer with writer/reader semaphores; the writer rewrites the SAME
// buffer once every reader has consumed the previous version.
//
// Redesign (daemon-less, like shm_store.cc): one POSIX shm segment per
// channel holding a robust process-shared mutex, a futex sequence word, a
// version counter, a reader-ack counter, and the payload arena. Protocol:
//
//   write(buf):  lock; wait until acks == num_readers (previous value fully
//                consumed — this is the pipeline backpressure); memcpy in;
//                version++; acks = 0; wake.
//   read(last):  lock; wait until version > last; memcpy out; acks++;
//                wake; return version.
//
// Copies happen under the lock (payloads are pipeline activations, small
// relative to the RPC+pickle+scheduler path they replace).
//
// Blocking is a raw futex on `seq` (bumped on every state change), NOT a
// process-shared pthread condvar: glibc pshared condvars keep waiter
// accounting (__wrefs/__g_refs) in the shared segment, and a peer
// SIGKILLed mid-wait leaks its reference forever — every later
// signal/broadcast then wedges in the group-quiesce spin, hanging all
// SURVIVING processes (observed: a killed RL env-runner froze the queue
// actor inside a zero-timeout read). Futex wait queues live in the
// kernel, keyed by task — a dead waiter simply evaporates. Combined with
// EOWNERDEAD recovery on the mutex (dead lock HOLDERS), a crashed peer
// cannot wedge the channel, and close() wakes all waiters with an error.
//
// Build: g++ -O2 -fPIC -shared -o libshm_channel.so shm_channel.cc -lpthread -lrt

#include <cerrno>
#include <climits>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <linux/futex.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x525443484e4c3032ULL;  // "RTCHNL02"

struct ChannelHeader {
  uint64_t magic;
  uint64_t capacity;
  pthread_mutex_t mu;
  uint32_t seq;          // futex word: state-change notification counter
  uint32_t seq_pad_;
  uint64_t version;      // sequence number of the value in the arena
  uint64_t acks;         // readers that consumed `version`
  uint64_t num_readers;
  uint64_t len;          // payload bytes of current value
  int32_t closed;
  // arena follows
};

struct Handle {
  ChannelHeader* hdr;
  uint64_t map_size;
};

char* arena(ChannelHeader* h) {
  return reinterpret_cast<char*>(h) + sizeof(ChannelHeader);
}

int lock_robust(ChannelHeader* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    // previous owner died mid-critical-section; state is still a valid
    // snapshot (counters are only advanced after memcpy completes)
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

void deadline_after_ms(timespec* ts, int64_t ms) {
  clock_gettime(CLOCK_MONOTONIC, ts);
  ts->tv_sec += ms / 1000;
  ts->tv_nsec += (ms % 1000) * 1000000;
  if (ts->tv_nsec >= 1000000000) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000;
  }
}

// Wait for `seq` to move past `seen`, bounded by the absolute MONOTONIC
// deadline.  Returns ETIMEDOUT at the deadline; 0 on wake / value-change
// / EINTR (the caller re-checks channel state under the lock either way).
int wait_seq(ChannelHeader* h, uint32_t seen, const timespec* deadline) {
  timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  timespec rel;
  rel.tv_sec = deadline->tv_sec - now.tv_sec;
  rel.tv_nsec = deadline->tv_nsec - now.tv_nsec;
  if (rel.tv_nsec < 0) {
    rel.tv_sec -= 1;
    rel.tv_nsec += 1000000000;
  }
  if (rel.tv_sec < 0 || (rel.tv_sec == 0 && rel.tv_nsec == 0)) {
    return ETIMEDOUT;
  }
  long rc = syscall(SYS_futex, &h->seq, FUTEX_WAIT, seen, &rel,
                    nullptr, 0);
  if (rc == -1 && errno == ETIMEDOUT) return ETIMEDOUT;
  return 0;
}

// Bump the sequence word and wake every waiter.  Call while holding the
// mutex so the bump is ordered against the state change it publishes.
void wake_all(ChannelHeader* h) {
  __atomic_fetch_add(&h->seq, 1, __ATOMIC_SEQ_CST);
  syscall(SYS_futex, &h->seq, FUTEX_WAKE, INT_MAX, nullptr, nullptr, 0);
}

constexpr int kMaxHandles = 4096;
Handle g_handles[kMaxHandles];
int g_next_handle = 0;
pthread_mutex_t g_handles_mu = PTHREAD_MUTEX_INITIALIZER;

}  // namespace

extern "C" {

// Returns handle >= 0, or -errno.
int rtc_create(const char* name, uint64_t capacity, uint64_t num_readers) {
  uint64_t map_size = sizeof(ChannelHeader) + capacity;
  int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return -errno;
  struct stat st;
  bool fresh = fstat(fd, &st) == 0 && st.st_size == 0;
  if (fresh && ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -errno;
  auto* hdr = static_cast<ChannelHeader*>(mem);
  if (fresh || hdr->magic != kMagic) {
    std::memset(hdr, 0, sizeof(ChannelHeader));
    hdr->capacity = capacity;
    hdr->num_readers = num_readers;
    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mu, &ma);
    __sync_synchronize();
    hdr->magic = kMagic;
  }
  pthread_mutex_lock(&g_handles_mu);
  int h = g_next_handle++;
  if (h >= kMaxHandles) {
    pthread_mutex_unlock(&g_handles_mu);
    munmap(mem, map_size);
    return -ENOMEM;
  }
  g_handles[h] = {hdr, map_size};
  pthread_mutex_unlock(&g_handles_mu);
  return h;
}

int rtc_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return -errno;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -errno;
  auto* hdr = static_cast<ChannelHeader*>(mem);
  if (hdr->magic != kMagic) {
    munmap(mem, st.st_size);
    return -EINVAL;
  }
  pthread_mutex_lock(&g_handles_mu);
  int h = g_next_handle++;
  if (h >= kMaxHandles) {
    pthread_mutex_unlock(&g_handles_mu);
    munmap(mem, st.st_size);
    return -ENOMEM;
  }
  g_handles[h] = {hdr, static_cast<uint64_t>(st.st_size)};
  pthread_mutex_unlock(&g_handles_mu);
  return h;
}

// 0 ok; -EAGAIN timeout; -EPIPE closed; -EMSGSIZE too big.
int rtc_write(int h, const char* data, uint64_t len, int64_t timeout_ms) {
  ChannelHeader* hdr = g_handles[h].hdr;
  if (len > hdr->capacity) return -EMSGSIZE;
  timespec ts;
  deadline_after_ms(&ts, timeout_ms);
  if (lock_robust(hdr) != 0) return -EINVAL;
  // wait for every reader to have consumed the previous version
  while (!hdr->closed && hdr->version != 0 && hdr->acks < hdr->num_readers) {
    uint32_t seen = __atomic_load_n(&hdr->seq, __ATOMIC_SEQ_CST);
    pthread_mutex_unlock(&hdr->mu);
    if (wait_seq(hdr, seen, &ts) == ETIMEDOUT) return -EAGAIN;
    if (lock_robust(hdr) != 0) return -EINVAL;
  }
  if (hdr->closed) {
    pthread_mutex_unlock(&hdr->mu);
    return -EPIPE;
  }
  std::memcpy(arena(hdr), data, len);
  hdr->len = len;
  hdr->version += 1;
  hdr->acks = 0;
  wake_all(hdr);
  pthread_mutex_unlock(&hdr->mu);
  return 0;
}

// Blocks until version > last_version; copies payload into out (cap
// out_cap). Returns new version (>0); -EAGAIN timeout; -EPIPE closed;
// -EMSGSIZE out buffer too small (required size in *out_len).
int64_t rtc_read(int h, uint64_t last_version, char* out, uint64_t out_cap,
                 uint64_t* out_len, int64_t timeout_ms) {
  ChannelHeader* hdr = g_handles[h].hdr;
  timespec ts;
  deadline_after_ms(&ts, timeout_ms);
  if (lock_robust(hdr) != 0) return -EINVAL;
  while (!hdr->closed && hdr->version <= last_version) {
    uint32_t seen = __atomic_load_n(&hdr->seq, __ATOMIC_SEQ_CST);
    pthread_mutex_unlock(&hdr->mu);
    if (wait_seq(hdr, seen, &ts) == ETIMEDOUT) return -EAGAIN;
    if (lock_robust(hdr) != 0) return -EINVAL;
  }
  if (hdr->closed && hdr->version <= last_version) {
    pthread_mutex_unlock(&hdr->mu);
    return -EPIPE;
  }
  *out_len = hdr->len;
  if (hdr->len > out_cap) {
    pthread_mutex_unlock(&hdr->mu);
    return -EMSGSIZE;
  }
  std::memcpy(out, arena(hdr), hdr->len);
  uint64_t v = hdr->version;
  hdr->acks += 1;
  wake_all(hdr);
  pthread_mutex_unlock(&hdr->mu);
  return static_cast<int64_t>(v);
}

uint64_t rtc_capacity(int h) { return g_handles[h].hdr->capacity; }

int rtc_close(int h) {
  ChannelHeader* hdr = g_handles[h].hdr;
  if (lock_robust(hdr) != 0) return -EINVAL;
  hdr->closed = 1;
  wake_all(hdr);
  pthread_mutex_unlock(&hdr->mu);
  return 0;
}

int rtc_unlink(const char* name) {
  return shm_unlink(name) == 0 ? 0 : -errno;
}

}  // extern "C"
