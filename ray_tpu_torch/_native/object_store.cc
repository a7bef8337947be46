// Shared-memory object store — the plasma analog (reference:
// src/ray/object_manager/plasma/{store.cc,dlmalloc.cc}: a per-node
// shared-memory arena at /dev/shm so worker processes exchange large buffers
// zero-copy; reference mounts it the same way, raylet main.cc:84).
//
// Design: one POSIX shm segment = [StoreHeader | ObjectEntry table | data
// arena]. Allocation is first-fit over an in-shm free list with coalescing on
// free (the role dlmalloc plays in the reference, sized down to what a
// host-RAM object plane needs). All state lives IN the segment, guarded by a
// process-shared mutex, so any process that shm_open()s the segment is a
// full peer (create/seal/get/release/delete) with no daemon in the loop.
//
// C ABI only — consumed from Python via ctypes (no pybind11 in the image).
//
// The port's copy of ray_tpu/_native/object_store.cc, built by g++ at first
// use into build/native/ (ray_tpu_torch/core/native_store.py). The
// crash-injection test hook below compiles only with -DRT_STORE_TEST_HOOKS
// (the tests' own build, and stress_store.cc's); the library the runtime
// loads never has it.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x3252415954505553ULL;  // "SUPTYAR2" (v2 layout)
constexpr uint32_t kIdSize = 20;                  // ObjectID bytes (reference id.h)

// used: 0 = never occupied (ends a probe chain), 1 = live,
//       2 = tombstone (deleted; probes continue past, inserts may reuse)
struct ObjectEntry {
  uint8_t id[kIdSize];
  uint64_t offset;    // data offset from arena base
  uint64_t size;
  int64_t refcount;   // get/release pins; delete only when 0
  uint8_t sealed;     // visible to get() only when sealed
  uint8_t used;
};

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
  int64_t next;  // index into free_blocks, -1 = end
};

struct StoreHeader {
  uint64_t magic;
  uint64_t capacity;        // arena bytes
  uint64_t arena_offset;    // from segment base
  uint32_t max_entries;
  uint32_t max_free_blocks;
  int64_t free_head;        // index into free block table
  uint64_t bytes_in_use;
  uint64_t num_objects;
  pthread_mutex_t mutex;
};

struct Store {
  int fd;
  void* base;
  uint64_t total_size;
  StoreHeader* hdr;
  ObjectEntry* entries;
  FreeBlock* free_blocks;
  uint8_t* arena;
};

uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

// The entry table is an open-addressed hash over the 20-byte id (linear
// probing). Typical find/insert is O(1) instead of the v1 linear scan of
// the whole table per op. Deletions leave tombstones that inserts reuse;
// there is deliberately NO compaction pass — rehashing in place would
// violate the crash-recovery invariant that the entry table is always a
// consistent source of truth (a peer dying mid-rehash with the mutex held
// would lose live entries). Worst case (every slot 1 or 2) degrades to the
// old full-scan behavior, never below it.
uint32_t id_hash(const uint8_t* id) {
  uint32_t h = 2166136261u;  // FNV-1a
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 16777619u;
  }
  return h;
}

ObjectEntry* find_entry(Store* s, const uint8_t* id) {
  const uint32_t max = s->hdr->max_entries;
  const uint32_t h = id_hash(id) % max;
  for (uint32_t k = 0; k < max; k++) {
    ObjectEntry* e = &s->entries[(h + k) % max];
    if (e->used == 0) return nullptr;  // end of probe chain
    if (e->used == 1 && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

// Insert slot for a new id: first reusable slot (empty or tombstone) in the
// probe chain, provided the id is not already present. Null if the id
// exists or the table is full.
ObjectEntry* probe_insert(Store* s, const uint8_t* id) {
  const uint32_t max = s->hdr->max_entries;
  const uint32_t h = id_hash(id) % max;
  ObjectEntry* slot = nullptr;
  for (uint32_t k = 0; k < max; k++) {
    ObjectEntry* e = &s->entries[(h + k) % max];
    if (e->used == 1) {
      if (memcmp(e->id, id, kIdSize) == 0) return nullptr;  // exists
    } else {
      if (!slot) slot = e;
      if (e->used == 0) break;  // chain ends: id cannot exist beyond here
    }
  }
  return slot;
}

// First-fit allocation from the free list. Minimum allocation is 8 bytes so
// every object occupies a distinct arena range — zero-size objects would
// otherwise share an offset with their successor, which breaks crash
// recovery's entry-table walk (and offset-keyed invariants generally).
int64_t arena_alloc(Store* s, uint64_t size, uint64_t* out_offset);
int arena_free(Store* s, uint64_t offset, uint64_t size);

int64_t arena_alloc(Store* s, uint64_t size, uint64_t* out_offset) {
  size = align8(size ? size : 1);
  int64_t* prev_link = &s->hdr->free_head;
  int64_t idx = s->hdr->free_head;
  while (idx >= 0) {
    FreeBlock* b = &s->free_blocks[idx];
    if (b->size >= size) {
      *out_offset = b->offset;
      if (b->size == size) {
        *prev_link = b->next;
        b->size = 0;  // slot free for reuse
      } else {
        b->offset += size;
        b->size -= size;
      }
      s->hdr->bytes_in_use += size;
      return 0;
    }
    prev_link = &b->next;
    idx = b->next;
  }
  return -1;  // out of memory
}

// Returns 0 on success, -1 when the free-block table is exhausted — the
// caller must then rebuild_free_list() (the coalesced gap set between live
// entries always fits: gaps <= num_objects + 1 <= max_entries < max_free_
// blocks). No state is mutated on failure, so the rebuild sees a
// consistent entry table.
int arena_free(Store* s, uint64_t offset, uint64_t size) {
  size = align8(size ? size : 1);  // must mirror arena_alloc's minimum
  // walk the offset-sorted free list to the insertion point
  int64_t prev = -1;
  int64_t idx = s->hdr->free_head;
  while (idx >= 0 && s->free_blocks[idx].offset < offset) {
    prev = idx;
    idx = s->free_blocks[idx].next;
  }
  bool merge_next = (idx >= 0 && offset + size == s->free_blocks[idx].offset);
  bool merge_prev =
      (prev >= 0 && s->free_blocks[prev].offset + s->free_blocks[prev].size == offset);
  if (merge_prev && merge_next) {
    s->free_blocks[prev].size += size + s->free_blocks[idx].size;
    s->free_blocks[prev].next = s->free_blocks[idx].next;
    s->free_blocks[idx].size = 0;
    s->hdr->bytes_in_use -= size;
    return 0;
  }
  if (merge_prev) {
    s->free_blocks[prev].size += size;
    s->hdr->bytes_in_use -= size;
    return 0;
  }
  if (merge_next) {
    s->free_blocks[idx].offset = offset;
    s->free_blocks[idx].size += size;
    s->hdr->bytes_in_use -= size;
    return 0;
  }
  // new free block in the first empty slot
  for (uint32_t i = 0; i < s->hdr->max_free_blocks; i++) {
    if (s->free_blocks[i].size == 0) {
      s->free_blocks[i].offset = offset;
      s->free_blocks[i].size = size;
      s->free_blocks[i].next = idx;
      if (prev >= 0) {
        s->free_blocks[prev].next = i;
      } else {
        s->hdr->free_head = i;
      }
      s->hdr->bytes_in_use -= size;
      return 0;
    }
  }
  return -1;  // table exhausted; caller rebuilds from the entry table
}

// Rebuild all allocator metadata from the entry table. Used after a peer
// died mid-mutation (EOWNERDEAD): the free list may be half-spliced, but the
// entry table is the source of truth — every used entry's [offset, size) is
// live, everything else in the arena is free. Entries from a death between
// arena_alloc and `used = 1` are reclaimed (the object was never visible).
void rebuild_free_list(Store* s) {
  StoreHeader* h = s->hdr;
  // Selection-order walk over used entries by offset; O(n^2) but only runs
  // on the rare crash-recovery path (max_entries is a few thousand).
  memset(s->free_blocks, 0, sizeof(FreeBlock) * h->max_free_blocks);
  uint64_t prev_end = 0;
  uint64_t in_use = 0;
  uint64_t num_objects = 0;
  uint64_t last_offset = 0;
  int64_t last_index = -1;
  int64_t tail = -1;  // last free block written
  uint32_t slot = 0;
  h->free_head = -1;
  for (;;) {
    // Next used entry in (offset, table index) order — the index tiebreak
    // makes the walk robust even if two entries ever shared an offset.
    ObjectEntry* best = nullptr;
    int64_t best_index = -1;
    for (uint32_t i = 0; i < h->max_entries; i++) {
      ObjectEntry* e = &s->entries[i];
      if (e->used != 1) continue;
      if (e->offset < last_offset ||
          (e->offset == last_offset && (int64_t)i <= last_index)) {
        continue;
      }
      if (!best || e->offset < best->offset) {
        best = e;
        best_index = i;
      }
    }
    uint64_t gap_end = best ? best->offset : h->capacity;
    if (gap_end > prev_end && slot < h->max_free_blocks) {
      s->free_blocks[slot] = {prev_end, gap_end - prev_end, -1};
      if (tail >= 0) {
        s->free_blocks[tail].next = slot;
      } else {
        h->free_head = slot;
      }
      tail = slot;
      slot++;
    }
    if (!best) break;
    last_offset = best->offset;
    last_index = best_index;
    uint64_t span = align8(best->size ? best->size : 1);
    uint64_t end = best->offset + span;
    if (end > prev_end) prev_end = end;
    in_use += span;
    num_objects++;
  }
  h->bytes_in_use = in_use;
  h->num_objects = num_objects;
}

class Lock {
 public:
  explicit Lock(Store* s) : s_(s) {
    int rc = pthread_mutex_lock(&s_->hdr->mutex);
    if (rc == EOWNERDEAD) {
      // A peer died holding the lock; the robust mutex hands it to us in an
      // inconsistent state. The multi-step free-list splices in
      // arena_alloc/arena_free are NOT idempotent, so rebuild the allocator
      // metadata from the entry table (the source of truth) before marking
      // the mutex consistent.
      rebuild_free_list(s_);
      pthread_mutex_consistent(&s_->hdr->mutex);
    }
  }
  ~Lock() { pthread_mutex_unlock(&s_->hdr->mutex); }

 private:
  Store* s_;
};

}  // namespace

extern "C" {

// Create a new store segment. Returns handle or null.
void* rt_store_create(const char* name, uint64_t capacity, uint32_t max_entries) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;

  uint32_t max_free = max_entries * 2;
  uint64_t entries_off = align8(sizeof(StoreHeader));
  uint64_t free_off = align8(entries_off + sizeof(ObjectEntry) * max_entries);
  uint64_t arena_off = align8(free_off + sizeof(FreeBlock) * max_free);
  uint64_t total = arena_off + capacity;
  if (ftruncate(fd, total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }

  Store* s = new Store();
  s->fd = fd;
  s->base = base;
  s->total_size = total;
  s->hdr = static_cast<StoreHeader*>(base);
  s->entries = reinterpret_cast<ObjectEntry*>(static_cast<char*>(base) + entries_off);
  s->free_blocks = reinterpret_cast<FreeBlock*>(static_cast<char*>(base) + free_off);
  s->arena = reinterpret_cast<uint8_t*>(base) + arena_off;

  memset(s->hdr, 0, arena_off);
  s->hdr->magic = kMagic;
  s->hdr->capacity = capacity;
  s->hdr->arena_offset = arena_off;
  s->hdr->max_entries = max_entries;
  s->hdr->max_free_blocks = max_free;
  // one big free block
  s->free_blocks[0] = {0, capacity, -1};
  s->hdr->free_head = 0;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&s->hdr->mutex, &attr);
  return s;
}

// Open an existing segment (peer process).
void* rt_store_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  StoreHeader* hdr = static_cast<StoreHeader*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->fd = fd;
  s->base = base;
  s->total_size = st.st_size;
  s->hdr = hdr;
  uint64_t entries_off = align8(sizeof(StoreHeader));
  uint64_t free_off = align8(entries_off + sizeof(ObjectEntry) * hdr->max_entries);
  s->entries = reinterpret_cast<ObjectEntry*>(static_cast<char*>(base) + entries_off);
  s->free_blocks = reinterpret_cast<FreeBlock*>(static_cast<char*>(base) + free_off);
  s->arena = reinterpret_cast<uint8_t*>(base) + hdr->arena_offset;
  return s;
}

// Allocate an object buffer (unsealed). Returns pointer to data or null.
// (reference: plasma Create — two-phase create/seal)
void* rt_store_create_object(void* handle, const uint8_t* id, uint64_t size) {
  Store* s = static_cast<Store*>(handle);
  uint64_t offset;
  {
    Lock lock(s);
    ObjectEntry* e = probe_insert(s, id);  // null: exists or table full
    if (!e) return nullptr;
    if (arena_alloc(s, size, &offset) != 0) return nullptr;
    memcpy(e->id, id, kIdSize);
    e->offset = offset;
    e->size = size;
    e->refcount = 1;  // creator holds a pin until seal+release
    e->sealed = 0;
    e->used = 1;
    s->hdr->num_objects++;
  }
  uint8_t* data = s->arena + offset;
  if (size >= (1u << 20)) {
    // Populate the extent's pages in one kernel walk instead of one minor
    // fault per 4 KiB during the producer's copy (~2x on fresh mappings).
    // Outside the store mutex: a multi-MB populate must not block peers.
    // Page-align the range; best-effort (older kernels: ENOSYS/EINVAL).
    uintptr_t lo = reinterpret_cast<uintptr_t>(data) & ~4095ULL;
    uintptr_t hi = reinterpret_cast<uintptr_t>(data) + size;
#ifdef MADV_POPULATE_WRITE
    madvise(reinterpret_cast<void*>(lo), hi - lo, MADV_POPULATE_WRITE);
#endif
  }
  return data;
}

int rt_store_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  ObjectEntry* e = find_entry(s, id);
  if (!e) return -1;
  e->sealed = 1;
  return 0;
}

// Get a sealed object: returns data pointer, fills size; pins the object.
void* rt_store_get(void* handle, const uint8_t* id, uint64_t* size_out) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  ObjectEntry* e = find_entry(s, id);
  if (!e || !e->sealed) return nullptr;
  e->refcount++;
  *size_out = e->size;
  return s->arena + e->offset;
}

int rt_store_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  ObjectEntry* e = find_entry(s, id);
  if (!e) return -1;
  if (e->refcount > 0) e->refcount--;
  return 0;
}

int rt_store_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  ObjectEntry* e = find_entry(s, id);
  return (e && e->sealed) ? 1 : 0;
}

// Delete when refcount==0 (reference: eviction only of unpinned objects).
int rt_store_delete(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  ObjectEntry* e = find_entry(s, id);
  if (!e) return -1;
  if (e->refcount > 0) return -2;  // pinned
  uint64_t off = e->offset, sz = e->size;
  e->used = 2;  // tombstone BEFORE freeing: a crash here loses no space
  s->hdr->num_objects--;
  if (arena_free(s, off, sz) != 0) {
    // Free-block table exhausted (v1 silently leaked here): rebuild the
    // whole allocator from the entry table — the coalesced gap set always
    // fits, and the rebuild also recomputes bytes_in_use/num_objects.
    rebuild_free_list(s);
  }
  return 0;
}

uint64_t rt_store_bytes_in_use(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  return s->hdr->bytes_in_use;
}

uint64_t rt_store_num_objects(void* handle) {
  Store* s = static_cast<Store*>(handle);
  Lock lock(s);
  return s->hdr->num_objects;
}

uint64_t rt_store_capacity(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s->hdr->capacity;
}

void rt_store_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->total_size);
  close(s->fd);
  delete s;
}

int rt_store_destroy(const char* name) { return shm_unlink(name); }

// Pre-fault the arena's pages so first puts don't pay kernel page
// population at transfer time (observed ~10x write slowdown on fresh shm
// pages under memory ballooning). Content-preserving: an atomic |= 0
// dirties each page without changing bytes, so it is safe to run while
// objects are live. chunk_bytes per burst, sleep_us between bursts keeps
// it off the critical path on small machines.
void rt_store_prefault(void* handle, uint64_t chunk_bytes, uint32_t sleep_us,
                       uint64_t max_bytes) {
  Store* s = static_cast<Store*>(handle);
  const uint64_t kPage = 4096;
  uint64_t cap = s->hdr->capacity;
  if (max_bytes && max_bytes < cap) cap = max_bytes;
  // Drop this (dedicated) thread to SCHED_IDLE: page population is pure
  // opportunistic background work, and on small hosts an arena-sized fault
  // storm at normal priority starves the very puts it exists to speed up
  // (observed: boot prefault of 4 co-hosted daemons stretching a 1.1s walk
  // into minutes on one core while bench puts ran at 1/30th speed).
  struct sched_param sp = {};
  pthread_setschedparam(pthread_self(), SCHED_IDLE, &sp);
  volatile uint8_t* base = reinterpret_cast<volatile uint8_t*>(s->arena);
  for (uint64_t off = 0; off < cap; off += chunk_bytes) {
    uint64_t end = off + chunk_bytes < cap ? off + chunk_bytes : cap;
    for (uint64_t p = off; p < end; p += kPage) {
      __atomic_fetch_or(const_cast<uint8_t*>(base + p), 0, __ATOMIC_RELAXED);
    }
    if (sleep_us) usleep(sleep_us);
  }
}

// -- test hook (crash-recovery tests) ---------------------------------------
// Simulates a peer dying mid-splice: acquires the mutex, trashes the
// allocator metadata, and returns WITHOUT unlocking. The caller then exits,
// so the next locker observes EOWNERDEAD with inconsistent metadata and must
// rebuild from the entry table. Compiled ONLY into a test build — never
// exported from the library the runtime loads.
#ifdef RT_STORE_TEST_HOOKS
int rt_store_test_corrupt_and_hold(void* handle) {
  Store* s = static_cast<Store*>(handle);
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    rebuild_free_list(s);
    pthread_mutex_consistent(&s->hdr->mutex);
  }
  s->hdr->free_head = -1;  // dangling: no free space reachable
  s->hdr->bytes_in_use = s->hdr->capacity;
  s->hdr->num_objects += 17;
  return 0;
}
#endif  // RT_STORE_TEST_HOOKS

}  // extern "C"
