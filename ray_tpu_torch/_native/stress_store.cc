// Sanitizer stress harness for the shm object store (the reference runs
// its stores under asan/tsan in CI — ci/ray_ci/tester.py:137-144; this is
// that job for the plasma analog). N threads hammer one arena with
// create/write/seal/get/release/delete cycles plus random aborts, so the
// open-addressed entry table, free-list splices, tombstone reuse, and the
// rebuild path all run under the sanitizer. Exit 0 = clean.
//
// The port's copy of ray_tpu/_native/stress_store.cc. Build with
// AddressSanitizer (or -fsanitize=thread) from this directory:
//   g++ -O1 -g -fsanitize=address -fno-omit-frame-pointer -std=c++17 \
//       -DRT_STORE_TEST_HOOKS stress_store.cc -o stress_store_asan \
//       -lpthread -lrt
// and run ./stress_store_asan [seconds].

#include "object_store.cc"

#include <atomic>
#include <cstdlib>
#include <ctime>
#include <thread>
#include <vector>

namespace {

std::atomic<uint64_t> g_ops{0};
std::atomic<bool> g_stop{false};

void worker(void* store, unsigned seed) {
  unsigned state = seed;
  auto rnd = [&state]() {
    state = state * 1103515245u + 12345u;
    return state >> 16;
  };
  while (!g_stop.load(std::memory_order_relaxed)) {
    uint8_t id[20];
    for (int i = 0; i < 20; i++) id[i] = static_cast<uint8_t>(rnd());
    uint64_t size = 64 + rnd() % 65536;
    void* data = rt_store_create_object(store, id, size);
    if (data == nullptr) continue;  // full / collision
    if (rnd() % 8 == 0) {
      // abandoned create (abort path): release + delete unsealed
      rt_store_release(store, id);
      rt_store_delete(store, id);
      continue;
    }
    memset(data, static_cast<int>(rnd() % 251), size);
    rt_store_seal(store, id);
    rt_store_release(store, id);
    uint64_t got = 0;
    void* back = rt_store_get(store, id, &got);
    if (back != nullptr) {
      volatile uint8_t sink = static_cast<uint8_t*>(back)[got - 1];
      (void)sink;
      rt_store_release(store, id);
    }
    rt_store_delete(store, id);
    g_ops.fetch_add(1, std::memory_order_relaxed);
  }
}

}  // namespace

int main(int argc, char** argv) {
  int seconds = argc > 1 ? atoi(argv[1]) : 5;
  const char* name = "/rtpu-stress";
  rt_store_destroy(name);
  void* store = rt_store_create(name, 64ull * 1024 * 1024, 512);
  if (store == nullptr) {
    fprintf(stderr, "create failed\n");
    return 1;
  }
  std::vector<std::thread> threads;
  for (int i = 0; i < 8; i++) {
    threads.emplace_back(worker, store, 0x9e3779b9u * (i + 1));
  }
  struct timespec ts = {seconds, 0};
  nanosleep(&ts, nullptr);
  g_stop.store(true);
  for (auto& t : threads) t.join();
  uint64_t in_use = rt_store_bytes_in_use(store);
  uint64_t objects = rt_store_num_objects(store);
  printf("ops=%llu leftover_objects=%llu bytes_in_use=%llu\n",
         static_cast<unsigned long long>(g_ops.load()),
         static_cast<unsigned long long>(objects),
         static_cast<unsigned long long>(in_use));
  rt_store_close(store);
  rt_store_destroy(name);
  // Every thread deletes what it created: a leak here is an allocator bug.
  return (objects == 0 && in_use == 0) ? 0 : 2;
}
