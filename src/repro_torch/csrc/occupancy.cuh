// The kernel instances a library has launched, and their occupancy.
//
// Every launch site calls repro::occ::note(kernel, block, dynamic shared
// memory) before it launches; the first launch of each (instance, block
// size, dynamic shared memory) is kept in a table, one per library. A
// launch that repeats the calling thread's last triple (a loop launching one
// instance) costs a thread-local compare and takes no lock; any other takes
// the table's mutex and one hash lookup. <source>_occupancy(i, out, name,
// len) reports entry i: its block size and dynamic shared memory, the
// registers, static shared memory and local memory cudaFuncGetAttributes
// gives, the blocks an SM keeps resident by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, and the instance's mangled
// name by cudaFuncGetName. chip_smoke.py holds the port's Eq. 1
// (repro_torch/kernels/tuning.py::resident_blocks, from the ptxas report's
// entry of that name) to that number for every instance.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>
#include <functional>
#include <mutex>
#include <unordered_set>
#include <vector>

namespace repro {
namespace occ {
// Internal linkage: each library keeps its own table (an inline variable
// would be one GNU-unique symbol shared by every library in the process).
namespace {

struct Seen {
  const void* fn;
  int threads;
  size_t smem;
  bool operator==(const Seen& o) const {
    return fn == o.fn && threads == o.threads && smem == o.smem;
  }
};

struct SeenHash {
  size_t operator()(const Seen& s) const {
    return std::hash<const void*>()(s.fn) ^ ((size_t)s.threads << 20) ^
           (s.smem * 0x9e3779b97f4a7c15ull);
  }
};

std::vector<Seen> g_seen;                      // in first-launch order
std::unordered_set<Seen, SeenHash> g_index;
std::mutex g_mu;
thread_local Seen t_last = {nullptr, 0, 0};

template <typename F>
inline void note(F* fn, dim3 block, size_t smem) {
  const Seen s = {(const void*)fn, (int)(block.x * block.y * block.z), smem};
  if (s == t_last) return;
  t_last = s;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_index.insert(s).second) g_seen.push_back(s);
}

// out[0] threads a block, [1] dynamic shared memory, [2] registers a thread,
// [3] static shared memory, [4] local memory a thread, [5] resident blocks an
// SM (CUDA's occupancy), [6] the instance's max threads a block, [7] the
// CUDA error of the three queries (0: none); `name` gets the mangled name,
// cut to len - 1 bytes. Returns the count of instances kept (out and name
// untouched when i is not one).
inline int query(int i, long long* out, char* name, int len) {
  std::lock_guard<std::mutex> lock(g_mu);
  const int count = (int)g_seen.size();
  if (i < 0 || i >= count) return count;
  const Seen& s = g_seen[i];
  cudaGetLastError();  // a query reports its own error, not an earlier one
  cudaFuncAttributes a = {};
  int blocks = 0;
  const char* fname = nullptr;
  cudaError_t err = cudaFuncGetAttributes(&a, s.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, s.fn, s.threads, s.smem);
  if (err == cudaSuccess) err = cudaFuncGetName(&fname, s.fn);
  out[0] = s.threads;
  out[1] = (long long)s.smem;
  out[2] = a.numRegs;
  out[3] = (long long)a.sharedSizeBytes;
  out[4] = (long long)a.localSizeBytes;
  out[5] = blocks;
  out[6] = a.maxThreadsPerBlock;
  out[7] = (long long)err;
  if (len > 0) {
    name[0] = '\0';
    if (fname) {
      std::strncpy(name, fname, (size_t)len - 1);
      name[len - 1] = '\0';
    }
  }
  return count;
}

}  // namespace
}  // namespace occ
}  // namespace repro

#define REPRO_OCCUPANCY(source)                                           \
  extern "C" int source##_occupancy(int i, long long* out, char* name, int len) { \
    return repro::occ::query(i, out, name, len);                           \
  }
