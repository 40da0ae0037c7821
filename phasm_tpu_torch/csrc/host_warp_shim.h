// Host stand-ins for the CUDA built-ins that csrc/wband.cu uses, warp
// collectives included, so that a host compiler builds the kernel source
// unchanged:
//     g++ -std=c++20 -O1 -shared -fPIC -pthread -x c++ -DPHASM_HOST_SHIM
//         -include csrc/host_warp_shim.h -o libwband_host.so csrc/wband.cu
// A launch runs its blocks' warps one after another; a warp's 32 lanes run
// as 32 threads that meet at a barrier in every collective (each lane posts
// its value, all wait, each reads its source lane, all wait again), which is
// the card's semantics for collectives that every lane of the warp reaches,
// as the W-band kernels' do.  Pointers passed to the C entries are host
// pointers.  tests/test_torch_wband_hostbuild.py builds and uses it.
#pragma once

#include <algorithm>
#include <barrier>
#include <climits>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

using std::max;
using std::min;

struct alignas(8) uint2 {
  uint32_t x, y;
};

inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
inline int __viaddmin_s32(int a, int b, int c) { return std::min(a + b, c); }
inline int __vimin3_s32(int a, int b, int c) { return std::min(a, std::min(b, c)); }

struct phasm_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
// Internal linkage for every variable here: inline variables are emitted as
// process-wide unique symbols, so a second host build loaded into the same
// process (csrc/host_shim.h's plain blockIdx / threadIdx) would bind these
// names to the first one's objects, and the thread-local accesses then
// land on a plain global (a segfault).
static thread_local phasm_dim3 blockIdx, threadIdx;
static phasm_dim3 blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace phasm_warp {
struct Warp {
  std::barrier<> bar{32};
  long long slot[32];
};
static thread_local Warp* warp;
static thread_local int lane;

inline long long exchange(long long v, int src) {
  warp->slot[lane] = v;
  warp->bar.arrive_and_wait();
  const long long r = warp->slot[src];
  warp->bar.arrive_and_wait();
  return r;
}

template <class Op>
long long reduce(long long v, Op op) {
  warp->slot[lane] = v;
  warp->bar.arrive_and_wait();
  long long r = warp->slot[0];
  for (int i = 1; i < 32; ++i) r = op(r, warp->slot[i]);
  warp->bar.arrive_and_wait();
  return r;
}
}  // namespace phasm_warp

// width: the segment a shuffle stays in (a power of two up to 32)
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  const int seg = phasm_warp::lane & ~(width - 1);
  return (int)phasm_warp::exchange(v, seg + ((src % width) + width) % width);
}
inline int __shfl_up_sync(unsigned, int v, unsigned d, int width = 32) {
  const int l = phasm_warp::lane;
  return (int)phasm_warp::exchange(v, (l & (width - 1)) >= (int)d ? l - (int)d : l);
}
inline int __shfl_down_sync(unsigned, int v, unsigned d, int width = 32) {
  const int l = phasm_warp::lane;
  return (int)phasm_warp::exchange(v, (l & (width - 1)) + (int)d < width ? l + (int)d : l);
}
inline int __shfl_xor_sync(unsigned, int v, int mask, int width = 32) {
  const int l = phasm_warp::lane, src = l ^ mask;
  return (int)phasm_warp::exchange(v, src >= (l & ~(width - 1)) + width ? l : src);
}
inline bool __any_sync(unsigned, bool p) {
  return phasm_warp::reduce(p, [](long long a, long long b) { return a | b; }) != 0;
}
inline bool __all_sync(unsigned, bool p) {
  return phasm_warp::reduce(p, [](long long a, long long b) { return a & b; }) != 0;
}
inline int __reduce_max_sync(unsigned, int v) {
  return (int)phasm_warp::reduce(v, [](long long a, long long b) { return std::max(a, b); });
}

namespace phasm_host {
struct Grid {
  int grid, block;
  template <class F>
  auto operator()(F kernel) const {
    return [grid = grid, block = block, kernel](auto... args) {
      blockDim.x = (unsigned)block;
      for (int b = 0; b < grid; ++b)
        for (int w0 = 0; w0 < block; w0 += 32) {
          phasm_warp::Warp warp;
          std::vector<std::thread> lanes;
          for (int l = 0; l < 32; ++l)
            lanes.emplace_back([&, l] {
              blockIdx.x = (unsigned)b;
              threadIdx.x = (unsigned)(w0 + l);
              phasm_warp::warp = &warp;
              phasm_warp::lane = l;
              kernel(args...);
            });
          for (auto& t : lanes) t.join();
        }
    };
  }
};
}  // namespace phasm_host

#define PHASM_LAUNCH(kernel, grid, block, stream) \
  phasm_host::Grid{(int)(grid), (int)(block)}(kernel)
