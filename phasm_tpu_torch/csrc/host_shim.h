// Host stand-ins for the CUDA built-ins that csrc/myers.cu uses, so that a
// host compiler builds the kernel source unchanged and runs its grid as
// loops, one thread after another:
//     g++ -std=c++17 -O1 -shared -fPIC -x c++ -DPHASM_HOST_SHIM
//         -include csrc/host_shim.h -o libmyers_host.so csrc/myers.cu
// The kernels do one pair per thread with no warp collectives, so running
// the threads in turn gives the card's results.  Pointers passed to the C
// entries are host pointers.  tests/test_torch_myers_hostbuild.py builds
// and uses it.
#pragma once

#include <algorithm>
#include <cstdint>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

using std::max;
using std::min;

struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return uint4{x, y, z, w}; }

inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t sh) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (sh & 31)) >> 32);
}
// result byte i = byte (s >> 4i) & 7 of the 8 bytes {y:x} (sign mode unused)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t out = 0;
  for (int i = 0; i < 4; ++i) out |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return out;
}

struct phasm_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
// internal linkage: as inline variables they would be process-wide unique
// symbols, shared with (and taken over by) another host build loaded first
static phasm_dim3 blockIdx, threadIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace phasm_host {
struct Grid {
  int grid, block;
  template <class F>
  auto operator()(F kernel) const {
    return [grid = grid, block = block, kernel](auto... args) {
      blockDim.x = (unsigned)block;
      for (int b = 0; b < grid; ++b)
        for (int t = 0; t < block; ++t) {
          blockIdx.x = (unsigned)b;
          threadIdx.x = (unsigned)t;
          kernel(args...);
        }
    };
  }
};
}  // namespace phasm_host

#define PHASM_LAUNCH(kernel, grid, block, stream) \
  phasm_host::Grid{(int)(grid), (int)(block)}(kernel)
