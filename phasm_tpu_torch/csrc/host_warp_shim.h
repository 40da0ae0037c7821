// Host stand-ins for the CUDA built-ins that csrc/wband.cu and csrc/myers.cu
// use, warp collectives included, so that a host compiler builds the kernel
// sources unchanged:
//     g++ -std=c++20 -O1 -shared -fPIC -pthread -x c++ -DPHASM_HOST_SHIM
//         -include csrc/host_warp_shim.h -o libwband_host.so csrc/wband.cu
// A launch runs its warps on a few host threads; a warp's 32 lanes run as
// 32 fibers (ucontext) on one of them, which meet in every collective: each
// lane posts its value and yields, and once all 32 have posted each reads
// its source lane.  That is the card's semantics for collectives that every
// lane of the warp reaches, as the W-band and Myers kernels' do, and, with
// no lock or OS wait in a collective, it keeps its speed on a busy machine.
// Pointers passed to the C entries are host pointers.
// tests/test_torch_wband_hostbuild.py and tests/test_torch_myers_hostbuild.py
// build and use it.
//
// Everything here has internal linkage (an unnamed namespace): the two host
// builds load into one process, and inline functions or variables with
// external linkage would be process-wide unique symbols, so one library's
// collectives would run on the other's thread-local warp state.
#pragma once

#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

using std::max;
using std::min;

namespace {

struct alignas(8) uint2 {
  uint32_t x, y;
};
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
inline int __viaddmin_s32(int a, int b, int c) { return std::min(a + b, c); }
inline int __vimin3_s32(int a, int b, int c) { return std::min(a, std::min(b, c)); }

struct phasm_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
thread_local phasm_dim3 blockIdx, threadIdx;
phasm_dim3 blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// A warp: its lanes' fibers and the slots they post to.  Two slot sets
// used in turns: a lane posts to set n % 2 for collective n + 2 only after
// every lane has resumed from collective n + 1, and so has read collective
// n's values.
namespace phasm_warp {
constexpr size_t kStack = 256 * 1024;
struct Warp {
  ucontext_t sched, ctx[32];
  long long slot[2][32];
  int turn[32];
  bool done[32];
  std::function<void()> body;  // the kernel, for the lane now running
};
thread_local Warp* warp;
thread_local int lane;

void lane_main() {
  warp->body();
  warp->done[lane] = true;  // returns to the scheduler (uc_link)
}

inline long long* post(long long v) {
  Warp* w = warp;
  const int l = lane;
  long long* set = w->slot[w->turn[l]];
  w->turn[l] ^= 1;
  set[l] = v;
  swapcontext(&w->ctx[l], &w->sched);  // every lane posts before any resumes
  return set;
}

inline long long exchange(long long v, int src) { return post(v)[src]; }

template <class Op>
long long reduce(long long v, Op op) {
  const long long* set = post(v);
  long long r = set[0];
  for (int i = 1; i < 32; ++i) r = op(r, set[i]);
  return r;
}

inline int source(int src, int width) {  // the card's rule: src modulo the segment width
  return (lane & ~(width - 1)) + ((src % width) + width) % width;
}
}  // namespace phasm_warp

// width: the segment a shuffle stays in (a power of two up to 32)
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  return (int)phasm_warp::exchange(v, phasm_warp::source(src, width));
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src, int width = 32) {
  return (unsigned)phasm_warp::exchange(v, phasm_warp::source(src, width));
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
// Runs the warps of a launch on up to hardware_concurrency host threads,
// each warp's lanes as fibers on one of them (blocks of whole warps).
struct Grid {
  int grid, block;
  template <class F>
  auto operator()(F kernel) const {
    return [grid = grid, block = block, kernel](auto... args) {
      blockDim.x = (unsigned)block;
      const int per_block = (block + 31) / 32, warps = grid * per_block;
      std::atomic<int> next{0};
      auto run = [&] {
        auto stacks = std::make_unique<char[]>(32 * phasm_warp::kStack);
        auto w = std::make_unique<phasm_warp::Warp>();
        for (int k; (k = next++) < warps;) {
          const int b = k / per_block, w0 = 32 * (k % per_block);
          w->body = [&] { kernel(args...); };
          for (int l = 0; l < 32; ++l) {
            w->turn[l] = 0;
            w->done[l] = w0 + l >= block;  // a block's last warp may be partial
            getcontext(&w->ctx[l]);
            w->ctx[l].uc_stack.ss_sp = stacks.get() + l * phasm_warp::kStack;
            w->ctx[l].uc_stack.ss_size = phasm_warp::kStack;
            w->ctx[l].uc_link = &w->sched;
            makecontext(&w->ctx[l], phasm_warp::lane_main, 0);
          }
          phasm_warp::warp = w.get();
          for (bool live = true; live;) {  // one round: every live lane to its next collective
            live = false;
            for (int l = 0; l < 32; ++l) {
              if (w->done[l]) continue;
              live = true;
              phasm_warp::lane = l;
              blockIdx.x = (unsigned)b;
              threadIdx.x = (unsigned)(w0 + l);
              swapcontext(&w->sched, &w->ctx[l]);
            }
          }
        }
      };
      const int n = std::max(1, std::min<int>(warps, (int)std::thread::hardware_concurrency()));
      std::vector<std::thread> pool;
      for (int t = 1; t < n; ++t) pool.emplace_back(run);
      run();
      for (auto& t : pool) t.join();
    };
  }
};
}  // namespace phasm_host

}  // namespace

#define PHASM_LAUNCH(kernel, grid, block, stream) \
  phasm_host::Grid{(int)(grid), (int)(block)}(kernel)
