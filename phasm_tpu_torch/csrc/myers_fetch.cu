// Kernel 5: the Myers table tier's per-pair forward window fetch, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel scripts/myers_dma_proto.py::make_fwd_fetch (which
// stands in for the XLA row gather + barrel shift of
// phasm_tpu/overlap/myers.py::fwd_prep_tab).  For each pair p:
//   peq_out[k, c, p] = peq[a_oid[p], c, sfw[p] + k]   k < NBLK, c < 4
//   bpk_out[w, p]    = bpk[b_oid[p], 0, w]            w < JW = J/16
// from the whole-read tables (peq [n_o, 8, PW] uint32 words, bpk [n_o, 2,
// BW] packed codes), in the layout the window-fed Myers kernels read (pair
// last: [NBLK, 4, B] and [JW, B]).  A word past a table row is written as 0,
// which is what the TPU kernel read from its zero-padded tables; the tables
// here are not padded, and B need not be a multiple of anything.
//
// What bounds it on this card: bytes.  It computes nothing; it writes
// NBLK * 16 + JW * 4 bytes a pair and reads each table word a window covers
// (pairs that share a read share its words) and 12 bytes of indices a pair
// (PERF.md section 6 has its bound and time on c4's buckets).  Design, simple
// first: threadIdx.x indexes pairs, so every store is a coalesced 128-byte
// row segment of the pair-last output; blockIdx.y picks a plane and a run of
// kRun consecutive words, which each thread reads from one table row, so
// its loads walk consecutive addresses and share sectors from one load to
// the next.  The loads of a warp still touch 32 different rows; staging a
// tile through shared memory to coalesce both sides is the next step.
//
// Launch rules: the current stream, no allocation, no synchronisation; the
// C entry returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 8;  // words per thread

__global__ void myers_fwd_fetch_kernel(const int* __restrict__ a_oid,
                                       const int* __restrict__ b_oid,
                                       const int* __restrict__ sfw,
                                       const uint32_t* __restrict__ peq, int PW,
                                       const int* __restrict__ bpk, int BW, int B, int NBLK,
                                       int JW, uint32_t* __restrict__ peq_out,
                                       int* __restrict__ bpk_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int peq_runs = 4 * ((NBLK + kRun - 1) / kRun);  // (plane, run) pairs
  const int r = blockIdx.y;
  if (r < peq_runs) {
    const int c = r & 3, k0 = (r >> 2) * kRun;
    const uint32_t* row = peq + ((size_t)a_oid[p] * 8 + c) * PW;
    const int s = sfw[p] + k0;
    const int n = min(kRun, NBLK - k0);
    for (int i = 0; i < n; ++i) {
      const int w = s + i;
      peq_out[((size_t)(k0 + i) * 4 + c) * B + p] = (w >= 0 && w < PW) ? row[w] : 0u;
    }
  } else {
    const int w0 = (r - peq_runs) * kRun;
    const int* row = bpk + (size_t)b_oid[p] * 2 * BW;  // plane 0
    const int n = min(kRun, JW - w0);
    for (int i = 0; i < n; ++i) {
      const int w = w0 + i;
      bpk_out[(size_t)w * B + p] = w < BW ? row[w] : 0;
    }
  }
}

}  // namespace

extern "C" int phasm_myers_fwd_fetch(const int* a_oid, const int* b_oid, const int* sfw,
                                     const uint32_t* peq, int PW, const int* bpk, int BW, int B,
                                     int NBLK, int JW, uint32_t* peq_out, int* bpk_out,
                                     void* stream) {
  if (B == 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads,
                  4 * ((NBLK + kRun - 1) / kRun) + (JW + kRun - 1) / kRun);
  myers_fwd_fetch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a_oid, b_oid, sfw, peq, PW, bpk, BW, B, NBLK, JW, peq_out, bpk_out);
  return (int)cudaGetLastError();
}
