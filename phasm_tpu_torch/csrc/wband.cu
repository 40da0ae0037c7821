// W-band semiglobal unit-cost overlap kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel phasm_tpu/overlap/extend.py::_make_pallas_extend_seg
// (kernel 3, the segmented cell-per-lane W-band DP).  It computes
// phasm_tpu/overlap/extend.py::dp_core exactly: the packed band cell
// cost * pack + s_rel with pack = max(128, next_pow2(W)), the BIG = 2^15
// clamp, the i == la and j == lb endpoint reductions with their tie-breaks,
// and the two-grid WINDOW = 256 statistic.  It takes every band W from 1 to
// 512 (the Pallas kernel takes W <= 256, any W), so the 512 escalation rung
// runs here too (same function as dp_core).
//
// What bounds it on this card: integer ALU work and warp shuffles.  Each
// column costs ~12 int ops per band cell plus a log2(32)-step cross-lane
// prefix min; the bytes read are one a code and one b code per pair and
// column.  Design: one warp per pair, W/32 adjacent band cells per lane
// (2, 4, 8, 16 at W = 64, 128, 256, 512) holding the packed cell in
// registers for all J columns, so no column segments and no scratch
// memory; any other band runs in the next of those widths with its cells
// w >= W held invalid, as the cell past the band is in dp_core.  The left
// dependency resolves as an in-lane running min followed
// by a __shfl_up_sync scan of the lane minima; the a codes of the band
// slide one cell per column (one new code per warp per column, passed
// between lanes with __shfl_down_sync); positions outside a read never
// match (the 254/255 rule of the reference's band tensors).  The warp-wide
// column minimum is taken only at window mark columns (1 in 128), the
// final-column reduction only at j + 1 == lb.  Each warp stops at its own
// lb: later columns are all-invalid in the reference and change nothing.
//
// Launch rules: the current stream, no allocation, no synchronisation; the
// C entry returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BIG = 1 << 15;
constexpr int BIGK = 1 << 30;
constexpr int WINDOW = 256;

__device__ __forceinline__ int a_code(const uint8_t* arow, int i, int la) {
  return (i >= 0 && i < la) ? (int)arow[i] : 254;
}

template <int CPL>  // band cells per lane: 32 * CPL cells, the first W of them live
__global__ void wband_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                             const int* __restrict__ d0s, const int* __restrict__ lengths,
                             const uint8_t* __restrict__ codes, int LA, int B, int W, int J,
                             int lw, int* __restrict__ out) {
  constexpr int WC = 32 * CPL;
  const int half = W / 2;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= B) return;  // whole warps exit together
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int la = lengths[ao >> 1], lb = lengths[bo >> 1];
  const uint8_t* arow = codes + (size_t)ao * LA;
  const uint8_t* brow = codes + (size_t)bo * LA;
  const int pack = 1 << lw;
  const int BIGPW = BIG << lw;
  const int w0 = lane * CPL;  // first band cell of this lane
  const int base = d0 - half;  // i0 = s_rel + base

  int P[CPL], ac[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int w = w0 + c;
    const int i = d0 + w - half;
    P[c] = (w < W && i >= 0 && i <= la) ? w : BIGPW;
    ac[c] = a_code(arow, i, la);  // a code read by cell w at column 0
  }

  int bcost = BIG, blen = -1, bi0 = 0, bie = 0, bje = 0;
  int wprev = 0, wmax = 0, wprev2 = 0, wmax2 = 0;
  const int win_cap = min(lb, la - d0 - half);

  // endpoint candidate: packed key ck = cost << (lw+1) | (W-1 - w + s_rel)
  auto consider = [&](int ck, int w_sel, int j) {
    if (ck >= BIGK) return;
    const int cost = ck >> (lw + 1);
    const int mid = ck & ((1 << (lw + 1)) - 1);
    const int i0 = mid - (W - 1) + w_sel + base;
    const int i_end = min(d0 + (j + 1) + w_sel - half, la);
    const int alen = (i_end - i0) + (j + 1);
    if (cost < bcost || (cost == bcost && alen > blen)) {
      bcost = cost; blen = alen; bi0 = i0; bie = i_end; bje = j + 1;
    }
  };

  const int ncol = min(J, lb);
  for (int j = 0; j < ncol; ++j) {
    const int bc = brow[j];
    int up_next = __shfl_down_sync(FULL, P[0], 1);
    if (lane == 31) up_next = BIGPW;
    // diag / up, then x[w] = pre[w] - w*pack and its running min in-lane
    int x[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int diag = P[c] + (ac[c] != bc ? pack : 0);
      const int up = (c + 1 < CPL ? P[c + 1] : up_next) + pack;
      x[c] = min(diag, up) - (w0 + c) * pack;
      if (c > 0) x[c] = min(x[c], x[c - 1]);
    }
    // cross-lane inclusive scan of the lane minima, then exclusive prefix
    int tot = x[CPL - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, tot, off);
      if (lane >= off) tot = min(tot, v);
    }
    int excl = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) excl = 0x7FFFFFFF;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int w = w0 + c;
      const int i_cell = d0 + (j + 1) + w - half;
      const int pn = min(x[c], excl) + w * pack;
      P[c] = (w < W && i_cell >= 0 && i_cell <= la) ? min(pn, BIGPW) : BIGPW;
    }

    // endpoint i == la: the one band cell on row la this column
    const int w_la = la - (d0 + (j + 1) - half);
    if (w_la >= 0 && w_la < W) {
      int mine = BIGPW;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (w0 + c == w_la) mine = P[c];
      const int pla = __shfl_sync(FULL, mine, w_la / CPL);
      if (pla < BIGPW) {
        const int ck = ((pla >> lw) << (lw + 1)) + (W - 1 - w_la + (pla & (pack - 1)));
        consider(ck, w_la, j);
      }
    }

    // endpoint j + 1 == lb: lexicographic (key, w) min over the column
    if (j + 1 == lb) {
      int kmin = BIGK, wmin = W;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int w = w0 + c;
        const int k = P[c] < BIGPW ? ((P[c] >> lw) << (lw + 1)) + (W - 1 - w + (P[c] & (pack - 1))) : BIGK;
        if (k < kmin) { kmin = k; wmin = w; }  // cells ascend: first w wins ties
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int k2 = __shfl_xor_sync(FULL, kmin, off);
        const int w2 = __shfl_xor_sync(FULL, wmin, off);
        if (k2 < kmin || (k2 == kmin && w2 < wmin)) { kmin = k2; wmin = w2; }
      }
      consider(kmin, wmin, j);
    }

    // windowed-divergence probe at mark columns (two offset grids)
    if (((j + 1) & (WINDOW / 2 - 1)) == 0) {
      int cm = BIG;
#pragma unroll
      for (int c = 0; c < CPL; ++c) cm = min(cm, P[c] >> lw);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cm = min(cm, __shfl_xor_sync(FULL, cm, off));
      const bool in_cap = (j + 1) <= win_cap;
      if (((j + 1) & (WINDOW - 1)) == 0) {
        if (in_cap) wmax = max(wmax, cm - wprev);
        wprev = cm;
      } else {
        if (in_cap && (j + 1) != WINDOW / 2) wmax2 = max(wmax2, cm - wprev2);
        wprev2 = cm;
      }
    }

    // slide the band's a codes one cell for the next column
    int next0 = __shfl_down_sync(FULL, ac[0], 1);
    if (lane == 31) next0 = a_code(arow, d0 + (j + 1) + (WC - 1) - half, la);
#pragma unroll
    for (int c = 0; c + 1 < CPL; ++c) ac[c] = ac[c + 1];
    ac[CPL - 1] = next0;
  }

  if (lane == 0) {  // no endpoint: BIG, 0, 0, 0 (the initial state)
    out[0 * B + p] = bcost;
    out[1 * B + p] = bi0;
    out[2 * B + p] = bie;
    out[3 * B + p] = bje;
    out[4 * B + p] = max(wmax, wmax2);
  }
}

constexpr int kThreads = 256;  // 8 pairs per block

template <int CPL>
cudaError_t launch(const int* a, const int* b, const int* d0, const int* len,
                   const uint8_t* codes, int LA, int B, int W, int J, int lw, int* out,
                   cudaStream_t s) {
  const int per_block = kThreads / 32;
  wband_kernel<CPL><<<(B + per_block - 1) / per_block, kThreads, 0, s>>>(
      a, b, d0, len, codes, LA, B, W, J, lw, out);
  return cudaGetLastError();
}

}  // namespace

// 1 <= W <= 512; out is [5, B] int32 (cost, i0, iend, jend, win).  The
// wrapper checks the band.
extern "C" int phasm_wband(const int* a_oid, const int* b_oid, const int* d0,
                           const int* lengths, const uint8_t* codes, int LA, int B, int W,
                           int J, int* out, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  int lw = 7;
  while ((1 << lw) < W) ++lw;  // pack = max(128, next_pow2(W))
  if (W < 1 || W > 512) return (int)cudaErrorInvalidValue;
  if (W <= 64) return launch<2>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
  if (W <= 128) return launch<4>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
  if (W <= 256) return launch<8>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
  return launch<16>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
}
