// W-band semiglobal unit-cost overlap kernels for Hopper (sm_90a).
//
// Kernel 3, wband_kernel, replaces the TPU kernel
// phasm_tpu/overlap/extend.py::_make_pallas_extend_seg (the segmented
// cell-per-lane W-band DP over the resident reads).  Kernel 4,
// wband_dense_kernel, replaces phasm_tpu/overlap/extend.py::
// _make_pallas_extend (the single-shot W-band DP over host-staged band
// windows, reached through banded_overlap_pallas).  Both compute
// phasm_tpu/overlap/extend.py::dp_core exactly: the packed band cell
// cost * pack + s_rel with pack = max(128, next_pow2(W)), the BIG = 2^15
// clamp, the i == la and j == lb endpoint reductions with their tie-breaks,
// and the two-grid WINDOW = 256 statistic.  Kernel 3 takes every band W
// from 1 to 512 (the segmented Pallas kernel takes W <= 256), so the 512
// escalation rung runs there too.  Kernel 4 keeps the single-shot kernel's
// contract, W <= 128 (its 7-bit w key field), jmax % 8 == 0, jmax < 32768;
// the wrapper checks it.
//
// What bounds them on this card: integer ALU work and warp shuffles, not
// bytes (one a code and one b code per pair and column, each read once).
//
// Kernel 3's design, wband_pair<CPL, Codes> (templated on its code source,
// ResidentCodes: a and b from the resident [2N, LA] read matrix by
// oriented id, positions outside the read never matching): one warp per
// pair, W/32 adjacent band cells per lane (2, 4, 8, 16 at W = 64, 128,
// 256, 512) holding the packed cell in registers for all J columns, so no
// column segments and no scratch memory; any other band runs in the next
// of those widths with its cells w >= W held invalid, as the cell past the
// band is in dp_core.  Each column costs ~14 int ops per live band cell
// (substitution, diagonal / up minimum, the left prefix minimum in-lane,
// the validity clamp) plus a log2(32)-step cross-lane prefix min per lane.
// The left dependency resolves as an in-lane running min followed by a
// __shfl_up_sync scan of the lane minima; the a codes of the band slide one
// cell per column (one new code per warp per column, passed between lanes
// with __shfl_down_sync).  The warp-wide column minimum is taken only at
// window mark columns (1 in 128), the final-column reduction only at
// j + 1 == lb.  Each warp stops at its own lb: later columns are
// all-invalid in the reference and change nothing.
//
// Kernel 4's design, wband_dense_kernel<CPL, FAST> (its own body, on
// the staged a2 [J + W] / b2 [J] rows, where the 254 / 255 pads come from
// the data).  One pair on a warp left most of each column's cost in fixed
// per-lane work (8 shuffles, two byte loads, a validity compare a cell)
// shared by only 2 cells at W <= 64, so:
//   * several pairs to a warp: LPP = 8 lanes a pair, CPL = 8 cells a lane
//     at W <= 64 and 16 at W <= 128 (4 or 2 pairs a warp); every shuffle
//     takes the segment width, the prefix scan is log2(LPP) steps;
//   * each pair stops at its last live column, min(J, lb, la - d0 + W/2):
//     past it every band cell lies on a row past la, so no endpoint fires and
//     no window mark counts (on c4's J = 4096 buckets every pair has such
//     columns, ~40 % of min(J, lb) in all); the warp's column loop runs to
//     its longest pair, pairs launched in column order of their live
//     columns (extend.py column_order, dense_live_cols) so a warp's pairs
//     are about as long;
//   * the cell as U = P - (w - 2) * pack, so that the recurrence is five
//     integer instructions a cell with Hopper's fused add-min
//     (__viaddmin_s32 twice, __vimin3_s32 for the exclusive prefix and the
//     BIG clamp, a compare and a select for the substitution; ptxas moves
//     the chain's + 2 * pack to an IMAD) and no validity compare:
//     band rows < 0 hold BIG from the first column on (they read only
//     rows below them), and rows past la or columns past lb never reach a
//     valid cell, so dp_core's mask changes no value that is read;
//   * the endpoint tests (the i == la cell, the j + 1 == lb column
//     minimum) run only in the 8-column steps where some pair of the warp
//     has row la in its band or its last column (a warp vote a step;
//     extend.py dense_quiet_steps is the same predicate), window marks
//     once a step (128 % 8 == 0);
//   * codes from registers: the column loop is unrolled by 8 (J % 8 == 0);
//     a lane loads the CPL + 7 a codes its cells read over the 8 columns
//     and the pair's 8 b codes as 8-byte words (rows are 8-byte aligned at
//     W = 64 and 128), so no code is shuffled and no byte loaded a column.
//     Other bands load bytes and hold cells w >= W invalid every column.
// What bounds kernel 4 now: the same integer work, 5 instructions a live
// cell plus ~11 a lane a column (shuffles, scan mins, selects); with fewer
// warps than schedulers (c3's 1,956 pairs at 4 a warp), a column's
// dependent chain instead (the in-lane prefix min, then four shuffles).
//
// Launch rules: the current stream, no allocation, no synchronisation; the
// C entries return cudaGetLastError().

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BIG = 1 << 15;
constexpr int BIGK = 1 << 30;
constexpr int WINDOW = 256;

// Kernel 3's code source: the pair's rows of the resident read matrix.
// Band column t (cell w at DP column j reads t = j + w) is a position
// d0 + t - W/2 of a; positions outside the read never match (254).
struct ResidentCodes {
  const uint8_t* arow;
  const uint8_t* brow;
  int la, lo;  // lo = d0 - W/2: a position of band column 0
  __device__ __forceinline__ int a(int t) const {
    const int i = lo + t;
    return (i >= 0 && i < la) ? (int)arow[i] : 254;
  }
  __device__ __forceinline__ int b(int j) const { return brow[j]; }
};

// The DP of one pair on one warp (see the header); lane 0 writes the
// pair's (cost, i0, iend, jend, win) column p of out [5, B].
template <int CPL, class Codes>  // band cells per lane: 32 * CPL cells, the first W of them live
__device__ __forceinline__ void wband_pair(const Codes& codes, int la, int lb, int d0, int W,
                                           int J, int lw, int lane, int p, int B,
                                           int* __restrict__ out) {
  constexpr int WC = 32 * CPL;
  const int half = W / 2;
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
    ac[c] = codes.a(w);  // a code read by cell w at column 0
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
    const int bc = codes.b(j);
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
    if (lane == 31) next0 = codes.a(j + WC);  // cell WC - 1 at column j + 1
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

template <int CPL>
__global__ void wband_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                             const int* __restrict__ d0s, const int* __restrict__ lengths,
                             const uint8_t* __restrict__ codes, int LA, int B, int W, int J,
                             int lw, int* __restrict__ out) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= B) return;  // whole warps exit together
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int la = lengths[ao >> 1], lb = lengths[bo >> 1];
  const ResidentCodes src{codes + (size_t)ao * LA, codes + (size_t)bo * LA, la, d0 - W / 2};
  wband_pair<CPL>(src, la, lb, d0, W, J, lw, threadIdx.x & 31, p, B, out);
}

constexpr int kThreads = 256;  // 8 pairs per block

int pack_bits(int W) {  // pack = max(128, next_pow2(W))
  int lw = 7;
  while ((1 << lw) < W) ++lw;
  return lw;
}

template <int CPL>
cudaError_t launch(const int* a, const int* b, const int* d0, const int* len,
                   const uint8_t* codes, int LA, int B, int W, int J, int lw, int* out,
                   cudaStream_t s) {
  const int per_block = kThreads / 32;
  wband_kernel<CPL><<<(B + per_block - 1) / per_block, kThreads, 0, s>>>(
      a, b, d0, len, codes, LA, B, W, J, lw, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 4 (see the header): LPP lanes a pair, CPL cells a lane, 32 / LPP
// pairs a warp.  FAST: W == LPP * CPL (64 or 128) and 8-byte aligned a2 /
// b2, so every code load is a vector load and no cell lies past the band;
// any other band or alignment loads bytes and holds cells w >= W invalid.

constexpr int kDenseThreads = 128;
// Lanes a pair.  Phase 5 of chip_smoke.py, H100 80GB HBM3 at 700 W,
// 30-launch means, 8 against 16 lanes a pair: c4 W64 J4096 3.343 against
// 3.991 ms, c3 W64 J12288 (1,956 pairs, ~1 warp a scheduler at 4 pairs a
// warp) 1.412 against 1.480, c4 W128 J4096 6.309 against 6.595; so 8 at
// every band and every M.
constexpr int LPP = 8;

// The codes of one 8-column step j8..j8+7: the CPL + 7 a codes the lane's
// cells read (cell c at column j8 + jj reads ak[jj + c] = a2[t0 + jj + c],
// t0 = j8 + w0) and the pair's 8 b codes.  Only cells w >= W read past the
// row's end (t >= na = J + W); the byte path clamps those reads to the row,
// since such cells are held invalid whatever they read.
template <int CPL, bool FAST>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ arow,
                                           const uint8_t* __restrict__ brow, int t0, int j8,
                                           int na, int (&ak)[CPL + 7], int (&bk)[8]) {
  if constexpr (FAST) {
    // t0 is a multiple of 8 (CPL = 4: of 4) in a row that starts 8-byte
    // aligned; the last word ends at t0 + CPL + 7 <= J + W - 1, in the row
    uint32_t wd[(CPL + 8) / 4];
    if constexpr (CPL % 8 == 0) {
#pragma unroll
      for (int k = 0; k < (CPL + 8) / 8; ++k) {
        const uint2 v = *reinterpret_cast<const uint2*>(arow + t0 + 8 * k);
        wd[2 * k] = v.x;
        wd[2 * k + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < (CPL + 8) / 4; ++k) wd[k] = *reinterpret_cast<const uint32_t*>(arow + t0 + 4 * k);
    }
#pragma unroll
    for (int k = 0; k < CPL + 7; ++k) ak[k] = (wd[k >> 2] >> (8 * (k & 3))) & 0xFF;
    const uint2 bv = *reinterpret_cast<const uint2*>(brow + j8);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) bk[jj] = ((jj < 4 ? bv.x : bv.y) >> (8 * (jj & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int k = 0; k < CPL + 7; ++k) ak[k] = arow[min(t0 + k, na - 1)];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) bk[jj] = brow[j8 + jj];
  }
}

// One warp runs 32 / LPP pairs, slots order[k] in launch order; lane q of a
// pair's segment holds band cells w0 = q * CPL .. w0 + CPL - 1 as
// U = P - (w - 2) * pack (P: dp_core's packed cell), so that the diagonal
// and up candidates are one add-and-min each:
//   y[w] = min(U[w] + (mismatch ? -pack : -2 * pack), U[w + 1]) = min(diag, up) - w * pack
// then U' = min(prefix min over w' <= w of y[w'] + 2 * pack, BIG clamp).
template <int CPL, bool FAST>
__global__ void __launch_bounds__(kDenseThreads)
    wband_dense_kernel(const int64_t* __restrict__ order, const uint8_t* __restrict__ a2,
                       const uint8_t* __restrict__ b2, const int* __restrict__ las,
                       const int* __restrict__ lbs, const int* __restrict__ d0s, int M, int W,
                       int J, int lw, int* __restrict__ out) {
  constexpr int WC = LPP * CPL;  // band cells a pair holds; FAST: W == WC
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  if ((gt & ~31) / LPP >= M) return;  // whole warps past the last pair exit together
  // a slot past the last pair reruns the last pair of its warp, unwritten
  const int slot = gt / LPP, q = gt & (LPP - 1), w0 = q * CPL;
  const int p = (int)order[min(slot, M - 1)];
  const int la = las[p], lb = lbs[p], d0 = d0s[p];
  const uint8_t* arow = a2 + (size_t)p * (J + W);
  const uint8_t* brow = b2 + (size_t)p * J;
  const int half = W / 2, pack = 1 << lw, BIGPW = BIG << lw;
  const int base = d0 - half;  // i0 = s_rel + base

  int U[CPL], capU[CPL];  // capU: U of an invalid cell (P = BIGPW)
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int w = w0 + c, i = d0 + w - half, off = (w - 2) * pack;
    capU[c] = BIGPW - off;
    U[c] = (w < W && i >= 0 && i <= la) ? w - off : capU[c];
  }
  const int up_pad = BIGPW - (WC - 2) * pack;  // U of cell WC, never valid

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

  // Eight columns j8..j8+7 on codes held in registers.  The recurrence
  // runs unmasked (see the header for why that is exact); ENDS: the two
  // endpoint tests too, in dp_core's order.  Cells w >= W (only when W <
  // LPP * CPL) are held invalid every column, since cell W - 1 reads cell W.
  auto step = [&](auto ends_tag, int j8, const int(&ak)[CPL + 7], const int(&bk)[8]) {
    constexpr bool ENDS = decltype(ends_tag)::value;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j8 + jj;
      int up = __shfl_down_sync(FULL, U[0], 1, LPP);
      if (q == LPP - 1) up = up_pad;
      int x[CPL];  // prefix min of y over the lane's cells, + 2 * pack
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int sub = ak[jj + c] != bk[jj] ? -pack : -2 * pack;
        const int y = __viaddmin_s32(U[c], sub, c + 1 < CPL ? U[c + 1] : up);
        x[c] = c == 0 ? y + 2 * pack : __viaddmin_s32(y, 2 * pack, x[c - 1]);
      }
      // segmented inclusive scan of the lane minima (a lane below off
      // reads its own value), then the exclusive prefix
      int tot = x[CPL - 1];
#pragma unroll
      for (int off = 1; off < LPP; off <<= 1) tot = min(tot, __shfl_up_sync(FULL, tot, off, LPP));
      int excl = __shfl_up_sync(FULL, tot, 1, LPP);
      if (q == 0) excl = INT_MAX;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        U[c] = __vimin3_s32(x[c], excl, capU[c]);
        if constexpr (!FAST) U[c] = c < W - w0 ? U[c] : capU[c];
      }
      if constexpr (ENDS) {
        // endpoint i == la: the one band cell on row la this column (valid
        // while j < lb)
        const int w_la = la - (d0 + (j + 1) - half);
        int mine = 0;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          if (w0 + c == w_la) mine = U[c];
        const int pla = __shfl_sync(FULL, mine, (w_la / CPL) & (LPP - 1), LPP) + (w_la - 2) * pack;
        if (w_la >= 0 && w_la < W && j < lb && pla < BIGPW)
          consider(((pla >> lw) << (lw + 1)) + (W - 1 - w_la + (pla & (pack - 1))), w_la, j);

        // endpoint j + 1 == lb: lexicographic (key, w) min over the
        // column's cells on rows <= la
        if (__any_sync(FULL, j + 1 == lb)) {
          const int hi = la - (d0 + (j + 1) - half + w0);  // cells c <= hi are on rows <= la
          int kmin = BIGK, wmin = W;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int w = w0 + c, P = U[c] + (w - 2) * pack;
            const int k = c <= hi && P < BIGPW
                              ? ((P >> lw) << (lw + 1)) + (W - 1 - w + (P & (pack - 1)))
                              : BIGK;
            if (k < kmin) { kmin = k; wmin = w; }  // cells ascend: first w wins ties
          }
#pragma unroll
          for (int off = LPP / 2; off > 0; off >>= 1) {
            const int k2 = __shfl_xor_sync(FULL, kmin, off, LPP);
            const int w2 = __shfl_xor_sync(FULL, wmin, off, LPP);
            if (k2 < kmin || (k2 == kmin && w2 < wmin)) { kmin = k2; wmin = w2; }
          }
          if (j + 1 == lb) consider(kmin, wmin, j);
        }
      }
    }
  };

  // The 8-column steps in which no endpoint can fire: row la outside the
  // band (the i == la endpoint's columns are ae_hi - W + 1 .. ae_hi) and
  // j + 1 != lb, or the pair has ended (j >= ncol, its live columns:
  // past ae_hi every band cell lies on a row past la).
  // overlap/extend.py dense_live_cols and dense_quiet_steps are the same
  // formulas in plain torch.
  const int ae_hi = la - d0 + half - 1, ae_lo = ae_hi - (W - 1);
  const int ncol = max(0, min(min(J, lb), ae_hi + 1));
  const int end8 = (__reduce_max_sync(FULL, ncol) + 7) & ~7;  // the warp's longest pair
  for (int j8 = 0; j8 < end8; j8 += 8) {
    int ak[CPL + 7], bk[8];
    load_codes<CPL, FAST>(arow, brow, j8 + w0, j8, J + W, ak, bk);
    const bool quiet =
        j8 >= ncol || ((j8 > ae_hi || j8 + 7 < ae_lo) && (unsigned)(lb - 1 - j8) >= 8u);
    if (__all_sync(FULL, quiet))
      step(std::false_type{}, j8, ak, bk);
    else
      step(std::true_type{}, j8, ak, bk);

    // windowed-divergence probe at mark columns (two offset grids); 128 % 8 == 0
    if (((j8 + 8) & (WINDOW / 2 - 1)) == 0) {
      const int j = j8 + 7;
      int cm = INT_MAX;
#pragma unroll
      for (int c = 0; c < CPL; ++c) cm = __viaddmin_s32(U[c], (w0 + c - 2) * pack, cm);
      cm >>= lw;  // the min of P >> lw, every P <= BIGPW
#pragma unroll
      for (int off = LPP / 2; off > 0; off >>= 1) cm = min(cm, __shfl_xor_sync(FULL, cm, off, LPP));
      const bool in_cap = (j + 1) <= win_cap;
      if (((j + 1) & (WINDOW - 1)) == 0) {
        if (in_cap) wmax = max(wmax, cm - wprev);
        wprev = cm;
      } else {
        if (in_cap && (j + 1) != WINDOW / 2) wmax2 = max(wmax2, cm - wprev2);
        wprev2 = cm;
      }
    }
  }

  if (q == 0 && slot < M) {  // no endpoint: BIG, 0, 0, 0 (the initial state)
    out[0 * M + p] = bcost;
    out[1 * M + p] = bi0;
    out[2 * M + p] = bie;
    out[3 * M + p] = bje;
    out[4 * M + p] = max(wmax, wmax2);
  }
}

template <int CPL, bool FAST>
cudaError_t launch_dense(const int64_t* order, const uint8_t* a2, const uint8_t* b2,
                         const int* la, const int* lb, const int* d0, int M, int W, int J,
                         int lw, int* out, cudaStream_t s) {
  const long long threads = (long long)M * LPP;
  wband_dense_kernel<CPL, FAST><<<(int)((threads + kDenseThreads - 1) / kDenseThreads),
                                  kDenseThreads, 0, s>>>(order, a2, b2, la, lb, d0, M, W, J, lw,
                                                         out);
  return cudaGetLastError();
}

template <int WC>  // band cells a pair: 64 or 128
cudaError_t launch_dense_at(bool fast, const int64_t* order, const uint8_t* a2,
                            const uint8_t* b2, const int* la, const int* lb, const int* d0,
                            int M, int W, int J, int lw, int* out, cudaStream_t s) {
  constexpr int CPL = WC / LPP;
  if (fast) return launch_dense<CPL, true>(order, a2, b2, la, lb, d0, M, W, J, lw, out, s);
  return launch_dense<CPL, false>(order, a2, b2, la, lb, d0, M, W, J, lw, out, s);
}

}  // namespace

// 1 <= W <= 512; out is [5, B] int32 (cost, i0, iend, jend, win).  The
// wrapper checks the band.
extern "C" int phasm_wband(const int* a_oid, const int* b_oid, const int* d0,
                           const int* lengths, const uint8_t* codes, int LA, int B, int W,
                           int J, int* out, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int lw = pack_bits(W);
  if (W < 1 || W > 512) return (int)cudaErrorInvalidValue;
  if (W <= 64) return launch<2>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
  if (W <= 128) return launch<4>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
  if (W <= 256) return launch<8>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
  return launch<16>(a_oid, b_oid, d0, lengths, codes, LA, B, W, J, lw, out, s);
}

// a2 uint8 [M, J + W], b2 uint8 [M, J], la/lb/d0 int32 [M]; 1 <= W <= 128,
// J % 8 == 0, J < 32768 (checked by the wrapper); out is [5, M] int32.
// order int64 [M]: the launch order (slot k runs pair order[k]; outputs land
// at the pair's own index).
extern "C" int phasm_wband_dense(const int64_t* order, const uint8_t* a2, const uint8_t* b2,
                                 const int* la, const int* lb, const int* d0, int M, int W,
                                 int J, int* out, void* stream) {
  if (M == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > 128) return (int)cudaErrorInvalidValue;
  const int lw = pack_bits(W);
  // 8 cells a lane at W <= 64 (4 pairs a warp), 16 at W <= 128 (2 pairs)
  const bool fast = (W == 64 || W == 128) && reinterpret_cast<uintptr_t>(a2) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(b2) % 8 == 0;
  if (W <= 64) return launch_dense_at<64>(fast, order, a2, b2, la, lb, d0, M, W, J, lw, out, s);
  return launch_dense_at<128>(fast, order, a2, b2, la, lb, d0, M, W, J, lw, out, s);
}
