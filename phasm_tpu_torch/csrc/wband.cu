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
// from 1 to 512 and any column count J (the segmented Pallas kernel takes
// W <= 256), so the 512 escalation rung runs there too.  Kernel 4 keeps the
// single-shot kernel's contract, W <= 128 (its 7-bit w key field), jmax %
// 8 == 0, jmax < 32768; the wrapper checks it.
//
// What bounds them on this card: integer ALU work and warp shuffles, not
// bytes (one a code and one b code per pair and column, each read once).
//
// One body, wband_body<LPP, CPL, FULLW, Codes>, runs both kernels; they
// differ only in where a lane's codes come from:
//   * kernel 4, StagedCodes: the staged a2 [J + W] / b2 [J] rows, whose
//     254 / 255 pads come from the data; 8-byte loads when W is 64 or 128
//     and the rows are 8-byte aligned, byte loads otherwise;
//   * kernel 3, ResidentCodes: the pair's rows of the resident [2N, LA]
//     matrix by oriented id, band column t at position d0 - W/2 + t of a.
//     Rows and d0 have any alignment, so a lane loads the aligned 8-byte
//     words that cover its bytes and funnels them into place (byte loads
//     instead: 1 to 5 % slower on c4's W64 to W512 J4096 batches, 1 % faster
//     on c3's W64 J12288; chip_smoke.py wband_ms, H100 80GB HBM3 at 700 W);
//     in the steps whose words would leave the matrix (row 0 before its
//     start, the last row past its end) it loads bytes at addresses clamped
//     into it.
//     Positions outside a read keep the matrix's own bytes (the zero pad,
//     a neighbouring row): no valid cell reads them.  A cell on row i reads
//     a[i - 1], and the valid rows are 0..la, where row 0's diagonal comes
//     from row -1, which holds BIG; column j reads b[j], and the valid
//     columns are j < lb.  So no 254 / 255 is needed.
// The body.  One pair on a warp would leave most of each column's cost in
// fixed per-lane work (8 shuffles, two byte loads and a validity compare a
// cell, shared by 2 cells at W <= 64), so:
//   * several pairs to a warp: LPP lanes a pair, CPL cells a lane, 32 / LPP
//     pairs a warp: 8 x 8 at W <= 64 (4 pairs a warp), 8 x 16 at W <= 128
//     (2), and for kernel 3 16 x 16 at W <= 256 (2) and 32 x 16 at W <= 512
//     (1); every shuffle takes the segment width, the prefix scan is
//     log2(LPP) steps.  16 cells a lane at most: 158 registers at 16 cells
//     (kernel 3, full band) with no spill; 32 would about double that.
//     Any other band runs in the next width with its cells w >= W held
//     invalid (FULLW false), as the cell past the band is in dp_core;
//   * each pair stops at its last live column, min(J, lb, la - d0 + W/2):
//     past it every band cell lies on a row past la, so no endpoint fires and
//     no window mark counts (on c4's J = 4096 buckets every pair has such
//     columns, 40 to 55 % of min(J, lb) in all); the warp's column loop runs
//     to its longest pair, pairs launched in column order of their live
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
//   * codes from registers: the column loop is unrolled by 8; a lane loads
//     the CPL + 7 a codes its cells read over the 8 columns and the pair's
//     8 b codes once a step, so no code is shuffled and no byte loaded a
//     column.  A step may run past J when J % 8 != 0 (kernel 3): the i ==
//     la endpoint is taken only at j < min(lb, J), the j + 1 == lb one only
//     when lb <= J, and window marks only up to J, as in dp_core's loop.
// The packed cell and its keys hold to W = 512: lw = 9 there, BIGPW =
// 2^15 * pack = 2^24 and U's offset (w - 2) * pack < 2^18, so every cell
// and sum stays far inside int32; an endpoint key is cost << (lw + 1) |
// (W - 1 - w + s_rel), whose low field (at most 2W - 2) fits its lw + 1
// bits, and cost <= 2^15 keeps the key under BIGK = 2^30.
// What bounds the body now: the same integer work, 5 instructions a live
// cell plus ~11 to ~15 a lane a column (shuffles, scan mins, selects; more
// at 16 and 32 lanes a pair); with fewer warps than schedulers (c3's 1,956
// pairs at 4 a warp), a column's dependent chain instead (the in-lane
// prefix min, then the shuffle scan).
//
// Launch rules: the current stream, no allocation, no synchronisation; the
// C entries return cudaGetLastError().  With PHASM_HOST_SHIM defined (a
// header that supplies the CUDA built-ins and the warp collectives on the
// host, csrc/host_warp_shim.h) the file builds with a host compiler and the
// launches run each warp's lanes as fibers that meet at every collective:
// tests/test_torch_wband_hostbuild.py holds it to the plain versions.

#include <climits>
#include <cstdint>
#include <type_traits>
#ifndef PHASM_HOST_SHIM
#include <cuda_runtime.h>
#define PHASM_LAUNCH(kernel, grid, block, stream) kernel<<<grid, block, 0, stream>>>
#endif

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BIG = 1 << 15;
constexpr int BIGK = 1 << 30;
constexpr int WINDOW = 256;
constexpr int kThreads = 128;

int pack_bits(int W) {  // pack = max(128, next_pow2(W))
  int lw = 7;
  while ((1 << lw) < W) ++lw;
  return lw;
}

// ---------------------------------------------------------------------------
// Code sources.  load(j8, ak, bk) gives the codes of one 8-column step
// j8..j8+7: the CPL + 7 a codes the lane's cells read (cell c at column
// j8 + jj reads ak[jj + c], band column j8 + jj + w0 + c) and the pair's 8 b
// codes.

// Kernel 4: the staged a2 [J + W] / b2 [J] rows.  FAST: 8-byte aligned rows
// (band column t0 = j8 + w0 is a multiple of 8).  Only cells w >= W read past
// the row's end (t >= na = J + W); the byte path clamps those reads to the
// row, since such cells are held invalid whatever they read.
template <int CPL, bool FAST>
struct StagedCodes {
  const uint8_t* __restrict__ arow;
  const uint8_t* __restrict__ brow;
  int w0, na;

  __device__ __forceinline__ void load(int j8, int (&ak)[CPL + 7], int (&bk)[8]) const {
    const int t0 = j8 + w0;
    if constexpr (FAST) {
      // the last word ends at t0 + CPL + 7 <= J + W - 1, in the row
      uint32_t wd[(CPL + 8) / 4];
#pragma unroll
      for (int k = 0; k < (CPL + 8) / 8; ++k) {
        const uint2 v = *reinterpret_cast<const uint2*>(arow + t0 + 8 * k);
        wd[2 * k] = v.x;
        wd[2 * k + 1] = v.y;
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
};

// out[k] = byte s + k (s in 0..7) of the little-endian word stream h
template <int N, int NH>
__device__ __forceinline__ void unpack_bytes(const uint32_t (&h)[NH], int s, int (&out)[N]) {
  constexpr int NO = (N + 3) / 4;  // output words
  static_assert(NO + 2 <= NH, "the stream must hold the bytes from any s");
  const bool up = s >= 4;
  const int sh = 8 * (s & 3);
  uint32_t g[NO + 1];
#pragma unroll
  for (int m = 0; m <= NO; ++m) g[m] = up ? h[m + 1] : h[m];
#pragma unroll
  for (int m = 0; m < NO; ++m) {
    const uint32_t v = __funnelshift_r(g[m], g[m + 1], sh);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * m + i < N) out[4 * m + i] = (v >> (8 * i)) & 0xFF;
  }
}

// Kernel 3: the pair's rows of the resident matrix (n bytes at codes).  A
// step moves both rows by 8 bytes, so each row's byte shift within its
// aligned words is fixed: a lane holds the word pointers at j8 = 0 and the
// shifts.  The steps j8 in [jlo, jhi) load aligned words wholly inside the
// matrix (NA words of a, 2 of b); the others load bytes at offsets clamped
// into it.
template <int CPL>
struct ResidentCodes {
  static constexpr int NA = (CPL + 13) / 8 + 1;  // a words: CPL + 7 bytes at any shift
  const uint8_t* codes;
  long long n;
  const uint8_t* pa;  // the word of the lane's first a code at j8 = 0
  const uint8_t* pb;  // the word of b[0]
  int sa, sb, jlo, jhi;

  // a_pos, b_pos: offsets in the matrix of the lane's first a code and of
  // b[0] at j8 = 0 (a_pos may lie before the matrix)
  __device__ __forceinline__ ResidentCodes(const uint8_t* codes_, long long n_, long long a_pos,
                                           long long b_pos)
      : codes(codes_), n(n_) {
    const long long mis = (long long)(reinterpret_cast<uintptr_t>(codes) & 7);
    const long long a0 = mis + a_pos, b0 = mis + b_pos;  // offsets from codes - mis
    pa = codes + ((a0 & ~7LL) - mis);
    pb = codes + ((b0 & ~7LL) - mis);
    sa = (int)(a0 & 7);
    sb = (int)(b0 & 7);
    // words [w, w + 8) with lo_ok <= w and w + 8 <= hi_ok lie in the matrix;
    // floor8(x) >= L <=> x >= L and floor8(x) <= K <=> x < K + 8 (L, K
    // multiples of 8)
    const long long lo_ok = (mis + 7) & ~7LL, hi_ok = (mis + n) & ~7LL;
    const long long lo = max(lo_ok - a0, lo_ok - b0);
    const long long hi = min(hi_ok - 8 * NA + 8 - a0, hi_ok - 8 - b0);
    jlo = (int)min(max(lo, 0LL), (long long)INT_MAX);
    jhi = (int)max(min(hi, (long long)INT_MAX), 0LL);
  }

  __device__ __forceinline__ void load(int j8, int (&ak)[CPL + 7], int (&bk)[8]) const {
    if (j8 >= jlo && j8 < jhi) {
      uint32_t ha[2 * NA], hb[4];
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        const uint2 v = *reinterpret_cast<const uint2*>(pa + j8 + 8 * k);
        ha[2 * k] = v.x;
        ha[2 * k + 1] = v.y;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint2 v = *reinterpret_cast<const uint2*>(pb + j8 + 8 * k);
        hb[2 * k] = v.x;
        hb[2 * k + 1] = v.y;
      }
      unpack_bytes<CPL + 7>(ha, sa, ak);
      unpack_bytes<8>(hb, sb, bk);
    } else {
      const long long oa = (pa - codes) + sa + j8, ob = (pb - codes) + sb + j8;
#pragma unroll
      for (int k = 0; k < CPL + 7; ++k) ak[k] = codes[min(max(oa + k, 0LL), n - 1)];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) bk[jj] = codes[min(max(ob + jj, 0LL), n - 1)];
    }
  }
};

// ---------------------------------------------------------------------------
// The DP of the pair on this lane's LPP-lane segment (see the header); lane
// q holds band cells w0 = q * CPL .. w0 + CPL - 1 as U = P - (w - 2) * pack
// (P: dp_core's packed cell), so that the diagonal and up candidates are
// one add-and-min each:
//   y[w] = min(U[w] + (mismatch ? -pack : -2 * pack), U[w + 1]) = min(diag, up) - w * pack
// then U' = min(prefix min over w' <= w of y[w'] + 2 * pack, BIG clamp).
// store: write the pair's (cost, i0, iend, jend, win) to column p of out
// [5, M].  Every lane of the warp calls it (the shuffles take the full mask).
template <int LPP, int CPL, bool FULLW, class Codes>
__device__ __forceinline__ void wband_body(const Codes& src, int la, int lb, int d0, int W,
                                           int J, int lw, int q, bool store, int p, int M,
                                           int* __restrict__ out) {
  constexpr int WC = LPP * CPL;  // band cells a pair holds; FULLW: W == WC
  const int w0 = q * CPL;
  const int half = W / 2, pack = 1 << lw, BIGPW = BIG << lw;
  const int base = d0 - half;  // i0 = s_rel + base
  // dp_core's loop ends at column J: the i == la endpoint needs j <
  // min(lb, J), the j + 1 == lb one lb <= J (lb_end -1 never matches)
  const int lbj = min(lb, J), lb_end = lb <= J ? lb : -1;

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
  const int win_cap = min(lbj, la - d0 - half);

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
        if constexpr (!FULLW) U[c] = c < W - w0 ? U[c] : capU[c];
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
        if (w_la >= 0 && w_la < W && j < lbj && pla < BIGPW)
          consider(((pla >> lw) << (lw + 1)) + (W - 1 - w_la + (pla & (pack - 1))), w_la, j);

        // endpoint j + 1 == lb: lexicographic (key, w) min over the
        // column's cells on rows <= la
        if (__any_sync(FULL, j + 1 == lb_end)) {
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
          if (j + 1 == lb_end) consider(kmin, wmin, j);
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
  const int ncol = max(0, min(lbj, ae_hi + 1));
  const int end8 = (__reduce_max_sync(FULL, ncol) + 7) & ~7;  // the warp's longest pair
  for (int j8 = 0; j8 < end8; j8 += 8) {
    int ak[CPL + 7], bk[8];
    src.load(j8, ak, bk);
    const bool quiet =
        j8 >= ncol || ((j8 > ae_hi || j8 + 7 < ae_lo) && (unsigned)(lb_end - 1 - j8) >= 8u);
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

  if (store) {  // no endpoint: BIG, 0, 0, 0 (the initial state)
    out[0 * M + p] = bcost;
    out[1 * M + p] = bi0;
    out[2 * M + p] = bie;
    out[3 * M + p] = bje;
    out[4 * M + p] = max(wmax, wmax2);
  }
}

// Both kernels: one warp runs 32 / LPP pairs, slots order[k] in launch
// order; a slot past the last pair reruns the last pair of its warp,
// unwritten.  Whole warps past the last pair exit together.

// Kernel 3: pairs by oriented id against the resident [n_o, LA] matrix.
template <int LPP, int CPL, bool FULLW>
__device__ __forceinline__ void wband_resident(const int64_t* __restrict__ order,
                                               const int* __restrict__ a_oid,
                                               const int* __restrict__ b_oid,
                                               const int* __restrict__ d0s,
                                               const int* __restrict__ lengths,
                                               const uint8_t* __restrict__ codes, long long n,
                                               int LA, int M, int W, int J, int lw,
                                               int* __restrict__ out) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  if ((gt & ~31) / LPP >= M) return;
  const int slot = gt / LPP, q = gt & (LPP - 1);
  const int p = (int)order[min(slot, M - 1)];
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int la = lengths[ao >> 1], lb = lengths[bo >> 1];
  const ResidentCodes<CPL> src(codes, n, (long long)ao * LA + (d0 - W / 2) + q * CPL,
                               (long long)bo * LA);
  wband_body<LPP, CPL, FULLW>(src, la, lb, d0, W, J, lw, q, q == 0 && slot < M, p, M, out);
}

#define WBAND_KERNEL_ARGS                                                                    \
  const int64_t *__restrict__ order, const int *__restrict__ a_oid,                         \
      const int *__restrict__ b_oid, const int *__restrict__ d0s,                           \
      const int *__restrict__ lengths, const uint8_t *__restrict__ codes, long long n, int LA, \
      int M, int W, int J, int lw, int *__restrict__ out

// W == LPP * CPL (64, 128, 256, 512): ptxas's own register count (96 at 8
// cells a lane, 158 at 16), no spill
template <int LPP, int CPL>
__global__ void __launch_bounds__(kThreads) wband_kernel(WBAND_KERNEL_ARGS) {
  wband_resident<LPP, CPL, true>(order, a_oid, b_oid, d0s, lengths, codes, n, LA, M, W, J, lw,
                                 out);
}

// A narrower band: the per-cell mask of the cells past it takes ~60 more
// registers at 16 cells a lane, and under ptxas's own cap (168) it spilled;
// at one block an SM at least, it does not (226 registers).
template <int LPP, int CPL>
__global__ void __launch_bounds__(kThreads, 1) wband_masked_kernel(WBAND_KERNEL_ARGS) {
  wband_resident<LPP, CPL, false>(order, a_oid, b_oid, d0s, lengths, codes, n, LA, M, W, J, lw,
                                  out);
}

// Kernel 4: 8 lanes a pair on the staged windows.  FAST: W == 8 * CPL (64
// or 128) and 8-byte aligned a2 / b2, so every code load is a vector load
// and no cell lies past the band.
// Lanes a pair.  Phase 5 of chip_smoke.py, H100 80GB HBM3 at 700 W,
// 30-launch means, 8 against 16 lanes a pair: c4 W64 J4096 3.343 against
// 3.991 ms, c3 W64 J12288 (1,956 pairs, ~1 warp a scheduler at 4 pairs a
// warp) 1.412 against 1.480, c4 W128 J4096 6.309 against 6.595; so 8 at
// every band and every M.
constexpr int LPP4 = 8;

template <int CPL, bool FAST>
__global__ void __launch_bounds__(kThreads)
    wband_dense_kernel(const int64_t* __restrict__ order, const uint8_t* __restrict__ a2,
                       const uint8_t* __restrict__ b2, const int* __restrict__ las,
                       const int* __restrict__ lbs, const int* __restrict__ d0s, int M, int W,
                       int J, int lw, int* __restrict__ out) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  if ((gt & ~31) / LPP4 >= M) return;
  const int slot = gt / LPP4, q = gt & (LPP4 - 1);
  const int p = (int)order[min(slot, M - 1)];
  const StagedCodes<CPL, FAST> src{a2 + (size_t)p * (J + W), b2 + (size_t)p * J, q * CPL, J + W};
  wband_body<LPP4, CPL, FAST>(src, las[p], lbs[p], d0s[p], W, J, lw, q, q == 0 && slot < M, p,
                              M, out);
}

unsigned blocks_of(int M, int lpp) {
  return (unsigned)(((long long)M * lpp + kThreads - 1) / kThreads);
}

template <int LPP, int CPL>  // a band of LPP * CPL cells, or fewer
cudaError_t launch_at(int W, const int64_t* order, const int* a, const int* b, const int* d0,
                      const int* len, const uint8_t* codes, long long n, int LA, int M, int J,
                      int lw, int* out, cudaStream_t s) {
  const auto kernel = W == LPP * CPL ? wband_kernel<LPP, CPL> : wband_masked_kernel<LPP, CPL>;
  PHASM_LAUNCH(kernel, blocks_of(M, LPP), kThreads, s)(
      order, a, b, d0, len, codes, n, LA, M, W, J, lw, out);
  return cudaGetLastError();
}

template <int CPL, bool FAST>
cudaError_t launch_dense(const int64_t* order, const uint8_t* a2, const uint8_t* b2,
                         const int* la, const int* lb, const int* d0, int M, int W, int J,
                         int lw, int* out, cudaStream_t s) {
  const auto kernel = wband_dense_kernel<CPL, FAST>;
  PHASM_LAUNCH(kernel, blocks_of(M, LPP4), kThreads, s)(
      order, a2, b2, la, lb, d0, M, W, J, lw, out);
  return cudaGetLastError();
}

template <int WC>  // band cells a pair: 64 or 128
cudaError_t launch_dense_at(bool fast, const int64_t* order, const uint8_t* a2,
                            const uint8_t* b2, const int* la, const int* lb, const int* d0,
                            int M, int W, int J, int lw, int* out, cudaStream_t s) {
  constexpr int CPL = WC / LPP4;
  if (fast) return launch_dense<CPL, true>(order, a2, b2, la, lb, d0, M, W, J, lw, out, s);
  return launch_dense<CPL, false>(order, a2, b2, la, lb, d0, M, W, J, lw, out, s);
}

}  // namespace

// codes uint8 [n_o, LA] (the resident matrix), lengths int32 [n_o / 2];
// a_oid / b_oid / d0 int32 [B]; order int64 [B]: the launch order (slot k
// runs pair order[k]; outputs land at the pair's own index).  1 <= W <=
// 512 (the wrapper checks it too), any J; out is [5, B] int32 (cost, i0,
// iend, jend, win).
extern "C" int phasm_wband(const int64_t* order, const int* a_oid, const int* b_oid,
                           const int* d0, const int* lengths, const uint8_t* codes, int n_o,
                           int LA, int B, int W, int J, int* out, void* stream) {
  if (W < 1 || W > 512) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int lw = pack_bits(W);
  const long long n = (long long)n_o * LA;
  // lanes a pair x cells a lane: 8 x 8 (4 pairs a warp), 8 x 16 (2), 16 x 16 (2), 32 x 16 (1)
  if (W <= 64) return launch_at<8, 8>(W, order, a_oid, b_oid, d0, lengths, codes, n, LA, B, J, lw, out, s);
  if (W <= 128) return launch_at<8, 16>(W, order, a_oid, b_oid, d0, lengths, codes, n, LA, B, J, lw, out, s);
  if (W <= 256) return launch_at<16, 16>(W, order, a_oid, b_oid, d0, lengths, codes, n, LA, B, J, lw, out, s);
  return launch_at<32, 16>(W, order, a_oid, b_oid, d0, lengths, codes, n, LA, B, J, lw, out, s);
}

// a2 uint8 [M, J + W], b2 uint8 [M, J], la/lb/d0 int32 [M]; 1 <= W <= 128,
// J % 8 == 0, J < 32768 (checked by the wrapper); out is [5, M] int32.
// order int64 [M]: the launch order, as phasm_wband's.
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
