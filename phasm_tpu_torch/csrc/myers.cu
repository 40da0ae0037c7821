// Myers bit-vector block-band overlap kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels phasm_tpu/overlap/myers_pallas.py::_make_myers_fwd
// (kernel 1, forward pass) and ::_make_myers_rev (kernel 2, reverse start
// recovery), in their plain and tab2 variants.  Semantics are those of the
// jnp cores phasm_tpu/overlap/myers.py::myers_fwd_core / myers_rev_core,
// which the plain torch twin phasm_tpu_torch/overlap/myers.py mirrors; both
// kernels are held equal to that twin, integer for integer.
//
// What bounds it on this card: integer ALU work.  Per pair and column the
// forward pass runs ~17 dependent 32-bit ops on each of K = K_of(W) band
// words (5 at W=64, 7 at W=128; the reverse pass rev_K = K+3 words); the
// bytes read are one code byte per column plus K 16-byte match-mask words
// per 32 columns, far below the ops.  Design: one pair per thread, the K
// band words and the horizontal carries in registers for the whole column
// loop (no per-column memory traffic besides the b code), the forward Eq
// words loaded straight from the per-oriented-read match-mask table (the
// window is 32-row aligned), the reverse Eq words joined from two adjacent
// words of the reversed-read table with __funnelshift_r (its anchor is not
// aligned), popcounts by __popc, and the windowed band minimum a bit scan at
// mark columns only (1 in 128).  Each thread stops at its own b length: past
// it the reference's columns are inactive and change nothing.
//
// Launch rules: the current stream, no allocation, no synchronisation; the
// C entries return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WB = 32;
constexpr int MBIG = 1 << 28;

__device__ __forceinline__ int k_of(int W) { return (W + 63 + WB - 1) / WB + 1; }

// arithmetic shift == floor division by 32 for negative values too
__device__ __forceinline__ int fwd_anchor(int d0, int W) { return ((d0 - W / 2) >> 5) - 1; }

__device__ __forceinline__ uint32_t select_eq(const uint4& e, int c) {
  return c == 0 ? e.x : c == 1 ? e.y : c == 2 ? e.z : c == 3 ? e.w : 0u;
}

__device__ __forceinline__ uint4 load_word(const uint4* row, int w, int PW) {
  return (w >= 0 && w < PW) ? row[w] : make_uint4(0u, 0u, 0u, 0u);
}

// one Myers word update; hp/hn carry in and out; ph/mh are the pre-shift
// horizontal delta words (bit t: row 32k + t of this column)
__device__ __forceinline__ void word_step(uint32_t eq, uint32_t& pv, uint32_t& mv,
                                          uint32_t& hp, uint32_t& hn,
                                          uint32_t& ph_pre, uint32_t& mh_pre) {
  const uint32_t xv = eq | mv;
  const uint32_t eq2 = eq | hn;
  const uint32_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  ph_pre = ph;
  mh_pre = mh;
  const uint32_t hop = ph >> 31, hon = mh >> 31;
  ph = (ph << 1) | hp;
  mh = (mh << 1) | hn;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  hp = hop;
  hn = hon;
}

template <int K>
__device__ __forceinline__ void shift_band(uint32_t (&VP)[K], uint32_t (&VN)[K]) {
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    VP[k] = VP[k + 1];
    VN[k] = VN[k + 1];
  }
  VP[K - 1] = 0xFFFFFFFFu;
  VN[K - 1] = 0u;
}

template <int K>
__global__ void myers_fwd_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                                 const int* __restrict__ d0s, const int* __restrict__ lengths,
                                 const uint8_t* __restrict__ codes, int LA,
                                 const uint4* __restrict__ peq, int PW, int B, int W, int J,
                                 int* __restrict__ out_cost, int* __restrict__ out_iend,
                                 int* __restrict__ out_jend, int* __restrict__ out_win) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int la = lengths[ao >> 1], lb = lengths[bo >> 1];
  const int NB = J / WB;
  const int m0 = fwd_anchor(d0, W);
  const int la_rel = la - m0 * WB;
  const int neg_floor = la_rel - la;  // rel row r is absolute row r - neg_floor
  const int win_cap = min(lb, la - d0 - W / 2);
  const int kla = max(la_rel - 1, 0) / WB;
  const int tla = max(la_rel - 1, 0) % WB;
  const uint4* prow = peq + (size_t)ao * PW;
  const uint8_t* brow = codes + (size_t)bo * LA;

  uint32_t VP[K], VN[K];
#pragma unroll
  for (int k = 0; k < K; ++k) VP[k] = VN[k] = 0u;
  int s_top = 0, s_bot = 0;
  bool below = la_rel > K * WB;
  int s_la = (la_rel >= 0 && la_rel <= K * WB) ? 0 : MBIG;
  int bc = MBIG, bn = 1 << 30, bi = 0, bj = 0;
  int wprev = 0, wmax = 0, wprev2 = 0, wmax2 = 0;

  const int nblk = min(NB, (lb + WB - 1) / WB);
  for (int blk = 0; blk < nblk; ++blk) {
    uint4 eq4[K];
#pragma unroll
    for (int k = 0; k < K; ++k) eq4[k] = load_word(prow, m0 + blk + k, PW);
    const int kla_rel = kla - blk;
    const bool in_win = la_rel >= blk * WB && la_rel <= (blk + K) * WB && !below;
    const int ncol = min(WB, lb - blk * WB);
    for (int u = 0; u < ncol; ++u) {
      const int j = blk * WB + u;
      const int c = brow[j];
      uint32_t hp = 1u, hn = 0u;
      int dla = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t ph, mh;
        word_step(select_eq(eq4[k], c), VP[k], VN[k], hp, hn, ph, mh);
        if (k == kla_rel) dla = (int)((ph >> tla) & 1u) - (int)((mh >> tla) & 1u);
      }
      s_top += 1;
      s_bot += (int)hp - (int)hn;
      if (la_rel == blk * WB) dla = 1;  // la is the anchor row
      if (in_win) {
        s_la += dla;
        if (s_la < MBIG) {
          const int negsum = -(la_rel + j + 1);
          if (s_la < bc || (s_la == bc && negsum < bn)) {
            bc = s_la; bn = negsum; bi = la_rel; bj = j + 1;
          }
        }
      }
    }

    if ((blk & 3) == 3) {  // windowed band-min mark at jj = (blk + 1) * 32
      const int base = blk * WB;
      int bm = (base >= neg_floor && base <= la_rel) ? s_top : MBIG;
      int val = s_top;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        for (int t = 0; t < WB; ++t) {
          val += (int)((VP[k] >> t) & 1u) - (int)((VN[k] >> t) & 1u);
          const int rel = base + 1 + k * WB + t;
          if (rel >= neg_floor && rel <= la_rel) bm = min(bm, val);
        }
      }
      const bool in_cap = (blk + 1) * WB <= win_cap;
      if ((blk & 7) == 7) {
        if (in_cap) wmax = max(wmax, bm - wprev);
        wprev = bm;
      } else {
        if (in_cap && blk != 3) wmax2 = max(wmax2, bm - wprev2);
        wprev2 = bm;
      }
    }

    if ((blk + 1) * WB < lb) {  // block-end shift, frozen at the pair's lb
      s_top += __popc(VP[0]) - __popc(VN[0]);
      shift_band<K>(VP, VN);
      s_bot += WB;
      const int edge = (blk + 1 + K) * WB;
      if (below && la_rel <= edge) {  // la enters through the new word
        s_la = s_bot - (edge - la_rel);
        below = false;
      }
    }
  }

  // final-column extraction from the frozen band: min cost, ties to the
  // largest row (smallest negsum)
  if (lb <= J) {
    const int anchor = min(max(lb - 1, 0) / WB, NB - 1) * WB;
    int m1 = (anchor >= neg_floor && anchor <= la_rel) ? s_top : MBIG, best_rel = anchor;
    int val = s_top;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (int t = 0; t < WB; ++t) {
        val += (int)((VP[k] >> t) & 1u) - (int)((VN[k] >> t) & 1u);
        const int rel = anchor + 1 + k * WB + t;
        const int cost = (rel >= neg_floor && rel <= la_rel) ? val : MBIG;
        if (cost < m1 || (cost == m1 && rel > best_rel)) { m1 = cost; best_rel = rel; }
      }
    }
    if (m1 < MBIG) {
      const int negsum = -(best_rel + lb);
      if (m1 < bc || (m1 == bc && negsum < bn)) { bc = m1; bn = negsum; bi = best_rel; bj = lb; }
    }
  }
  out_cost[p] = bc;
  out_iend[p] = bi + m0 * WB;
  out_jend[p] = bj;
  out_win[p] = max(wmax, wmax2);
}

template <int K>
__global__ void myers_rev_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                                 const int* __restrict__ d0s, const int* __restrict__ iends,
                                 const int* __restrict__ jends, const int* __restrict__ lengths,
                                 const uint8_t* __restrict__ codes, int LA,
                                 const uint4* __restrict__ peq_rev, int PW, int B, int W, int J,
                                 int* __restrict__ out_cost, int* __restrict__ out_row) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int la = lengths[ao >> 1], lb = lengths[bo >> 1];
  const int iend = iends[p], jend = jends[p];
  const int NB = J / WB;
  // reverse-window anchor (myers.rev_anchor)
  const int m0r = (((iend - jend) - WB * fwd_anchor(d0, W) - WB * k_of(W)) >> 5) - 1;
  const int row_off = m0r * WB;
  // reversed prefix char r is a[iend-1-r] = reversed-table position fbase + r
  const int fbase = la - iend;
  const uint4* rrow = peq_rev + (size_t)ao * PW;
  const uint8_t* brow = codes + (size_t)bo * LA;

  // anchored start D[row, 0] = |row|: VP where the next row is > 0
  uint32_t VP[K], VN[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int tmax = -(row_off + k * WB + 1);  // bits t <= tmax have next row <= 0
    const uint32_t neg = tmax < 0 ? 0u : tmax >= 31 ? 0xFFFFFFFFu : ((1u << (tmax + 1)) - 1u);
    VN[k] = neg;
    VP[k] = ~neg;
  }
  int s_top = row_off < 0 ? -row_off : row_off;

  const int nblk = min(NB, (max(jend, 0) + WB - 1) / WB);
  for (int blk = 0; blk < nblk; ++blk) {
    uint4 eq4[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int wr = m0r + blk + k;  // reversed rows [32 wr, 32 wr + 32)
      if (wr < 0) {
        eq4[k] = make_uint4(0u, 0u, 0u, 0u);  // below the reversed prefix
      } else {
        const int bit = fbase + wr * WB;
        const int w0 = bit >> 5, sh = bit & 31;
        const uint4 lo = load_word(rrow, w0, PW), hi = load_word(rrow, w0 + 1, PW);
        eq4[k] = make_uint4(__funnelshift_r(lo.x, hi.x, sh), __funnelshift_r(lo.y, hi.y, sh),
                            __funnelshift_r(lo.z, hi.z, sh), __funnelshift_r(lo.w, hi.w, sh));
      }
    }
    const int ncol = min(WB, jend - blk * WB);
    for (int u = 0; u < ncol; ++u) {
      const int src = jend - 1 - (blk * WB + u);  // reversed b prefix
      const int c = src < lb ? brow[src] : 4;
      uint32_t hp = 1u, hn = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t ph, mh;
        word_step(select_eq(eq4[k], c), VP[k], VN[k], hp, hn, ph, mh);
      }
      s_top += 1;
    }
    if ((blk + 1) * WB < jend) {
      s_top += __popc(VP[0]) - __popc(VN[0]);
      shift_band<K>(VP, VN);
    }
  }

  // frozen-state extraction: min cost, ties to the LARGEST reverse row
  const int anchor = (max(jend - 1, 0) / WB) * WB + row_off;
  int bc = (anchor >= 0 && anchor <= iend) ? s_top : MBIG, br = anchor;
  int val = s_top;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int t = 0; t < WB; ++t) {
      val += (int)((VP[k] >> t) & 1u) - (int)((VN[k] >> t) & 1u);
      const int row = anchor + 1 + k * WB + t;
      const int cost = (row >= 0 && row <= iend) ? val : MBIG;
      if (cost < bc || (cost == bc && row > br)) { bc = cost; br = row; }
    }
  }
  out_cost[p] = bc;
  out_row[p] = br;
}

constexpr int kThreads = 128;

template <int K>
cudaError_t launch_fwd(const int* a, const int* b, const int* d0, const int* len,
                       const uint8_t* codes, int LA, const uint4* peq, int PW, int B, int W,
                       int J, int* c, int* ie, int* je, int* wn, cudaStream_t s) {
  myers_fwd_kernel<K><<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a, b, d0, len, codes, LA, peq, PW, B, W, J, c, ie, je, wn);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_rev(const int* a, const int* b, const int* d0, const int* ie, const int* je,
                       const int* len, const uint8_t* codes, int LA, const uint4* peq, int PW,
                       int B, int W, int J, int* c, int* row, cudaStream_t s) {
  myers_rev_kernel<K><<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a, b, d0, ie, je, len, codes, LA, peq, PW, B, W, J, c, row);
  return cudaGetLastError();
}

int host_k_of(int W) { return (W + 63 + WB - 1) / WB + 1; }

}  // namespace

// W must satisfy 4 <= K_of(W) <= 7 (W <= 128); the wrapper checks it.
extern "C" int phasm_myers_fwd(const int* a_oid, const int* b_oid, const int* d0,
                               const int* lengths, const uint8_t* codes, int LA,
                               const uint32_t* peq, int PW, int B, int W, int J, int* cost,
                               int* iend, int* jend, int* win, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = reinterpret_cast<const uint4*>(peq);
  switch (host_k_of(W)) {
    case 4: return launch_fwd<4>(a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    case 5: return launch_fwd<5>(a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    case 6: return launch_fwd<6>(a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    case 7: return launch_fwd<7>(a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int phasm_myers_rev(const int* a_oid, const int* b_oid, const int* d0,
                               const int* iend, const int* jend, const int* lengths,
                               const uint8_t* codes, int LA, const uint32_t* peq_rev, int PW,
                               int B, int W, int J, int* cost, int* best_row, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = reinterpret_cast<const uint4*>(peq_rev);
  switch (host_k_of(W) + 3) {  // rev_K(W) = K_of(W) + 3
    case 7: return launch_rev<7>(a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    case 8: return launch_rev<8>(a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    case 9: return launch_rev<9>(a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    case 10: return launch_rev<10>(a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
