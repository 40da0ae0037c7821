// Myers bit-vector block-band overlap kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels phasm_tpu/overlap/myers_pallas.py::_make_myers_fwd
// (kernel 1, forward pass) and ::_make_myers_rev (kernel 2, reverse start
// recovery): their plain bodies (the resident kernels, and, fed the same
// pre-cut windows, the window kernels) and their tab2 bodies (the tab2
// kernels, which cut their windows out of the blocked table themselves).  Semantics
// are those of the jnp cores phasm_tpu/overlap/myers.py::myers_fwd_core /
// myers_rev_core, which the plain torch twin phasm_tpu_torch/overlap/myers.py
// mirrors; every kernel is held equal to that twin, integer for integer.
//
// What bounds it on this card: integer ALU work.  Per pair and column the
// forward pass runs ~17 32-bit ops on each of K = K_of(W) band words (5 at
// W=64, 7 at W=128; the reverse pass rev_K = K+3 words); the bytes read are
// one code byte per column plus one 16-byte match-mask word per 32 columns,
// far below the ops.  One warp holds too few pairs to hide the latency of
// a word step's dependent ops, so the design is about issue:
//   - one pair per thread, the K band words and the horizontal carries in
//     registers for the whole column loop; one-warp blocks (kThreads), so a
//     batch's warps spread over every SM;
//   - the resident wrappers hand the kernels a column-order permutation
//     (overlap/myers_cuda.py), so the 32 pairs of a warp run loops of about
//     the same length; thread i takes pair order[i] and writes there;
//   - the 32 columns of a full block run as straight-line groups of
//     kGroupCols<K> columns, a wavefront (column j+1's word k issues beside
//     column j's word k+1); the carry between words is the previous word's
//     bit 31, taken with a funnel shift; the plane select is three SELs on
//     predicates worked out once a column, with N / PAD masked inside the
//     word step's LOP3s; the per-column extras are masks and selects, not
//     branches, and D at the band's bottom is summed from the band when la
//     enters it instead of carried every column; a block that the pair's
//     last column cuts short (or whose codes cannot be read as one vector)
//     runs a one-column loop that stops at the pair's own end, so VP/VN
//     freeze there as in the reference;
//   - loads one block ahead, in two steps (issue, then use a block later):
//     the band moves one word a block, so a block needs one new Eq word
//     (forward: one aligned 16-byte table word; reverse: two, joined with
//     __funnelshift_r, as its anchor is not aligned) and 32 b codes
//     (forward: two or three aligned 16-byte loads from the row at any
//     alignment, joined; reverse: the same, read down from jend - 1 and
//     byte-reversed with __byte_perm);
//   - popcounts by __popc; the windowed band minimum a bit scan at mark
//     columns only (1 in 128), and none past the window's cap.
//
// Two sources feed one DP body each (fwd_pair / rev_pair, templated over
// where the Eq words and b codes come from):
//   Resident*  the main path: Eq words from DeviceReads' match-mask tables,
//              b codes from the resident read matrix, per pair thread;
//   Window     the table tier (overlap/myers_cuda.py::myers_compute_tab):
//              the TPU kernels' own inputs, pre-cut pair-last windows
//              (peq [NBLK, 4, B] words, bpk [J/16, B] 2-bit packed codes)
//              made by kernel 5 (csrc/myers_fetch.cu) and rev_prep_tab, in
//              pair order, so neighbouring threads read neighbouring words.
//              Packing maps PAD to code 0; columns j >= lb are gated off, so
//              it is never read (the reference's argument,
//              myers_pallas.py::_pack_b).
//   Tab2*      the tab2 tier (overlap/myers_cuda.py::myers_compute_tab2):
//              each pair thread reads its window words straight out of the
//              blocked table (overlap/myers.py::build_myers_tables_blocked),
//              where the TPU kernel DMAs per-pair coarse row blocks into VMEM
//              and shifts them there.  Forward word k is one 16-byte load
//              (four planes) at word s % 32 + k of the pair's row block; the
//              reverse word k funnels two such loads by the per-pair bit
//              offset, and is 0 below the reversed prefix (k < -m0r); the
//              reverse codes funnel two packed flip-b words.  Every row index
//              is clamped to the range the reference clips it to, so each
//              pair reads what the reference reads.  Batches that would
//              give the slab body more warps than tab2_lanes allows
//              (past 8,448 pairs forward, 12,672 reverse at W64) run these
//              one-pair-a-thread bodies, the forward pass in pair order,
//              the reverse in column order; smaller ones run the slab body
//              below (several lanes a pair, the same table words).
//
// Launch rules: the current stream, no allocation, no synchronisation; the
// C entries return cudaGetLastError().  With PHASM_HOST_SHIM defined (a
// header that supplies the CUDA built-ins and warp collectives on the
// host, csrc/host_warp_shim.h) the file builds with a host compiler and the
// launches run each warp's lanes as fibers that meet at every collective:
// tests/test_torch_myers_hostbuild.py holds it to the plain versions.

#include <cstdint>
#ifndef PHASM_HOST_SHIM
#include <cuda_runtime.h>
#define PHASM_LAUNCH(kernel, grid, block, stream) kernel<<<grid, block, 0, stream>>>
#endif

namespace {

constexpr int WB = 32;
constexpr int MBIG = 1 << 28;
constexpr int F_TAB = 16;  // table front-pad words (overlap/myers.py::F_TAB)
constexpr int BK = 32;     // peq words a blocked-table row (4 planes each)
constexpr int BKB = 128;   // packed-b words a blocked-table row
constexpr int kThreads = 32;  // one warp a block

// Columns of one straight-line group at K band words: 8 up to K = 7 (the
// forward pass), 4 above (the reverse pass's 8 to 10 words), which keeps an
// unrolled group body under ~1,100 instructions.  4 and 8 timed within 1 %
// of each other at K = 7.
template <int K>
constexpr int kGroupCols = K <= 7 ? 8 : 4;

__device__ __forceinline__ int k_of(int W) { return (W + 63 + WB - 1) / WB + 1; }

// arithmetic shift == floor division by 32 for negative values too
__device__ __forceinline__ int fwd_anchor(int d0, int W) { return ((d0 - W / 2) >> 5) - 1; }

// A column's b code as two plane-select bits and a mask: codes past 3 (N,
// PAD) match nothing, so their mask is 0 and the word step ANDs it in
// (inside the LOP3s it already has).  Worked out once a column, used by
// every band word: three SELs a word.  (A four-way select chain with 0 for
// the codes past 3 became divergent branches at rev K = 10 and took 3x.)
struct Code {
  bool b0, b1;
  uint32_t valid;
};

__device__ __forceinline__ Code code_of(int c) {
  return Code{(c & 1) != 0, (c & 2) != 0, c < 4 ? 0xFFFFFFFFu : 0u};
}

// the match word of plane c & 3, before the mask
__device__ __forceinline__ uint32_t select_eq(const uint4& e, const Code& c) {
  return c.b1 ? (c.b0 ? e.w : e.z) : (c.b0 ? e.y : e.x);
}

__device__ __forceinline__ uint4 load_word(const uint4* row, int w, int PW) {
  return (w >= 0 && w < PW) ? row[w] : make_uint4(0u, 0u, 0u, 0u);
}

// 32 bytes at p, any alignment, in two steps, so that a block's loads go
// out a block before their values are used: fetch48 loads the aligned
// 16-byte words from p's 16-byte boundary (the third only when p is not
// aligned, and then it holds byte 31; every word loaded holds a byte of
// [p, p + 32)); join32 picks the 8 little-endian words of [p, p + 32) out
// of them with a word select and a funnel shift.
struct Raw48 {
  uint4 w0, w1, w2;
  int sh;
};

__device__ __forceinline__ void fetch48(const uint8_t* p, Raw48& r) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* w = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  r.sh = (int)(a & 15);
  r.w0 = w[0];
  r.w1 = w[1];
  r.w2 = make_uint4(0u, 0u, 0u, 0u);
  if (r.sh != 0) r.w2 = w[2];
}

__device__ __forceinline__ void join32(const Raw48& r, uint32_t (&y)[8]) {
  const uint32_t x[12] = {r.w0.x, r.w0.y, r.w0.z, r.w0.w, r.w1.x, r.w1.y,
                          r.w1.z, r.w1.w, r.w2.x, r.w2.y, r.w2.z, r.w2.w};
  const int q = r.sh >> 2, sh = 8 * (r.sh & 3);
  uint32_t z[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    z[i] = q == 0 ? x[i] : q == 1 ? x[i + 1] : q == 2 ? x[i + 2] : x[i + 3];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = __funnelshift_r(z[i], z[i + 1], sh);
}

// one Myers word update on match word sel & valid.  ph_c / mh_c: in, the
// previous word's pre-shift horizontal delta words (their bit 31 is the
// carry into this word; the first word gets 0x80000000 / 0); out, this
// word's (bit t: row 32k + t)
__device__ __forceinline__ void word_step(uint32_t sel, uint32_t valid, uint32_t& pv,
                                          uint32_t& mv, uint32_t& ph_c, uint32_t& mh_c) {
  const uint32_t xv = (sel & valid) | mv;
  const uint32_t eq2 = (sel & valid) | (mh_c >> 31);
  const uint32_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
  const uint32_t ph = mv | ~(xh | pv);
  const uint32_t mh = pv & xh;
  const uint32_t phs = __funnelshift_l(ph_c, ph, 1);  // (ph << 1) | carry
  const uint32_t mhs = __funnelshift_l(mh_c, mh, 1);
  pv = mhs | ~(xv | phs);
  mv = phs & xv;
  ph_c = ph;
  mh_c = mh;
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
__device__ __forceinline__ void shift_eq(uint4 (&eq4)[K], const uint4& next) {
#pragma unroll
  for (int k = 0; k < K - 1; ++k) eq4[k] = eq4[k + 1];
  eq4[K - 1] = next;
}

// A block's 32 b codes in registers; code(v) is column G * g + v of the
// block after g calls of next_group<G>().
struct Bytes32 {  // one code a byte
  uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  __device__ __forceinline__ int code(int v) const {
    return (int)((w[v >> 2] >> (8 * (v & 3))) & 0xFFu);
  }
  template <int G>  // a multiple of 4
  __device__ __forceinline__ void next_group() {
#pragma unroll
    for (int i = 0; i < 8 - G / 4; ++i) w[i] = w[i + G / 4];
  }
};

struct Packed32 {  // 2 bits a code, 16 a word
  uint32_t lo = 0u, hi = 0u;
  __device__ __forceinline__ int code(int v) const { return (int)((lo >> (2 * v)) & 3u); }
  template <int G>
  __device__ __forceinline__ void next_group() {
    lo = __funnelshift_r(lo, hi, 2 * G);
    hi >>= 2 * G;
  }
};

// Where a pass reads its inputs, each load in two steps (issue, then use),
// so the next block's loads fly while the current block computes.
//   fetch_eq(q) / eq_of(raw): window word q (rows [32q, 32q + 32) above
//     the pass's anchor), all four planes;
//   vec_ok(blk): block blk's codes may be read as one vector (the pass
//     checks that the block is full);
//   fetch_codes(blk, raw) / codes_of(raw, out): that vector;
//   code(j): the b code of column j, one at a time.

struct ResidentFwd {  // kernel 1 on the main path
  using Codes = Bytes32;
  using CodeRaw = Raw48;
  using EqRaw = uint4;
  const uint4* prow;  // the a row's forward match-mask words
  int PW, m0;
  const uint8_t* brow;
  __device__ __forceinline__ EqRaw fetch_eq(int q) const { return load_word(prow, m0 + q, PW); }
  static __device__ __forceinline__ uint4 eq_of(const EqRaw& e) { return e; }
  __device__ __forceinline__ bool vec_ok(int) const { return true; }
  __device__ __forceinline__ void fetch_codes(int blk, CodeRaw& r) const {
    fetch48(brow + blk * WB, r);
  }
  static __device__ __forceinline__ void codes_of(const CodeRaw& r, Codes& out) {
    join32(r, out.w);
  }
  __device__ __forceinline__ int code(int j) const { return brow[j]; }
};

// A reverse window word: the four planes of (hi:lo) >> sh, the reverse
// anchor being at any bit offset.
struct EqPair {
  uint4 lo, hi;
  int sh;
};

__device__ __forceinline__ uint4 funnel_eq(const EqPair& e) {
  return make_uint4(__funnelshift_r(e.lo.x, e.hi.x, e.sh), __funnelshift_r(e.lo.y, e.hi.y, e.sh),
                    __funnelshift_r(e.lo.z, e.hi.z, e.sh), __funnelshift_r(e.lo.w, e.hi.w, e.sh));
}

struct ResidentRev {  // kernel 2 on the main path
  using Codes = Bytes32;
  using CodeRaw = Raw48;
  using EqRaw = EqPair;
  const uint4* rrow;  // the a row's reversed match-mask words
  int PW, m0r, fbase;
  const uint8_t* brow;
  int jend, lb;
  __device__ __forceinline__ EqRaw fetch_eq(int q) const {
    const int wr = m0r + q;  // reversed rows [32 wr, 32 wr + 32)
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    if (wr < 0) return EqRaw{zero, zero, 0};  // below the reversed prefix
    // reversed prefix char r is a[iend-1-r] = reversed-table position fbase + r
    const int bit = fbase + wr * WB;
    const int w0 = bit >> 5;
    return EqRaw{load_word(rrow, w0, PW), load_word(rrow, w0 + 1, PW), bit & 31};
  }
  static __device__ __forceinline__ uint4 eq_of(const EqRaw& e) { return funnel_eq(e); }
  // the block's highest source lies inside b (its lowest is >= 0 in a full block)
  __device__ __forceinline__ bool vec_ok(int blk) const { return jend - 1 - blk * WB < lb; }
  // sources jend - 32 (blk + 1) .. jend - 1 - 32 blk, upward
  __device__ __forceinline__ void fetch_codes(int blk, CodeRaw& r) const {
    fetch48(brow + jend - (blk + 1) * WB, r);
  }
  static __device__ __forceinline__ void codes_of(const CodeRaw& r, Codes& out) {
    uint32_t y[8];
    join32(r, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) out.w[i] = __byte_perm(y[7 - i], 0u, 0x0123);
  }
  __device__ __forceinline__ int code(int j) const {
    const int src = jend - 1 - j;  // reversed b prefix
    return src < lb ? brow[src] : 4;
  }
};

struct Window {  // the table tier: pair-last windows, pair p of B
  using Codes = Packed32;
  using CodeRaw = Packed32;
  using EqRaw = uint4;
  const uint32_t* peq;
  const int* bpk;
  int B, p;
  __device__ __forceinline__ EqRaw fetch_eq(int q) const {
    const uint32_t* w = peq + (size_t)q * 4 * B + p;
    return make_uint4(w[0], w[B], w[2 * (size_t)B], w[3 * (size_t)B]);
  }
  static __device__ __forceinline__ uint4 eq_of(const EqRaw& e) { return e; }
  __device__ __forceinline__ bool vec_ok(int) const { return true; }
  __device__ __forceinline__ void fetch_codes(int blk, CodeRaw& out) const {
    const int* w = bpk + (size_t)(2 * blk) * B + p;
    out.lo = (uint32_t)w[0];
    out.hi = (uint32_t)w[B];
  }
  static __device__ __forceinline__ void codes_of(const CodeRaw& r, Codes& out) { out = r; }
  __device__ __forceinline__ int code(int j) const {
    return (int)(((uint32_t)bpk[(size_t)(j >> 4) * B + p] >> (2 * (j & 15))) & 3u);
  }
};

// The blocked table's rows: peq rows are 32 words of four planes (uint4),
// packed-b rows 128 words.  clamp: the reference's clip of a row index.
__device__ __forceinline__ int clamp_row(int r, int lo, int hi) { return min(max(r, lo), hi); }

struct Tab2Fwd {  // the tab2 tier's forward pass: pair p's words of the blocked table
  using Codes = Packed32;
  using CodeRaw = Packed32;
  using EqRaw = uint4;
  const uint4* peq;      // the table as peq rows
  const uint32_t* brow;  // the pair's packed forward b row (OFF_BF + b_oid)
  int row0, srem, row_hi;  // a_oid * NBb + s / 32, s % 32 (s = m0 + F_TAB), OFF_R - 1
  __device__ __forceinline__ EqRaw fetch_eq(int q) const {
    const int u = srem + q;
    return peq[(size_t)clamp_row(row0 + (u >> 5), 0, row_hi) * BK + (u & 31)];
  }
  static __device__ __forceinline__ uint4 eq_of(const EqRaw& e) { return e; }
  __device__ __forceinline__ bool vec_ok(int) const { return true; }
  __device__ __forceinline__ void fetch_codes(int blk, CodeRaw& out) const {
    out.lo = brow[2 * blk];
    out.hi = brow[2 * blk + 1];
  }
  static __device__ __forceinline__ void codes_of(const CodeRaw& r, Codes& out) { out = r; }
  __device__ __forceinline__ int code(int j) const {
    return (int)((brow[j >> 4] >> (2 * (j & 15))) & 3u);
  }
};

struct Tab2Rev {  // the tab2 tier's reverse pass
  using Codes = Packed32;
  struct CodeRaw {
    uint32_t z0, z1, z2;
  };
  using EqRaw = EqPair;
  const uint4* peq;
  int row0, qrem, row_lo, row_hi;  // OFF_R + a_oid * NBb + q0 / 32, q0 % 32, OFF_R, OFF_BF - 1
  int negm0r, delta;               // words k < -m0r are 0; the window's bit offset % 32
  const uint32_t* bpk;             // the table as packed-b rows
  int brow0, crem, brow_lo, brow_hi, db;  // the flip-b words' rows, residual, clip and funnel
  __device__ __forceinline__ uint4 word(int u) const {  // residual-shifted flip peq word
    u += qrem;
    return peq[(size_t)clamp_row(row0 + (u >> 5), row_lo, row_hi) * BK + (u & 31)];
  }
  __device__ __forceinline__ uint32_t bword(int w) const {  // residual-shifted flip-b word
    w += crem;
    return bpk[(size_t)clamp_row(brow0 + (w >> 7), brow_lo, brow_hi) * BKB + (w & 127)];
  }
  __device__ __forceinline__ EqRaw fetch_eq(int q) const {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    if (q < negm0r) return EqRaw{zero, zero, 0};  // below the reversed prefix
    return EqRaw{word(q), word(q + 1), delta};
  }
  static __device__ __forceinline__ uint4 eq_of(const EqRaw& e) { return funnel_eq(e); }
  __device__ __forceinline__ bool vec_ok(int) const { return true; }
  __device__ __forceinline__ void fetch_codes(int blk, CodeRaw& r) const {
    r = CodeRaw{bword(2 * blk), bword(2 * blk + 1), bword(2 * blk + 2)};
  }
  __device__ __forceinline__ void codes_of(const CodeRaw& r, Codes& out) const {
    out.lo = __funnelshift_r(r.z0, r.z1, db);
    out.hi = __funnelshift_r(r.z1, r.z2, db);
  }
  __device__ __forceinline__ int code(int j) const {
    const uint32_t w = __funnelshift_r(bword(j >> 4), bword((j >> 4) + 1), db);
    return (int)((w >> (2 * (j & 15))) & 3u);
  }
};

// One forward column: the K word steps, and the horizontal delta at row la
// (mk[k]: the bit of row la in word k, or 0; anc: la is the anchor row),
// returned.
template <int K>
__device__ __forceinline__ int fwd_column(Code c, const uint4 (&eq4)[K], const uint32_t (&mk)[K],
                                          uint32_t anc, uint32_t (&VP)[K], uint32_t (&VN)[K]) {
  uint32_t phc = 0x80000000u, mhc = 0u, selp = anc, selm = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    word_step(select_eq(eq4[k], c), c.valid, VP[k], VN[k], phc, mhc);
    selp |= phc & mk[k];
    selm |= mhc & mk[k];
  }
  return (int)(selp != 0u) - (int)(selm != 0u);
}

// The forward pass of pair p; iend is written as bi + iend_base (the
// resident kernel: absolute rows; the window kernel: anchor-relative, as the
// TPU kernel returns it).
template <int K, class Src>
__device__ __forceinline__ void fwd_pair(const Src& src, int p, int la, int lb, int d0, int W,
                                         int J, int iend_base, int* __restrict__ out_cost,
                                         int* __restrict__ out_iend, int* __restrict__ out_jend,
                                         int* __restrict__ out_win) {
  constexpr int G = kGroupCols<K>;
  const int NB = J / WB;
  const int m0 = fwd_anchor(d0, W);
  const int la_rel = la - m0 * WB;
  const int neg_floor = la_rel - la;  // rel row r is absolute row r - neg_floor
  const int win_cap = min(lb, la - d0 - W / 2);
  const int kla = max(la_rel - 1, 0) / WB;
  const int tla = max(la_rel - 1, 0) % WB;

  uint32_t VP[K], VN[K];
#pragma unroll
  for (int k = 0; k < K; ++k) VP[k] = VN[k] = 0u;
  int s_top = 0;  // D at the anchor row
  bool below = la_rel > K * WB;
  int s_la = (la_rel >= 0 && la_rel <= K * WB) ? 0 : MBIG;
  // the running best at row la: later columns win ties (their negsum is
  // smaller), so bn and bi follow from bc and bj after the loop
  int bc = MBIG, bj = 0;
  int wprev = 0, wmax = 0, wprev2 = 0, wmax2 = 0;

  const int nblk = min(NB, (lb + WB - 1) / WB);
  uint4 eq4[K];
#pragma unroll
  for (int k = 0; k < K; ++k) eq4[k] = Src::eq_of(src.fetch_eq(k));
  typename Src::Codes cb;
  typename Src::CodeRaw nraw;
  bool full = nblk > 0 && WB <= lb && src.vec_ok(0);
  if (full) {
    src.fetch_codes(0, nraw);
    src.codes_of(nraw, cb);
  }

  for (int blk = 0; blk < nblk; ++blk) {
    // the next block's loads go out before this block computes
    const bool more = blk + 1 < nblk;
    typename Src::EqRaw neq{};
    bool nfull = false;
    if (more) {
      neq = src.fetch_eq(blk + K);
      nfull = (blk + 2) * WB <= lb && src.vec_ok(blk + 1);
      if (nfull) src.fetch_codes(blk + 1, nraw);
    }

    const int kla_rel = kla - blk;
    const bool in_win = la_rel >= blk * WB && la_rel <= (blk + K) * WB && !below;
    const bool is_anchor = la_rel == blk * WB;  // la is the anchor row
    const uint32_t anc = (in_win && is_anchor) ? 1u : 0u;
    // a column updates the best when s_la <= min(bc, cap): cap keeps every
    // column out of the window, and s_la = MBIG, from it
    const int cap = in_win ? MBIG - 1 : -1;
    uint32_t mk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) mk[k] = (in_win && !is_anchor && k == kla_rel) ? (1u << tla) : 0u;
    const int jb = blk * WB + 1;  // jend of the block's first column

    if (full) {
#pragma unroll 1
      for (int g = 0; g < WB / G; ++g) {
#pragma unroll
        for (int v = 0; v < G; ++v) {
          s_la += fwd_column<K>(code_of(cb.code(v)), eq4, mk, anc, VP, VN);
          const bool upd = s_la <= min(bc, cap);
          bc = upd ? s_la : bc;
          bj = upd ? jb + g * G + v : bj;
        }
        cb.template next_group<G>();
      }
      s_top += WB;
    } else {
      const int ncol = min(WB, lb - blk * WB);
      for (int u = 0; u < ncol; ++u) {
        s_la += fwd_column<K>(code_of(src.code(blk * WB + u)), eq4, mk, anc, VP, VN);
        const bool upd = s_la <= min(bc, cap);
        bc = upd ? s_la : bc;
        bj = upd ? jb + u : bj;
      }
      s_top += ncol;
    }

    // windowed band-min mark at jj = (blk + 1) * 32; past win_cap a mark
    // only feeds wprev / wprev2 for later marks, which are past it too
    if ((blk & 3) == 3 && (blk + 1) * WB <= win_cap) {
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
      if ((blk & 7) == 7) {
        wmax = max(wmax, bm - wprev);
        wprev = bm;
      } else {
        if (blk != 3) wmax2 = max(wmax2, bm - wprev2);
        wprev2 = bm;
      }
    }

    if ((blk + 1) * WB < lb) {  // block-end shift, frozen at the pair's lb
      s_top += __popc(VP[0]) - __popc(VN[0]);
      shift_band<K>(VP, VN);
      const int edge = (blk + 1 + K) * WB;
      if (below && la_rel <= edge) {  // la enters through the new word
        int s_bot = s_top;  // D at the band's bottom row: the vertical deltas summed
#pragma unroll
        for (int k = 0; k < K; ++k) s_bot += __popc(VP[k]) - __popc(VN[k]);
        s_la = s_bot - (edge - la_rel);
        below = false;
      }
    }
    if (more) {
      shift_eq<K>(eq4, Src::eq_of(neq));
      if (nfull) src.codes_of(nraw, cb);
      full = nfull;
    }
  }

  int bi = 0, bn = 1 << 30;
  if (bc < MBIG) {
    bi = la_rel;
    bn = -(la_rel + bj);
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
      if (m1 < bc || (m1 == bc && negsum < bn)) { bc = m1; bi = best_rel; bj = lb; }
    }
  }
  out_cost[p] = bc;
  out_iend[p] = bi + iend_base;
  out_jend[p] = bj;
  out_win[p] = max(wmax, wmax2);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    myers_fwd_kernel(const int64_t* __restrict__ order, const int* __restrict__ a_oid,
                     const int* __restrict__ b_oid, const int* __restrict__ d0s,
                     const int* __restrict__ lengths, const uint8_t* __restrict__ codes, int LA,
                     const uint4* __restrict__ peq, int PW, int B, int W, int J,
                     int* __restrict__ out_cost, int* __restrict__ out_iend,
                     int* __restrict__ out_jend, int* __restrict__ out_win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int p = (int)order[i];
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int m0 = fwd_anchor(d0, W);
  const ResidentFwd src{peq + (size_t)ao * PW, PW, m0, codes + (size_t)bo * LA};
  fwd_pair<K>(src, p, lengths[ao >> 1], lengths[bo >> 1], d0, W, J, m0 * WB, out_cost, out_iend,
              out_jend, out_win);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    myers_fwd_win_kernel(const int* __restrict__ las, const int* __restrict__ lbs,
                         const int* __restrict__ d0s, const uint32_t* __restrict__ peq,
                         const int* __restrict__ bpk, int B, int W, int J,
                         int* __restrict__ out_cost, int* __restrict__ out_iend,
                         int* __restrict__ out_jend, int* __restrict__ out_win) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const Window src{peq, bpk, B, p};
  fwd_pair<K>(src, p, las[p], lbs[p], d0s[p], W, J, 0, out_cost, out_iend, out_jend, out_win);
}

// One reverse column: the K word steps.
template <int K>
__device__ __forceinline__ void rev_column(Code c, const uint4 (&eq4)[K], uint32_t (&VP)[K],
                                           uint32_t (&VN)[K]) {
  uint32_t phc = 0x80000000u, mhc = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) word_step(select_eq(eq4[k], c), c.valid, VP[k], VN[k], phc, mhc);
}

// The reverse pass of pair p from anchor row row_off (= 32 * m0r).
template <int K, class Src>
__device__ __forceinline__ void rev_pair(const Src& src, int p, int row_off, int iend, int jend,
                                         int J, int* __restrict__ out_cost,
                                         int* __restrict__ out_row) {
  constexpr int G = kGroupCols<K>;
  const int NB = J / WB;
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
  uint4 eq4[K];
#pragma unroll
  for (int k = 0; k < K; ++k) eq4[k] = Src::eq_of(src.fetch_eq(k));
  typename Src::Codes cb;
  typename Src::CodeRaw nraw;
  bool full = nblk > 0 && WB <= jend && src.vec_ok(0);
  if (full) {
    src.fetch_codes(0, nraw);
    src.codes_of(nraw, cb);
  }

  for (int blk = 0; blk < nblk; ++blk) {
    const bool more = blk + 1 < nblk;
    typename Src::EqRaw neq{};
    bool nfull = false;
    if (more) {
      neq = src.fetch_eq(blk + K);
      nfull = (blk + 2) * WB <= jend && src.vec_ok(blk + 1);
      if (nfull) src.fetch_codes(blk + 1, nraw);
    }
    if (full) {
#pragma unroll 1
      for (int g = 0; g < WB / G; ++g) {
#pragma unroll
        for (int v = 0; v < G; ++v) rev_column<K>(code_of(cb.code(v)), eq4, VP, VN);
        cb.template next_group<G>();
      }
      s_top += WB;
    } else {
      const int ncol = min(WB, jend - blk * WB);
      for (int u = 0; u < ncol; ++u) rev_column<K>(code_of(src.code(blk * WB + u)), eq4, VP, VN);
      s_top += ncol;
    }
    if ((blk + 1) * WB < jend) {
      s_top += __popc(VP[0]) - __popc(VN[0]);
      shift_band<K>(VP, VN);
    }
    if (more) {
      shift_eq<K>(eq4, Src::eq_of(neq));
      if (nfull) src.codes_of(nraw, cb);
      full = nfull;
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

template <int K>
__global__ void __launch_bounds__(kThreads)
    myers_rev_kernel(const int64_t* __restrict__ order, const int* __restrict__ a_oid,
                     const int* __restrict__ b_oid, const int* __restrict__ d0s,
                     const int* __restrict__ iends, const int* __restrict__ jends,
                     const int* __restrict__ lengths, const uint8_t* __restrict__ codes, int LA,
                     const uint4* __restrict__ peq_rev, int PW, int B, int W, int J,
                     int* __restrict__ out_cost, int* __restrict__ out_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int p = (int)order[i];
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int iend = iends[p], jend = jends[p];
  // reverse-window anchor (myers.rev_anchor)
  const int m0r = (((iend - jend) - WB * fwd_anchor(d0, W) - WB * k_of(W)) >> 5) - 1;
  const ResidentRev src{peq_rev + (size_t)ao * PW, PW, m0r, lengths[ao >> 1] - iend,
                        codes + (size_t)bo * LA, jend, lengths[bo >> 1]};
  rev_pair<K>(src, p, m0r * WB, iend, jend, J, out_cost, out_row);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    myers_rev_win_kernel(const int* __restrict__ row_offs, const int* __restrict__ iends,
                         const int* __restrict__ jends, const uint32_t* __restrict__ peq,
                         const int* __restrict__ bpk, int B, int J, int* __restrict__ out_cost,
                         int* __restrict__ out_row) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const Window src{peq, bpk, B, p};
  rev_pair<K>(src, p, row_offs[p], iends[p], jends[p], J, out_cost, out_row);
}

// The tab2 kernels.  win: the blocked table, n_o oriented rows of NBb
// peq rows (forward, then flip), one packed forward b row and NBc packed
// flip-b rows each (overlap/myers.py::tab2_offsets).
template <int K>
__global__ void __launch_bounds__(kThreads)
    myers_fwd_tab2_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                          const int* __restrict__ d0s, const int* __restrict__ lengths,
                          const uint32_t* __restrict__ win, int n_o, int NBb, int B, int W,
                          int J, int* __restrict__ out_cost, int* __restrict__ out_iend,
                          int* __restrict__ out_jend, int* __restrict__ out_win) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int s = fwd_anchor(d0, W) + F_TAB;  // the window's first word in the a row
  const Tab2Fwd src{reinterpret_cast<const uint4*>(win), win + (size_t)(2 * n_o * NBb + bo) * BKB,
                    ao * NBb + (s >> 5), s & 31, n_o * NBb - 1};
  fwd_pair<K>(src, p, lengths[ao >> 1], lengths[bo >> 1], d0, W, J, 0, out_cost, out_iend,
              out_jend, out_win);
}

// order: the launch order (thread i runs pair order[i]), the wrapper's
// column order by jend.
template <int K>
__global__ void __launch_bounds__(kThreads)
    myers_rev_tab2_kernel(const int64_t* __restrict__ order, const int* __restrict__ a_oid,
                          const int* __restrict__ b_oid, const int* __restrict__ d0s,
                          const int* __restrict__ iends, const int* __restrict__ jends,
                          const uint32_t* __restrict__ win, int LA, int n_o, int NBb, int NBc,
                          int B, int W, int J, int* __restrict__ out_cost,
                          int* __restrict__ out_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int p = (int)order[i];
  const int ao = a_oid[p], bo = b_oid[p], d0 = d0s[p];
  const int iend = iends[p], jend = jends[p];
  const int m0r = (((iend - jend) - WB * fwd_anchor(d0, W) - WB * k_of(W)) >> 5) - 1;
  // window bit t of word k = flip-peq bit obit + 32k + t (shifts: floor division)
  const int obit = (LA - iend) + m0r * WB + F_TAB * WB;
  const int q0 = obit >> 5;
  const int cb = LA - jend;  // reversed code j = flip-b code cb + j
  const int cbw = cb >> 4;
  const int off_r = n_o * NBb, off_br = 2 * n_o * NBb + n_o;
  const Tab2Rev src{reinterpret_cast<const uint4*>(win),
                    off_r + ao * NBb + (q0 >> 5), q0 & 31, off_r, 2 * off_r - 1,
                    -m0r, obit & 31,
                    win, off_br + bo * NBc + (cbw >> 7), cbw & 127, off_br,
                    off_br + n_o * NBc - 1, 2 * (cb & 15)};
  rev_pair<K>(src, p, m0r * WB, iend, jend, J, out_cost, out_row);
}

// ---------------------------------------------------------------------------
// The tab2 kernels' slab body (myers_fwd_tab2_slab_kernel /
// myers_rev_tab2_slab_kernel<K, M>): M band words a lane, L = ceil(K / M)
// lanes a pair, 32 / L pairs a warp.  It computes what the one-pair-a-
// thread tab2 kernels compute, from the same blocked-table words (Tab2Fwd /
// Tab2Rev), integer for integer.
//
// One pair a thread gives c4's J <= 2048 batches (6,000 to 16,000 pairs)
// 186 to 506 warps, under one a scheduler: then each column's K word steps
// wait on their own latency.  Spreading a pair over L lanes gives L times
// the warps and cuts a warp's column to M word steps; tab2_lanes picks L
// (and where one pair a thread is faster) from measured times.
//   - A wavefront.  Lane p works column j at step j + p + j / 32: its M
//     words in order (each word step hands the next its carry, the bit 31 of
//     ph / mh), after taking the carries of word pM - 1 from lane p - 1 by
//     two __shfl_sync; lane 0's first word takes the chain's start instead.
//     The code of a column is read once a lane for its M words.
//   - The band moves down one word a block: each lane, one step after its
//     last column of the block (a bubble step), moves its words up one slot
//     and takes lane p + 1's top word (its state, match planes and row-la
//     mark) by shuffle; the last lane starts a fresh bottom word.  The
//     bubbles fall at fixed steps of the 33-step body (lane 0 at step 32,
//     lane p at step p - 1 of the next body), so every move is a few
//     predicated copies at known steps.  The body runs its first four
//     steps (every bubble but lane 0's, L <= 5) and step 32 unrolled, and
//     steps 4..31 as a loop of four-step groups reading codes from a shift
//     register: unrolled whole, the body stalled on instruction fetch at
//     M >= 3.
//   - Per-pair scalars.  s_top lives in lane 0, which always holds the top
//     word.  The row-la running cost lives in the lane that holds la's word
//     and moves up with it; when the word leaves the band lane 0 adds 1 a
//     column, which keeps every later column from updating the best, as the
//     reference's cap does; each lane keeps the best of the columns it ran.
//     The windowed band-minimum marks, la's entry into the band and the final
//     extraction scan each lane's words (marks and entries their state at
//     the block's last column, kept at the bubble when some pair of the warp
//     needs it) and combine the L partial results in band order by shuffles
//     (slab_min).
//   - Loads.  A body's 33 codes a lane come from four packed words that the
//     pair's lanes load once, a body ahead, and shuffle; each lane cuts its
//     window out with a funnel shift a word.  The new bottom word is loaded
//     a body ahead; in the reverse pass its lower 16-byte half is the old
//     bottom's upper half, kept in the last lane, so each window word costs
//     one table load.
// Every warp collective is reached by all 32 lanes: the lanes past the
// warp's pairs run a copy of its first pair and store nothing.
// What bounds it: the same integer work as one pair a thread plus the
// per-step code bits, head and state selects and the forward tracker; on
// c4's J1024 batches it runs at 30-32 % of the op bound (PERF.md section
// 6: pair-order raggedness in the reverse pass, under one warp a scheduler
// in the forward pass).

constexpr unsigned FULL = 0xFFFFFFFFu;
// the row-la cost of a lane that does not hold la's word: ±1 a column from
// here never comes near MBIG
constexpr int HUGE_S = 1 << 29;

__device__ __forceinline__ uint4 shfl4(const uint4& v, int src) {
  return make_uint4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                    __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// A lane's place: lane p of its pair's L-lane segment, which starts at lane
// base.
template <int K, int M>
struct Slab {
  static constexpr int L = (K + M - 1) / M;        // lanes a pair
  static constexpr int P = 32 / L;                 // pairs a warp
  static constexpr int BOT = K - 1 - (L - 1) * M;  // the bottom word's slot in lane L - 1
  static_assert(L >= 2 && L <= 5, "the body's first four steps hold every lane's bubble");
  int p, base, prev, next, pair;
  bool live;  // a pair of the batch (not a spare lane's copy): it stores
  bool idle;  // the warp has no pair (warp-uniform)
  __device__ __forceinline__ explicit Slab(int B) {
    const int lane = (int)(threadIdx.x & 31);
    const int first = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * P;
    const int s = lane / L;
    const bool spare = s >= P;
    base = spare ? lane : s * L;
    p = spare ? 0 : lane - base;
    prev = spare ? lane : base + (p == 0 ? L - 1 : p - 1);
    next = spare ? lane : base + (p == L - 1 ? 0 : p + 1);
    live = !spare && first + s < B;
    pair = live ? first + s : first;
    idle = first >= B;
  }
};

// One step of a lane: take word pM - 1's carries (lane 0: the chain's
// start), then its M word steps on the plane (b1, b0), kept when act; ph /
// mh: each word's (for the row-la tracker); the last one is what the next
// lane takes.
template <int M>
__device__ __forceinline__ void slab_step(uint32_t (&vp)[M], uint32_t (&vn)[M],
                                          const uint4 (&eq)[M], bool b0, bool b1, bool act,
                                          bool head, int prev, uint32_t& sph, uint32_t& smh,
                                          uint32_t (&ph)[M], uint32_t (&mh)[M]) {
  uint32_t pc = __shfl_sync(FULL, sph, prev), mc = __shfl_sync(FULL, smh, prev);
  if (head) {
    pc = 0x80000000u;
    mc = 0u;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t npv = vp[m], nmv = vn[m];
    word_step(b1 ? (b0 ? eq[m].w : eq[m].z) : (b0 ? eq[m].y : eq[m].x), FULL, npv, nmv, pc, mc);
    ph[m] = pc;
    mh[m] = mc;
    if (act) {
      vp[m] = npv;
      vn[m] = nmv;
    }
  }
  sph = pc;
  smh = mc;
}

// The forward pass's running cost at row la in this lane, over the columns
// it runs (act): mk[m] is la's bit in word slot m while this lane holds la's
// word; anc = 1 in lane 0 after the word leaves the band (+1 a column: no
// later column updates the best); best = lim (MBIG - 1: none) at column
// jend bj, later columns winning ties.
template <int M>
struct RowLa {
  uint32_t mk[M];
  uint32_t anc;
  int s, lim, bj;
  __device__ __forceinline__ void step(const uint32_t (&ph)[M], const uint32_t (&mh)[M], bool act,
                                       int jend) {
    uint32_t up = anc, dn = 0u;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      up |= ph[m] & mk[m];
      dn |= mh[m] & mk[m];
    }
    // selects, not branches: act differs between the lanes of a warp
    s += act ? (int)(up != 0u) - (int)(dn != 0u) : 0;
    const bool upd = act && s <= lim;
    lim = upd ? s : lim;
    bj = upd ? jend : bj;
  }
};

// The band minimum of one band state over rows [lo, hi]: the anchor row
// (value s_top, lane 0's), then rows anchor + 1 + 32w + t of word w; ties
// to the larger row.  Each lane scans its own words and the L results are
// combined in band order; every lane of the pair gets (cost, row, s_top +
// the words' summed vertical deltas), cost MBIG when no row is in range.
struct BandMin {
  int cost, row, bottom;
};

template <int K, int M>
__device__ __forceinline__ BandMin slab_min(const uint32_t (&vp)[M], const uint32_t (&vn)[M],
                                            const Slab<K, M>& sl, int s_top, int anchor, int lo,
                                            int hi) {
  int val = 0, lmin = MBIG, lrow = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int w = sl.p * M + m;
    if (w >= K) break;  // the last lane's spare slots
    const int r0 = anchor + 1 + WB * w;
    for (int t = 0; t < WB; ++t) {
      val += (int)((vp[m] >> t) & 1u) - (int)((vn[m] >> t) & 1u);
      const int row = r0 + t;
      if (row >= lo && row <= hi && val <= lmin) {
        lmin = val;
        lrow = row;
      }
    }
  }
  int off = __shfl_sync(FULL, s_top, sl.base);
  int cost = (anchor >= lo && anchor <= hi) ? off : MBIG, row = anchor;
#pragma unroll
  for (int l = 0; l < Slab<K, M>::L; ++l) {
    const int src = sl.base + l;
    const int tl = __shfl_sync(FULL, val, src), ml = __shfl_sync(FULL, lmin, src);
    const int rl = __shfl_sync(FULL, lrow, src);
    if (ml < MBIG && off + ml <= cost) {
      cost = off + ml;
      row = rl;
    }
    off += tl;
  }
  return BandMin{cost, row, off};
}

// The codes of one body: stream words 2b - 1 + u (u = 0..3) loaded once a
// pair (L >= 4: lane u loads word u; else lanes 0 and 1 load two each), a
// body ahead, then each lane's 33 codes cut from bit offset o of word 2b -
// 1 (o in [0, 62], even).  bit(k, h) reads bit h of code k of the window.
template <int L>
struct SlabCodes {
  uint32_t r0 = 0u, r1 = 0u;  // this lane's loaded stream words
  template <class Load>
  __device__ __forceinline__ void load(int p, int w, Load&& word) {  // w = 2b - 1
    if constexpr (L >= 4) {
      if (p < 4) r0 = word(w + p);
    } else if (p < 2) {
      r0 = word(w + 2 * p);
      r1 = word(w + 2 * p + 1);
    }
  }
  uint32_t c[3];
  __device__ __forceinline__ void cut(int base, int o) {
    const int u = o >> 5, sh = o & 31;
    uint32_t a0, a1, a2;
    if constexpr (L >= 4) {
      a0 = __shfl_sync(FULL, r0, base + u);
      a1 = __shfl_sync(FULL, r0, base + u + 1);
      a2 = __shfl_sync(FULL, r0, base + u + 2);
    } else {
      const uint32_t x0 = __shfl_sync(FULL, r0, base), x1 = __shfl_sync(FULL, r1, base);
      const uint32_t x2 = __shfl_sync(FULL, r0, base + 1), x3 = __shfl_sync(FULL, r1, base + 1);
      a0 = u ? x1 : x0;
      a1 = u ? x2 : x1;
      a2 = u ? x3 : x2;
    }
    c[0] = __funnelshift_r(a0, a1, sh);
    c[1] = __funnelshift_r(a1, a2, sh);
    c[2] = a2 >> sh;
  }
  __device__ __forceinline__ bool bit(int k, int h) const {  // k a compile-time constant
    return (c[k >> 4] >> (2 * (k & 15) + h)) & 1u;
  }
  // code i + 1 when up, else code i: two fixed positions, no dynamic index
  __device__ __forceinline__ bool bit2(int i, bool up, int h) const {
    return up ? bit(i + 1, h) : bit(i, h);
  }
};

template <int K, int M>
__global__ void __launch_bounds__(kThreads)
    myers_fwd_tab2_slab_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                               const int* __restrict__ d0s, const int* __restrict__ lengths,
                               const uint32_t* __restrict__ win, int n_o, int NBb, int B, int W,
                               int J, int* __restrict__ out_cost, int* __restrict__ out_iend,
                               int* __restrict__ out_jend, int* __restrict__ out_win) {
  using S = Slab<K, M>;
  constexpr int L = S::L;
  const S sl(B);
  if (sl.idle) return;
  const int pr = sl.pair, p = sl.p;
  const int ao = a_oid[pr], bo = b_oid[pr], d0 = d0s[pr];
  const int la = lengths[ao >> 1], lb = lengths[bo >> 1];
  const int m0 = fwd_anchor(d0, W), s = m0 + F_TAB;
  const Tab2Fwd src{reinterpret_cast<const uint4*>(win), win + (size_t)(2 * n_o * NBb + bo) * BKB,
                    ao * NBb + (s >> 5), s & 31, n_o * NBb - 1};
  const int NB = J / WB;
  const int la_rel = la - m0 * WB, neg_floor = la_rel - la;
  const int win_cap = min(lb, la - d0 - W / 2);
  const int ncol = min(lb, J), nblk = (ncol + WB - 1) / WB;
  // bodies: lane p > 0 ends a block (its last columns, its bubble, a mark
  // or la's entry) in the next body's first L - 1 steps
  const int nb = __reduce_max_sync(FULL, nblk) + 1;

  // row la is bit tla of window word kla (kla = -1: la is block 0's anchor
  // row, so its word has left the band before the first column)
  const int kla = (la_rel - 1) >> 5;
  const uint32_t lbit = la_rel >= 0 ? 1u << ((la_rel - 1) & 31) : 0u;
  const bool below = la_rel > K * WB;
  RowLa<M> t;
  t.anc = p == 0 && la_rel == 0 ? 1u : 0u;
  t.s = la_rel == 0 && p == 0 ? 0 : HUGE_S;
  t.lim = MBIG - 1;
  t.bj = 0;
  uint32_t vp[M], vn[M], ph[M], mh[M];
  uint4 eq[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int w = p * M + m;
    vp[m] = vn[m] = 0u;
    eq[m] = src.fetch_eq(w);
    t.mk[m] = w == kla && w < K ? lbit : 0u;
    if (w == kla && !below && la_rel > 0) t.s = 0;
  }
  uint32_t sph = 0u, smh = 0u;
  int wprev = 0, wmax = 0, wprev2 = 0, wmax2 = 0;
  int sacc = 0, s_top_b = 0;  // lane 0: summed top-word deltas; s_top at the last block end
  uint32_t sv[M], sn[M];      // the state at a block's last column, when a mark or entry needs it
#pragma unroll
  for (int m = 0; m < M; ++m) sv[m] = sn[m] = 0u;

  auto word_of = [&](int w) { return src.brow[max(w, 0)]; };
  SlabCodes<L> cn;
  cn.load(p, -1, word_of);
  bool snap_prev = false, mark_prev = false, enter_prev = false, shift_prev = false;
  uint4 eqn = eq[0];
  for (int b = 0; b < nb; ++b) {
    SlabCodes<L> cw = cn;
    cw.cut(sl.base, 32 - 2 * p);  // column 32b - p is bit 32 - 2p of word 2b - 1
    cn.load(p, 2 * b + 1, word_of);
    const int c0 = WB * b - p, E = ncol - c0;  // step i's column is c0 + i (+1 before the bubble)
    const bool shift = WB * (b + 1) < lb;      // the band moves after this block
    const bool mark = (b & 3) == 3 && WB * (b + 1) <= win_cap;
    // la enters the band through the new bottom word after the block whose
    // shift first brings it in (the band's bottom row reaches la)
    const bool enter = shift && (b + K) * WB < la_rel && la_rel <= (b + 1 + K) * WB;
    const bool snap = __any_sync(FULL, mark || enter);
    uint4 eqb = eqn;
    if (p == L - 1) eqb = src.fetch_eq(b + K);  // the bottom word after this block
    // one step, column c0 + k: the lane's M word steps and la's running cost
    auto run = [&](int k, bool act, bool b0, bool b1) {
      slab_step<M>(vp, vn, eq, b0, b1, act, p == 0, sl.prev, sph, smh, ph, mh);
      t.step(ph, mh, act, c0 + k + 1);
    };
    // lane h's bubble after block bm: the band moves one slot up there (when
    // sh), taking lane h + 1's top word; snapped: keep the block-end state
    auto move = [&](int h, bool sh, int bm, bool snapped) {
      const bool mine = p == h;
      const uint32_t up_vp = __shfl_sync(FULL, vp[0], sl.next);
      const uint32_t up_vn = __shfl_sync(FULL, vn[0], sl.next);
      const uint4 up_eq = shfl4(eq[0], sl.next);
      const uint32_t up_mk = __shfl_sync(FULL, t.mk[0], sl.next);
      const int up_s = __shfl_sync(FULL, t.s, sl.next);
      if (mine && snapped) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          sv[m] = vp[m];
          sn[m] = vn[m];
        }
      }
      if (mine && p == 0) s_top_b = WB * (bm + 1) + sacc;  // before the shift
      if (mine && sh) {
        if (p == 0) {
          sacc += __popc(vp[0]) - __popc(vn[0]);
          if (t.mk[0]) t.anc = 1u;  // la's word leaves the band
        } else if (t.mk[0]) {
          t.s = HUGE_S;  // la's word moves to lane p - 1
        }
#pragma unroll
        for (int m = 0; m + 1 < M; ++m) {
          vp[m] = vp[m + 1];
          vn[m] = vn[m + 1];
          eq[m] = eq[m + 1];
          t.mk[m] = t.mk[m + 1];
        }
        if (p + 1 < L) {
          vp[M - 1] = up_vp;
          vn[M - 1] = up_vn;
          eq[M - 1] = up_eq;
          t.mk[M - 1] = up_mk;
          if (up_mk) t.s = up_s;
        } else {
          vp[S::BOT] = 0xFFFFFFFFu;
          vn[S::BOT] = 0u;
          eq[S::BOT] = eqn;
          t.mk[S::BOT] = bm + K == kla ? lbit : 0u;
        }
      }
    };
    // steps 0..3: lane p > 0 ends block b - 1 (its last columns, its bubble
    // and move at step p - 1); at step L - 2 every lane has moved
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool tail = i + 2 < L && i + 2 <= p;  // still in block b - 1 (code i + 1)
      const int k = i + (tail ? 1 : 0);
      run(k, i + 1 < L ? i != p - 1 && (tail ? b > 0 : i >= p) && k < E : i < E,
          cw.bit2(i, tail, 0), cw.bit2(i, tail, 1));
      if (i + 1 < L) move(i + 1, shift_prev, b - 1, snap_prev);
      if (i == L - 2 && snap_prev) {  // block b - 1's mark and la's entry
        const BandMin r = slab_min<K, M>(sv, sn, sl, s_top_b, WB * (b - 1), neg_floor, la_rel);
        if (mark_prev) {  // windowed band-min mark at jj = 32b
          if (((b - 1) & 7) == 7) {
            wmax = max(wmax, r.cost - wprev);
            wprev = r.cost;
          } else {
            if (b - 1 != 3) wmax2 = max(wmax2, r.cost - wprev2);
            wprev2 = r.cost;
          }
        }
        // la's cost at the new bottom row (D at the band's bottom + 1 a row), less the rows
        if (enter_prev && p == L - 1) t.s = r.bottom + WB - ((b + K) * WB - la_rel);
      }
    }
    if (b + 1 == nb) break;  // the last body only ends block b - 1
    // steps 4..31, four a pass: every lane in block b, codes from a shift
    // register (the loop is not unrolled: a 33-step body overflows the
    // instruction cache at M >= 2)
    uint32_t lo = __funnelshift_r(cw.c[0], cw.c[1], 8), hi = __funnelshift_r(cw.c[1], cw.c[2], 8);
#pragma unroll 1
    for (int i = 4; i < WB; i += 4) {
#pragma unroll
      for (int v = 0; v < 4; ++v) run(i + v, i + v < E, (lo >> (2 * v)) & 1u, (lo >> (2 * v + 1)) & 1u);
      lo = __funnelshift_r(lo, hi, 8);
      hi >>= 8;
    }
    // step 32: lane 0's bubble, then its move before block b + 1
    run(WB, p != 0 && WB < E, cw.bit(WB, 0), cw.bit(WB, 1));
    move(0, shift, b, snap);
    snap_prev = snap;
    mark_prev = mark;
    enter_prev = enter;
    shift_prev = shift;
    eqn = eqb;
  }

  // the best at row la: each lane's, least cost, ties to the later column
  int bc = t.lim < MBIG - 1 ? t.lim : MBIG, bj = t.bj;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int cl = __shfl_sync(FULL, bc, sl.base + l), jl = __shfl_sync(FULL, bj, sl.base + l);
    if (cl < bc || (cl == bc && jl > bj)) {
      bc = cl;
      bj = jl;
    }
  }
  int bi = 0, bn = 1 << 30;
  if (bc < MBIG) {
    bi = la_rel;
    bn = -(la_rel + bj);
  } else {
    bj = 0;
  }
  // final-column extraction from the frozen band (every lane takes part in
  // the shuffles; the result counts when lb <= J)
  const int anchor = min(max(lb - 1, 0) / WB, NB - 1) * WB;
  const BandMin r = slab_min<K, M>(vp, vn, sl, ncol + sacc, anchor, neg_floor, la_rel);
  if (lb <= J && r.cost < MBIG) {
    const int negsum = -(r.row + lb);
    if (r.cost < bc || (r.cost == bc && negsum < bn)) {
      bc = r.cost;
      bi = r.row;
      bj = lb;
    }
  }
  if (sl.live && p == 0) {
    out_cost[pr] = bc;
    out_iend[pr] = bi;
    out_jend[pr] = bj;
    out_win[pr] = max(wmax, wmax2);
  }
}

template <int K, int M>
__global__ void __launch_bounds__(kThreads)
    myers_rev_tab2_slab_kernel(const int* __restrict__ a_oid, const int* __restrict__ b_oid,
                               const int* __restrict__ d0s, const int* __restrict__ iends,
                               const int* __restrict__ jends, const uint32_t* __restrict__ win,
                               int LA, int n_o, int NBb, int NBc, int B, int W, int J,
                               int* __restrict__ out_cost, int* __restrict__ out_row) {
  using S = Slab<K, M>;
  constexpr int L = S::L;
  const S sl(B);
  if (sl.idle) return;
  const int pr = sl.pair, p = sl.p;
  const int ao = a_oid[pr], bo = b_oid[pr], d0 = d0s[pr];
  const int iend = iends[pr], jend = jends[pr];
  const int m0r = (((iend - jend) - WB * fwd_anchor(d0, W) - WB * k_of(W)) >> 5) - 1;
  const int obit = (LA - iend) + m0r * WB + F_TAB * WB;
  const int q0 = obit >> 5;
  const int cb = LA - jend;
  const int cbw = cb >> 4;
  const int off_r = n_o * NBb, off_br = 2 * n_o * NBb + n_o;
  const Tab2Rev src{reinterpret_cast<const uint4*>(win),
                    off_r + ao * NBb + (q0 >> 5), q0 & 31, off_r, 2 * off_r - 1,
                    -m0r, obit & 31,
                    win, off_br + bo * NBc + (cbw >> 7), cbw & 127, off_br,
                    off_br + n_o * NBc - 1, 2 * (cb & 15)};
  const int row_off = m0r * WB;
  const int ncol = min(max(jend, 0), J), nblk = (ncol + WB - 1) / WB;
  const int nb = __reduce_max_sync(FULL, nblk) + 1;

  // anchored start D[row, 0] = |row|; window word w = (table word w + 1 :
  // word w) >> delta, 0 below the reversed prefix; hi: the bottom slot's
  // word w + 1 (the last lane's), the next bottom word's lower half
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint32_t vp[M], vn[M], ph[M], mh[M];
  uint4 eq[M];
  uint4 lo = src.word(p * M), hi;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int w = p * M + m;
    const int tmax = -(row_off + w * WB + 1);
    vn[m] = tmax < 0 ? 0u : tmax >= 31 ? 0xFFFFFFFFu : ((1u << (tmax + 1)) - 1u);
    vp[m] = ~vn[m];
    hi = src.word(w + 1);
    eq[m] = w < src.negm0r ? zero : funnel_eq(EqPair{lo, hi, src.delta});
    lo = hi;
  }
  hi = p == L - 1 ? src.word(K) : zero;  // the bottom word K - 1's upper half
  uint32_t sph = 0u, smh = 0u;
  int sacc = 0;

  auto word_of = [&](int w) { return src.bword(max(w, 0)); };
  SlabCodes<L> cn;
  cn.load(p, -1, word_of);
  bool shift_prev = false;
  uint4 hin = hi;
  for (int b = 0; b < nb; ++b) {
    SlabCodes<L> cw = cn;
    cw.cut(sl.base, 32 - 2 * p + src.db);  // reversed column j is stream bit 2j + db
    cn.load(p, 2 * b + 1, word_of);
    const int c0 = WB * b - p, E = ncol - c0;
    const bool shift = WB * (b + 1) < jend;
    uint4 hib = hin;
    if (p == L - 1) hib = src.word(b + K + 1);  // the upper half of the bottom word after this block
    auto run = [&](bool act, bool b0, bool b1) {
      slab_step<M>(vp, vn, eq, b0, b1, act, p == 0, sl.prev, sph, smh, ph, mh);
    };
    auto move = [&](int h, bool sh, int bm) {
      const uint32_t up_vp = __shfl_sync(FULL, vp[0], sl.next);
      const uint32_t up_vn = __shfl_sync(FULL, vn[0], sl.next);
      const uint4 up_eq = shfl4(eq[0], sl.next);
      if (p == h && sh) {
        if (p == 0) sacc += __popc(vp[0]) - __popc(vn[0]);
#pragma unroll
        for (int m = 0; m + 1 < M; ++m) {
          vp[m] = vp[m + 1];
          vn[m] = vn[m + 1];
          eq[m] = eq[m + 1];
        }
        if (p + 1 < L) {
          vp[M - 1] = up_vp;
          vn[M - 1] = up_vn;
          eq[M - 1] = up_eq;
        } else {
          vp[S::BOT] = 0xFFFFFFFFu;
          vn[S::BOT] = 0u;
          eq[S::BOT] = bm + K < src.negm0r ? zero : funnel_eq(EqPair{hi, hin, src.delta});
          hi = hin;
        }
      }
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool tail = i + 2 < L && i + 2 <= p;
      const int k = i + (tail ? 1 : 0);
      run(i + 1 < L ? i != p - 1 && (tail ? b > 0 : i >= p) && k < E : i < E,
          cw.bit2(i, tail, 0), cw.bit2(i, tail, 1));
      if (i + 1 < L) move(i + 1, shift_prev, b - 1);
    }
    if (b + 1 == nb) break;
    uint32_t lo = __funnelshift_r(cw.c[0], cw.c[1], 8), hi2 = __funnelshift_r(cw.c[1], cw.c[2], 8);
#pragma unroll 1
    for (int i = 4; i < WB; i += 4) {
#pragma unroll
      for (int v = 0; v < 4; ++v) run(i + v < E, (lo >> (2 * v)) & 1u, (lo >> (2 * v + 1)) & 1u);
      lo = __funnelshift_r(lo, hi2, 8);
      hi2 >>= 8;
    }
    run(p != 0 && WB < E, cw.bit(WB, 0), cw.bit(WB, 1));
    move(0, shift, b);
    shift_prev = shift;
    hin = hib;
  }

  // frozen-state extraction: min cost, ties to the largest reverse row (the
  // last row when none is in range)
  const int anchor = (max(jend - 1, 0) / WB) * WB + row_off;
  const int s_top = (row_off < 0 ? -row_off : row_off) + ncol + sacc;
  const BandMin r = slab_min<K, M>(vp, vn, sl, s_top, anchor, 0, iend);
  if (sl.live && p == 0) {
    out_cost[pr] = r.cost;
    out_row[pr] = r.cost < MBIG ? r.row : anchor + K * WB;
  }
}

int blocks(int B) { return (B + kThreads - 1) / kThreads; }

template <int K>
cudaError_t launch_fwd(const int64_t* o, const int* a, const int* b, const int* d0, const int* len,
                       const uint8_t* codes, int LA, const uint4* peq, int PW, int B, int W,
                       int J, int* c, int* ie, int* je, int* wn, cudaStream_t s) {
  PHASM_LAUNCH(myers_fwd_kernel<K>, blocks(B), kThreads, s)(
      o, a, b, d0, len, codes, LA, peq, PW, B, W, J, c, ie, je, wn);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_rev(const int64_t* o, const int* a, const int* b, const int* d0, const int* ie,
                       const int* je, const int* len, const uint8_t* codes, int LA,
                       const uint4* peq, int PW, int B, int W, int J, int* c, int* row,
                       cudaStream_t s) {
  PHASM_LAUNCH(myers_rev_kernel<K>, blocks(B), kThreads, s)(
      o, a, b, d0, ie, je, len, codes, LA, peq, PW, B, W, J, c, row);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_fwd_win(const int* la, const int* lb, const int* d0, const uint32_t* peq,
                           const int* bpk, int B, int W, int J, int* c, int* ie, int* je,
                           int* wn, cudaStream_t s) {
  PHASM_LAUNCH(myers_fwd_win_kernel<K>, blocks(B), kThreads, s)(
      la, lb, d0, peq, bpk, B, W, J, c, ie, je, wn);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_rev_win(const int* ro, const int* ie, const int* je, const uint32_t* peq,
                           const int* bpk, int B, int J, int* c, int* row, cudaStream_t s) {
  PHASM_LAUNCH(myers_rev_win_kernel<K>, blocks(B), kThreads, s)(
      ro, ie, je, peq, bpk, B, J, c, row);
  return cudaGetLastError();
}

// Lanes a pair for tab2 kernel 1 (rev false) or 2 on a batch of B pairs at
// K band words: 1 runs one pair a thread (myers_{fwd,rev}_tab2_kernel, the
// reverse pass in column order), L > 1 the slab body (forward: 2 lanes of
// ceil(K / 2) words, 16 pairs a warp; reverse: ceil(K / 2) lanes of 2
// words, 32 / L pairs a warp).  Times on an H100 80GB HBM3 at 700 W
// (chip_smoke.tab2_bodies_ms, 30-launch means), one pair a thread (the
// reverse pass in column order, its sort included) / the slab at this
// rule's lanes, on phase 7's batches and on seeded random cuts of two:
//   c4 W64 J1024, 7,070 pairs:   fwd 0.122 / 0.114,  rev 0.166 / 0.096
//   c4 W128 J1024, 5,952 pairs:  fwd 0.174 / 0.145,  rev 0.162 / 0.085
//   c2 W64 J1024 cut to  6,000 /  8,000 / 10,000 / 12,000 / 14,000 / 16,000:
//     fwd 0.122 / 0.112, 0.123 / 0.115, 0.122 / 0.197, 0.122 / 0.198, 0.122 / 0.198, 0.122 / 0.201
//     rev 0.162 / 0.095, 0.170 / 0.097, 0.164 / 0.139, 0.165 / 0.140, 0.163 / 0.177, 0.168 / 0.179
//   c4 W64 J2048 cut to  4,000 /  6,000 /  8,000 / 10,000 / 12,000 / 14,000:
//     fwd 0.245 / 0.211, 0.244 / 0.211, 0.245 / 0.211, 0.245 / 0.372, 0.244 / 0.372, 0.246 / 0.376
//     rev 0.293 / 0.125, 0.296 / 0.193, 0.296 / 0.194, 0.296 / 0.284, 0.297 / 0.286, 0.300 / 0.365
//   c4 W64 J2048, 16,167 pairs:  fwd 0.244 / 0.374,  rev 0.300 / 0.366
//   c2 W64 J1024, 64,070 pairs:  fwd 0.420 / 0.735,  rev 0.365 / 0.630
// One pair a thread is flat below one warp a scheduler (latency sets it);
// the slab steps up with its warps on the busiest of the card's 528
// schedulers (132 SMs x 4), at both J: the forward slab loses from its
// second warp a scheduler (past 8,448 pairs), the reverse from its fourth
// (past 12,672 pairs at 8 pairs a warp).  So the rule counts the slab's
// warps, the same at every J.
constexpr int kSchedulers = 132 * 4;
#ifdef PHASM_TAB2_FORCE
// A measurement build only (chip_smoke.tab2_bodies_ms): phasm_tab2_force(L)
// makes every batch run one pair a thread (L = 1), the slab body at L lanes
// a pair (2..5) or the fixed rule (0).
int g_tab2_force = 0;
#endif
int tab2_lanes(int B, int K, bool rev) {
#ifdef PHASM_TAB2_FORCE
  if (g_tab2_force) return g_tab2_force;
#endif
  const int L = rev ? (K + 1) / 2 : 2, P = 32 / L;
  const int warps = (B + P - 1) / P;
  return warps > (rev ? 3 : 1) * kSchedulers ? 1 : L;
}

template <int K, int M>
int slab_blocks(int B) {  // one-warp blocks of Slab<K, M>::P pairs
  return (B + Slab<K, M>::P - 1) / Slab<K, M>::P;
}

template <int K, int L>
cudaError_t launch_fwd_slab(const int* a, const int* b, const int* d0, const int* len,
                            const uint32_t* win, int n_o, int NBb, int B, int W, int J, int* c,
                            int* ie, int* je, int* wn, cudaStream_t s) {
  constexpr int M = (K + L - 1) / L;
  const auto kernel = myers_fwd_tab2_slab_kernel<K, M>;
  PHASM_LAUNCH(kernel, (slab_blocks<K, M>(B)), kThreads, s)(
      a, b, d0, len, win, n_o, NBb, B, W, J, c, ie, je, wn);
  return cudaGetLastError();
}

template <int K, int L>
cudaError_t launch_rev_slab(const int* a, const int* b, const int* d0, const int* ie,
                            const int* je, const uint32_t* win, int LA, int n_o, int NBb, int NBc,
                            int B, int W, int J, int* c, int* row, cudaStream_t s) {
  constexpr int M = (K + L - 1) / L;
  const auto kernel = myers_rev_tab2_slab_kernel<K, M>;
  PHASM_LAUNCH(kernel, (slab_blocks<K, M>(B)), kThreads, s)(
      a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c, row);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_fwd_tab2(const int* a, const int* b, const int* d0, const int* len,
                            const uint32_t* win, int n_o, int NBb, int B, int W, int J, int* c,
                            int* ie, int* je, int* wn, cudaStream_t s) {
  switch (tab2_lanes(B, K, false)) {
    case 1:
      PHASM_LAUNCH(myers_fwd_tab2_kernel<K>, blocks(B), kThreads, s)(
          a, b, d0, len, win, n_o, NBb, B, W, J, c, ie, je, wn);
      return cudaGetLastError();
    case 2: return launch_fwd_slab<K, 2>(a, b, d0, len, win, n_o, NBb, B, W, J, c, ie, je, wn, s);
#ifdef PHASM_TAB2_FORCE
    case 3: return launch_fwd_slab<K, 3>(a, b, d0, len, win, n_o, NBb, B, W, J, c, ie, je, wn, s);
    case 4: return launch_fwd_slab<K, 4>(a, b, d0, len, win, n_o, NBb, B, W, J, c, ie, je, wn, s);
    case 5: return launch_fwd_slab<K, 5>(a, b, d0, len, win, n_o, NBb, B, W, J, c, ie, je, wn, s);
#endif
    default: return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t launch_rev_tab2(const int64_t* o, const int* a, const int* b, const int* d0,
                            const int* ie, const int* je, const uint32_t* win, int LA, int n_o,
                            int NBb, int NBc, int B, int W, int J, int* c, int* row,
                            cudaStream_t s) {
  const int L = tab2_lanes(B, K, true);
  if (L == 1) {
    if (o == nullptr) return cudaErrorInvalidValue;  // one pair a thread reads the order
    PHASM_LAUNCH(myers_rev_tab2_kernel<K>, blocks(B), kThreads, s)(
        o, a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c, row);
    return cudaGetLastError();
  }
  if (L == (K + 1) / 2)
    return launch_rev_slab<K, (K + 1) / 2>(a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c,
                                           row, s);
#ifdef PHASM_TAB2_FORCE
  if (L == 2) return launch_rev_slab<K, 2>(a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c, row, s);
  if (L == 3) return launch_rev_slab<K, 3>(a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c, row, s);
  if (L == 4) return launch_rev_slab<K, 4>(a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c, row, s);
  if (L == 5) return launch_rev_slab<K, 5>(a, b, d0, ie, je, win, LA, n_o, NBb, NBc, B, W, J, c, row, s);
#endif
  return cudaErrorInvalidValue;
}

int host_k_of(int W) { return (W + 63 + WB - 1) / WB + 1; }

}  // namespace

// W must satisfy 4 <= K_of(W) <= 7 (W <= 128); the wrapper checks it.
// order: an int64 permutation of [0, B); thread i runs pair order[i].
extern "C" int phasm_myers_fwd(const int64_t* order, const int* a_oid, const int* b_oid,
                               const int* d0, const int* lengths, const uint8_t* codes, int LA,
                               const uint32_t* peq, int PW, int B, int W, int J, int* cost,
                               int* iend, int* jend, int* win, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = reinterpret_cast<const uint4*>(peq);
  switch (host_k_of(W)) {
    case 4: return launch_fwd<4>(order, a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    case 5: return launch_fwd<5>(order, a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    case 6: return launch_fwd<6>(order, a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    case 7: return launch_fwd<7>(order, a_oid, b_oid, d0, lengths, codes, LA, t, PW, B, W, J, cost, iend, jend, win, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int phasm_myers_rev(const int64_t* order, const int* a_oid, const int* b_oid,
                               const int* d0, const int* iend, const int* jend, const int* lengths,
                               const uint8_t* codes, int LA, const uint32_t* peq_rev, int PW,
                               int B, int W, int J, int* cost, int* best_row, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto t = reinterpret_cast<const uint4*>(peq_rev);
  switch (host_k_of(W) + 3) {  // rev_K(W) = K_of(W) + 3
    case 7: return launch_rev<7>(order, a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    case 8: return launch_rev<8>(order, a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    case 9: return launch_rev<9>(order, a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    case 10: return launch_rev<10>(order, a_oid, b_oid, d0, iend, jend, lengths, codes, LA, t, PW, B, W, J, cost, best_row, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The table tier's window-fed kernels: peq [J/32 + K, 4, B] / bpk [J/16, B]
// forward (K = K_of(W)), [J/32 + rev_K(W), 4, B] / [J/16, B] reverse.
extern "C" int phasm_myers_fwd_win(const int* la, const int* lb, const int* d0,
                                   const uint32_t* peq, const int* bpk, int B, int W, int J,
                                   int* cost, int* iend_rel, int* jend, int* win, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (host_k_of(W)) {
    case 4: return launch_fwd_win<4>(la, lb, d0, peq, bpk, B, W, J, cost, iend_rel, jend, win, s);
    case 5: return launch_fwd_win<5>(la, lb, d0, peq, bpk, B, W, J, cost, iend_rel, jend, win, s);
    case 6: return launch_fwd_win<6>(la, lb, d0, peq, bpk, B, W, J, cost, iend_rel, jend, win, s);
    case 7: return launch_fwd_win<7>(la, lb, d0, peq, bpk, B, W, J, cost, iend_rel, jend, win, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int phasm_myers_rev_win(const int* row_off, const int* iend, const int* jend,
                                   const uint32_t* peq, const int* bpk, int B, int W, int J,
                                   int* cost, int* best_row, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (host_k_of(W) + 3) {  // rev_K(W) = K_of(W) + 3
    case 7: return launch_rev_win<7>(row_off, iend, jend, peq, bpk, B, J, cost, best_row, s);
    case 8: return launch_rev_win<8>(row_off, iend, jend, peq, bpk, B, J, cost, best_row, s);
    case 9: return launch_rev_win<9>(row_off, iend, jend, peq, bpk, B, J, cost, best_row, s);
    case 10: return launch_rev_win<10>(row_off, iend, jend, peq, bpk, B, J, cost, best_row, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tab2 tier's kernels over the blocked table win (n_o oriented rows
// built at width LA; NBb / NBc its peq / flip-b rows a read).  The forward
// kernel returns iend relative to the anchor row 32 * m0, as the TPU
// kernel does.  The wrapper checks that J <= 2048 (tab2_fits), which the
// table's padding rows are sized for.  Each entry picks its body by
// tab2_lanes; the reverse entry's order (an int64 permutation of [0, B),
// the column order by jend) is read only by the one-pair-a-thread body
// (phasm_myers_tab2_lanes says which runs), and may be null otherwise: the
// entry returns cudaErrorInvalidValue when that body would read a null one.
extern "C" int phasm_myers_fwd_tab2(const int* a_oid, const int* b_oid, const int* d0,
                                    const int* lengths, const uint32_t* win, int n_o, int NBb,
                                    int B, int W, int J, int* cost, int* iend_rel, int* jend,
                                    int* win_out, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (host_k_of(W)) {
    case 4: return launch_fwd_tab2<4>(a_oid, b_oid, d0, lengths, win, n_o, NBb, B, W, J, cost, iend_rel, jend, win_out, s);
    case 5: return launch_fwd_tab2<5>(a_oid, b_oid, d0, lengths, win, n_o, NBb, B, W, J, cost, iend_rel, jend, win_out, s);
    case 6: return launch_fwd_tab2<6>(a_oid, b_oid, d0, lengths, win, n_o, NBb, B, W, J, cost, iend_rel, jend, win_out, s);
    case 7: return launch_fwd_tab2<7>(a_oid, b_oid, d0, lengths, win, n_o, NBb, B, W, J, cost, iend_rel, jend, win_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int phasm_myers_rev_tab2(const int64_t* order, const int* a_oid, const int* b_oid,
                                    const int* d0, const int* iend, const int* jend,
                                    const uint32_t* win, int LA, int n_o, int NBb, int NBc, int B,
                                    int W, int J, int* cost, int* best_row, void* stream) {
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (host_k_of(W) + 3) {  // rev_K(W) = K_of(W) + 3
    case 7: return launch_rev_tab2<7>(order, a_oid, b_oid, d0, iend, jend, win, LA, n_o, NBb, NBc, B, W, J, cost, best_row, s);
    case 8: return launch_rev_tab2<8>(order, a_oid, b_oid, d0, iend, jend, win, LA, n_o, NBb, NBc, B, W, J, cost, best_row, s);
    case 9: return launch_rev_tab2<9>(order, a_oid, b_oid, d0, iend, jend, win, LA, n_o, NBb, NBc, B, W, J, cost, best_row, s);
    case 10: return launch_rev_tab2<10>(order, a_oid, b_oid, d0, iend, jend, win, LA, n_o, NBb, NBc, B, W, J, cost, best_row, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Lanes a pair phasm_myers_{fwd,rev}_tab2 give a batch of B pairs (1: one
// pair a thread; L > 1: the slab body).
extern "C" int phasm_myers_tab2_lanes(int B, int W, int J, int rev) {
  return tab2_lanes(B, host_k_of(W) + (rev ? 3 : 0), rev != 0);
}

#ifdef PHASM_TAB2_FORCE
extern "C" void phasm_tab2_force(int L) { g_tab2_force = L; }
#endif
