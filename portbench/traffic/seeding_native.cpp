// Seeding for the benchmark's traffic generator: a frozen copy of the
// minimizer extraction, radix argsort, seed-pair emission and candidate
// histogram of the port's host library (phasm_tpu_torch/csrc/
// phasm_native.cpp at the commit this benchmark was written on), so the
// candidate pairs a seed gives do not move when the program's seeding does.
// Built with g++ into portbench/.build/ by portbench/traffic/seeding.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <thread>
#include <vector>

namespace {

// splitmix-style mixer — MUST match seeding._hash64 exactly
inline uint64_t hash64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline uint64_t revcomp_kmer(uint64_t v, int k) {
  uint64_t out = 0;
  for (int i = 0; i < k; ++i) {
    out = (out << 2) | (3ULL - (v & 3ULL));
    v >>= 2;
  }
  return out;
}

inline int n_threads(int64_t work) {
  const int hw = (int)std::thread::hardware_concurrency();
  const int by_work = (int)std::min<int64_t>(8, work / (1 << 20) + 1);
  return std::max(1, std::min(hw > 0 ? hw : 1, by_work));
}

// Parallel stable LSD radix sort of (key, payload) pairs, 8-bit digits.
// Stability: threads own contiguous input ranges; scatter offsets are laid
// out (digit-major, thread-minor), so equal keys keep input order —
// deterministic regardless of thread count.
void radix_sort_pairs(std::vector<std::pair<uint64_t, int64_t>>& a,
                      std::vector<std::pair<uint64_t, int64_t>>& b) {
  const int64_t n = (int64_t)a.size();
  if (n < 2) return;
  uint64_t ormask = 0;
  for (int64_t i = 0; i < n; ++i) ormask |= a[i].first;
  const int T = n_threads(n * 16);
  std::vector<int64_t> bounds(T + 1);
  for (int t = 0; t <= T; ++t) bounds[t] = n * t / T;
  std::vector<std::vector<int64_t>> cnt(T, std::vector<int64_t>(256));
  std::vector<std::vector<int64_t>> off(T, std::vector<int64_t>(256));
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = pass * 8;
    if (pass > 0 && (ormask >> shift) == 0) break;
    auto count_fn = [&](int t) {
      auto& c = cnt[t];
      std::fill(c.begin(), c.end(), 0);
      for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
        ++c[(a[i].first >> shift) & 255];
    };
    {
      std::vector<std::thread> th;
      for (int t = 1; t < T; ++t) th.emplace_back(count_fn, t);
      count_fn(0);
      for (auto& x : th) x.join();
    }
    int64_t acc = 0;
    for (int d = 0; d < 256; ++d)
      for (int t = 0; t < T; ++t) {
        off[t][d] = acc;
        acc += cnt[t][d];
      }
    auto scatter_fn = [&](int t) {
      auto& o = off[t];
      for (int64_t i = bounds[t]; i < bounds[t + 1]; ++i)
        b[o[(a[i].first >> shift) & 255]++] = a[i];
    };
    {
      std::vector<std::thread> th;
      for (int t = 1; t < T; ++t) th.emplace_back(scatter_fn, t);
      scatter_fn(0);
      for (auto& x : th) x.join();
    }
    a.swap(b);
  }
}

}  // namespace

extern "C" {

// Bumped on any ABI change.
int64_t phasm_native_abi_version() { return 5; }


// Minimizer extraction over a dense read matrix.
//
// codes    [n_reads, lpad] row-major base codes 0..3
// lengths  [n_reads]
// outputs: per-seed read id / fwd position / canonical kmer / orientation
// returns the number of seeds written (<= cap), or -1 if cap exceeded.
int64_t extract_minimizers(const uint8_t* codes, int64_t n_reads, int64_t lpad,
                           const int32_t* lengths, int32_t k, int32_t w,
                           int32_t* out_read, int32_t* out_pos,
                           uint64_t* out_canon, uint8_t* out_orient,
                           int64_t cap) {
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  // parallel over contiguous read ranges; per-thread buffers concatenated
  // in read order afterwards, so output order is identical to the former
  // sequential loop regardless of thread count
  int64_t total_bases = 0;
  for (int64_t r = 0; r < n_reads; ++r) total_bases += lengths[r];
  const int T = n_threads(total_bases);
  std::vector<int64_t> rb(T + 1);
  for (int t = 0; t <= T; ++t) rb[t] = n_reads * t / T;
  struct Buf {
    std::vector<int32_t> read, pos;
    std::vector<uint64_t> canon;
    std::vector<uint8_t> orient;
  };
  std::vector<Buf> bufs(T);

  auto work = [&](int t) {
    Buf& o = bufs[t];
    std::vector<uint64_t> canon, hash;
    std::vector<uint8_t> orient;
    std::vector<int32_t> picks;
    for (int64_t r = rb[t]; r < rb[t + 1]; ++r) {
      const uint8_t* row = codes + r * lpad;
      const int32_t len = lengths[r];
      const int32_t nk = len - k + 1;
      if (nk <= 0) continue;

      canon.assign(nk, 0);
      hash.assign(nk, 0);
      orient.assign(nk, 0);

      // rolling forward and reverse-complement kmers
      uint64_t fwd = 0, rev = 0;
      for (int32_t i = 0; i < len; ++i) {
        fwd = ((fwd << 2) | (row[i] & 3)) & mask;
        rev = (rev >> 2) | ((3ULL - (row[i] & 3)) << (2 * (k - 1)));
        if (i >= k - 1) {
          const int32_t p = i - k + 1;
          const bool rc_smaller = rev < fwd;
          orient[p] = rc_smaller ? 1 : 0;
          canon[p] = rc_smaller ? rev : fwd;
          hash[p] = hash64(canon[p]);
        }
      }

      // window minima, first-min tie-break (== numpy argmin), dedup
      const int32_t win = (nk <= w) ? nk : w;
      std::deque<int32_t> dq;
      picks.clear();
      for (int32_t i = 0; i < nk; ++i) {
        while (!dq.empty() && hash[i] < hash[dq.back()]) dq.pop_back();
        dq.push_back(i);
        if (dq.front() <= i - win) dq.pop_front();
        if (i >= win - 1) picks.push_back(dq.front());
      }
      if (picks.empty() && nk > 0)
        picks.push_back((int32_t)(
            std::min_element(hash.begin(), hash.end()) - hash.begin()));
      std::sort(picks.begin(), picks.end());
      picks.erase(std::unique(picks.begin(), picks.end()), picks.end());
      for (int32_t p : picks) {
        o.read.push_back((int32_t)r);
        o.pos.push_back(p);
        o.canon.push_back(canon[p]);
        o.orient.push_back(orient[p]);
      }
    }
  };
  {
    std::vector<std::thread> th;
    for (int t = 1; t < T; ++t) th.emplace_back(work, t);
    work(0);
    for (auto& x : th) x.join();
  }
  int64_t n_out = 0;
  for (int t = 0; t < T; ++t) n_out += (int64_t)bufs[t].read.size();
  if (n_out > cap) return -1;
  int64_t o = 0;
  for (int t = 0; t < T; ++t) {
    const int64_t m = (int64_t)bufs[t].read.size();
    std::memcpy(out_read + o, bufs[t].read.data(), m * 4);
    std::memcpy(out_pos + o, bufs[t].pos.data(), m * 4);
    std::memcpy(out_canon + o, bufs[t].canon.data(), m * 8);
    std::memcpy(out_orient + o, bufs[t].orient.data(), m * 1);
    o += m;
  }
  return n_out;
}

// Seed matching: emit all cross-read pairs per canonical-k-mer bucket
// (buckets larger than max_occ skipped), with relative strand and diagonal
// in the a-forward frame (a = smaller read id).
//
// presorted != 0 asserts the caller already sorted seeds by (canon,
// read_id) — the production path: a numpy combined-key sort of 45M seeds
// takes ~2 s where the former std::stable_sort through a 64-bit comparator
// lambda took 71 s at c6 geometry (round-5 host-seeding profile), and the
// blocked engine re-paid it per tile (8x).  presorted == 0 keeps the
// self-sorting behavior for ad-hoc callers.
//
// cross_split >= 0 restricts emission to pairs straddling the read-id
// boundary (a < cross_split <= b) — the DALIGNER block-vs-block tile case
// (overlap_reads_blocked), which would otherwise re-emit intra-block pairs
// in every cross tile only to discard them.  cross_split < 0 emits all.
// Returns pairs written (<= cap) or -1 on overflow.
int64_t match_seed_pairs(const int32_t* read_id, const int32_t* pos,
                         const uint64_t* canon, const uint8_t* orient,
                         int64_t n_seeds, const int32_t* lengths, int32_t k,
                         int32_t max_occ, int32_t cross_split,
                         int32_t presorted,
                         int32_t* out_a, int32_t* out_b,
                         int32_t* out_strand, int32_t* out_diag, int64_t cap) {
  std::vector<int64_t> order;
  const int64_t* ord = nullptr;
  if (!presorted) {
    order.resize(n_seeds);
    for (int64_t i = 0; i < n_seeds; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
      if (canon[x] != canon[y]) return canon[x] < canon[y];
      return read_id[x] < read_id[y];
    });
    ord = order.data();
  }
  auto at = [&](int64_t t) -> int64_t { return ord ? ord[t] : t; };

  int64_t n_out = 0;
  int64_t s = 0;
  while (s < n_seeds) {
    int64_t e = s + 1;
    while (e < n_seeds && canon[at(e)] == canon[at(s)]) ++e;
    const int64_t c = e - s;
    if (c >= 2 && c <= max_occ) {
      for (int64_t x = s; x < e; ++x) {
        for (int64_t y = x + 1; y < e; ++y) {
          int64_t i = at(x), j = at(y);
          if (read_id[i] == read_id[j]) continue;
          if (read_id[i] > read_id[j]) std::swap(i, j);
          const int32_t a = read_id[i], b = read_id[j];
          if (cross_split >= 0 && !(a < cross_split && b >= cross_split))
            continue;
          const int32_t st = orient[i] ^ orient[j];
          const int32_t lb = lengths[b];
          const int32_t pb_or = st ? (lb - k - pos[j]) : pos[j];
          if (n_out >= cap) return -1;
          out_a[n_out] = a;
          out_b[n_out] = b;
          out_strand[n_out] = st;
          out_diag[n_out] = pos[i] - pb_or;
          ++n_out;
        }
      }
    }
    s = e;
  }
  return n_out;
}

// 64-bit LSB radix argsort: writes the sorting permutation of keys[0..n)
// into order_out (stable).  8 passes x 8 bits with (key, idx) payload —
// ~20x the throughput of comparator std::stable_sort on 45M+ seed keys.
void sort_u64_order(const uint64_t* keys, int64_t n, int64_t* order_out) {
  std::vector<std::pair<uint64_t, int64_t>> a(n), b(n);
  for (int64_t i = 0; i < n; ++i) a[i] = {keys[i], i};
  radix_sort_pairs(a, b);
  for (int64_t i = 0; i < n; ++i) order_out[i] = a[i].second;
}

// Candidate histogram over raw seed pairs: group by (a, b, strand,
// diag band), count + mean-diag per bucket, keep buckets with >= min_seeds
// seeds, then per (a, b, strand) keep the band with the most seeds
// (smallest band on ties).  Bit-identical to the numpy reference in
// seeding.match_seeds (key packing, floor division and tie-breaks match);
// replaces a 76M-row np.unique full sort (33 s) + key build (15 s) at c6
// geometry with one radix sort + linear scans (~6 s).
// Returns output rows, or -1 if cap exceeded.
int64_t pair_histogram(const int32_t* a, const int32_t* b, const int32_t* st,
                       const int32_t* diag, int64_t n_pairs, int64_t n_reads,
                       int32_t diag_band, int32_t min_seeds,
                       int32_t* out_a, int32_t* out_b, int32_t* out_st,
                       int32_t* out_d0, int32_t* out_cnt, int64_t cap) {
  // key = ((a*(n_reads+1)+b)*2 + st) << 22 | band  (band = floor_divide
  // (diag + 2^20, diag_band) — non-negative for |diag| < 2^20)
  std::vector<std::pair<uint64_t, int64_t>> kv(n_pairs), tmp(n_pairs);
  for (int64_t i = 0; i < n_pairs; ++i) {
    const int64_t band =
        ((int64_t)diag[i] + (1LL << 20)) / diag_band;  // diag >= -2^20: >= 0
    const uint64_t key =
        ((((uint64_t)a[i] * (n_reads + 1) + b[i]) * 2 + st[i]) << 22) |
        (uint64_t)band;
    kv[i] = {key, diag[i]};
  }
  radix_sort_pairs(kv, tmp);
  // linear scan: per band-bucket (count, diag sum); per (pair, strand)
  // group keep (max count, then smallest band); emit in pk-ascending order
  int64_t n_out = 0;
  int64_t i = 0;
  while (i < n_pairs) {
    const uint64_t pk = kv[i].first >> 22;  // (pair, strand) group
    int32_t best_cnt = 0;
    uint64_t best_band = 0;
    int64_t best_dsum = 0;
    while (i < n_pairs && (kv[i].first >> 22) == pk) {
      const uint64_t key = kv[i].first;
      int32_t cnt = 0;
      int64_t dsum = 0;
      while (i < n_pairs && kv[i].first == key) {
        dsum += kv[i].second;
        ++cnt;
        ++i;
      }
      if (cnt >= min_seeds && cnt > best_cnt) {
        best_cnt = cnt;
        best_band = key & ((1 << 22) - 1);
        best_dsum = dsum;
      }
      // ties keep the FIRST (smallest band): bands scan in ascending order
      (void)best_band;
    }
    if (best_cnt > 0) {
      if (n_out >= cap) return -1;
      const uint64_t rest = pk;
      out_st[n_out] = (int32_t)(rest & 1);
      const uint64_t ab = rest >> 1;
      out_b[n_out] = (int32_t)(ab % (uint64_t)(n_reads + 1));
      out_a[n_out] = (int32_t)(ab / (uint64_t)(n_reads + 1));
      // numpy floor division semantics for possibly-negative dsum
      const int64_t c = best_cnt;
      int64_t q = best_dsum >= 0 ? best_dsum / c
                                 : -((-best_dsum + c - 1) / c);
      out_d0[n_out] = (int32_t)q;
      out_cnt[n_out] = best_cnt;
      ++n_out;
    }
  }
  return n_out;
}

}  // extern "C"
