"""Batches of the benchmark's traffic: frozen copies of the overlap
engine's candidate normalisation, column bucketing, 65,536-pair chunking
and band-escalation retry rule (``phasm_tpu_torch.overlap.engine``), and of
the routing predicates that pick a kernel family for each (band, bucket)
(``phasm_tpu_torch.overlap.routing`` with the constants it reads).

They are copies so that the yardstick does not move when later changes
make the program batch, route or escalate differently: the window always
drives these batches, and the reference judges each by the family these
predicates name.
"""
from __future__ import annotations

import dataclasses

import numpy as np

BIG = 1 << 15  # cost of a pair with no endpoint
WINDOW = 256  # columns of the windowed-divergence statistic
MAX_BATCH = 65536  # pairs a device call

# routing constants (the reference engine's class constants and the TPU's
# scoped-VMEM budget its Myers / W-band boundary was drawn from)
WB = 32
MYERS_MAX_BAND = 128
WBAND_MAX_BAND = 512
VMEM_BUDGET = 14 << 20
BK = 32
BKB = 128
JWMAX = 128


@dataclasses.dataclass(frozen=True)
class OverlapParams:
    band: int = 64
    wide_bands: tuple = (128, 256, 512)
    min_overlap: int = 500
    pallas_buckets: tuple = (1024, 4096)
    seg: int = 4096
    max_jmax: int = 131072
    wide_retry_factor: float = 1.25
    wide_retry_margin: float = 0.02
    backend: str = "myers_pallas"


def K_of(W: int) -> int:
    return -(-(W + 63) // WB) + 1


def rev_K(W: int) -> int:
    return K_of(W) + 3


def _tab2_geometry(W: int, J: int):
    gf = -(-(J // WB + K_of(W) + BK - 1) // BK)
    gr = -(-(J // WB + rev_K(W) + 1 + BK - 1) // BK)
    gb = -(-(J // 16 + 1 + BKB - 1) // BKB)
    return gf, gr, gb


def _vmem_bytes(W: int, J: int, R: int | None = None) -> int:
    if R is None:
        R = 16 if _vmem_bytes(W, J, 16) <= VMEM_BUDGET else 8
    return 2 * ((J // WB + rev_K(W)) * 4 + J // 16) * (R * 128 * 4)


def _vmem_bytes_tab2(W: int, J: int, R: int) -> int:
    GF, GR, GB = _tab2_geometry(W, J)
    persistent = (J // WB + rev_K(W)) * 4 + J // 16
    return (persistent + max(2 * max(GF, GR) * 128, 2 * GB * BKB)) * (R * 128 * 4)


def _tab2_fits(W: int, J: int) -> bool:
    return J // 16 <= JWMAX and _vmem_bytes_tab2(W, J, 8) <= VMEM_BUDGET


def route(backend: str, W: int, J: int) -> str:
    """Kernel family of one (band, column bucket): myers | wband | dp_core."""
    if backend == "jnp":
        return "dp_core"
    if W <= MYERS_MAX_BAND and (
        backend == "myers"
        or (backend == "myers_pallas" and (_tab2_fits(W, J) or _vmem_bytes(W, J) <= VMEM_BUDGET))
    ):
        return "myers"
    return "wband" if W <= WBAND_MAX_BAND else "dp_core"


@dataclasses.dataclass
class Frame:
    """Candidates in the kernel frame: A = kernel a side (oriented id), B
    the b side, d0 >= 0 the seed diagonal; la / lb their lengths."""

    ka: np.ndarray
    kb: np.ndarray
    kd: np.ndarray
    la: np.ndarray
    lb: np.ndarray

    def __len__(self):
        return int(self.ka.shape[0])


def normalize(cands, lengths: np.ndarray) -> Frame:
    """Candidate pairs -> kernel frame: a forward, oriented b carrying the
    strand, the roles swapped where the seed diagonal is negative."""
    a_id = cands.a_id.astype(np.int64)
    b_id = cands.b_id.astype(np.int64)
    d = cands.diag.astype(np.int64)
    oid_a, oid_b = 2 * a_id, 2 * b_id + cands.strand.astype(np.int64)
    swap = d < 0
    ka = np.where(swap, oid_b, oid_a)
    kb = np.where(swap, oid_a, oid_b)
    kd = np.where(swap, -d, d).astype(np.int32)
    return Frame(ka=ka, kb=kb, kd=kd, la=lengths[ka >> 1].astype(np.int64),
                 lb=lengths[kb >> 1].astype(np.int64))


def need_cols(f: Frame, idx: np.ndarray, band: int) -> np.ndarray:
    """Columns each pair needs at ``band``: to the end of b or of a, plus the band."""
    return np.minimum(f.lb[idx], f.la[idx] - f.kd[idx] + band).astype(np.int64) + band


def bucket_edges(need: np.ndarray, p: OverlapParams) -> list[int]:
    """The short fixed buckets, then segment multiples up to the largest
    needed count (capped)."""
    max_need = int(min(need.max(), p.max_jmax)) if need.shape[0] else 0
    edges = [b for b in p.pallas_buckets if b < max_need]
    k = 2
    while k * p.seg < max_need:
        if k * p.seg > (edges[-1] if edges else 0):
            edges.append(k * p.seg)
        k *= 2
    edges.append(((max_need + p.seg - 1) // p.seg) * p.seg if max_need > p.pallas_buckets[0]
                 else p.pallas_buckets[0])
    return sorted(set(edges))


@dataclasses.dataclass
class Batch:
    """One device call: pairs ``idx`` (positions in the frame) at band W
    over J columns, run by ``family``."""

    W: int
    J: int
    family: str
    idx: np.ndarray


def plan(f: Frame, idx: np.ndarray, band: int, p: OverlapParams) -> list[Batch]:
    """Pairs ``idx`` bucketed by needed columns and chunked (``MAX_BATCH``
    pairs a call) as the engine dispatches them, in its order."""
    need = need_cols(f, idx, band)
    out, prev = [], 0
    edges = bucket_edges(need, p)
    for bi, cap in enumerate(edges):
        sel = (need > prev) & (need <= cap) if bi + 1 < len(edges) else (need > prev)
        prev = cap
        sel_idx = idx[np.nonzero(sel)[0]]
        fam = route(p.backend, band, cap)
        for s0 in range(0, sel_idx.shape[0], MAX_BATCH):
            out.append(Batch(W=band, J=cap, family=fam, idx=sel_idx[s0 : s0 + MAX_BATCH]))
    return out


class Results:
    """Per-candidate results (cost, a_start, a_end, b_end, win) int64."""

    def __init__(self, n: int):
        self.cols = np.zeros((5, n), dtype=np.int64)
        self.cols[0] = BIG

    def put(self, idx: np.ndarray, rows: np.ndarray) -> None:
        self.cols[:, idx] = rows.T


def escalate(f: Frame, first: Results, p: OverlapParams, run_band):
    """The engine's band escalation from first-pass results: for each wider
    band, the pairs that re-extend there.  ``run_band(W, idx)`` extends
    pairs ``idx`` at band W and returns their [len(idx), 5] rows; each
    band's selection reads the results of the bands before it.  Returns
    [(W, idx)] in order (idx may be empty)."""
    N = len(f)
    r = first.cols.copy()
    out = []
    if not N or not any(W2 > p.band for W2 in p.wide_bands):
        return out
    r_diffs, r_as, r_ae, r_be, r_win = r
    aln_len = np.maximum(np.maximum(r_ae - r_as, r_be), 1)
    err1 = r_diffs / aln_len
    fidx = np.nonzero(r_diffs < BIG)[0]
    e_half = np.zeros(int(max(f.ka.max(), f.kb.max()) >> 1) + 1, dtype=np.float64)
    if fidx.shape[0]:
        rds = np.concatenate([f.ka[fidx] >> 1, f.kb[fidx] >> 1])
        ers = np.concatenate([err1[fidx], err1[fidx]])
        order = np.lexsort((ers, rds))
        rds_s, ers_s = rds[order], ers[order]
        uniq_r, starts = np.unique(rds_s, return_index=True)
        counts = np.diff(np.append(starts, rds_s.shape[0]))
        lo = ers_s[starts + (counts - 1) // 2]
        hi = ers_s[starts + counts // 2]
        e_half[uniq_r] = (lo + hi) / 2.0 / 2.0
    exp_pair = e_half[f.ka >> 1] + e_half[f.kb >> 1]
    mu_w = exp_pair * WINDOW
    win_thresh = mu_w + np.maximum(6.0 * np.sqrt(mu_w), 12.0)
    band_rung = np.full(N, p.band, dtype=np.int64)
    exhausted = np.zeros(N, dtype=bool)
    for W2 in p.wide_bands:
        if W2 <= p.band:
            continue
        r_diffs, r_as, r_ae, r_be, r_win = r
        aln_len = np.maximum(np.maximum(r_ae - r_as, r_be), 1)
        err1 = r_diffs / aln_len
        sigma = np.sqrt(np.maximum(aln_len * exp_pair, 0.0) * 0.8)
        covered = (band_rung // 2) >= 4.0 * sigma + 8.0
        retry = ((r_diffs >= BIG) | (((err1 > exp_pair * p.wide_retry_factor + p.wide_retry_margin)
                                      | (r_win > win_thresh)) & ~covered)) & ~exhausted
        ridx = np.nonzero(retry)[0]
        out.append((W2, ridx))
        if ridx.shape[0]:
            new = run_band(W2, ridx).T.astype(np.int64)
            exhausted[ridx[(r[:, ridx] == new).all(axis=0)]] = True
            r[:, ridx] = new
            band_rung[ridx] = W2
    return out
