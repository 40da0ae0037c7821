"""W-band extension: the plain ``dp_core`` twin, kernel 3 (W-band over the
resident read set), kernel 4 (W-band over staged band windows) and the
stateless batch entry point around kernel 4.

``dp_core`` here is a bit-identical torch twin of
``phasm_tpu.overlap.extend.dp_core``: the packed cell ``cost * pack + s_rel``
with ``pack = max(128, next_pow2(W))``, the ``BIG = 2^15`` clamp, the two
endpoint reductions and their tie-breaks, and the two-grid WINDOW statistic
whose first half-span is not scored.  Both kernels (``csrc/wband.cu``)
compute the same function:

  * kernel 3, ``wband``: pairs by oriented id against ``DeviceReads``,
    every band W up to 512 and any J (the engine's W-band family), its
    codes read from the resident matrix;
  * kernel 4, ``wband_dense``: pairs as staged ``a2``/``b2`` windows
    (``prepare_pair_tensors``), the reference's single-shot Pallas
    contract 1 <= W <= 128, ``jmax % 8 == 0``, ``jmax < 32768``.

Both run one body: several pairs to a warp, each run to its last live
column (``dense_live_cols``) and launched in ``column_order`` of those,
with the endpoint tests only in the 8-column steps that
``dense_quiet_steps`` does not clear.

The batch API mirrors the reference's: ``prepare_pair_tensors`` (staging),
``banded_overlap_batch`` (the plain version) and ``banded_overlap_cuda``
(the twin of ``banded_overlap_pallas``), host arrays in and an
``ExtendResult`` out, with no engine and no resident reads.

``BIG``, ``WINDOW``, ``ExtendResult`` and the routing bounds are copies of
the reference's; ``overlap.routing`` decides which family runs a bucket.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phasm_tpu_torch import _build
from phasm_tpu_torch.device import resolve_device

# Packed DP cell: P = cost * pack + s_rel; cell costs are clamped to
# BIG = 2**15 every column, so an alignment needing >= 32768 edits reports
# as "not found".  BIGK is the endpoint-key no-result.
BIG = np.int32(1 << 15)
BIGK = 1 << 30

# Windowed-divergence probe: the band's minimum cost per column is
# nondecreasing, so the delta across a WINDOW-column span lower-bounds the
# edits every path spends there.  Two grids offset by WINDOW/2; windows are
# scored only while fully interior (j <= min(lb, la - d0 - W/2)).
WINDOW = 256

# routing bounds, the reference ``DeviceExtender``'s class constants
MYERS_MAX_BAND = 128  # widest band the Myers kernels run at
MYERS_VMEM_BUDGET = 14 << 20  # the TPU's scoped-VMEM budget for the Myers streams
PALLAS_MAX_BAND = 256  # widest band of the reference's segmented W-band kernel

WBAND_MAX_BAND = 512  # kernel 3 takes every band 1 <= W <= 512
# kernel 4 (the reference's single-shot kernel): its packed endpoint keys
# hold w in 7 bits and the end-key middle in 8, so W <= 128; its columns
# run in aligned blocks of 8; its i == la key underflows past 2^15 columns
DENSE_MAX_BAND = 128
DENSE_MAX_JMAX = 1 << 15

wband_launches = 0
wband_dense_launches = 0


@dataclasses.dataclass
class ExtendResult:
    a_start: np.ndarray
    a_end: np.ndarray
    b_start: np.ndarray
    b_end: np.ndarray
    diffs: np.ndarray
    # max edits forced in any fully-interior WINDOW-column span (0 when the
    # overlap is too short for a full window); see WINDOW
    win_cost: np.ndarray | None = None


def dp_core(a2, b2, la, lb, d0, band: int):
    """Twin of ``extend.dp_core``.  a2 [B, J + W] band-aligned a codes,
    b2 [B, J] (any integer type); la/lb/d0 [B].  Returns int64 (cost, i0,
    a_end, b_end, win).

    The column loop stops after the batch's longest b: past a pair's lb
    every cell is invalid, no endpoint fires and no window is in its cap,
    so the skipped columns change nothing."""
    B, J = b2.shape
    W = band
    la, lb, d0 = la.long(), lb.long(), d0.long()
    dev = b2.device
    lw = max(7, (W - 1).bit_length())
    pack = 1 << lw
    BIGPW = (1 << 15) * pack
    iota_w = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    half = W // 2
    d0c, lac, lbc = d0[:, None], la[:, None], lb[:, None]
    base = d0 - half  # i0 = s_rel + base

    i_at_j0 = d0c + iota_w - half
    P = torch.where((i_at_j0 >= 0) & (i_at_j0 <= lac), iota_w, BIGPW)
    win_cap = torch.minimum(lb, la - d0 - half)

    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    bcost, blen, bi0, bie, bje = zero + int(BIG), zero - 1, zero, zero, zero
    wprev, wmax, wprev2, wmax2 = zero, zero, zero, zero
    big_col = torch.full((B, 1), BIGPW, dtype=torch.int64, device=dev)
    wpk = iota_w * pack

    def key(p, w):
        """Endpoint key cost << (lw+1) | (W-1 - w + s_rel) of packed cells."""
        return torch.where(p < BIGPW, ((p >> lw) << (lw + 1)) + (W - 1 - w + (p & (pack - 1))), BIGK)

    def consider(j, cand_key, w_sel, mask):
        nonlocal bcost, blen, bi0, bie, bje
        ck = torch.where(mask, cand_key, BIGK)
        cost = ck >> (lw + 1)
        mid = ck & ((1 << (lw + 1)) - 1)
        i0 = mid - (W - 1) + w_sel + base
        i_end = torch.minimum(d0 + (j + 1) + w_sel - half, la)
        alen = (i_end - i0) + (j + 1)
        better = (ck < BIGK) & ((cost < bcost) | ((cost == bcost) & (alen > blen)))
        bcost = torch.where(better, cost, bcost)
        blen = torch.where(better, alen, blen)
        bi0 = torch.where(better, i0, bi0)
        bie = torch.where(better, i_end, bie)
        bje = torch.where(better, zero + (j + 1), bje)

    ncols = min(J, int(lb.max())) if B else 0
    end_cols = set(lb.tolist())  # columns j + 1 where some pair's b ends
    w_la0 = la - d0 + half - 1  # band cell on row la at column j: w_la0 - j
    for j in range(ncols):
        sub = (a2[:, j : j + W] != b2[:, j : j + 1]) * pack
        up = torch.cat([P[:, 1:], big_col], dim=1) + pack
        x = torch.minimum(P + sub, up) - wpk
        Pn = torch.cummin(x, dim=1).values + wpk  # left dependency
        i_cell = i_at_j0 + (j + 1)
        valid = (i_cell >= 0) & (i_cell <= lac) & (j < lbc)
        P = torch.where(valid, Pn.clamp(max=BIGPW), BIGPW)

        # endpoint i == la: the one band cell on row la, when in the band
        w_la = w_la0 - j
        in_band = (w_la >= 0) & (w_la < W)
        w_la = w_la.clamp(0, W - 1)
        k_la = key(P.gather(1, w_la[:, None])[:, 0], w_la)
        consider(j, k_la, w_la, in_band & (k_la < BIGK))
        # endpoint j + 1 == lb: best cell of the final column, smallest w on ties
        if j + 1 in end_cols:
            key1 = key(P, iota_w)
            k_be = key1.min(dim=1).values
            w_be = torch.where(key1 == k_be[:, None], iota_w, W).min(dim=1).values
            consider(j, k_be, w_be, (lb == j + 1) & (k_be < BIGK))

        if (j + 1) % (WINDOW // 2) == 0:  # windowed-divergence probe
            colmin = (P >> lw).min(dim=1).values
            in_cap = (j + 1) <= win_cap
            if (j + 1) % WINDOW == 0:
                wmax = torch.where(in_cap, torch.maximum(wmax, colmin - wprev), wmax)
                wprev = colmin
            else:
                if j + 1 != WINDOW // 2:  # half-size first span: not scored
                    wmax2 = torch.where(
                        in_cap, torch.maximum(wmax2, colmin - wprev2), wmax2
                    )
                wprev2 = colmin
    return bcost, bi0, bie, bje, torch.maximum(wmax, wmax2)


def stage_pairs(codes, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Band windows of each pair, gathered on the codes' device:
    a2[p, t] = a[d0 + t - W/2] for t < J + W (254 outside the read) and
    b2[p, j] = b[j] for j < J (255 past lb), both uint8 [M, *]; la, lb
    int32 [M].  Rows stay pairs-major, one pair's window contiguous."""
    a_oid, b_oid = a_oid.long(), b_oid.long()
    la, lb = lengths[a_oid >> 1], lengths[b_oid >> 1]
    LA = codes.shape[1]
    dev = codes.device
    flat = codes.reshape(-1)
    ai = d0.long()[:, None] + torch.arange(J + W, device=dev)[None, :] - W // 2
    a_ok = (ai >= 0) & (ai < la.long()[:, None])
    a2 = torch.where(a_ok, flat[a_oid[:, None] * LA + ai.clamp(0, LA - 1)], 254)
    jj = torch.arange(J, device=dev)[None, :]
    b_ok = jj < lb.long()[:, None]
    b2 = torch.where(b_ok, flat[b_oid[:, None] * LA + jj.clamp(max=LA - 1)], 255)
    return a2, b2, la.to(torch.int32), lb.to(torch.int32)


def _i32(xs):
    return tuple(x.to(torch.int32) for x in xs)


def wband_plain(codes, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Kernel 3's contract in plain torch: (cost, i0, iend, jend, win) int32."""
    a2, b2, la, lb = stage_pairs(codes, lengths, a_oid, b_oid, d0, W, J)
    return _i32(dp_core(a2, b2, la, lb, d0, W))


def wband(reads, a_oid, b_oid, d0, W: int, J: int):
    """Kernel 3: W-band extension of pairs of a ``state.DeviceReads`` read
    set, (cost, i0, iend, jend, win) int32 [B]; pairs launched in
    ``column_order`` of their ``dense_live_cols``."""
    global wband_launches
    if reads.device.type == "cpu":
        return wband_plain(reads.codes, reads.lengths, a_oid, b_oid, d0, W, J)
    if not 1 <= W <= WBAND_MAX_BAND:
        raise ValueError(f"W-band kernel takes bands 1..{WBAND_MAX_BAND}, not {W}")
    _build.check_launch_inputs(reads, None, a_oid, b_oid, d0)
    dev = reads.device
    B = a_oid.shape[0]
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    if B:
        # gathered on the device: extend_async does not wait for it
        la, lb = reads.lengths[a_oid.long() >> 1], reads.lengths[b_oid.long() >> 1]
        order = column_order(dense_live_cols(la, lb, d0, W, J), J)
        n_o, LA = reads.codes.shape
        err = _build.load().phasm_wband(
            order.data_ptr(), a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(),
            reads.lengths.data_ptr(), reads.codes.data_ptr(), n_o, LA,
            B, W, J, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "phasm_wband")
        wband_launches += 1
        _build.count_shape("wband", B, W, J)
    return tuple(out[i] for i in range(5))


def column_order(cols, J: int) -> torch.Tensor:
    """The launch order of kernels 1 to 4: pair indices (int64, on
    cols' device) by the 32-column blocks each pair runs, most first (the
    key floor(min(cols, J - 1) / 32) groups pairs as the block count does),
    so the pairs that share a warp run loops of about the same length and
    the longest warps start first.  The key is one byte up to J = 8192 (two
    above), which sorts faster than the int32 columns do."""
    key = torch.uint8 if J <= 256 * 32 else torch.int16
    return torch.argsort((cols.clamp(max=J - 1) >> 5).to(key), descending=True)


def dense_live_cols(la, lb, d0, W: int, J: int) -> torch.Tensor:
    """The columns kernels 3 and 4 run for each pair, int64 [M]: min(J, lb,
    la - d0 + W // 2), at least 0.  Past column ae_hi = la - d0 + W // 2 - 1
    every band cell lies on a row past la, so no endpoint fires there and no
    window mark counts (they stop at la - d0 - W // 2).  Same formulas, in
    the same order, as csrc/wband.cu."""
    la, lb, d0 = (t.long() for t in (la, lb, d0))
    ae_hi = la - d0 + W // 2 - 1
    return torch.minimum(lb.clamp(max=J), ae_hi + 1).clamp(min=0)


def dense_quiet_steps(la, lb, d0, W: int, J: int) -> torch.Tensor:
    """The W-band kernels' step predicate, bool [M, J // 8]: True where pair p's
    8-column step j8 .. j8 + 7 can fire no endpoint, so the kernel runs it
    without the endpoint tests (when every pair of its warp agrees): row la
    lies outside the band in all eight columns (the i == la endpoint's
    columns are ae_hi - W + 1 .. ae_hi) and none is the pair's last column
    lb - 1, or the pair has ended (j8 >= dense_live_cols).  The recurrence itself
    never needs dp_core's validity mask (only cells past the band, w >= W,
    are held invalid): band rows < 0 hold BIG from the first column on
    (they read only rows below them), and rows past la or columns past lb
    never reach a valid cell.  Same formulas, in the same order, as
    csrc/wband.cu."""
    ncol = dense_live_cols(la, lb, d0, W, J)[:, None]
    la, lb, d0 = (t.long()[:, None] for t in (la, lb, d0))
    half = W // 2
    j8 = torch.arange(0, J, 8, device=la.device)[None, :]
    ae_hi = la - d0 + half - 1
    ae_lo = ae_hi - (W - 1)
    return (j8 >= ncol) | (((j8 > ae_hi) | (j8 + 7 < ae_lo)) & ((lb - 1 - j8 < 0) | (lb - 1 - j8 >= 8)))


def check_dense_contract(W: int, J: int) -> None:
    """Raise unless (W, J) is inside kernel 4's contract, the reference
    single-shot kernel's own."""
    if not 1 <= W <= DENSE_MAX_BAND:
        raise ValueError(
            f"band {W}: the dense W-band kernel takes 1..{DENSE_MAX_BAND} "
            "(its endpoint keys hold the band offset w in a 7-bit field)"
        )
    if J % 8:
        raise ValueError(f"jmax {J} must be a multiple of 8 (aligned column blocks)")
    if not 0 < J < DENSE_MAX_JMAX:
        raise ValueError(f"jmax {J} must be below {DENSE_MAX_JMAX} (the i == la endpoint key)")


def wband_dense_plain(a2, b2, la, lb, d0, W: int):
    """Kernel 4's contract in plain torch: (cost, i0, iend, jend, win) int32."""
    return _i32(dp_core(a2, b2, la, lb, d0, W))


def wband_dense(a2, b2, la, lb, d0, W: int):
    """Kernel 4: W-band extension over staged windows; a2 uint8 [M, J + W],
    b2 uint8 [M, J], la/lb/d0 int32 [M].  Returns (cost, i0, iend, jend,
    win) int32 [M]."""
    global wband_dense_launches
    if a2.device.type == "cpu":
        return wband_dense_plain(a2, b2, la, lb, d0, W)
    M, J = b2.shape
    check_dense_contract(W, J)
    for name, t, cols in (("a2", a2, J + W), ("b2", b2, J)):
        if (
            t.device != b2.device or t.dtype != torch.uint8 or t.dim() != 2
            or tuple(t.shape) != (M, cols) or not t.is_contiguous()
        ):
            raise ValueError(f"{name}: expected contiguous uint8 [{M}, {cols}] on {b2.device}")
    _build.check_pair_vectors(b2.device, la, lb, d0)
    if la.shape[0] != M:
        raise ValueError(f"per-pair vectors: {la.shape[0]} pairs, windows hold {M}")
    out = torch.empty((5, M), dtype=torch.int32, device=b2.device)
    if M:
        order = column_order(dense_live_cols(la, lb, d0, W, J), J)
        err = _build.load().phasm_wband_dense(
            order.data_ptr(), a2.data_ptr(), b2.data_ptr(), la.data_ptr(), lb.data_ptr(),
            d0.data_ptr(), M, W, J, out.data_ptr(),
            torch.cuda.current_stream(b2.device).cuda_stream,
        )
        _build.check(err, "phasm_wband_dense")
        wband_dense_launches += 1
    return tuple(out[i] for i in range(5))


def _stage(oriented, lengths, a_oid, b_oid, d0, band: int, jmax: int, device):
    """Upload the host arrays and stage the windows: (a2, b2, la, lb, d0)."""
    dev = resolve_device(device)
    codes = torch.from_numpy(np.ascontiguousarray(oriented, dtype=np.uint8)).to(dev)
    lens = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(dev)
    a, b, d = _build.index_tensors(dev, a_oid, b_oid, d0)
    return (*stage_pairs(codes, lens, a, b, d, band, jmax), d)


def prepare_pair_tensors(oriented, lengths, a_oid, b_oid, d0, band: int, jmax: int, device="cuda"):
    """Twin of the reference's ``prepare_pair_tensors``: uploads the
    oriented [2N, LA] uint8 matrix and gathers on ``device``.  Returns
    (a2 uint8 [M, jmax + band], b2 uint8 [M, jmax], la, lb int32 [M]),
    byte for byte the reference's arrays."""
    return _stage(oriented, lengths, a_oid, b_oid, d0, band, jmax, device)[:4]


def _result(out) -> ExtendResult:
    cost, i0, iend, jend, win = (x.cpu().numpy() for x in out)
    return ExtendResult(
        a_start=i0, a_end=iend, b_start=np.zeros_like(i0), b_end=jend,
        diffs=cost, win_cost=win,
    )


def banded_overlap_batch(
    oriented, lengths, a_oid, b_oid, d0, band: int = 64, jmax: int = 4096, device="cuda",
) -> ExtendResult:
    """Twin of the reference's ``banded_overlap_batch``: staged windows
    through the plain ``dp_core`` (the CPU path, and kernel 4's plain
    version on the card)."""
    return _result(wband_dense_plain(*_stage(oriented, lengths, a_oid, b_oid, d0, band, jmax, device), band))


def banded_overlap_cuda(
    oriented, lengths, a_oid, b_oid, d0, band: int = 64, jmax: int = 4096, device="cuda",
) -> ExtendResult:
    """Twin of the reference's ``banded_overlap_pallas``: staged windows
    through kernel 4, under its contract (1 <= band <= 128, jmax % 8 == 0,
    jmax < 32768; anything else raises).  Nothing is padded: the kernel
    masks the ragged edge.  On a CPU device this is ``banded_overlap_batch``."""
    check_dense_contract(band, jmax)
    if resolve_device(device).type == "cpu":
        return banded_overlap_batch(oriented, lengths, a_oid, b_oid, d0, band, jmax, device)
    return _result(wband_dense(*_stage(oriented, lengths, a_oid, b_oid, d0, band, jmax, device), band))
