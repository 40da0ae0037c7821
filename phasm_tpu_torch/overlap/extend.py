"""W-band extension (plain ``dp_core`` twin + kernel 3) and the device
extender that routes each (band, column bucket) to a kernel family.

``dp_core`` here is a bit-identical torch twin of
``phasm_tpu.overlap.extend.dp_core``: the packed cell ``cost * pack + s_rel``
with ``pack = max(128, next_pow2(W))``, the ``BIG = 2^15`` clamp, the two
endpoint reductions and their tie-breaks, and the two-grid WINDOW statistic
whose first half-span is not scored.  Kernel 3 (``csrc/wband.cu``) computes
the same function for every band W up to 512.

Routing copies the reference's ``DeviceExtender._get_run`` (the TPU's VMEM
predicates decide the Myers / W-band boundary, and the two families give
different alignments, so the boundary is imported, not re-derived):

  * Myers kernels iff W <= MYERS_MAX_BAND and (tab2_fits(W, J) or
    kernel_vmem_bytes(W, J) <= MYERS_VMEM_BUDGET) under ``myers_pallas``;
  * otherwise the W-band kernel for W <= 512.  The reference runs the
    segmented Pallas kernel up to PALLAS_MAX_BAND = 256 and the jnp
    dp_core above; both compute dp_core's function, and so does kernel 3;
  * the plain dp_core only where the reference has no kernel either: past
    W = 512 (above PALLAS_MAX_BAND), and everywhere under ``jnp`` (the CPU
    default).
"""
from __future__ import annotations

import numpy as np
import torch

from phasm_tpu import metrics
from phasm_tpu.overlap.extend import BIG, WINDOW, ExtendResult
from phasm_tpu.overlap.extend import DeviceExtender as _RefExtender
from phasm_tpu.overlap.myers_pallas import kernel_vmem_bytes, tab2_fits

from phasm_tpu_torch import _build
from phasm_tpu_torch.overlap.myers_cuda import check_launch_inputs, index_tensors, myers_pair
from phasm_tpu_torch.state import DeviceReads

BIGK = 1 << 30
MYERS_MAX_BAND = _RefExtender.MYERS_MAX_BAND
MYERS_VMEM_BUDGET = _RefExtender.MYERS_VMEM_BUDGET
WBAND_MAX_BAND = 512  # kernel 3 takes every band 1 <= W <= 512

wband_launches = 0


def dp_core(a2, b2, la, lb, d0, band: int):
    """Twin of ``extend.dp_core``.  a2 [B, J + W] band-aligned a codes,
    b2 [B, J]; la/lb/d0 [B].  Returns int64 (cost, i0, a_end, b_end, win).

    The column loop stops after the batch's longest b: past a pair's lb
    every cell is invalid, no endpoint fires and no window is in its cap,
    so the skipped columns change nothing."""
    B, J = b2.shape
    W = band
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
    for j in range(ncols):
        sub = (a2[:, j : j + W] != b2[:, j : j + 1]).long() * pack
        i_cell = d0c + (j + 1) + iota_w - half
        up = torch.cat([P[:, 1:], big_col], dim=1) + pack
        x = torch.minimum(P + sub, up) - iota_w * pack
        Pn = torch.cummin(x, dim=1).values + iota_w * pack  # left dependency
        valid = (i_cell >= 0) & (i_cell <= lac) & (j < lbc)
        P = torch.where(valid, Pn, BIGPW).clamp(max=BIGPW)

        cost, s_rel = P // pack, P % pack
        key1 = torch.where(
            P < BIGPW, (cost << (lw + 1)) + (W - 1 - iota_w + s_rel), BIGK
        )
        # endpoint i == la: at most one band cell this column
        la_mask = i_cell == lac
        k_la = torch.where(la_mask, key1, BIGK).min(dim=1).values
        w_la = torch.where(
            la_mask & (key1 == k_la[:, None]), iota_w, W
        ).min(dim=1).values
        consider(j, k_la, w_la, k_la < BIGK)
        # endpoint j + 1 == lb: best cell of the final column
        k_be = key1.min(dim=1).values
        w_be = torch.where(key1 == k_be[:, None], iota_w, W).min(dim=1).values
        consider(j, k_be, w_be, (lb == j + 1) & (k_be < BIGK))

        if (j + 1) % (WINDOW // 2) == 0:  # windowed-divergence probe
            colmin = cost.min(dim=1).values
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


def band_tensors(codes, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Band-aligned pair tensors (the reference extender's prep):
    a2[p, t] = a[d0 + t - W/2] (254 outside the read), b2[p, j] = b[j]
    (255 past lb).  Returns int64 (a2, b2, la, lb, d0)."""
    a_oid, b_oid, d0 = a_oid.long(), b_oid.long(), d0.long()
    la, lb = lengths[a_oid >> 1].long(), lengths[b_oid >> 1].long()
    LA = codes.shape[1]
    dev = codes.device
    ai = d0[:, None] + torch.arange(J + W, device=dev)[None, :] - W // 2
    a_rows = codes[a_oid].long()
    a2 = torch.where(
        (ai >= 0) & (ai < la[:, None]), a_rows.gather(1, ai.clamp(0, LA - 1)), 254
    )
    jj = torch.arange(J, device=dev)[None, :]
    b_rows = codes[b_oid].long()
    b2 = torch.where(jj < lb[:, None], b_rows.gather(1, jj.clamp(max=LA - 1).expand(len(b_oid), J)), 255)
    return a2, b2, la, lb, d0


def wband_plain(codes, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Kernel 3's contract in plain torch: (cost, i0, iend, jend, win) int32."""
    a2, b2, la, lb, d0 = band_tensors(codes, lengths, a_oid, b_oid, d0, W, J)
    return tuple(x.to(torch.int32) for x in dp_core(a2, b2, la, lb, d0, W))


def wband(reads: DeviceReads, a_oid, b_oid, d0, W: int, J: int):
    """Kernel 3: W-band extension, (cost, i0, iend, jend, win) int32 [B]."""
    global wband_launches
    if reads.device.type == "cpu":
        return wband_plain(reads.codes, reads.lengths, a_oid, b_oid, d0, W, J)
    if not 1 <= W <= WBAND_MAX_BAND:
        raise ValueError(f"W-band kernel takes bands 1..{WBAND_MAX_BAND}, not {W}")
    check_launch_inputs(reads, None, a_oid, b_oid, d0)
    dev = reads.device
    B = a_oid.shape[0]
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    if B:
        err = _build.load().phasm_wband(
            a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(),
            reads.lengths.data_ptr(), reads.codes.data_ptr(), reads.codes.shape[1],
            B, W, J, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "phasm_wband")
        wband_launches += 1
    return tuple(out[i] for i in range(5))


def route(backend: str, W: int, J: int) -> str:
    """Kernel family for one (band, column bucket): myers | wband | dp_core."""
    if backend == "jnp":
        return "dp_core"
    if W <= MYERS_MAX_BAND and (
        backend == "myers"
        or (
            backend == "myers_pallas"
            and (tab2_fits(W, J) or kernel_vmem_bytes(W, J) <= MYERS_VMEM_BUDGET)
        )
    ):
        return "myers"
    return "wband" if W <= WBAND_MAX_BAND else "dp_core"


class DeviceExtender:
    """Device-resident batched extension: the surface the reference engine's
    ``_dispatch_bucketed`` / ``_materialize_pending`` /
    ``_escalate_and_build`` drive (``extend_async`` + ``materialize``).

    backend: ``myers_pallas`` (what the engine's ``auto`` means on CUDA),
    ``jnp`` (what it means on the CPU), ``myers`` or ``pallas``."""

    def __init__(self, reads: DeviceReads, band: int, backend: str):
        if backend not in ("myers_pallas", "myers", "pallas", "jnp"):
            raise ValueError(f"unknown backend {backend!r}")
        self.reads = reads
        self.band = band
        self.backend = backend

    def extend_async(self, a_oid, b_oid, d0, jmax: int, band: int | None = None):
        """Launch one batch; returns (device outputs, M).  Nothing waits for
        the device until ``materialize``."""
        W = self.band if band is None else band
        fam = route(self.backend, W, jmax)
        metrics.incr(f"overlap.family.{fam}.j{jmax}")
        a, b, d = index_tensors(self.reads.device, a_oid, b_oid, d0)
        if fam == "myers":
            out = myers_pair(self.reads, a, b, d, W, jmax)
        elif fam == "wband":
            out = wband(self.reads, a, b, d, W, jmax)
        else:  # where the reference runs the jnp dp_core, no kernel
            out = wband_plain(self.reads.codes, self.reads.lengths, a, b, d, W, jmax)
        return out, int(a.shape[0])

    @staticmethod
    def materialize(out, M: int) -> ExtendResult:
        cost, i0, ie, je, wn = (x.cpu().numpy() for x in out)
        return ExtendResult(
            a_start=i0, a_end=ie, b_start=np.zeros(M, dtype=np.int32),
            b_end=je, diffs=cost, win_cost=wn,
        )
