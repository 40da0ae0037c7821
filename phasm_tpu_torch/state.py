"""The state the port carries on the device: the read set.

This system has no learned weights.  What stays resident is the oriented
read matrix, the read lengths and, on CUDA, the per-oriented-read match-mask
tables the Myers kernels read their Eq words from.  Replaces the reference's
``put_chunked`` / ``_mesh_put`` upload (``phasm_tpu/overlap/extend.py``).
``MyersTables`` holds the table tier's whole-read tables and
``MyersBlockedTables`` the tab2 tier's blocked table, each built only when
asked (the reference's ``DeviceExtender._ensure_tables``).

``readset_from_arrays`` and ``alignment_table_from_matrix`` carry state
across from the reference: they take a reference object's fields as numpy
arrays and build the port's own objects, so the two packages can be fed one
input without the port importing the reference's classes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phasm_tpu_torch.alignments import AlignmentTable
from phasm_tpu_torch.device import resolve_device
from phasm_tpu_torch.overlap.myers import (
    blocked_counts,
    build_myers_tables,
    build_myers_tables_blocked,
    match_mask_table,
)
from phasm_tpu_torch.reads import ReadSet


def readset_from_arrays(codes: np.ndarray, lengths: np.ndarray, names=None) -> ReadSet:
    """The port's ReadSet from a read set's fields: [N, Lpad] codes, [N]
    lengths and, optionally, the N read names (default ``read_<i>``)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if names is None:
        names = [f"read_{i}" for i in range(codes.shape[0])]
    return ReadSet(codes=codes, lengths=np.asarray(lengths, dtype=np.int32), names=list(names))


def alignment_table_from_matrix(matrix: np.ndarray, win: np.ndarray | None = None) -> AlignmentTable:
    """The port's AlignmentTable from an [n, 8] ``as_matrix()`` array
    (a_id, b_id, strand, a_start, a_end, b_start, b_end, diffs) and the
    optional [n] window statistic."""
    m = np.asarray(matrix).reshape(-1, 8)
    return AlignmentTable(*(m[:, i] for i in range(8)), win=win)


@dataclasses.dataclass
class DeviceReads:
    """A read set resident on one device.

    codes    [2N, LA] uint8 oriented code matrix (row oid = 2*read + strand)
    lengths  [N] int32
    peq_fwd  [2N, PW, 4] int32 (uint32 bits), CUDA only: forward match
             masks, word w covering positions [32w, 32w + 32) of the row
    peq_rev  the same over each row reversed within its own length
             (position f holds row[len - 1 - f])
    """

    codes: torch.Tensor
    lengths: torch.Tensor
    peq_fwd: torch.Tensor | None = None
    peq_rev: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @classmethod
    def from_reads(cls, reads: ReadSet, device) -> "DeviceReads":
        return cls.from_arrays(reads.oriented_codes_matrix(), reads.lengths, device)

    @classmethod
    def from_arrays(cls, oriented: np.ndarray, lengths: np.ndarray, device) -> "DeviceReads":
        """Upload an oriented matrix ([2N, LA] codes) and per-read lengths."""
        dev = resolve_device(device)
        codes = torch.from_numpy(np.ascontiguousarray(oriented, dtype=np.uint8)).to(dev)
        lens = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(dev)
        out = cls(codes=codes, lengths=lens)
        if dev.type == "cuda":
            out._build_tables()
        return out

    def _build_tables(self) -> None:
        row_len = self.lengths.long().repeat_interleave(2)[: self.codes.shape[0]]
        self.peq_fwd = match_mask_table(self.codes, row_len)
        self.peq_rev = match_mask_table(self.codes, row_len, reverse=True)


@dataclasses.dataclass
class MyersTables:
    """The Myers table tier's whole-read tables (``myers.build_myers_tables``)
    on the reads' device.

    peq  [n_o, 8, PW] int32 (uint32 bits): forward and flip match masks
    bpk  [n_o, 2, BW] int32: 2-bit packed forward and flip codes
    LA   the oriented matrix's width the tables were built from
    """

    peq: torch.Tensor
    bpk: torch.Tensor
    LA: int

    @property
    def device(self) -> torch.device:
        return self.peq.device

    @property
    def nbytes(self) -> int:
        return self.peq.nbytes + self.bpk.nbytes

    @classmethod
    def from_reads(cls, reads: DeviceReads) -> "MyersTables":
        t = build_myers_tables(reads.codes, reads.lengths)
        return cls(peq=t["peq"], bpk=t["bpk"], LA=reads.codes.shape[1])


@dataclasses.dataclass
class MyersBlockedTables:
    """The tab2 tier's blocked table (``myers.build_myers_tables_blocked``)
    on one device.

    win  [n_o * (2*NBb + 1 + NBc), 128] int32 (uint32 bits): forward and
         flip peq blocks, packed forward b rows, packed flip b rows
    LA   the oriented matrix's width the table was built from
    n_o  the oriented rows it holds
    """

    win: torch.Tensor
    LA: int
    n_o: int

    @property
    def device(self) -> torch.device:
        return self.win.device

    @property
    def nbytes(self) -> int:
        return self.win.nbytes

    @classmethod
    def from_reads(cls, reads: DeviceReads) -> "MyersBlockedTables":
        t = build_myers_tables_blocked(reads.codes, reads.lengths)
        return cls(win=t["win"], LA=reads.codes.shape[1], n_o=reads.codes.shape[0])

    @classmethod
    def from_arrays(cls, win: np.ndarray, LA: int, device="cuda") -> "MyersBlockedTables":
        """Upload a blocked table built at width LA (uint32 or int32 words,
        e.g. the reference's ``build_myers_tables_blocked(...)["win"]``)."""
        dev = resolve_device(device)
        win = np.ascontiguousarray(win)
        NBb, NBc = blocked_counts(LA)
        per_read = 2 * NBb + 1 + NBc
        if win.ndim != 2 or win.shape[1] != 128 or win.shape[0] % per_read or win.itemsize != 4:
            raise ValueError(
                f"blocked table: expected 32-bit [n_o * {per_read}, 128] words at LA={LA}, "
                f"got {win.dtype} {list(win.shape)}"
            )
        t = torch.tensor(win.view(np.int32), device=dev)  # a copy: win may be read-only
        return cls(win=t, LA=LA, n_o=win.shape[0] // per_read)
