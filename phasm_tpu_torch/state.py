"""The state the port carries on the device: the read set.

This system has no learned weights.  What stays resident is the oriented
read matrix, the read lengths and, on CUDA, the per-oriented-read match-mask
tables the Myers kernels read their Eq words from.  Replaces the reference's
``put_chunked`` / ``_mesh_put`` upload (``phasm_tpu/overlap/extend.py``) and
its window-table builds (``myers.build_myers_tables*``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phasm_tpu.overlap.myers import WB
from phasm_tpu.reads import ReadSet

from phasm_tpu_torch.device import resolve_device

_TABLE_CHUNK_CELLS = 1 << 24  # bounds the int64 temporaries of a table build


def _to_u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit words -> int32 with the same bit pattern."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def match_mask_table(
    rows: torch.Tensor, lens: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """[n, L] uint8 codes + [n] valid lengths -> [n, ceil(L/32), 4] int32
    (uint32 bits): bit t of word w, plane c <=> x[32w + t] == c and
    32w + t < lens, where x is the row (reverse=False) or the row reversed
    within its own length (x[f] = row[lens - 1 - f]).  Positions outside a
    read never match."""
    n, L = rows.shape
    PW = -(-L // WB)
    out = torch.empty((n, PW, 4), dtype=torch.int32, device=rows.device)
    t = torch.arange(WB, dtype=torch.int64, device=rows.device)
    pos = torch.arange(PW * WB, device=rows.device).view(1, PW, WB)
    f = torch.arange(L, device=rows.device)[None, :]
    step = max(1, _TABLE_CHUNK_CELLS // (PW * WB))
    for s in range(0, n, step):
        x = rows[s : s + step]
        ln = lens[s : s + step]
        if reverse:
            x = x.gather(1, (ln[:, None] - 1 - f).clamp(min=0))
        x = torch.nn.functional.pad(x, (0, PW * WB - L)).view(-1, PW, WB)
        valid = pos < ln.view(-1, 1, 1)
        planes = [
            (((x == c) & valid).long() << t).sum(dim=-1) for c in range(4)
        ]
        out[s : s + step] = _to_u32_bits(torch.stack(planes, dim=-1))
    return out


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
    def from_reference(cls, reads: ReadSet, device) -> "DeviceReads":
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
