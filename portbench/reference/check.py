"""What decides ``correct``: the program's answers on a sample of each
batch group, every pass of the window, against the plain reference.

A group is the pairs of one (band W, column bucket J) of the pass: the
first pass's buckets and each retry band's.  From every group the check
draws up to ``SAMPLE_PER_GROUP`` pairs from the seed; the harness keeps the
program's five columns (cost, a_start, a_end, b_end, win) of those pairs
from every pass of the window, and after the window the reference works
each group out again at the group's own W and J, by the family the frozen
routing predicates name (Myers DP or W-band DP), from the reads and
candidates alone.  The number compared is the count of sampled answers,
over all passes, that differ in any column; its limit is 0.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.myers_dp import myers_pairs
from portbench.reference.wband_dp import wband_pairs

SAMPLE_PER_GROUP = 2048
LIMITS = {"mismatched_results": 0}


def family_fn(family: str):
    return myers_pairs if family == "myers" else wband_pairs


def reference_answers(codes, lengths, frame, groups: list, band_divisor: int = 1,
                      block: int = 8192) -> np.ndarray:
    """[5, n] int64 reference answers (cost, a_start, a_end, b_end, win) of
    every group's pairs, in the groups' order.  Groups of one family and
    band run together, each pair at its own group's column bucket, which
    gives what each group gives alone in fewer column steps."""
    dev = codes.device
    offs = np.cumsum([0] + [g[3].shape[0] for g in groups])
    out = np.zeros((5, offs[-1]), dtype=np.int64)
    merged = {}
    for g, (W, _J, fam, _idx) in enumerate(groups):
        merged.setdefault((fam, W // band_divisor), []).append(g)
    for (fam, W), gs in merged.items():
        idx = np.concatenate([groups[g][3] for g in gs])
        jcap = np.concatenate([np.full(groups[g][3].shape[0], groups[g][1]) for g in gs])
        pos = np.concatenate([np.arange(offs[g], offs[g + 1]) for g in gs])
        for s in range(0, idx.shape[0], block):
            sub, cap = idx[s : s + block], torch.from_numpy(jcap[s : s + block]).to(dev)
            a = torch.from_numpy(frame.ka[sub]).to(dev)
            b = torch.from_numpy(frame.kb[sub]).to(dev)
            d = torch.from_numpy(frame.kd[sub].astype(np.int64)).to(dev)
            ans = family_fn(fam)(codes, lengths, a, b, d, W, int(cap.max()), cap)
            out[:, pos[s : s + block]] = torch.stack([x.long() for x in ans]).cpu().numpy()
    return out


def mismatches(variants: list, ref: np.ndarray) -> tuple[int, int]:
    """(answers that differ, answers compared) over the kept variants of
    one group: [(rows [5, n], passes that gave them)]."""
    bad = seen = 0
    for rows, count in variants:
        bad += count * int((rows != ref).any(axis=0).sum())
        seen += count * ref.shape[1]
    return bad, seen
