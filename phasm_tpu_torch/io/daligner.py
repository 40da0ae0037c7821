"""DALIGNER / DAZZ_DB dump interop parsers.

Ref: phasm/io/daligner.py :: parse_local_alignments, parse_reads
(SURVEY.md §2 L1).  The reference consumes `LAdump -cd` and `DBdump -rhs`
text streams produced by the external C tools; these parsers accept the same
streams so datasets prepared for the reference pipeline can be fed to this
framework directly (and outputs diffed 1:1).

LAdump record shape (per alignment, with -c and -d flags):
    P <a_read> <b_read> <n|c> [...]      pair + orientation (c = b compl.)
    C <a_beg> <a_end> <b_beg> <b_end>    aligned ranges
    D <diffs>                            difference count
DBdump record shape (with -rh / -s):
    R <read_id>
    L <well> <beg> <end>                 read length = end - beg
    S <len> <sequence>

DALIGNER reports b-ranges on the COMPLEMENTED strand when the orientation
flag is 'c' — the same convention as our AlignmentTable (b-coordinates on
the oriented strand), so ranges pass through unchanged.  DALIGNER read ids
are 1-based; they are shifted to 0-based here.

Host copy of the reference's ``phasm_tpu.io.daligner``: the same code with
its imports pointed at this package.
"""
from __future__ import annotations

from typing import IO, Iterable, Iterator

import numpy as np

from phasm_tpu_torch.alignments import AlignmentTable
from phasm_tpu_torch.reads import ReadSet


def _lines(stream: IO | Iterable[str]) -> Iterator[list[str]]:
    for raw in stream:
        parts = raw.strip().split()
        if parts:
            yield parts


def parse_local_alignments(stream: IO | Iterable[str]) -> AlignmentTable:
    """Parse an LAdump text stream into an AlignmentTable."""
    rows = []
    a = b = strand = None
    coords = None
    diffs = 0

    def flush():
        nonlocal a, coords, diffs
        if a is not None and coords is not None:
            rows.append((a, b, strand, *coords, diffs))
        coords, diffs = None, 0

    for parts in _lines(stream):
        tag = parts[0]
        if tag == "P":
            flush()
            a = int(parts[1]) - 1
            b = int(parts[2]) - 1
            strand = 1 if parts[3] == "c" else 0
        elif tag == "C":
            coords = tuple(int(x) for x in parts[1:5])
        elif tag == "D":
            diffs = int(parts[1])
        # +, %, @ header/count lines and T trace lines are skipped
    flush()
    if not rows:
        return AlignmentTable.empty()
    return AlignmentTable.from_rows(rows)


def parse_reads(stream: IO | Iterable[str]) -> ReadSet:
    """Parse a DBdump text stream (with -s) into a ReadSet."""
    names: list[str] = []
    seqs: list[str] = []
    current = None
    for parts in _lines(stream):
        tag = parts[0]
        if tag == "R":
            current = int(parts[1]) - 1
            names.append(f"read_{current}")
        elif tag == "S" and current is not None:
            seqs.append(parts[2].upper())
    return ReadSet.from_sequences(seqs, names=names)


def write_ladump(path: str, t: AlignmentTable) -> None:
    """Write an AlignmentTable as an LAdump-style stream (interop export)."""
    with open(path, "w") as fh:
        fh.write(f"+ P {len(t)}\n")
        for i in range(len(t)):
            o = "c" if t.strand[i] else "n"
            fh.write(f"P {int(t.a_id[i]) + 1} {int(t.b_id[i]) + 1} {o}\n")
            fh.write(
                f"C {int(t.a_start[i])} {int(t.a_end[i])} "
                f"{int(t.b_start[i])} {int(t.b_end[i])}\n"
            )
            fh.write(f"D {int(t.diffs[i])}\n")


def save_table_npz(path: str, t: AlignmentTable) -> None:
    """Native checkpoint format for alignment tables (stage boundary file).

    The optional windowed-divergence column rides along so a resumed
    pipeline keeps its filtering/containment/arm-classification policy
    (filter.window_excess_mask) intact.
    """
    if t.win is not None:
        np.savez_compressed(path, matrix=t.as_matrix(), win=t.win)
    else:
        np.savez_compressed(path, matrix=t.as_matrix())


def load_table_npz(path: str) -> AlignmentTable:
    d = np.load(path)
    m = d["matrix"]
    win = d["win"] if "win" in d.files else None
    return AlignmentTable(*(m[:, i] for i in range(8)), win=win)


def read_paf(path: str) -> AlignmentTable:
    """Parse a PAF file into an AlignmentTable — the exact inverse of
    ``write_paf`` (b-coordinates converted from the forward strand back to
    the oriented strand; diffs recovered as span - matches, which is exact
    for any table write_paf produced).

    Read ids: names of the form ``read_<N>`` map to id N (write_paf's
    default); any other name gets a stable first-appearance index.  Used by
    scripts/diff_vs_reference.py for the overlap-set diff vs the reference
    (BASELINE north star), where only set-level consistency of ids matters.
    """
    rows = []
    ids: dict[str, int] = {}

    def rid(name: str) -> int:
        if name.startswith("read_"):
            tail = name[5:]
            if tail.isdigit():
                return int(tail)
        return ids.setdefault(name, len(ids))

    with open(path) as fh:
        for raw in fh:
            p = raw.rstrip("\n").split("\t")
            if len(p) < 12:
                continue
            a = rid(p[0])
            b = rid(p[5])
            a_s, a_e = int(p[2]), int(p[3])
            st = 1 if p[4] == "-" else 0
            lb = int(p[6])
            bs, be = int(p[7]), int(p[8])
            if st:  # forward-b coords -> oriented-b coords
                bs, be = lb - be, lb - bs
            matches, span = int(p[9]), int(p[10])
            rows.append((a, b, st, a_s, a_e, bs, be, max(span - matches, 0)))
    if not rows:
        return AlignmentTable.empty()
    return AlignmentTable.from_rows(rows)


def write_paf(path: str, t: AlignmentTable, lengths: np.ndarray, names=None) -> None:
    """Write alignments as PAF (minimap2 interchange; modern ecosystems speak
    PAF rather than LAdump).  b-coordinates are converted back to the forward
    strand of b as PAF requires.
    """
    def nm(i: int) -> str:
        return names[i] if names is not None else f"read_{i}"

    with open(path, "w") as fh:
        for i in range(len(t)):
            a, b = int(t.a_id[i]), int(t.b_id[i])
            la, lb = int(lengths[a]), int(lengths[b])
            st = int(t.strand[i])
            bs, be = int(t.b_start[i]), int(t.b_end[i])
            if st:  # oriented-b coords -> forward-b coords
                bs, be = lb - be, lb - bs
            span = max(int(t.a_end[i]) - int(t.a_start[i]), be - bs)
            matches = max(span - int(t.diffs[i]), 0)
            fh.write(
                "\t".join(
                    str(x)
                    for x in (
                        nm(a), la, int(t.a_start[i]), int(t.a_end[i]),
                        "-" if st else "+",
                        nm(b), lb, bs, be,
                        matches, span, 255,
                    )
                )
                + "\n"
            )
