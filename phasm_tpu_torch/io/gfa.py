"""GFA2 read/write for string graphs and unitig graphs.

Ref: phasm/io/gfa.py (gfa2_parse, write_gfa2) — the reference round-trips
its assembly graph through GFA2 between the layout and phase stages
(SURVEY.md §2 L1, §4.2/4.3); we keep that stage-boundary contract so graphs
are diffable against the reference and other GFA tools.

Conventions:
  * string graph: one S line per READ (id r<read_id>), one E line per edge;
    segment orientation comes from the oriented-node id parity;
  * the exact appended-length (`elen`) is carried in an `el:i:` tag so the
    edge tensor round-trips losslessly (GFA2 coordinates alone are enough
    for interop, the tag is for bit-exact reload);
  * unitig graph: S lines are unitigs (id u<i>) with spelled sequences.

Host copy of the reference's ``phasm_tpu.io.gfa``: the same code with its
imports pointed at this package.
"""
from __future__ import annotations

import numpy as np

from phasm_tpu_torch import dna
from phasm_tpu_torch.graph.structure import StringGraph
from phasm_tpu_torch.graph.unitigs import UnitigGraph
from phasm_tpu_torch.reads import ReadSet


def _orient(oid: int) -> str:
    return "-" if (oid & 1) else "+"


def _coord(x: int, seg_len: int) -> str:
    """GFA2 position: trailing $ marks the end of the segment."""
    return f"{x}$" if x == seg_len else str(x)


def write_gfa2(path: str, g: StringGraph, reads: ReadSet, sequences: bool = True):
    """Serialize a string graph; segments are reads (forward strand).

    E-line intervals are on the FORWARD segment per the GFA2 spec (an
    oriented-strand interval [b, e) maps to [L-e, L-b) for '-' references);
    ADVICE r1 flagged the oriented-coordinate intervals round 1 wrote as
    misleading external tools.  The el:i tag still carries the exact
    appended-length for bit-exact reload.
    """
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:2.0\n")
        used = np.zeros(g.n_nodes // 2, dtype=bool)
        used[(np.concatenate([g.src, g.dst]) >> 1)] = True
        for r in np.nonzero(used)[0].tolist():
            ln = int(reads.lengths[r])
            seq = dna.decode(reads.seq(r)) if sequences else "*"
            fh.write(f"S\tr{r}\t{ln}\t{seq}\n")
        for e in range(g.n_edges):
            u, v = int(g.src[e]), int(g.dst[e])
            ovl = int(g.ovl[e])
            elen = int(g.elen[e])
            lu = int(g.node_len[u])
            lv = int(g.node_len[v])
            # suffix of oriented-u overlaps prefix of oriented-v
            b1, e1 = lu - ovl, lu
            b2, e2 = 0, ovl
            if u & 1:  # convert to forward-strand coordinates
                b1, e1 = lu - e1, lu - b1
            if v & 1:
                b2, e2 = lv - e2, lv - b2
            fh.write(
                f"E\t*\tr{u >> 1}{_orient(u)}\tr{v >> 1}{_orient(v)}\t"
                f"{_coord(b1, lu)}\t{_coord(e1, lu)}\t"
                f"{_coord(b2, lv)}\t{_coord(e2, lv)}\t*\tel:i:{elen}\n"
            )


def read_gfa2(path: str) -> tuple[StringGraph, ReadSet]:
    """Parse a GFA2 string graph written by write_gfa2 (or compatible)."""
    names: list[str] = []
    seqs: list[str] = []
    sid_to_idx: dict[str, int] = {}
    lengths: list[int] = []
    edges = []

    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if not parts:
                continue
            if parts[0] == "S":
                sid, slen, seq = parts[1], int(parts[2]), parts[3]
                sid_to_idx[sid] = len(names)
                names.append(sid)
                lengths.append(slen)
                seqs.append(seq if seq != "*" else "A" * slen)
            elif parts[0] == "E":
                edges.append(parts)

    rs = ReadSet.from_sequences(seqs, names=names)

    def parse_ref(tok: str) -> int:
        sid, orient = tok[:-1], tok[-1]
        return 2 * sid_to_idx[sid] + (1 if orient == "-" else 0)

    src, dst, elen_a, ovl_a = [], [], [], []
    for parts in edges:
        u = parse_ref(parts[2])
        v = parse_ref(parts[3])
        b1 = int(parts[4].rstrip("$"))
        e1 = int(parts[5].rstrip("$"))
        # intervals are forward-strand (GFA2 spec); overlap length is
        # invariant under the '-' flip b,e -> L-e,L-b so no branch needed
        ovl = e1 - b1
        elen = None
        for tag in parts[9:]:
            if tag.startswith("el:i:"):
                elen = int(tag[5:])
        if elen is None:
            elen = int(lengths[v >> 1]) - ovl
        src.append(u)
        dst.append(v)
        elen_a.append(elen)
        ovl_a.append(ovl)

    node_len = np.repeat(np.array(lengths, dtype=np.int32), 2)
    g = StringGraph(
        2 * len(names),
        np.array(src, dtype=np.int32),
        np.array(dst, dtype=np.int32),
        np.array(elen_a, dtype=np.int32),
        np.array(ovl_a, dtype=np.int32),
        node_len,
    )
    return g.canonicalize(), rs


def remap_node_ids(g: StringGraph, seg_names: list[str], reads: ReadSet) -> StringGraph:
    """Map a GFA graph's position-compacted node ids back onto `reads`.

    write_gfa2 serializes only reads that appear in edges, so read_gfa2's
    node ids are FILE POSITIONS, not the original read ids.  Pairing such a
    graph directly with the full FASTA read set + alignment table (the CLI
    phase stage) silently misaligns every node whenever layout dropped a
    read — contained reads and clipped tips, i.e. nearly always (ADVICE r1
    high).  Segments named ``r<k>`` map to read index k; any other name is
    looked up in ``reads.names``.
    """
    name_to_idx = {n: i for i, n in enumerate(reads.names)}
    m = np.zeros(len(seg_names), dtype=np.int64)
    for i, s in enumerate(seg_names):
        if s.startswith("r") and s[1:].isdigit():
            k = int(s[1:])
        elif s in name_to_idx:
            k = name_to_idx[s]
        else:
            raise ValueError(f"cannot map GFA segment {s!r} onto the read set")
        if not (0 <= k < reads.n_reads):
            raise ValueError(
                f"GFA segment {s!r} maps to read {k}, outside the "
                f"{reads.n_reads}-read set"
            )
        m[i] = k
    src = (2 * m[g.src >> 1] + (g.src & 1)).astype(np.int32)
    dst = (2 * m[g.dst >> 1] + (g.dst & 1)).astype(np.int32)
    node_len = np.repeat(reads.lengths.astype(np.int32), 2)
    out = StringGraph(2 * reads.n_reads, src, dst, g.elen, g.ovl, node_len)
    return out.canonicalize()


def write_gfa2_unitigs(path: str, ug: UnitigGraph, reads: ReadSet):
    """Serialize a unitig graph (S per unitig with spelled sequence)."""
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:2.0\n")
        for u in range(ug.n_nodes):
            seq = dna.decode(ug.spell(u, reads))
            fh.write(f"S\tu{u}\t{len(seq)}\t{seq}\tRC:i:{int(ug.rc[u])}\n")
        for e in range(ug.n_edges):
            u, v = int(ug.src[e]), int(ug.dst[e])
            ovl = int(ug.ovl[e])
            lu = int(ug.length[u])
            fh.write(
                f"E\t*\tu{u}+\tu{v}+\t{lu - ovl}\t{lu}$\t0\t{ovl}\t*\t"
                f"el:i:{int(ug.elen[e])}\n"
            )
