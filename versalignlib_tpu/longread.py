"""Long-read mapping: minimizer seeding + chaining + banded extension.

ADDITIVE — completes the mapping ladder. Panel search (``search.py``) is
read-vs-entries; window mapping (``refmap.py``) is exhaustive-exact to
bacterial-genome scale; THIS path is for long reads (kbp-100kbp) against
large references, where exhaustive DP is wasteful and the standard
seed-chain-extend decomposition (the minimap2 lineage) is the production
answer:

1. **Seed**: the read's (w, k)-minimizers hit the reference's
   :class:`~versalignlib_tpu.seed.MinimizerIndex`; matches become anchors
   ``(read_pos, ref_pos, strand)``. Hashes occurring more than ``max_occ``
   times are repeat-masked (standard).
2. **Chain** (host, per read): the classic gap-cost chaining DP over
   anchors sorted by reference position — colinear anchors within a gap
   bound extend a chain, scored by anchor count minus a diagonal-drift
   penalty. The best chain fixes the locus/strand; the best chain at a
   DIFFERENT locus feeds MAPQ.
3. **Extend** (device): one banded alignment of the oriented read against
   the chained reference window (band sized from the chain's diagonal
   spread) through ``ops/banded.py`` — the framework's long-pair band
   scan does the only heavy DP, batched across reads.

The result is exact WITHIN the seeded locus (banded DP), heuristic in
locus choice (as all seed-and-extend mappers are) — use refmap for
guaranteed-exhaustive search when the scale allows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from versalignlib_tpu.alphabet import pad_and_encode, reverse_complement_codes
from versalignlib_tpu.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu.seed import MinimizerIndex, build_index, minimizers
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak


@dataclasses.dataclass
class Chain:
    """One chained candidate locus for a read."""

    ref_id: int
    strand: int          # 0 = forward, 1 = read maps reverse-complemented
    score: float         # chaining score (anchors minus drift penalty)
    q_lo: int            # oriented-read coordinates covered by anchors
    q_hi: int
    r_lo: int            # reference coordinates covered by anchors
    r_hi: int
    n_anchors: int
    max_dev: int         # max |diagonal deviation| within the chain


def _chain_anchors(q: np.ndarray, r: np.ndarray, k: int,
                   max_gap: int = 5000, horizon: int = 64,
                   ) -> tuple[float, np.ndarray]:
    """Gap-cost chaining DP over anchors sorted by (r, q).

    Returns (best score, member mask of the best chain). Score model:
    each anchor adds ``k``; linking to a predecessor within ``max_gap``
    costs ``0.1 * |diag_i - diag_j| + 0.01 * gap`` (drift + length
    penalty). ``horizon`` bounds predecessors per anchor (minimap2's
    practical O(n*h)).
    """
    n = q.shape[0]
    order = np.lexsort((q, r))
    qs, rs = q[order], r[order]
    f = np.full(n, float(k))
    parent = np.full(n, -1, dtype=np.int64)
    diag = rs - qs
    for i in range(1, n):
        j0 = max(0, i - horizon)
        qj, rj = qs[j0:i], rs[j0:i]
        ok = (qj < qs[i]) & (rj < rs[i]) & (rs[i] - rj <= max_gap) \
            & (qs[i] - qj <= max_gap)
        if not ok.any():
            continue
        cost = (0.1 * np.abs(diag[i] - diag[j0:i])
                + 0.01 * (rs[i] - rj))
        cand = np.where(ok, f[j0:i] - cost, -np.inf)
        jbest = int(np.argmax(cand))
        if cand[jbest] > 0:
            f[i] = k + cand[jbest]
            parent[i] = j0 + jbest
    best = int(np.argmax(f))
    members_sorted = np.zeros(n, dtype=bool)
    i = best
    while i >= 0:
        members_sorted[i] = True
        i = int(parent[i])
    members = np.zeros(n, dtype=bool)
    members[order[members_sorted]] = True
    return float(f[best]), members


def find_chains(
    read, index: MinimizerIndex, max_occ: int = 64,
    min_anchors: int = 3, max_gap: int = 5000,
) -> list[Chain]:
    """All candidate chains for one read, best first.

    One chain per (ref, strand, locus cluster): anchors group by
    (ref, strand), split into clusters separated by > ``max_gap`` on the
    reference, and each cluster chains independently.
    """
    codes = (read if isinstance(read, np.ndarray)
             else pad_and_encode([read])[0])
    L = int(codes.shape[0])
    k = index.k
    qpos, qh, qstr = minimizers(codes, k, index.w)
    if qpos.size == 0 or len(index) == 0:
        return []
    lo, hi = index.lookup(qh)
    occ = hi - lo
    keep = (occ > 0) & (occ <= max_occ)
    if not keep.any():
        return []
    # Expand matches into anchor arrays.
    counts = occ[keep]
    q_rep = np.repeat(qpos[keep], counts)
    qs_rep = np.repeat(qstr[keep], counts)
    idx_flat = np.concatenate(
        [np.arange(l, h) for l, h in zip(lo[keep], hi[keep])])
    r_rep = index.pos[idx_flat]
    rid_rep = index.ref_id[idx_flat]
    rstr_rep = index.strand[idx_flat]
    strand = (qs_rep ^ rstr_rep).astype(np.int8)
    # Oriented read coordinate: strand-1 anchors chain in revcomp space.
    q_orient = np.where(strand == 0, q_rep, (L - k) - q_rep)
    chains: list[Chain] = []
    for rid in np.unique(rid_rep):
        for s in (0, 1):
            sel = (rid_rep == rid) & (strand == s)
            if int(sel.sum()) < min_anchors:
                continue
            q_a, r_a = q_orient[sel], r_rep[sel]
            # Cluster by reference gaps.
            order = np.argsort(r_a)
            q_a, r_a = q_a[order], r_a[order]
            breaks = np.flatnonzero(np.diff(r_a) > max_gap)
            bounds = np.concatenate(([0], breaks + 1, [r_a.shape[0]]))
            for b0, b1 in zip(bounds[:-1], bounds[1:]):
                if b1 - b0 < min_anchors:
                    continue
                qc, rc = q_a[b0:b1], r_a[b0:b1]
                score, members = _chain_anchors(qc, rc, k, max_gap)
                if int(members.sum()) < min_anchors:
                    continue
                qm, rm = qc[members], rc[members]
                dev = (rm - qm) - (rm - qm).mean()
                chains.append(Chain(
                    ref_id=int(rid), strand=int(s), score=score,
                    q_lo=int(qm.min()), q_hi=int(qm.max()) + k,
                    r_lo=int(rm.min()), r_hi=int(rm.max()) + k,
                    n_anchors=int(members.sum()),
                    max_dev=int(np.abs(dev).max()) if qm.size else 0))
    chains.sort(key=lambda c: -c.score)
    return chains


@dataclasses.dataclass
class LongReadHits:
    """Per-read results from :func:`map_long_reads` (global coordinates)."""

    ref_id: np.ndarray      # (B,) int32; -1 = unmapped (no chain)
    pos: np.ndarray         # (B,) int64 global alignment start (or -1)
    strand: np.ndarray      # (B,) int8
    score: np.ndarray       # (B,) int32 DP score of the extension
    mapq: np.ndarray        # (B,) uint8 chain-gap heuristic
    chain_score: np.ndarray  # (B,) float32 best chaining score
    alignments: list[Alignment | None]  # global ref coords; None = unmapped

    def __len__(self) -> int:
        return self.ref_id.shape[0]


def _mapq_from_chains(best: float, second: float) -> int:
    """minimap2-flavor confidence: scaled by the secondary/primary ratio
    (60 when no distinct secondary exists). Heuristic, monotone."""
    if best <= 0:
        return 0
    if second <= 0:
        return 60
    return int(max(0, min(60, 40.0 * (1.0 - second / best))))


def map_long_reads(
    reads,
    references,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    k: int = 15,
    w: int = 10,
    max_occ: int = 64,
    min_anchors: int = 3,
    max_gap: int = 5000,
    pad: int = 256,
    band_slack: int = 128,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
) -> LongReadHits:
    """Seed-chain-extend mapping of long reads against indexed references.

    ``references``: sequences or a prebuilt
    :class:`~versalignlib_tpu.seed.MinimizerIndex` PLUS the sequences —
    pass ``(index, seqs)`` to reuse an index. The extension runs the
    band scan per read over the chained window, band =
    chain drift + ``band_slack``; alignments come back in GLOBAL
    reference coordinates. DNA-only (seeding needs the complement).
    """
    if params.matrix is not None:
        raise ValueError("long-read mapping is DNA-only")
    if isinstance(references, tuple):
        index, ref_seqs = references
    else:
        index = build_index(references, k=k, w=w)
        ref_seqs = references
    if isinstance(ref_seqs, (str, np.ndarray)) and getattr(
            ref_seqs, "ndim", 1) == 1:
        ref_seqs = [ref_seqs]
    ref_codes = [r if isinstance(r, np.ndarray) else pad_and_encode([r])[0]
                 for r in ref_seqs]
    b = len(reads)
    out_rid = np.full(b, -1, dtype=np.int32)
    out_pos = np.full(b, -1, dtype=np.int64)
    out_strand = np.zeros(b, dtype=np.int8)
    out_score = np.zeros(b, dtype=np.int32)
    out_mapq = np.zeros(b, dtype=np.uint8)
    out_cscore = np.zeros(b, dtype=np.float32)
    alns: list[Alignment | None] = [None] * b

    # Phase 1 (host): chain every read, pick primary + distinct secondary.
    jobs = []  # (i, chain, oriented_codes, window_codes, window_start, band)
    for i, read in enumerate(reads):
        codes = (read if isinstance(read, np.ndarray)
                 else pad_and_encode([read])[0])
        chains = find_chains(codes, index, max_occ=max_occ,
                             min_anchors=min_anchors, max_gap=max_gap)
        if not chains:
            continue
        c = chains[0]
        second = 0.0
        for other in chains[1:]:
            distinct = (other.ref_id != c.ref_id or other.strand != c.strand
                        or other.r_lo > c.r_hi + max_gap
                        or other.r_hi < c.r_lo - max_gap)
            if distinct:
                second = other.score
                break
        out_rid[i] = c.ref_id
        out_strand[i] = c.strand
        out_mapq[i] = _mapq_from_chains(c.score, second)
        out_cscore[i] = c.score
        oriented = (reverse_complement_codes(codes[None])[0]
                    if c.strand else codes)
        L = int(codes.shape[0])
        # Window anchored on the CHAIN DIAGONAL: read row q aligns near
        # window column q (slope 1, intercept ~0) — exactly the geometry
        # the band scan's moving band tracks when the read and window
        # have EQUAL padded lengths. The band then only needs the chain's
        # indel drift plus slack (plus any start-clamp shift at a contig
        # edge).
        ideal = c.r_lo - c.q_lo
        w_lo = max(0, ideal)
        band = c.max_dev + band_slack + (w_lo - ideal)
        jobs.append((i, c.ref_id, oriented, w_lo, band))

    # Phase 2 (device): banded extension, batched by (padded-length, band)
    # bucket so each bucket is one compiled shape.
    from versalignlib_tpu.ops.banded import banded_align_batch

    def _bucket(n: int, floor: int = 256) -> int:
        v = floor
        while v < n:
            v <<= 1
        return v

    groups: dict[tuple[int, int], list[int]] = {}
    for j, (i, rid, oriented, w_lo, band) in enumerate(jobs):
        band_j = -(-(band) // 64) * 64
        key = (_bucket(oriented.shape[0] + band_j + pad), band_j)
        groups.setdefault(key, []).append(j)
    for (P, band), members in groups.items():
        rd = np.zeros((len(members), P), dtype=np.uint8)
        fd = np.zeros((len(members), P), dtype=np.uint8)
        for row, j in enumerate(members):
            _, rid, oriented, w_lo, _ = jobs[j]
            rd[row, : oriented.shape[0]] = oriented
            win = ref_codes[rid][w_lo : w_lo + P]
            fd[row, : win.shape[0]] = win
        got = banded_align_batch(rd, fd, params,
                                 Algorithm.SMITH_WATERMAN,
                                 band=min(band + 64, P), tie=tie)
        for row, j in enumerate(members):
            i, _, _, w_lo, _ = jobs[j]
            a = got[row]
            alns[i] = dataclasses.replace(
                a, ref_start=a.ref_start + w_lo, ref_end=a.ref_end + w_lo)
            out_score[i] = a.score
            out_pos[i] = a.ref_start + w_lo
    return LongReadHits(out_rid, out_pos, out_strand, out_score, out_mapq,
                        out_cscore, alns)
