"""Whole-reference read mapping: exhaustive window tiling on the device.

ADDITIVE over the reference (strictly 1:1 pairwise,
/root/reference/include/AlignmentKernel.h:34-44) and over ``search.py``'s
panel mode (best hit among SHORT panel entries): this maps reads against
LONG references — contigs, chromosomes — by tiling each reference into
overlapping fixed-size windows and scoring every (read, window) pair with
the device's dense score path.

Why brute force instead of seeding: heuristic mappers (minimizer seed →
chain → extend) exist to avoid DP work a CPU cannot afford. An accelerator
fills dense cells fast enough that exhaustive search is practical for
panel-to-bacterial-genome scale, and it is exact by construction: no seed,
no chain, no mapping missed because a heuristic skipped it. The tiling is
also the natural accelerator shape — thousands of identical fixed-size
pairs, zero control flow.

Correctness of the tiling: ``stride = window - overlap`` with ``overlap >=
max_read_span`` guarantees every reference interval a read can align to
lies ENTIRELY inside at least one window, so the best window score equals
the best full-reference score (local alignment is position-independent).
Window coordinates shift back to global reference coordinates on output.

MAPQ needs the best score gap over DISTINCT loci, and nearby windows see
the same locus through their overlap — so the fold keeps the top-k
(value, window) pairs per read and the "second best" is the best candidate
on a DIFFERENT reference or at least ceil(window/stride) windows away
(closer same-reference windows can share the winner's overlap region).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from versalignlib_tpu.alphabet import pad_and_encode, reverse_complement_codes
from versalignlib_tpu.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu.dispatch import resolve_score_impl
from versalignlib_tpu.search import (NEG32, _align_pairs, _chunk_scores,
                                     _encode, _mapq_from_gap)
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak

#: minimum top-k pool per read; map_to_reference widens it to 2x the
#: same-locus window distance so the pool always retains a distinct-locus
#: candidate when one exists (winner + up to 2*(dist-1) overlap
#: neighbours + 1).
TOPK = 4


@dataclasses.dataclass(frozen=True)
class WindowIndex:
    """Tiling of one or more reference sequences into scoring windows."""

    windows: np.ndarray    # (n_windows, window) uint8 codes, 0-padded tails
    ref_id: np.ndarray     # (n_windows,) which reference each window tiles
    start: np.ndarray      # (n_windows,) global start of each window
    window: int
    stride: int
    ref_lengths: list[int]

    def __len__(self) -> int:
        return self.windows.shape[0]

    def save(self, path) -> None:
        """Persist the tiling (npz): tile a large genome once, reuse it
        across runs/processes."""
        np.savez_compressed(
            path, windows=self.windows, ref_id=self.ref_id,
            start=self.start,
            meta=np.array([self.window, self.stride], dtype=np.int64),
            ref_lengths=np.array(self.ref_lengths, dtype=np.int64))

    @classmethod
    def load(cls, path) -> "WindowIndex":
        with np.load(path) as z:
            return cls(windows=z["windows"], ref_id=z["ref_id"],
                       start=z["start"], window=int(z["meta"][0]),
                       stride=int(z["meta"][1]),
                       ref_lengths=[int(v) for v in z["ref_lengths"]])


def tile_references(
    references,
    window: int,
    stride: int,
) -> WindowIndex:
    """Tile reference sequences (str or uint8 code arrays) into windows.

    Windows never span two references. The final window of each reference
    starts at the last stride multiple below its length and is 0-padded
    (padding scores zero — reference tail-fill semantics), so every suffix
    is covered.
    """
    if window <= 0 or stride <= 0 or stride > window:
        raise ValueError(f"need 0 < stride <= window, got "
                         f"window={window} stride={stride}")
    if isinstance(references, (str, np.ndarray)) and getattr(
            references, "ndim", 1) == 1:
        references = [references]
    enc = [r if isinstance(r, np.ndarray) else pad_and_encode([r])[0]
           for r in references]
    if not enc:
        return WindowIndex(
            windows=np.zeros((0, window), dtype=np.uint8),
            ref_id=np.zeros(0, dtype=np.int32),
            start=np.zeros(0, dtype=np.int64),
            window=window, stride=stride, ref_lengths=[])
    chunks, rids, starts = [], [], []
    for rid, codes in enumerate(enc):
        L = codes.shape[0]
        n_w = max(1, -(-max(L - window, 0) // stride) + 1)
        padded = np.zeros((n_w - 1) * stride + window, dtype=np.uint8)
        padded[:L] = codes
        view = np.lib.stride_tricks.sliding_window_view(
            padded, window)[::stride]
        chunks.append(view)
        rids.append(np.full(view.shape[0], rid, dtype=np.int32))
        starts.append(np.arange(view.shape[0], dtype=np.int64) * stride)
    return WindowIndex(
        windows=np.ascontiguousarray(np.concatenate(chunks)),
        ref_id=np.concatenate(rids),
        start=np.concatenate(starts),
        window=window, stride=stride,
        ref_lengths=[c.shape[0] for c in enc],
    )


def _stream_topk(reads_enc, windows, params, algorithm, impl, chunk,
                 mesh, k: int = TOPK, panel_axis: str = "reads"):
    """Top-k (score, window-index) fold over window chunks.

    Returns (vals (B, k) int32 desc, args (B, k) int32). Within-chunk and
    cross-chunk ties resolve to the LOWER window index (scan order, the
    panel-search convention). ``panel_axis="panel"`` (with ``mesh``) shards
    the WINDOW axis over the mesh with device-local top-k folds — genome
    window sets never replicate per device (see search.score_matrix).
    """
    import jax.numpy as jnp

    b = reads_enc.shape[0]
    r = windows.shape[0]
    reads_dev = None if mesh is not None else jnp.asarray(reads_enc)
    vals = np.full((b, k), NEG32, dtype=np.int64)
    args = np.zeros((b, k), dtype=np.int64)
    rows = np.arange(b)[:, None]
    for lo in range(0, r, chunk):
        pc = windows[lo : lo + chunk]
        kk = min(k, pc.shape[0])
        if mesh is not None and panel_axis == "panel":
            from versalignlib_tpu.search import _mesh_topk_scores

            top_v, top_a = _mesh_topk_scores(reads_enc, pc, params,
                                             algorithm, impl, mesh, k=kk)
        elif mesh is None:
            # Device-side top-k: O(B*k) over the link instead of (B, R);
            # lax.top_k is stable (ties keep the LOWER window index).
            from versalignlib_tpu.search import _score_topk_chunk

            v, i = _score_topk_chunk(reads_dev, jnp.asarray(pc), params,
                                     algorithm, impl, kk)
            top_v = np.asarray(v).astype(np.int64)
            top_a = np.asarray(i).astype(np.int64)
        else:
            s = _chunk_scores(reads_enc, reads_dev, pc, params, algorithm,
                              impl, mesh).astype(np.int64)
            # Composite key: high score first, LOW window index on ties —
            # argpartition alone picks an arbitrary member of a tied set,
            # which would violate the scan-order convention.
            key = s * np.int64(s.shape[1] + 1) - np.arange(s.shape[1])
            top = np.argpartition(-key, kk - 1, axis=1)[:, :kk]
            top_v = s[rows, top]
            top_a = top
        # Merge pools; sort by (-score, window) so equal scores keep the
        # earliest window, matching the streaming argmax convention.
        cand_v = np.concatenate([vals, top_v], axis=1)
        cand_a = np.concatenate([args, top_a + lo], axis=1)
        order = np.lexsort((cand_a, -cand_v), axis=1)[:, :k]
        vals = np.take_along_axis(cand_v, order, axis=1)
        args = np.take_along_axis(cand_a, order, axis=1)
    return vals.astype(np.int32), args.astype(np.int32)


def _second_distinct(vals, args, win_arg, ref_id, min_dist):
    """Best score among pool candidates at a DISTINCT locus from each
    read's winning window ``win_arg`` (NEG32 if the pool has none — e.g. a
    single-window reference).

    Distinct = a different reference sequence, OR the same reference at
    window distance >= ``min_dist`` (= ceil(window/stride): closer windows
    can contain the winner's locus through their overlap; windows of
    different references are always different loci, whatever their global
    indices).
    """
    win = win_arg[:, None]
    distinct = (ref_id[args] != ref_id[win]) | (
        np.abs(args - win) >= min_dist)
    distinct &= vals > NEG32
    masked = np.where(distinct, vals, NEG32)
    return masked.max(axis=1).astype(np.int32)


@dataclasses.dataclass
class ReferenceHits:
    """Per-read best-locus results from :func:`map_to_reference`.

    Alignments (``align=True``) are in GLOBAL reference coordinates:
    ``ref_start``/``ref_end`` index into the full reference sequence
    ``ref_id[i]``, ready for :func:`~versalignlib_tpu.io.sam.write_sam`
    against full-length ``@SQ`` entries.
    """

    ref_id: np.ndarray      # (B,) reference index (-1: empty reference set)
    pos: np.ndarray         # (B,) int64 global start of the hit window
    score: np.ndarray       # (B,) int32 best window score
    strand: np.ndarray      # (B,) 0 = forward, 1 = reverse-complement
    mapq: np.ndarray        # (B,) uint8 distinct-locus gap heuristic
    alignments: list[Alignment] | None

    def __len__(self) -> int:
        return self.ref_id.shape[0]


def map_to_reference(
    reads,
    references,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    window: int | None = None,
    stride: int | None = None,
    impl: str = "auto",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
    both_strands: bool = True,
    panel_axis: str = "reads",
) -> ReferenceHits:
    """Map reads against long references by exhaustive window scoring.

    ``window`` defaults to 4x the longest read (rounded up to a multiple
    of 128 for stable kernel shapes) and ``stride`` to ``window // 2``;
    any alignment whose reference span is <= window - stride (= 2x the
    longest read by default, generous even for gappy alignments) is fully
    contained in some window, making the search exact. Both strands are
    scored (DNA; disable with ``both_strands=False``). ``align=True``
    tracebacks each read against its winning window only and shifts the
    result to global coordinates. ``panel_axis="panel"`` (with ``mesh``)
    shards the WINDOW axis across devices with device-local top-k folds
    instead of replicating the window set — use it when the tiled genome
    dominates memory (the mesh analogue of the reference's memory-driven
    work partitioning, OpenCLKernel.cpp:517-568).
    """
    if params.matrix is not None and both_strands:
        raise ValueError("both_strands mapping is DNA-only (custom "
                         "substitution matrices have no complement)")
    reads_enc = _encode(reads)
    b, m = reads_enc.shape
    if isinstance(references, WindowIndex):
        index = references
    else:
        if window is None:
            window = max(128, -(-4 * m // 128) * 128)
        if stride is None:
            stride = window // 2
        index = tile_references(references, window, stride)
    overlap = index.window - index.stride
    if overlap < min(2 * m, index.stride):
        # Containment bound: spans up to window - stride are exact. Warn
        # loudly rather than silently degrade to approximate mapping.
        import warnings

        warnings.warn(
            f"window-stride overlap {overlap} < 2x read length {2 * m}: "
            f"alignments spanning more than {overlap}bp of reference may "
            "straddle every window and score low", stacklevel=2)
    n_w = len(index)
    if b == 0 or n_w == 0:
        from versalignlib_tpu.search import unmapped_alignment

        return ReferenceHits(np.full(b, -1, np.int32),
                             np.zeros(b, np.int64),
                             np.full(b, NEG32, np.int32),
                             np.zeros(b, np.int8), np.zeros(b, np.uint8),
                             [unmapped_alignment() for _ in range(b)]
                             if align else None)
    impl = resolve_score_impl(impl)
    algorithm = Algorithm(algorithm)
    chunk = max(1, min(n_w, max_pairs // max(b, 1)))
    # Same-locus window distance: windows closer than this (same ref)
    # overlap the winner's locus. The pool must be wide enough to retain a
    # distinct candidate past up to 2*(min_dist-1) overlap neighbours.
    min_dist = -(-index.window // index.stride)
    k = max(TOPK, 2 * min_dist)
    vals, args = _stream_topk(reads_enc, index.windows, params, algorithm,
                              impl, chunk, mesh, k=k,
                              panel_axis=panel_axis)
    strand = np.zeros(b, dtype=np.int8)
    if both_strands:
        rc_enc = reverse_complement_codes(reads_enc)
        rc_vals, rc_args = _stream_topk(rc_enc, index.windows, params,
                                        algorithm, impl, chunk,
                                        mesh, k=k, panel_axis=panel_axis)
        rev = rc_vals[:, 0] > vals[:, 0]     # strict >: forward wins ties
        # The distinct-locus second-best needs candidates from BOTH
        # orientations relative to the WINNING orientation's locus; merge
        # the pools before the gap computation.
        all_vals = np.concatenate([vals, rc_vals], axis=1)
        all_args = np.concatenate([args, rc_args], axis=1)
        win_arg = np.where(rev, rc_args[:, 0], args[:, 0])
        second = _second_distinct(all_vals, all_args, win_arg,
                                  index.ref_id, min_dist)
        best = np.where(rev, rc_vals[:, 0], vals[:, 0])
        arg = win_arg
        strand = rev.astype(np.int8)
        oriented = np.where(rev[:, None], rc_enc, reads_enc)
    else:
        best = vals[:, 0]
        arg = args[:, 0]
        second = _second_distinct(vals, args, args[:, 0], index.ref_id,
                                  min_dist)
        oriented = reads_enc
    mapq = _mapq_from_gap(best, second, params)
    alns = None
    if align:
        alns = _align_pairs(oriented, index.windows[arg], params, algorithm,
                            tie, backend, mesh)
        # Shift window-relative coordinates to global reference coords.
        alns = [dataclasses.replace(
                    a, ref_start=a.ref_start + int(index.start[w]),
                    ref_end=a.ref_end + int(index.start[w]))
                for a, w in zip(alns, arg)]
    return ReferenceHits(index.ref_id[arg].astype(np.int32),
                         index.start[arg].astype(np.int64),
                         best.astype(np.int32), strand, mapq, alns)
