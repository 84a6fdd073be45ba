"""Database search: score every read against a reference panel, align hits.

ADDITIVE over the reference, whose API is strictly pairwise 1:1 — both
``score_alignments`` and ``compute_alignments`` take equal-count read/ref
arrays (/root/reference/include/AlignmentKernel.h:34-44) and the driver
errors on a count mismatch (/root/reference/src/impl/main.cpp:93-102). The
classic production use of a pairwise aligner is one-vs-many: map each read
against a panel of references, keep the best hit(s), and only traceback the
winners (filter-then-align).

Device shape: the cross product of a read chunk and a panel chunk is
tiled on the device inside jit and scored by the device score path
(the GPU kernel where it compiles, the XLA scan elsewhere —
``dispatch.resolve_score_impl``); the host→device copy carries only B + R
sequences. The panel streams through in chunks bounded by ``max_pairs``
(device batch footprint); the running best/argmax folds on host between
chunks. Alignment happens once per read, on the winning pair only, through
the normal backend dispatch.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from versalignlib_tpu.alphabet import pad_and_encode
from versalignlib_tpu.dispatch import resolve_score_impl
from versalignlib_tpu.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak


def unmapped_alignment() -> Alignment:
    """Placeholder for a read with no candidate (empty panel): empty
    gapped strings + sentinel coords; ``io.sam.sam_record`` emits it as an
    unmapped record. Keeps ``align=True`` results index-aligned with the
    per-read hit arrays whatever the panel size."""
    return Alignment(read="", ref="", score=0, cigar="",
                     read_start=-1, read_end=-1, ref_start=-1, ref_end=-1)


def _encode(seqs) -> np.ndarray:
    if isinstance(seqs, np.ndarray) and seqs.dtype == np.uint8 and seqs.ndim == 2:
        return seqs
    return pad_and_encode(seqs)


def _cross_scores(reads, panel, params: AlignmentParameters,
                  algorithm: Algorithm, impl: str):
    """(B, m) x (Rc, n) -> (B, Rc) scores: the B*Rc pairs are tiled on the
    device and scored by the resolved device score path."""
    from versalignlib_tpu.dispatch import device_score_fn

    b = reads.shape[0]
    rc = panel.shape[0]
    r = jnp.repeat(reads, rc, axis=0)   # (B*Rc, m): read i vs every ref
    f = jnp.tile(panel, (b, 1))         # (B*Rc, n)
    return device_score_fn(impl)(r, f, params, algorithm).reshape(b, rc)


def _score_topk_chunk(reads, panel, params: AlignmentParameters,
                      algorithm: Algorithm, impl: str, k: int):
    """Device-side top-k fold of one chunk: the host receives O(B*k)
    (values, window-index) pairs instead of the full (B, R) matrix.
    ``lax.top_k`` is stable (equal values keep the LOWER index), matching
    the host fold's first-win scan-order convention exactly."""
    s = _cross_scores(reads, panel, params, algorithm, impl)
    return jax.lax.top_k(s, k)


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "impl", "mesh"),
)
def _score_cross_chunk_mesh(reads, panel, params: AlignmentParameters,
                            algorithm: Algorithm, impl: str,
                            mesh):
    """Mesh variant: reads shard over the data axis, the panel chunk is
    replicated on every device (each shard scores its reads against the
    whole chunk — zero inter-device communication; the result gather is
    the only collective, as everywhere in parallel/)."""
    from jax.sharding import PartitionSpec as P

    from versalignlib_tpu.parallel.mesh import DATA_AXIS

    mapped = jax.shard_map(
        lambda r, f: _cross_scores(r, f, params, algorithm, impl),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(None, None)),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    return mapped(reads, panel)


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "impl", "k", "mesh"),
)
def _score_topk_chunk_mesh(reads, panel, params: AlignmentParameters,
                           algorithm: Algorithm, impl: str,
                           k: int, mesh):
    """Panel-sharded top-k: the panel chunk shards over the data axis (the
    MANY side), reads replicate; every device folds its local top-k and the
    trailing gather carries O(B * k * n_dev) (value, global-index) pairs.
    Genome-scale window sets therefore never replicate per device — the
    mesh analogue of the reference's memory-driven work partitioning
    (OpenCLKernel.cpp:517-568), with the panel as the partitioned work list.
    """
    from jax.sharding import PartitionSpec as P

    from versalignlib_tpu.parallel.mesh import DATA_AXIS

    shard_r = panel.shape[0] // mesh.devices.size

    def local(r, f):
        s = _cross_scores(r, f, params, algorithm, impl)
        v, i = jax.lax.top_k(s, k)  # stable: ties keep the LOWER local index
        off = jax.lax.axis_index(DATA_AXIS).astype(jnp.int32) * shard_r
        return v, i + off

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None), P(DATA_AXIS, None)),
        out_specs=(P(None, DATA_AXIS), P(None, DATA_AXIS)),
        check_vma=False,
    )
    return mapped(reads, panel)


def _mesh_topk_scores(reads_enc, panel_chunk, params, algorithm, impl,
                      mesh, k: int):
    """One panel chunk sharded over the mesh's data axis with device-local
    top-k folds; the host k-way-merges the shard results.

    Returns (vals (B, k) int64 desc, idx (B, k) int64 chunk-local), ties
    resolved to the LOWEST panel index (scan order). Slots beyond the
    chunk's real candidate count hold NEG32 / index 0.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from versalignlib_tpu.parallel.mesh import DATA_AXIS

    n_dev = mesh.devices.size
    rc = panel_chunk.shape[0]
    # Every shard needs >= k rows for lax.top_k; pads are all-invalid
    # sequences appended at the end (global index >= rc), masked out below.
    shard_r = max(-(-rc // n_dev), k)
    pc = np.pad(panel_chunk, ((0, shard_r * n_dev - rc), (0, 0)))
    pc_dev = jax.device_put(jnp.asarray(pc),
                            NamedSharding(mesh, P(DATA_AXIS, None)))
    reads_dev = jax.device_put(jnp.asarray(reads_enc),
                               NamedSharding(mesh, P(None, None)))
    v, i = _score_topk_chunk_mesh(reads_dev, pc_dev, params, algorithm,
                                  impl, k, mesh)
    v = np.asarray(v).astype(np.int64)
    i = np.asarray(i).astype(np.int64)
    v = np.where(i < rc, v, np.int64(NEG32))     # drop padding candidates
    order = np.lexsort((i, -v), axis=1)[:, :k]   # (-score, index): first-win
    return np.take_along_axis(v, order, axis=1), \
        np.take_along_axis(np.where(i < rc, i, 0), order, axis=1)


def _mesh_chunk_scores_panel(reads_enc, panel_chunk, params, algorithm, impl,
                             mesh) -> np.ndarray:
    """Full (B, Rc) score block with the PANEL sharded over the data axis
    (reads replicated) — score_matrix's panel_axis="panel" mode."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from versalignlib_tpu.parallel.mesh import DATA_AXIS

    n_dev = mesh.devices.size
    rc = panel_chunk.shape[0]
    r_pad = -(-rc // n_dev) * n_dev
    pc = np.pad(panel_chunk, ((0, r_pad - rc), (0, 0)))
    pc_dev = jax.device_put(jnp.asarray(pc),
                            NamedSharding(mesh, P(DATA_AXIS, None)))
    reads_dev = jax.device_put(jnp.asarray(reads_enc),
                               NamedSharding(mesh, P(None, None)))
    out = _score_cross_chunk_mesh_panel(reads_dev, pc_dev, params, algorithm,
                                        impl, mesh)
    return np.asarray(out)[:, :rc]


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "impl", "mesh"),
)
def _score_cross_chunk_mesh_panel(reads, panel, params: AlignmentParameters,
                                  algorithm: Algorithm, impl: str,
                                  mesh):
    from jax.sharding import PartitionSpec as P

    from versalignlib_tpu.parallel.mesh import DATA_AXIS

    mapped = jax.shard_map(
        lambda r, f: _cross_scores(r, f, params, algorithm, impl),
        mesh=mesh,
        in_specs=(P(None, None), P(DATA_AXIS, None)),
        out_specs=P(None, DATA_AXIS),
        check_vma=False,
    )
    return mapped(reads, panel)


def _mesh_chunk_scores(reads_enc, panel_chunk, params, algorithm, impl, mesh):
    """One panel chunk over the mesh: pad B to the axis size, shard, score."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from versalignlib_tpu.parallel.mesh import DATA_AXIS

    n_dev = mesh.devices.size
    b = reads_enc.shape[0]
    b_pad = -(-b // n_dev) * n_dev
    reads_p = jnp.asarray(np.pad(reads_enc, ((0, b_pad - b), (0, 0))))
    reads_p = jax.device_put(reads_p, NamedSharding(mesh, P(DATA_AXIS, None)))
    panel_d = jax.device_put(jnp.asarray(panel_chunk),
                             NamedSharding(mesh, P(None, None)))
    out = _score_cross_chunk_mesh(reads_p, panel_d, params, algorithm,
                                  impl, mesh)
    return np.asarray(out)[:b]


NEG32 = np.iinfo(np.int32).min


def _stream_best(reads_enc, panel_enc, params, algorithm, impl,
                 chunk, mesh, panel_axis: str = "reads"):
    """Running top-2 fold over panel chunks.

    Returns (arg (B,), best (B,), second (B,)): the best entry's index and
    score plus the second-best score over DIFFERENT panel entries (int32
    min when the panel has a single entry) — the input to the MAPQ gap.
    """
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    reads_dev = None if mesh is not None else jnp.asarray(reads_enc)
    best = np.full(b, NEG32, dtype=np.int32)
    second = np.full(b, NEG32, dtype=np.int32)
    arg = np.zeros(b, dtype=np.int32)
    for lo in range(0, r, chunk):
        pc = panel_enc[lo : lo + chunk]
        if mesh is not None and panel_axis == "panel":
            # Shard the MANY side: local top-2 per device, host k-way merge.
            v, i = _mesh_topk_scores(reads_enc, pc, params, algorithm, impl,
                                     mesh, k=2)
            c_arg = i[:, 0].astype(np.int32)
            c_best = v[:, 0].astype(np.int32)
            c_second = v[:, 1]
        elif mesh is not None:
            s = _chunk_scores(reads_enc, reads_dev, pc, params, algorithm,
                              impl, mesh)
            rows = np.arange(b)
            c_arg = np.argmax(s, axis=1)       # first-win within the chunk
            c_best = s[rows, c_arg]
            c_second = (np.partition(s, -2, axis=1)[:, -2].astype(np.int64)
                        if s.shape[1] >= 2 else np.full(b, NEG32, np.int64))
        else:
            # Device-side top-2: O(B) comes back over the link, not (B, R).
            kk = min(2, pc.shape[0])
            v, i = _score_topk_chunk(reads_dev, jnp.asarray(pc), params,
                                     algorithm, impl, kk)
            v = np.asarray(v)
            c_arg = np.asarray(i)[:, 0]
            c_best = v[:, 0]
            c_second = (v[:, 1].astype(np.int64) if kk >= 2
                        else np.full(b, NEG32, np.int64))
        upd = c_best > best                    # strict >: earlier chunk wins ties
        # Top-2 merge of two disjoint candidate pools (exact).
        second = np.maximum(np.minimum(best.astype(np.int64), c_best),
                            np.maximum(second.astype(np.int64), c_second)
                            ).astype(np.int32)
        best = np.where(upd, c_best, best)
        arg = np.where(upd, lo + c_arg, arg).astype(np.int32)
    return arg, best, second


def score_matrix(
    reads,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    impl: str = "auto",
    max_pairs: int = 1 << 20,
    mesh=None,
    panel_axis: str = "reads",
) -> np.ndarray:
    """All-vs-all scores: (B,) reads x (R,) panel -> (B, R) int32.

    ``max_pairs`` bounds the device batch per dispatch (the panel streams
    through in ``ceil(B*R / max_pairs)`` chunks). ``impl``: auto = the GPU
    kernel where it compiles, xla elsewhere. ``mesh``: optional ``jax.sharding.Mesh`` —
    ``panel_axis`` selects which side shards over its data axis:
    ``"reads"`` (default) shards the read batch and replicates the panel
    chunk; ``"panel"`` shards the panel chunk and replicates the reads —
    use it when the many side dominates memory (genome window sets). Both
    modes have zero inter-device communication; the result gather is the
    only collective.
    """
    reads_enc = _encode(reads)
    panel_enc = _encode(panel)
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    if b == 0 or r == 0:
        return np.zeros((b, r), dtype=np.int32)
    impl = resolve_score_impl(impl)
    algorithm = Algorithm(algorithm)
    chunk = max(1, min(r, max_pairs // max(b, 1)))
    reads_dev = None if mesh is not None else jnp.asarray(reads_enc)
    out = np.empty((b, r), dtype=np.int32)
    for lo in range(0, r, chunk):
        pc = panel_enc[lo : lo + chunk]
        if mesh is not None and panel_axis == "panel":
            out[:, lo : lo + pc.shape[0]] = _mesh_chunk_scores_panel(
                reads_enc, pc, params, algorithm, impl, mesh)
        else:
            out[:, lo : lo + pc.shape[0]] = _chunk_scores(
                reads_enc, reads_dev, pc, params, algorithm, impl,
                mesh)
    return out


def best_hits(
    reads,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    impl: str = "auto",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
    panel_axis: str = "reads",
) -> tuple[np.ndarray, np.ndarray, list[Alignment] | None]:
    """Best panel hit per read: (hit_index (B,), score (B,), alignments).

    Ties resolve to the lowest panel index (scan order, mirroring the
    reference kernels' first-win argmax convention). ``align=True`` runs
    the full traceback ONLY on each read's winning pair — B alignments
    total instead of B×R — through the normal backend dispatch. An empty
    panel yields hit index -1 and int32-min scores (no fabricated hit 0).
    ``panel_axis="panel"`` (with ``mesh``) shards the panel across devices
    with device-local top-k folds instead of replicating it (see
    :func:`score_matrix`).
    """
    reads_enc = _encode(reads)
    panel_enc = _encode(panel)
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    if b == 0 or r == 0:
        return (np.full(b, -1, np.int32),
                np.full(b, np.iinfo(np.int32).min, np.int32),
                [unmapped_alignment() for _ in range(b)] if align else None)
    impl = resolve_score_impl(impl)
    algorithm = Algorithm(algorithm)
    chunk = max(1, min(r, max_pairs // max(b, 1)))
    arg, best, _ = _stream_best(reads_enc, panel_enc, params, algorithm,
                                impl, chunk, mesh, panel_axis)
    if not align:
        return arg, best, None
    alns = _align_pairs(reads_enc, panel_enc[arg], params, algorithm, tie,
                        backend, mesh)
    return arg, best, alns


def _align_pairs(reads_enc, refs_enc, params, algorithm, tie, backend, mesh):
    if mesh is not None:
        from versalignlib_tpu.parallel.distributed import distributed_align_batch

        return distributed_align_batch(reads_enc, refs_enc, params,
                                       algorithm, tie, mesh=mesh)
    from versalignlib_tpu.dispatch import get_backend

    return get_backend(backend).compute_alignments(
        algorithm, reads_enc, refs_enc, params, tie)


@dataclasses.dataclass
class SearchHits:
    """Per-read best-hit results from :func:`map_reads`."""

    index: np.ndarray       # (B,) best panel entry (-1 when the panel is empty)
    score: np.ndarray       # (B,) int32 DP score of the best hit
    strand: np.ndarray      # (B,) 0 = forward, 1 = reverse-complement
    alignments: list[Alignment] | None  # best-pair tracebacks (align=True)
    #: (B,) uint8 mapping-quality heuristic from the best-vs-second-best
    #: score gap: min(60, 6*gap/match_unit); 0 on exact ties, 60 when the
    #: panel offers no second candidate. A monotone confidence signal in
    #: the BWA tradition, not a calibrated error probability.
    mapq: np.ndarray = None

    def __len__(self) -> int:
        return self.index.shape[0]


def _mapq_from_gap(best, second, params) -> np.ndarray:
    unit = (params.score_match if params.matrix is None
            else max(max(r) for r in params.matrix))
    unit = max(int(unit), 1)
    gap = np.maximum(best.astype(np.int64) - second.astype(np.int64), 0)
    q = np.minimum(60, (6 * gap) // unit)
    return np.where(second == NEG32, 60, q).astype(np.uint8)


def _chunk_scores(reads_enc, reads_dev, pc, params, algorithm, impl,
                  mesh) -> np.ndarray:
    """One (reads x panel-chunk) score block, mesh-aware."""
    if mesh is not None:
        return _mesh_chunk_scores(reads_enc, pc, params, algorithm, impl, mesh)
    return np.asarray(_cross_scores(
        reads_dev, jnp.asarray(pc), params, algorithm, impl))


@dataclasses.dataclass
class PairedHits:
    """Per-fragment best-hit results from :func:`map_read_pairs`."""

    index: np.ndarray       # (B,) best panel entry (-1 when the panel is empty)
    score: np.ndarray       # (B,) int64 combined pair score (mate1 + mate2)
    #: (B,) fragment orientation: 0 = FR (mate1 forward, mate2 reverse-
    #: complement — the standard Illumina layout), 1 = RF (the converse).
    orient: np.ndarray
    alignments1: list[Alignment] | None  # mate-1 tracebacks (align=True)
    alignments2: list[Alignment] | None
    mapq: np.ndarray = None  # (B,) pair-level MAPQ heuristic (see map_reads)

    @property
    def strand1(self) -> np.ndarray:
        """(B,) mate-1 strand: reverse iff the fragment mapped RF."""
        return (self.orient == 1).astype(np.int8)

    @property
    def strand2(self) -> np.ndarray:
        """(B,) mate-2 strand: reverse iff the fragment mapped FR."""
        return (self.orient == 0).astype(np.int8)

    def __len__(self) -> int:
        return self.index.shape[0]


def map_read_pairs(
    reads1,
    reads2,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    impl: str = "auto",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
) -> PairedHits:
    """Paired-end mapping: best panel entry for each (mate1, mate2) pair.

    A fragment maps to ONE panel entry with its mates in opposite
    orientations; both layouts are scored — FR (mate1 forward + mate2
    reverse-complement) and RF — and per panel entry the better layout's
    COMBINED score (sum of mate scores) competes in the argmax, so a mate
    that matches one entry well never drags the pair onto different
    entries. FR wins layout ties; earlier panel entries win score ties
    (scan order). MAPQ comes from the combined-score gap to the
    second-best panel entry. ``align=True`` tracebacks both mates of the
    winning (entry, layout) only; DNA-only (needs the complement), like
    ``map_reads(both_strands=True)``.
    """
    if params.matrix is not None:
        raise ValueError("paired-end mapping is DNA-only (custom "
                         "substitution matrices have no complement)")
    from versalignlib_tpu.alphabet import reverse_complement_codes

    f1_enc = _encode(reads1)
    f2_enc = _encode(reads2)
    if f1_enc.shape[0] != f2_enc.shape[0]:
        raise ValueError(f"mate counts differ: {f1_enc.shape[0]} vs "
                         f"{f2_enc.shape[0]}")
    panel_enc = _encode(panel)
    b = f1_enc.shape[0]
    r = panel_enc.shape[0]
    if b == 0 or r == 0:
        empty = lambda: ([unmapped_alignment() for _ in range(b)]
                         if align else None)
        return PairedHits(np.full(b, -1, np.int32),
                          np.full(b, np.iinfo(np.int64).min, np.int64),
                          np.zeros(b, np.int8), empty(), empty(),
                          np.zeros(b, np.uint8))
    impl = resolve_score_impl(impl)
    algorithm = Algorithm(algorithm)
    r1_enc = reverse_complement_codes(f1_enc)
    r2_enc = reverse_complement_codes(f2_enc)
    # Four oriented mate batches stream the panel together; each chunk
    # costs 4 score dispatches. Halve the chunk so the device batch stays
    # within max_pairs across the two mates.
    chunk = max(1, min(r, max_pairs // (2 * max(b, 1))))
    devs = (None,) * 4 if mesh is not None else tuple(
        jnp.asarray(x) for x in (f1_enc, r1_enc, f2_enc, r2_enc))
    NEG = np.int64(np.iinfo(np.int64).min // 4)  # safe against adds
    best = np.full(b, NEG, dtype=np.int64)
    second = np.full(b, NEG, dtype=np.int64)
    arg = np.zeros(b, dtype=np.int32)
    orient = np.zeros(b, dtype=np.int8)
    rows = np.arange(b)
    for lo in range(0, r, chunk):
        pc = panel_enc[lo : lo + chunk]
        s_f1, s_r1, s_f2, s_r2 = (
            _chunk_scores(enc, dev, pc, params, algorithm, impl,
                          mesh).astype(np.int64)
            for enc, dev in zip((f1_enc, r1_enc, f2_enc, r2_enc), devs))
        fr = s_f1 + s_r2
        rf = s_r1 + s_f2
        c_comb = np.maximum(fr, rf)
        c_orient = (rf > fr)                   # FR wins layout ties
        c_arg = np.argmax(c_comb, axis=1)      # first-win within the chunk
        c_best = c_comb[rows, c_arg]
        c_second = (np.partition(c_comb, -2, axis=1)[:, -2]
                    if c_comb.shape[1] >= 2 else np.full(b, NEG))
        upd = c_best > best                    # strict >: earlier chunk wins ties
        second = np.maximum(np.minimum(best, c_best),
                            np.maximum(second, c_second))
        best = np.where(upd, c_best, best)
        arg = np.where(upd, lo + c_arg, arg).astype(np.int32)
        orient = np.where(upd, c_orient[rows, c_arg], orient).astype(np.int8)
    # Same heuristic as single-end hits: translate the paired sentinel to
    # the shared one and reuse the one formula (_mapq_from_gap).
    mapq = _mapq_from_gap(best, np.where(second == NEG, NEG32, second),
                          params)
    alns1 = alns2 = None
    if align:
        rev = orient.astype(bool)
        oriented1 = np.where(rev[:, None], r1_enc, f1_enc)
        oriented2 = np.where(rev[:, None], f2_enc, r2_enc)
        refs_sel = panel_enc[arg]
        alns1 = _align_pairs(oriented1, refs_sel, params, algorithm, tie,
                             backend, mesh)
        alns2 = _align_pairs(oriented2, refs_sel, params, algorithm, tie,
                             backend, mesh)
    return PairedHits(arg, best, orient, alns1, alns2, mapq)


def map_reads(
    reads,
    panel,
    params: AlignmentParameters = DEFAULT_PARAMETERS,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    impl: str = "auto",
    max_pairs: int = 1 << 20,
    align: bool = True,
    backend: str = "auto",
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh=None,
    both_strands: bool = True,
    panel_axis: str = "reads",
) -> SearchHits:
    """Strand-aware read mapping: best panel hit over both orientations.

    Real mappers score the read AND its reverse complement (DNA only; the
    code-level revcomp is padding-aware, ``alphabet.reverse_complement_codes``).
    The forward strand wins score ties. ``align=True`` tracebacks each
    read's winning (orientation, panel entry) pair only; reverse-strand
    alignments are reported in reverse-complement read coordinates (the
    SAM convention — ``io.sam.write_sam`` sets flag 16 from ``strand``).
    ``panel_axis="panel"`` (with ``mesh``) shards the panel across devices
    instead of replicating it (see :func:`score_matrix`).
    """
    if params.matrix is not None and both_strands:
        raise ValueError("both_strands mapping is DNA-only (custom "
                         "substitution matrices have no complement)")
    reads_enc = _encode(reads)
    panel_enc = _encode(panel)
    b = reads_enc.shape[0]
    r = panel_enc.shape[0]
    if b == 0 or r == 0:
        return SearchHits(np.full(b, -1, np.int32),
                          np.full(b, NEG32, np.int32),
                          np.zeros(b, np.int8),
                          [unmapped_alignment() for _ in range(b)]
                          if align else None,
                          np.zeros(b, np.uint8))
    impl = resolve_score_impl(impl)
    algorithm = Algorithm(algorithm)
    chunk = max(1, min(r, max_pairs // max(b, 1)))
    arg, best, second = _stream_best(reads_enc, panel_enc, params, algorithm,
                                     impl, chunk, mesh, panel_axis)
    strand = np.zeros(b, dtype=np.int8)
    if both_strands:
        from versalignlib_tpu.alphabet import reverse_complement_codes

        rc_enc = reverse_complement_codes(reads_enc)
        rc_arg, rc_best, rc_second = _stream_best(
            rc_enc, panel_enc, params, algorithm, impl, chunk,
            mesh, panel_axis)
        rev = rc_best > best            # strict >: forward wins ties
        # Top-2 merge across the two orientations' candidate pools.
        second = np.maximum(
            np.minimum(best.astype(np.int64), rc_best),
            np.maximum(second.astype(np.int64), rc_second),
        ).astype(np.int32)
        arg = np.where(rev, rc_arg, arg).astype(np.int32)
        best = np.where(rev, rc_best, best)
        strand = rev.astype(np.int8)
        oriented = np.where(rev[:, None], rc_enc, reads_enc)
    else:
        oriented = reads_enc
    alns = None
    if align:
        alns = _align_pairs(oriented, panel_enc[arg], params, algorithm,
                            tie, backend, mesh)
    return SearchHits(arg, best, strand, alns,
                      _mapq_from_gap(best, second, params))
