"""Position-specific scoring (PSSM / profile) search — ADDITIVE capability.

The reference library scores every read position with one substitution rule
(match/mismatch tables, /root/reference/src/Kernels/default/DefaultKernel.h:83-96);
a PSSM generalizes that to a per-position score row: aligning profile
position ``i`` against symbol code ``s`` scores ``P[i, s]`` (the standard
motif/domain-scanning model behind PSI-BLAST / MEME / HMM match states).
Gap costs stay the engine's linear or affine (Gotoh) model, and both
algorithm variants keep their exact reference semantics (SW clamp/global
max; the NW overlap score's free leading/trailing gaps,
DefaultKernel.cpp:177,189-191).

Semantically a PSSM is "matrix mode with a position-indexed read": a
synthetic read ``[1..m]`` scored through a rectangular (m+1, S) matrix.
The oracle is therefore the established numpy fills with a precomputed
substitution plane (oracle._fill_matrix / gotoh._fill_affine ``sub=``).

Device path: the dense XLA score scan (ops/xla.py ``profile_scores``) with
the profile as the row side — each row's substitution scores are the
profile row gathered at the pool codes — and the SW argmax end cell folded
on the device for hit coordinates.

Score conventions: ``P[i, 0]`` must be 0 (code 0 is the padding sentinel,
pad scores 0 exactly like the reference's '\\0' fill-up); codes outside
the table score 0 (the reference's invalid-base rule).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm


def validate_pssm(P) -> np.ndarray:
    P = np.asarray(P, dtype=np.int32)
    if P.ndim != 2 or P.shape[1] < 2:
        raise ValueError(f"PSSM must be (m, S >= 2), got {P.shape}")
    if np.any(P[:, 0] != 0):
        raise ValueError("PSSM column 0 must be zero (code 0 is padding)")
    return P


# ---------------------------------------------------------------------------
# Oracle (numpy) — the semantic source of truth for profile scoring
# ---------------------------------------------------------------------------

def profile_sub_plane(P: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """(m, n) substitution plane: sub[i, j] = P[i, ref_j] (0 outside)."""
    P = validate_pssm(P)
    ref = np.asarray(ref, dtype=np.int32)
    s = P.shape[1]
    inside = (ref >= 0) & (ref < s)
    codes = np.where(inside, ref, 0)
    return np.where(inside[None, :], P[:, codes], 0).astype(np.int32)


def score_profile_oracle(
    P: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
) -> np.ndarray:
    """Batch profile scores vs (R, n) code array — numpy reference.

    Reuses the golden-gated fills with a precomputed sub plane, so SW /
    NW-overlap / affine semantics are identical to sequence scoring.
    """
    from versalignlib_tpu.ops import gotoh, oracle

    P = validate_pssm(P)
    refs = np.asarray(refs, dtype=np.uint8)
    m = P.shape[0]
    dummy_read = np.zeros(m, dtype=np.int32)
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    out = np.empty(refs.shape[0], dtype=np.int32)
    for i, ref in enumerate(refs):
        sub = profile_sub_plane(P, ref)
        if params.affine:
            h, _, _ = gotoh._fill_affine(
                dummy_read, ref, params, local=local, col0_penalty=False,
                sub=sub)
        else:
            h = oracle._fill_matrix(
                dummy_read, ref, params, local=local, col0_penalty=False,
                sub=sub)
        if local:
            out[i] = int(h.max())
        else:
            last_col = h[1:, -1].max() if h.shape[0] > 1 else 0
            out[i] = int(max(0, int(last_col), int(h[-1, :].max())))
    return out


def profile_argmax_oracle(
    P: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SW (scores, end_rows, end_cols) per pool entry — numpy reference for
    the device coords fold: first cell attaining the global max in row-major
    order, strict-> scan seeded 0/(0, 0) (DefaultKernel.cpp:252-256)."""
    from versalignlib_tpu.ops import gotoh, oracle

    P = validate_pssm(P)
    refs = np.asarray(refs, dtype=np.uint8)
    m = P.shape[0]
    dummy_read = np.zeros(m, dtype=np.int32)
    nb = refs.shape[0]
    scores = np.zeros(nb, dtype=np.int32)
    rows = np.zeros(nb, dtype=np.int32)
    cols = np.zeros(nb, dtype=np.int32)
    for i, ref in enumerate(refs):
        sub = profile_sub_plane(P, ref)
        if params.affine:
            h, _, _ = gotoh._fill_affine(dummy_read, ref, params, local=True,
                                         col0_penalty=False, sub=sub)
        else:
            h = oracle._fill_matrix(dummy_read, ref, params, local=True,
                                    col0_penalty=False, sub=sub)
        best = int(h.max())
        if best > 0:
            flat = int(np.argmax(h[1:, 1:]))  # row-major first maximum
            rows[i] = flat // ref.size
            cols[i] = flat % ref.size
            scores[i] = best
    return scores, rows, cols


def profile_consensus_text(P: np.ndarray) -> str:
    """Displayable per-position consensus letters for the profile side of an
    alignment (argmax symbol per row; DNA letters for S <= 6 tables, the
    protein alphabet otherwise)."""
    from versalignlib_tpu.alphabet import PROTEIN_ALPHABET

    P = validate_pssm(P)
    s = P.shape[1]
    table = "\0ATCGN" if s <= 6 else ("\0" + PROTEIN_ALPHABET)
    out = []
    for row in P:
        sym = int(np.argmax(row[1:])) + 1
        out.append(table[sym] if sym < len(table) else "X")
    return "".join(out)


def profile_align_oracle(
    P: np.ndarray,
    ref: np.ndarray,
    params: AlignmentParameters,
    end: tuple[int, int] | None = None,
    ref_text: str | None = None,
):
    """Full SW alignment of a profile against one pool entry: gapped
    strings (profile side rendered as consensus letters), CIGAR, and true
    start/end coordinates — the ``compute_alignments`` half of the
    interface (include/AlignmentKernel.h:40-43) for profile queries.

    ``end``: (end_row, end_col) walk start (e.g. from the device coords
    fold); derived from the fill's row-major argmax when omitted. Linear
    params walk oracle._pointers, affine walk gotoh's Gotoh pointers —
    canonical DIAG > UP > LEFT flavor in both.
    """
    from versalignlib_tpu.ops import gotoh, oracle

    P = validate_pssm(P)
    ref = np.asarray(ref, dtype=np.uint8)
    m = P.shape[0]
    dummy_read = np.zeros(m, dtype=np.int32)
    sub = profile_sub_plane(P, ref)
    if params.affine:
        h, e, f = gotoh._fill_affine(dummy_read, ref, params, local=True,
                                     col0_penalty=False, sub=sub)
    else:
        h = oracle._fill_matrix(dummy_read, ref, params, local=True,
                                col0_penalty=False, sub=sub)
    if end is None:
        best = int(h.max())
        if best <= 0:
            end = (0, 0)
        else:
            flat = int(np.argmax(h[1:, 1:]))
            end = (flat // ref.size, flat % ref.size)
    from versalignlib_tpu.types import TieBreak

    score = int(h[end[0] + 1, end[1] + 1])
    consensus = profile_consensus_text(P)
    if params.affine:
        ptr = gotoh._affine_pointers(h, e, f, sub, params, local=True)
        return gotoh._affine_traceback(dummy_read, ref, ptr, end[0], end[1],
                                       score, consensus, ref_text)
    ptr = oracle._pointers(h, sub, None, params, local=True,
                           tie=TieBreak.DIAG_UP_LEFT)
    return oracle._traceback(dummy_read, ref, ptr, end[0], end[1], score,
                             consensus, ref_text)


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

def pssm_scores_device(
    P,
    pool,
    params: AlignmentParameters,
    algorithm: Algorithm,
    with_coords: bool = False,
):
    """(m, S) profile x (R, n) pool codes -> (R,) int32 scores on the device.

    ``with_coords`` (SW only): returns (scores, end_rows, end_cols) — the
    argmax DP cell per pool entry folded on the device (row-major
    strict-first-win, the reference SW end rule); 0-based profile position
    / pool column of the hit's last aligned pair.
    """
    from versalignlib_tpu.ops.xla import profile_scores

    return profile_scores(jnp.asarray(validate_pssm(P)), jnp.asarray(pool),
                          params, Algorithm(algorithm), with_coords)


def calibrate_profile(
    P: np.ndarray,
    params: AlignmentParameters | None = None,
    n: int = 128,
    samples: int = 512,
    seed: int = 0,
    backend: str = "auto",
):
    """Gumbel calibration for PROFILE scores vs random sequences — E-values
    for profile_search hits (``cal.evalue(score, P.shape[0], db_len)``).

    Scores ``samples`` random uniform sequences of length ``n`` through the
    profile (uniform ACGT for DNA-width tables, uniform over codes
    1..S-1 otherwise) and fits the extreme-value law with
    :func:`versalignlib_tpu.stats.calibrate_scores` — the same
    simulation-in-miniature approach the pairwise ``stats.calibrate``
    uses, with the profile as the fixed query side.
    """
    from versalignlib_tpu.params import DEFAULT_PARAMETERS
    from versalignlib_tpu.stats import calibrate_scores

    params = DEFAULT_PARAMETERS if params is None else params
    P = validate_pssm(P)
    s = P.shape[1]
    hi_code = 5 if s == 6 else s  # DNA tables: uniform ACGT (skip N)
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, hi_code, size=(samples, n)).astype(np.uint8)
    if backend == "oracle":
        scores = score_profile_oracle(P, pool, params,
                                      Algorithm.SMITH_WATERMAN)
    else:
        scores = np.asarray(pssm_scores_device(
            P, pool, params, Algorithm.SMITH_WATERMAN))
    return calibrate_scores(scores, P.shape[0], n, samples=samples)


# ---------------------------------------------------------------------------
# Profile construction
# ---------------------------------------------------------------------------

def pssm_from_sequences(
    seqs: np.ndarray,
    n_symbols: int = 6,
    pseudocount: float = 1.0,
    scale: float = 2.0,
    background: np.ndarray | None = None,
) -> np.ndarray:
    """Log-odds PSSM from aligned equal-length sequences ((B, m) codes).

    Counts each valid symbol (codes 1..n_symbols-1) per column, adds the
    pseudocount, and scores ``round(scale * log2(freq / background))``.
    Background defaults to uniform over codes 1..4 (the DNA alphabet,
    alphabet.py:9-16); column 0 (padding) is fixed at 0.
    """
    seqs = np.asarray(seqs, dtype=np.int32)
    if seqs.ndim != 2:
        raise ValueError("seqs must be (B, m) code array")
    b, m = seqs.shape
    s = n_symbols
    counts = np.zeros((m, s), dtype=np.float64)
    for sym in range(1, s):
        counts[:, sym] = (seqs == sym).sum(axis=0)
    if background is None:
        background = np.zeros(s)
        background[1:5] = 0.25
    background = np.asarray(background, dtype=np.float64)
    P = np.zeros((m, s), dtype=np.int32)
    valid_total = counts[:, 1:].sum(axis=1) + pseudocount * (s - 1)
    for sym in range(1, s):
        if background[sym] <= 0:
            continue  # symbols with no background stay 0 (neutral)
        freq = (counts[:, sym] + pseudocount) / valid_total
        P[:, sym] = np.round(scale * np.log2(freq / background[sym]))
    return P


class ProfileHit(NamedTuple):
    """One reported profile hit: WHERE the motif sits, not just how well.

    ``end_row``/``end_col``: 0-based profile position / pool-entry column of
    the hit's last aligned pair (the SW argmax cell, reference end rule).
    ``alignment`` (opt-in): full traceback — gapped strings (profile side as
    consensus letters), CIGAR, true start coordinates. ``evalue``/
    ``bitscore`` (opt-in): Gumbel statistics from a profile calibration.
    """

    index: int
    score: int
    end_row: int
    end_col: int
    alignment: object = None   # types.Alignment when requested
    evalue: float | None = None
    bitscore: float | None = None


def profile_search(
    P: np.ndarray,
    pool,
    params: AlignmentParameters = None,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    k: int = 10,
    backend: str = "auto",
    chunk: int = 1 << 17,
    hits: bool = False,
    alignments: bool = False,
    calibration=None,
    db_len: int | None = None,
):
    """Top-k pool entries for a profile: (scores, indices), score-sorted
    (ties keep the lower index, matching lax.top_k / the search paths).

    ``P``: one (m, S) table, or a LIST of tables (shapes may differ) —
    multi-profile mode scores each profile against the pool and returns a
    list of (scores, indices).

    ``pool``: (R, n) uint8 code array or list of sequence strings
    (padded + encoded with the reference rules). ``backend``: "oracle" for
    the numpy reference; anything else runs the device scan.
    ``chunk``: pool entries per device round (bounds the scan's device
    footprint to ~chunk*n int32 — the reference's memory-driven batching,
    OpenCLKernel.cpp:517-568; genome-scale pools stream through).

    ``hits=True`` (SW only) returns list[ProfileHit] instead — hit
    coordinates ride the scan's device argmax fold (zero extra host passes
    over the pool); ``alignments=True`` adds the full traceback
    per reported hit via :func:`profile_align_oracle` (host-side, k tiny
    fills — the same division of labor as the pairwise pipeline's host
    decode); ``calibration`` (a GumbelCalibration, e.g. from
    :func:`calibrate_profile`) adds bitscore/E-value columns with ``db_len``
    total database residues (default: pool cells).
    """
    from versalignlib_tpu.params import DEFAULT_PARAMETERS

    params = DEFAULT_PARAMETERS if params is None else params
    multi = isinstance(P, (list, tuple))
    if not isinstance(pool, np.ndarray):
        from versalignlib_tpu.alphabet import pad_and_encode

        pool = pad_and_encode(list(pool))
    want_coords = hits or alignments
    if want_coords and Algorithm(algorithm) != Algorithm.SMITH_WATERMAN:
        raise ValueError("profile hits with coordinates are SW-only "
                         "(NW overlap end cells are not a single argmax)")
    Ps = [validate_pssm(p0) for p0 in P] if multi else [validate_pssm(P)]
    coord_rows = None
    if backend == "oracle":
        if want_coords:
            trips = [profile_argmax_oracle(p0, pool, params) for p0 in Ps]
            score_rows = [t[0] for t in trips]
            coord_rows = [(t[1], t[2]) for t in trips]
        else:
            score_rows = [score_profile_oracle(p0, pool, params, algorithm)
                          for p0 in Ps]
    else:
        score_rows, coord_rows = [], []
        for p0 in Ps:
            parts = [
                pssm_scores_device(p0, pool[lo:lo + chunk], params, algorithm,
                                   with_coords=want_coords)
                for lo in range(0, pool.shape[0], chunk)
            ]
            if want_coords:
                score_rows.append(np.concatenate([np.asarray(q[0]) for q in parts]))
                coord_rows.append(
                    (np.concatenate([np.asarray(q[1]) for q in parts]),
                     np.concatenate([np.asarray(q[2]) for q in parts])))
            else:
                score_rows.append(np.concatenate([np.asarray(q) for q in parts]))

    def topk(scores):
        kk = min(k, scores.shape[0])
        # Stable top-k: sort by (-score, index).
        order = np.lexsort((np.arange(scores.shape[0]),
                            -scores.astype(np.int64)))
        top = order[:kk]
        return scores[top].astype(np.int32), top.astype(np.int32)

    if not want_coords:
        if multi:
            return [topk(s) for s in score_rows]
        return topk(score_rows[0])

    if db_len is None:
        db_len = int(pool.size)

    def build_hits(pi):
        scores, idx = topk(score_rows[pi])
        rows, cols = coord_rows[pi]
        out = []
        for s, i in zip(scores, idx):
            er, ec = int(rows[i]), int(cols[i])
            aln = None
            if alignments:
                aln = profile_align_oracle(Ps[pi], pool[i], params,
                                           end=(er, ec))
            ev = bs = None
            if calibration is not None:
                bs = float(calibration.bit_score(int(s)))
                ev = float(calibration.evalue(int(s), Ps[pi].shape[0],
                                              db_len))
            out.append(ProfileHit(int(i), int(s), er, ec, aln, ev, bs))
        return out

    if multi:
        return [build_hits(i) for i in range(len(Ps))]
    return build_hits(0)
