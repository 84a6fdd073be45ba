"""Pure-XLA (jax.jit) alignment kernels — the portable reference backend.

Batched DP over pairs: ``lax.scan`` over read rows; within a row the left
dependency ``H[i,j] = max(T[j], H[i,j-1]+gap_read)`` is resolved with the
exact prefix-max identity

    H[i,j] = gap_read*j + cummax_j(T[j] - gap_read*j)

so each scan step is fully vectorized over (batch, ref_len) — the XLA
equivalent of the reference's inter-pair SIMD lanes (SSEKernel.cpp:269-318)
with the row turned data-parallel instead of sequential.

This backend runs anywhere XLA runs (CPU tests, GPU) and is the reference
for the hand-written GPU score kernel (ops/triton_score.py) at full batch
sizes. Semantics are bit-identical to the reference (gated by
tests/test_golden.py through the numpy oracle and by tests/test_xla.py
directly).

Compile-time specialization: ``params``, algorithm, and tie-break are static
jit arguments — the analogue of the reference OpenCL backend baking scores
and lengths into ``-D`` defines (OpenCLKernel.cpp:401-411).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from versalignlib_tpu.ops import traceback as tb
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak, Trace


def _sub_row(read_col, refs, match, mismatch, matrix=None):
    """Substitution scores of one read column vs all ref positions.

    read_col: (B, 1) int32; refs: (B, n) int32 -> (B, n) int32.
    Generic S x S ``matrix`` (static tuple) lowers to an XLA gather; row/col
    0 are zero so padding and out-of-range codes score 0.
    """
    if matrix is not None:
        m = jnp.asarray(matrix, dtype=jnp.int32)
        s = m.shape[0]
        a = jnp.where((read_col >= 0) & (read_col < s), read_col, 0)
        b = jnp.where((refs >= 0) & (refs < s), refs, 0)
        return m[a, b]
    valid = ((read_col >= 1) & (read_col <= 4)) & ((refs >= 1) & (refs <= 4))
    sub = jnp.where(read_col == refs, jnp.int32(match), jnp.int32(mismatch))
    return jnp.where(valid, sub, jnp.int32(0))


def _row_solve(t_full, gap_read):
    """Exact prefix-max resolution of the within-row dependency.

    t_full: (B, n+1) with t_full[:, 0] = column-0 boundary value.
    """
    n1 = t_full.shape[1]
    j = jnp.arange(n1, dtype=jnp.int32)[None, :]
    adj = t_full - gap_read * j
    return jax.lax.cummax(adj, axis=1) + gap_read * j


# ---------------------------------------------------------------------------
# Score-only kernels
# ---------------------------------------------------------------------------

#: -inf stand-in safe against int32 adds
NEG_INF = jnp.int32(-(2**30))


def _row_solve_open(t_full, gap_open, gap_ext):
    """Affine E row: E[j] = ext*j + cummax_{k<j}(t_full[k] + open - ext*k).

    Returns (B, n) — E for columns 1..n (strictly-previous prefix).
    """
    n1 = t_full.shape[1]
    j = jnp.arange(n1, dtype=jnp.int32)[None, :]
    adj = t_full + gap_open - gap_ext * j
    run = jax.lax.cummax(adj, axis=1)
    return run[:, :-1] + gap_ext * j[:, 1:]


def _score_scan(xs, sub_fn, refs, params: AlignmentParameters, local: bool,
                with_coords: bool = False):
    """Score-only row scan shared by pairwise and profile scoring.

    ``xs``: per-row scan inputs (leading axis = DP rows); ``sub_fn(x)`` gives
    that row's (B, n) substitution scores. Linear gaps use the prefix-max row
    solve; affine (Gotoh) adds the F row to the carry and the open-aware E
    prefix (see ops/gotoh.py). ``with_coords`` (SW): also track the first
    cell (row-major) attaining the running max — the reference SW end rule.
    """
    b, n = refs.shape
    gap_ref = jnp.int32(params.score_gap_ref)
    gap_read = params.score_gap_read
    affine = params.affine

    def body(carry, x):
        i, xrow = x
        prev, f_prev, best, best_i, best_j = carry  # prev: (B, n+1) H row
        sub = sub_fn(xrow)
        if affine:
            f_row = jnp.maximum(
                prev[:, 1:] + params.gap_open_ref + gap_ref, f_prev + gap_ref
            )
            t = jnp.maximum(prev[:, :-1] + sub, f_row)
        else:
            f_row = f_prev
            t = jnp.maximum(prev[:, :-1] + sub, prev[:, 1:] + gap_ref)
        if local:
            t = jnp.maximum(t, 0)
        t_full = jnp.concatenate([jnp.zeros((b, 1), jnp.int32), t], axis=1)
        if affine:
            e_row = _row_solve_open(t_full, params.gap_open_read, gap_read)
            h_inner = jnp.maximum(t, e_row)
            if local:
                h_inner = jnp.maximum(h_inner, 0)
            h = jnp.concatenate([jnp.zeros((b, 1), jnp.int32), h_inner], axis=1)
        else:
            h = _row_solve(t_full, gap_read)
        if local and with_coords:
            row_max = jnp.max(h[:, 1:], axis=1)
            upd = row_max > best
            best = jnp.where(upd, row_max, best)
            best_i = jnp.where(upd, i, best_i)
            best_j = jnp.where(
                upd, jnp.argmax(h[:, 1:], axis=1).astype(jnp.int32), best_j)
        elif local:
            best = jnp.maximum(best, jnp.max(h, axis=1))
        else:
            # NW overlap score: max over the LAST column of every row
            # (DefaultKernel.cpp:177); the final-row max is added after.
            best = jnp.maximum(best, h[:, -1])
        return (h, f_row, best, best_i, best_j), None

    f_init = jnp.full((b, n), NEG_INF, jnp.int32) if affine else jnp.zeros((b, n), jnp.int32)
    zeros_b = jnp.zeros((b,), jnp.int32)
    init = (jnp.zeros((b, n + 1), jnp.int32), f_init, zeros_b, zeros_b, zeros_b)
    (h_last, _, best, best_i, best_j), _ = jax.lax.scan(body, init, xs)
    if not local:
        best = jnp.maximum(best, jnp.max(h_last, axis=1))
        best = jnp.maximum(best, 0)
    if with_coords:
        return best, best_i, best_j
    return best


@functools.partial(jax.jit, static_argnames=("params", "algorithm"))
def score_batch(reads, refs, params: AlignmentParameters, algorithm: Algorithm):
    """Batched scores. reads (B, m), refs (B, n) uint8 codes -> (B,) int32."""
    reads = reads.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    m = reads.shape[1]
    return _score_scan(
        (jnp.arange(m, dtype=jnp.int32), reads.T),
        lambda read_col: _sub_row(read_col[:, None], refs, params.score_match,
                                  params.score_mismatch, params.matrix),
        refs, params, algorithm == Algorithm.SMITH_WATERMAN)


@functools.partial(jax.jit,
                   static_argnames=("params", "algorithm", "with_coords"))
def profile_scores(profile, pool, params: AlignmentParameters,
                   algorithm: Algorithm, with_coords: bool = False):
    """(m, S) PSSM x (R, n) pool codes -> (R,) int32 scores.

    Row i's substitution scores are the profile row gathered at the pool
    codes (codes outside [0, S) score 0). ``with_coords`` (SW only):
    (scores, end_rows, end_cols), the first cell attaining the max in
    row-major order.
    """
    profile = profile.astype(jnp.int32)
    pool = pool.astype(jnp.int32)
    s = profile.shape[1]
    inside = (pool >= 0) & (pool < s)
    codes = jnp.where(inside, pool, 0)
    return _score_scan(
        (jnp.arange(profile.shape[0], dtype=jnp.int32), profile),
        lambda prow: jnp.where(inside, prow[codes], 0),
        pool, params, algorithm == Algorithm.SMITH_WATERMAN, with_coords)


# ---------------------------------------------------------------------------
# Alignment kernels: pointer matrix + traceback start cell
# ---------------------------------------------------------------------------

def _pointer_row(cur, diag, up, left, valid_comp, local, tie: TieBreak):
    """Vectorized pointer selection for one row (all (B, n) arrays)."""
    is_diag = cur == diag
    is_up = cur == up
    is_left = cur == left
    d, u, l, s = (jnp.uint8(Trace.DIAG), jnp.uint8(Trace.UP),
                  jnp.uint8(Trace.LEFT), jnp.uint8(Trace.START))
    if tie == TieBreak.DIAG_UP_LEFT:
        out = jnp.where(is_diag, d, jnp.where(is_up, u, jnp.where(is_left, l, s)))
        if local:
            out = jnp.where(cur == 0, s, out)
    else:
        is_diag = is_diag & valid_comp
        out = jnp.where(is_diag, d, jnp.where(is_left, l, jnp.where(is_up, u, s)))
    return out


@functools.partial(jax.jit, static_argnames=("params", "algorithm", "tie"))
def align_batch(reads, refs, params: AlignmentParameters, algorithm: Algorithm,
                tie: TieBreak = TieBreak.DIAG_UP_LEFT):
    """Batched pointer-matrix fill.

    Returns (ptr, start_read_pos, start_ref_pos, best_score):
      ptr: (B, m, n) uint8 inner pointer matrix
      start_*: (B,) int32 traceback start cell (reference best_coordinates)
      best_score: (B,) int32 (SW: global max; NW: score at the start cell)
    """
    reads = reads.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    b, m = reads.shape
    n = refs.shape[1]
    local = algorithm == Algorithm.SMITH_WATERMAN
    gap_ref = jnp.int32(params.score_gap_ref)
    gap_read = params.score_gap_read
    from versalignlib_tpu.alphabet import make_validity

    vfn = make_validity(params.matrix)
    ref_valid = vfn(refs)

    # Boundary validity flavor: Default counts N valid; SSE only A/C/G/T
    # (nonzero-scoring codes for custom matrices).
    if tie == TieBreak.DIAG_UP_LEFT:
        read_invalid = reads == 0
        ref_invalid = refs == 0
    else:
        read_invalid = ~vfn(reads)
        ref_invalid = ~ref_valid
    any_r = jnp.any(read_invalid, axis=1)
    first_r = jnp.argmax(read_invalid, axis=1).astype(jnp.int32)
    max_read_pos = jnp.where(any_r, first_r - 1, m - 1)

    def body(carry, x):
        i, read_col = x
        prev, best_score, best_i, best_j, h_keep = carry
        sub = _sub_row(read_col[:, None], refs, params.score_match, params.score_mismatch, params.matrix)
        up_v = prev[:, 1:] + gap_ref
        diag_v = prev[:, :-1] + sub
        t = jnp.maximum(diag_v, up_v)
        if local:
            t = jnp.maximum(t, 0)
            col0 = jnp.zeros((b, 1), jnp.int32)
        else:
            # NW traceback variant penalizes column 0 (DefaultKernel.cpp:305).
            col0 = jnp.full((b, 1), (i + 1), jnp.int32) * gap_ref
        t_full = jnp.concatenate([col0, t], axis=1)
        h = _row_solve(t_full, gap_read)
        cur = h[:, 1:]
        left_v = h[:, :-1] + gap_read
        valid_comp = vfn(read_col[:, None]) & ref_valid
        ptr_row = _pointer_row(cur, diag_v, up_v, left_v, valid_comp, local, tie)

        if local:
            row_max = jnp.max(cur, axis=1)
            row_arg = jnp.argmax(cur, axis=1).astype(jnp.int32)
            upd = row_max > best_score
            best_score = jnp.where(upd, row_max, best_score)
            best_i = jnp.where(upd, i, best_i)
            best_j = jnp.where(upd, row_arg, best_j)
        else:
            # Per-row argmax with the reference's boundary-seeded strict scan
            # (rowMax starts at the column-0 value with index 0,
            # DefaultKernel.cpp:317-318,352-355).
            row_max = jnp.max(cur, axis=1)
            row_arg = jnp.where(
                row_max > h[:, 0], jnp.argmax(cur, axis=1).astype(jnp.int32), 0
            )
            best_j = row_arg  # reused as the per-row index emission
            # Capture the H row of each pair's last valid read row so the
            # end-cell score is exact in every tie-break flavor.
            h_keep = jnp.where((max_read_pos == i)[:, None], h, h_keep)
        out_row = (ptr_row, best_j) if not local else ptr_row
        return (h, best_score, best_i, best_j, h_keep), out_row

    init = (
        jnp.zeros((b, n + 1), jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b, n + 1), jnp.int32),
    )
    xs = (jnp.arange(m, dtype=jnp.int32), reads.T)
    (h_last, best_score, best_i, best_j, h_keep), ys = jax.lax.scan(body, init, xs)

    if local:
        ptr = jnp.transpose(ys, (1, 0, 2))  # (B, m, n)
        return ptr, best_i, best_j, best_score

    ptr_rows, row_args = ys  # (m, B, n), (m, B)
    ptr = jnp.transpose(ptr_rows, (1, 0, 2))
    any_f = jnp.any(ref_invalid, axis=1)
    first_f = jnp.argmax(ref_invalid, axis=1).astype(jnp.int32)
    max_ref_pos = jnp.where(any_f, first_f - 1, n - 1)
    # globalRowMaxIndex: per-row argmax of the last valid row; 0 if the read
    # starts invalid (rowMaxIndex's initial value, DefaultKernel.cpp:299,313).
    gri = jnp.where(
        max_read_pos >= 0,
        jnp.take_along_axis(row_args.T, jnp.maximum(max_read_pos, 0)[:, None], axis=1)[:, 0],
        0,
    )
    start_ref = jnp.minimum(max_ref_pos, gri)
    # Exact end-cell score from the captured H row (0 when the end cell is
    # on the boundary row -1, where H = 0).
    score = jnp.where(
        max_read_pos >= 0,
        jnp.take_along_axis(
            h_keep, jnp.clip(start_ref, -1, n - 1)[:, None] + 1, axis=1
        )[:, 0],
        0,
    )
    return ptr, max_read_pos, start_ref, score


# ---------------------------------------------------------------------------
# Affine (Gotoh) alignment kernel: 4-bit pointer plane
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("params", "algorithm", "tie"))
def align_affine_batch(reads, refs, params: AlignmentParameters,
                       algorithm: Algorithm,
                       tie: TieBreak = TieBreak.DIAG_UP_LEFT):
    """Affine pointer-plane fill (see ops/gotoh.py for the pointer model).

    Returns (ptr, start_read_pos, start_ref_pos, score): ptr is (B, m, n)
    uint8 with hptr(2b) | e_ext<<2 | f_ext<<3. Canonical tie order
    DIAG > UP(F) > LEFT(E) with the SW zero-force; the SSE flavor gates
    DIAG on symbol validity and orders DIAG > LEFT(E) > UP(F) with no
    zero-force (the affine extension of SSEKernel.cpp:364-379 — the
    reference has no affine kernels; see gotoh._affine_pointers). Extend
    beats open on gap ties in both flavors (gaps coalesce).
    """
    reads = reads.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    b, m = reads.shape
    n = refs.shape[1]
    local = algorithm == Algorithm.SMITH_WATERMAN
    ext_f = jnp.int32(params.score_gap_ref)
    ext_r = params.score_gap_read
    open_f = jnp.int32(params.gap_open_ref)
    open_r = jnp.int32(params.gap_open_read)
    from versalignlib_tpu.alphabet import make_validity

    vfn = make_validity(params.matrix)
    ref_valid = vfn(refs)

    # NW end-cell validity: Default flavor counts any nonzero code valid
    # (matching gotoh.nw_align_affine); SSE flavor only nonzero-scoring codes.
    if tie == TieBreak.DIAG_UP_LEFT:
        read_invalid = reads == 0
        ref_invalid = refs == 0
    else:
        read_invalid = ~vfn(reads)
        ref_invalid = ~ref_valid
    any_r = jnp.any(read_invalid, axis=1)
    first_r = jnp.argmax(read_invalid, axis=1).astype(jnp.int32)
    max_read_pos = jnp.where(any_r, first_r - 1, m - 1)

    d, u, l, s = (jnp.uint8(Trace.DIAG), jnp.uint8(Trace.UP),
                  jnp.uint8(Trace.LEFT), jnp.uint8(Trace.START))

    def body(carry, x):
        i, read_col = x
        prev, f_prev, best_score, best_i, best_j, h_keep = carry
        sub = _sub_row(read_col[:, None], refs, params.score_match, params.score_mismatch, params.matrix)
        f_row = jnp.maximum(prev[:, 1:] + open_f + ext_f, f_prev + ext_f)
        diag_v = prev[:, :-1] + sub
        t = jnp.maximum(diag_v, f_row)
        if local:
            t = jnp.maximum(t, 0)
            col0 = jnp.zeros((b, 1), jnp.int32)
        else:
            col0 = open_f + (i + 1) * jnp.full((b, 1), 1, jnp.int32) * ext_f
        t_full = jnp.concatenate([col0, t], axis=1)
        e_row = _row_solve_open(t_full, open_r, ext_r)
        h_inner = jnp.maximum(t, e_row)
        if local:
            h_inner = jnp.maximum(h_inner, 0)
        h = jnp.concatenate([col0, h_inner], axis=1)

        if tie == TieBreak.DIAG_UP_LEFT:
            hp = jnp.where(h_inner == diag_v, d,
                           jnp.where(h_inner == f_row, u,
                                     jnp.where(h_inner == e_row, l, s)))
            if local:
                hp = jnp.where(h_inner == 0, s, hp)
        else:
            valid_comp = vfn(read_col[:, None]) & ref_valid
            hp = jnp.where((h_inner == diag_v) & valid_comp, d,
                           jnp.where(h_inner == e_row, l,
                                     jnp.where(h_inner == f_row, u, s)))
        e_shift = jnp.concatenate(
            [jnp.full((b, 1), NEG_INF, jnp.int32), e_row[:, :-1]], axis=1
        )
        e_ext = (e_row == e_shift + ext_r).astype(jnp.uint8)
        f_ext = (f_row == f_prev + ext_f).astype(jnp.uint8)
        ptr_row = hp | (e_ext << 2) | (f_ext << 3)

        if local:
            row_max = jnp.max(h_inner, axis=1)
            row_arg = jnp.argmax(h_inner, axis=1).astype(jnp.int32)
            upd = row_max > best_score
            best_score = jnp.where(upd, row_max, best_score)
            best_i = jnp.where(upd, i, best_i)
            best_j = jnp.where(upd, row_arg, best_j)
        else:
            row_max = jnp.max(h_inner, axis=1)
            best_j = jnp.where(
                row_max > h[:, 0], jnp.argmax(h_inner, axis=1).astype(jnp.int32), 0
            )
            h_keep = jnp.where((max_read_pos == i)[:, None], h, h_keep)
        out_row = (ptr_row, best_j) if not local else ptr_row
        return (h, f_row, best_score, best_i, best_j, h_keep), out_row

    init = (
        jnp.zeros((b, n + 1), jnp.int32),
        jnp.full((b, n), NEG_INF, jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b, n + 1), jnp.int32),
    )
    xs = (jnp.arange(m, dtype=jnp.int32), reads.T)
    (h_last, _, best_score, best_i, best_j, h_keep), ys = jax.lax.scan(body, init, xs)

    if local:
        ptr = jnp.transpose(ys, (1, 0, 2))
        return ptr, best_i, best_j, best_score

    ptr_rows, row_args = ys
    ptr = jnp.transpose(ptr_rows, (1, 0, 2))
    any_f = jnp.any(ref_invalid, axis=1)
    first_f = jnp.argmax(ref_invalid, axis=1).astype(jnp.int32)
    max_ref_pos = jnp.where(any_f, first_f - 1, n - 1)
    gri = jnp.where(
        max_read_pos >= 0,
        jnp.take_along_axis(row_args.T, jnp.maximum(max_read_pos, 0)[:, None], axis=1)[:, 0],
        0,
    )
    start_ref = jnp.minimum(max_ref_pos, gri)
    score = jnp.where(
        max_read_pos >= 0,
        jnp.take_along_axis(
            h_keep, jnp.clip(start_ref, -1, n - 1)[:, None] + 1, axis=1
        )[:, 0],
        0,
    )
    return ptr, max_read_pos, start_ref, score


# ---------------------------------------------------------------------------
# Pointer fill -> host decode
# ---------------------------------------------------------------------------

#: pointer-plane bytes per device round of the dense align path
ALIGN_CHUNK_BYTES = 1 << 30


def fill_pointers(reads, refs, params: AlignmentParameters,
                  algorithm: Algorithm, tie: TieBreak):
    """Device pointer fill (linear or affine) -> (ptr (B, m, n) uint8,
    start_read (B,), start_ref (B,), score (B,))."""
    fill = align_affine_batch if params.affine else align_batch
    return fill(reads, refs, params, Algorithm(algorithm), tie)


def decode_pointers(ptr, reads, refs, start_r, start_f, scores,
                    params: AlignmentParameters, algorithm: Algorithm,
                    raw: bool = False, gapped: bool = True,
                    read_texts=None, ref_texts=None):
    """Host decode of one filled chunk: the native walker, or the Python
    walkers when the native library is unavailable (not for ``raw``).
    Device outputs may carry padding rows past ``reads``; they are cut
    here, on the host."""
    b = reads.shape[0]
    ptr, start_r, start_f, scores = (
        np.asarray(x)[:b] for x in (ptr, start_r, start_f, scores))
    try:
        from versalignlib_tpu.native import decode_batch_native

        return decode_batch_native(
            ptr, reads, refs, start_r, start_f, params, algorithm, scores,
            read_texts, ref_texts, affine=params.affine, raw=raw,
            gapped=gapped)
    except ImportError:
        if raw:
            raise  # the column store requires the native decoder
    decode = tb.decode_batch_affine if params.affine else tb.decode_batch
    return decode(ptr, reads, refs, start_r, start_f, params, algorithm,
                  scores, read_texts, ref_texts)


def align_pairs(reads, refs, params: AlignmentParameters,
                algorithm: Algorithm, tie: TieBreak = TieBreak.DIAG_UP_LEFT,
                raw: bool = False, gapped: bool = True,
                chunk_pairs: int | None = None, read_texts=None,
                ref_texts=None):
    """Full alignment of a (B, m) x (B, n) batch: the pointer plane is filled
    ``chunk_pairs`` pairs at a time (default: about ``ALIGN_CHUNK_BYTES`` of
    plane per round) and decoded on the host one chunk behind the device.

    ``raw=True`` returns an :class:`~versalignlib_tpu.types.AlignmentBatch`
    column store; ``gapped=False`` (raw only) skips the gapped strings.
    ``read_texts``/``ref_texts``: optional display strings for the gapped
    output (e.g. protein letters) in place of the DNA code table.
    """
    from versalignlib_tpu.types import AlignmentBatch

    algorithm = Algorithm(algorithm)
    reads = np.asarray(reads)
    refs = np.asarray(refs)
    b, m = reads.shape
    n = refs.shape[1]
    if chunk_pairs is None:
        chunk_pairs = max(1, ALIGN_CHUNK_BYTES // max(m * n, 1))
    results, pending = [], None
    for lo in range(0, b, chunk_pairs):
        sl = slice(lo, lo + chunk_pairs)
        dev = fill_pointers(jnp.asarray(reads[sl]), jnp.asarray(refs[sl]),
                            params, algorithm, tie)
        if pending is not None:
            results.append(decode_pointers(*pending))
        pending = (dev[0], reads[sl], refs[sl], *dev[1:], params, algorithm,
                   raw, gapped,
                   None if read_texts is None else read_texts[sl],
                   None if ref_texts is None else ref_texts[sl])
    if pending is not None:
        results.append(decode_pointers(*pending))
    if raw:
        return AlignmentBatch.concat(results)
    return [a for chunk in results for a in chunk]


# ---------------------------------------------------------------------------
# Backend adapter
# ---------------------------------------------------------------------------

class XLABackend:
    """Dispatcher-facing adapter around the jit kernels."""

    name = "xla"
    #: pairs per device round of the align path (None: sized by
    #: ``ALIGN_CHUNK_BYTES``)
    align_chunk: int | None = None

    def is_available(self) -> bool:
        return True

    def score_alignments(self, algorithm, reads, refs, params):
        out = score_batch(jnp.asarray(reads), jnp.asarray(refs), params, Algorithm(algorithm))
        return np.asarray(out, dtype=np.int32)

    def compute_alignments(self, algorithm, reads, refs, params, tie,
                           raw: bool = False, gapped: bool = True):
        return align_pairs(reads, refs, params, algorithm, tie, raw=raw,
                           gapped=gapped, chunk_pairs=self.align_chunk)
