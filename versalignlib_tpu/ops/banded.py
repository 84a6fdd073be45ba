"""Banded DP for long pairs (10-100kbp): numpy oracles and an XLA band scan.

The reference has no banding and no intra-pair capacity strategy beyond
spilling the pointer matrix to global memory (SURVEY.md §5 "long-context";
alignment_kernels.cl:10-12) — sequence length is bounded by O(m*n) memory
and int16 scores. This module is the greenfield long-pair path:

- a diagonal band of static width W follows the main diagonal with per-row
  offset ``o(i) = clamp(i*n//m - W/2, 0, n-W)``; cells outside the band are
  -inf (standard banded alignment — an approximation by construction);
- the device path is a ``lax.scan`` over read rows that carries one (B, W)
  band row, shifts it by each row's offset step, and resolves the
  within-row left dependency with the same exact prefix-max identity as
  the dense scan (ops/xla.py ``_row_solve``);
- traceback emits a (B, m, W) uint8 band-relative pointer plane that the
  native walker (``native.decode_banded_native``) decodes on the host.

Scores use int32 (the reference's int16 would overflow beyond ~16kbp gaps).
Exactness vs the numpy banded oracles is gated by tests/test_banded.py,
including band == full-matrix equivalence when W covers the whole ref.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from versalignlib_tpu.alphabet import substitution_scores
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm

#: -inf stand-in safe against int32 adds
NEG_INF_I32 = -(2**30)


def band_offsets(m_pad: int, m_real: int, n: int, band: int) -> np.ndarray:
    """Per-row band start columns (0-based ref position of band cell 0).

    Single source of truth shared by the oracles and the band scan.
    """
    i = np.arange(m_pad, dtype=np.int64)
    o = (i * n) // max(m_real, 1) - band // 2
    return np.clip(o, 0, max(n - band, 0)).astype(np.int32)


# ---------------------------------------------------------------------------
# NumPy banded oracle (semantics definition)
# ---------------------------------------------------------------------------

def banded_score_oracle(read, ref, p: AlignmentParameters, band: int,
                        algorithm: Algorithm,
                        offsets: np.ndarray | None = None) -> int:
    """Reference banded score: full-matrix DP with -inf outside the band.

    Row 0 and (for band windows touching it) column 0 are 0 — the same free
    boundaries as the dense kernels, restricted to the band.
    """
    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    m, n = read.size, ref.size
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    if offsets is None:
        offsets = band_offsets(m, m, n, band)
    band = min(band, n)
    NEG = np.int64(NEG_INF_I32)
    h = np.zeros((m + 1, n + 1), dtype=np.int64)
    f = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    best = np.int64(0)
    last_col = np.int64(NEG)
    for i in range(1, m + 1):
        o = int(offsets[i - 1])
        prev = h[i - 1]
        f_prev = f[i - 1]
        row = np.full(n + 1, NEG, dtype=np.int64)
        f_row = np.full(n + 1, NEG, dtype=np.int64)
        row[0] = 0
        lo, hi = o + 1, min(o + band, n)  # H columns in band
        sub = substitution_scores(
            read[i - 1], ref[lo - 1 : hi], p.score_match, p.score_mismatch,
            p.matrix,
        ).astype(np.int64)
        e = NEG
        for j in range(lo, hi + 1):
            diag = prev[j - 1] + sub[j - lo]
            if p.affine:
                f_row[j] = max(prev[j] + p.gap_open_ref + p.score_gap_ref,
                               f_prev[j] + p.score_gap_ref, NEG)
                e = max(row[j - 1] + p.gap_open_read + p.score_gap_read,
                        e + p.score_gap_read, NEG)
                cur = max(diag, f_row[j], e)
            else:
                up = prev[j] + p.score_gap_ref
                left = row[j - 1] + p.score_gap_read
                cur = max(diag, up, left)
            cur = max(cur, NEG)
            if local:
                cur = max(cur, 0)
                best = max(best, cur)
            row[j] = cur
        h[i] = row
        f[i] = f_row
        if not local and hi == n:
            last_col = max(last_col, row[n])
    if local:
        return int(best)
    final = max(int(h[m].max()), int(last_col), 0)
    return final


def last_valid_pos(codes: np.ndarray, valid=None) -> int:
    """max_*_pos for one sequence: index before the first invalid code, else
    len-1 (DefaultKernel.cpp:308,348 semantics). ``valid``: elementwise
    validity predicate (default = canonical flavor, any nonzero code)."""
    codes = np.asarray(codes)
    inv = np.flatnonzero(codes == 0 if valid is None else ~valid(codes))
    return int(inv[0]) - 1 if inv.size else codes.size - 1


def banded_align_oracle(read, ref, p: AlignmentParameters, band: int,
                        algorithm: Algorithm,
                        offsets: np.ndarray | None = None,
                        read_text: str | None = None,
                        ref_text: str | None = None,
                        tie=None):
    """Reference banded ALIGNMENT: full-matrix DP with -inf outside the band,
    canonical pointer flavor, explicit end-cell rules. This is the semantics
    definition the XLA band scan's traceback is tested against
    (greenfield — the reference has no banding; its only long-pair strategy
    is spilling the pointer matrix to global memory,
    /root/reference/src/Kernels/OpenCL/opencl_c/alignment_kernels.cl:10-12).

    Boundaries are the banded-score oracle's (row 0 / col 0 free). Pointer
    model: canonical flavor (``tie`` None/DIAG_UP_LEFT) linear DIAG > UP >
    LEFT with SW zero-force; affine 4-bit ``hptr | e_ext<<2 | f_ext<<3``
    with extend-beats-open ties (ops/gotoh.py). SSE flavor
    (``TieBreak.DIAG_LEFT_UP``): validity-gated DIAG > LEFT > UP (affine:
    DIAG > LEFT(E) > UP(F)), no SW zero-force, and validity-flavored NW
    end-cell tracking — the banded extension of the dense SSE rules
    (oracle._pointers / gotoh._affine_pointers).

    End cells:
      - SW: first in-band cell (row-major) attaining the global clamped max;
        (0, 0) when the max is 0 (the reference's argmax-initial cell).
      - NW (overlap): row = last valid read row ``mrp`` (code != 0 flavor);
        column = leftmost argmax over that row's band cells at valid ref
        positions (<= max_ref_pos) — the banded analogue of the dense
        ``(max_read_pos, min(max_ref_pos, globalRowMaxIndex))`` rule
        (DefaultKernel.cpp:285-388) that keeps tracebacks off padding
        rows/columns. Empty intersection (or mrp < 0) -> empty alignment.

    The walk stops at START pointers, at the free row-0/col-0 boundaries,
    and when stepping outside the band.
    """
    from versalignlib_tpu.alphabet import make_validity
    from versalignlib_tpu.types import TieBreak

    read = np.asarray(read, dtype=np.int32)
    ref = np.asarray(ref, dtype=np.int32)
    m, n = read.size, ref.size
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    canonical = tie is None or TieBreak(tie) == TieBreak.DIAG_UP_LEFT
    vfn = make_validity(p.matrix)
    rvalid = vfn(read)
    fvalid = vfn(ref)
    if offsets is None:
        offsets = band_offsets(m, m, n, band)
    band = min(band, n)
    affine = p.affine
    NEG = np.int64(NEG_INF_I32)
    D, U, L, S = 3, 1, 2, 0  # Trace.DIAG/UP/LEFT/START

    h = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    h[0, :] = 0
    h[:, 0] = 0
    f = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    ptr = np.zeros((m + 1, n + 1), dtype=np.uint8)
    for i in range(1, m + 1):
        o = int(offsets[i - 1])
        lo, hi = o + 1, min(o + band, n)
        sub_row = substitution_scores(
            read[i - 1], ref[lo - 1 : hi], p.score_match, p.score_mismatch,
            p.matrix,
        ).astype(np.int64)
        e = NEG
        for j in range(lo, hi + 1):
            diag_v = h[i - 1, j - 1] + sub_row[j - lo]
            if affine:
                f_prev = f[i - 1, j]
                f_v = max(h[i - 1, j] + p.gap_open_ref + p.score_gap_ref,
                          f_prev + p.score_gap_ref, NEG)
                e_prev = e
                e = max(h[i, j - 1] + p.gap_open_read + p.score_gap_read,
                        e_prev + p.score_gap_read, NEG)
                cur = max(diag_v, f_v, e)
            else:
                up_v = h[i - 1, j] + p.score_gap_ref
                left_v = h[i, j - 1] + p.score_gap_read
                cur = max(diag_v, up_v, left_v)
            cur = max(cur, NEG)
            if local:
                cur = max(cur, 0)
            cell_valid = bool(rvalid[i - 1]) and bool(fvalid[j - 1])
            if affine:
                if canonical:
                    hp = D if cur == diag_v else (U if cur == f_v else
                                                  (L if cur == e else S))
                    if local and cur == 0:
                        hp = S
                else:
                    hp = (D if (cur == diag_v and cell_valid) else
                          (L if cur == e else (U if cur == f_v else S)))
                e_ext = 1 if e == e_prev + p.score_gap_read else 0
                f_ext = 1 if f_v == f_prev + p.score_gap_ref else 0
                ptr[i, j] = hp | (e_ext << 2) | (f_ext << 3)
                f[i, j] = f_v
            else:
                if canonical:
                    hp = D if cur == diag_v else (U if cur == up_v else
                                                  (L if cur == left_v else S))
                    if local and cur == 0:
                        hp = S
                else:
                    hp = (D if (cur == diag_v and cell_valid) else
                          (L if cur == left_v else (U if cur == up_v else S)))
                ptr[i, j] = hp
            h[i, j] = cur

    # In-band mask over inner cells (for end-cell picks and walk bounds).
    jj = np.arange(1, n + 1)[None, :]
    oo = np.asarray(offsets[:m], dtype=np.int64)[:, None]
    in_band = (jj >= oo + 1) & (jj <= np.minimum(oo + band, n))

    if local:
        inner = np.where(in_band, h[1:, 1:], -1)
        best = int(inner.max(initial=0))
        if best <= 0:
            start_r, start_f, score = 0, 0, 0
        else:
            flat = int(np.argmax(inner))
            start_r, start_f = divmod(flat, n)
            score = best
    else:
        bvalid = None if canonical else vfn
        mrp = last_valid_pos(read, bvalid)
        max_ref_pos = last_valid_pos(ref, bvalid)
        if mrp < 0:
            start_r = start_f = -1
            score = 0
        else:
            o = int(offsets[mrp])
            hi = min(o + band, n, max_ref_pos + 1)
            if hi <= o:
                start_r = start_f = -1
                score = 0
            else:
                vals = h[mrp + 1, o + 1 : hi + 1]
                arg = int(np.argmax(vals))
                start_r, start_f = mrp, o + arg
                score = int(vals[arg])

    return _banded_oracle_walk(ptr, in_band, read, ref, start_r, start_f,
                               score, affine, read_text, ref_text)


def _banded_oracle_walk(ptr, in_band, read, ref, start_r, start_f, score,
                        affine, read_text=None, ref_text=None):
    """Shared walker over the oracle's dense banded pointer matrix."""
    from versalignlib_tpu.ops.traceback import _text_from_codes
    from versalignlib_tpu.types import Alignment, Trace, cigar_from_gapped

    m, n = read.shape[0], ref.shape[0]
    if read_text is None:
        read_text = _text_from_codes(read)
    if ref_text is None:
        ref_text = _text_from_codes(ref)
    rp, fp = int(start_r), int(start_f)
    rg, fg = [], []
    state = 0  # 0=H, 1=F(up), 2=E(left) — affine only
    steps = 0
    while steps <= m + n and rp >= 0 and fp >= 0:
        if not in_band[rp, fp]:
            break
        code = int(ptr[rp + 1, fp + 1])
        hp = code & 3
        if not affine:
            if hp == Trace.START:
                break
            if hp == Trace.UP:
                rg.append(read_text[rp]); fg.append("-"); rp -= 1
            elif hp == Trace.LEFT:
                rg.append("-"); fg.append(ref_text[fp]); fp -= 1
            else:
                rg.append(read_text[rp]); fg.append(ref_text[fp])
                rp -= 1; fp -= 1
            steps += 1
            continue
        if state == 0:
            if hp == Trace.START:
                break
            if hp == Trace.DIAG:
                rg.append(read_text[rp]); fg.append(ref_text[fp])
                rp -= 1; fp -= 1
                steps += 1
            elif hp == Trace.UP:
                state = 1
            else:
                state = 2
        elif state == 1:
            rg.append(read_text[rp]); fg.append("-")
            rp -= 1
            if not ((code >> 3) & 1):
                state = 0
            steps += 1
        else:
            rg.append("-"); fg.append(ref_text[fp])
            fp -= 1
            if not ((code >> 2) & 1):
                state = 0
            steps += 1
    read_g = "".join(reversed(rg))
    ref_g = "".join(reversed(fg))
    aln_length = m + n
    return Alignment(
        read=read_g, ref=ref_g, score=int(score),
        cigar=cigar_from_gapped(read_g, ref_g),
        read_start=rp + 1, read_end=int(start_r) + 1,
        ref_start=fp + 1, ref_end=int(start_f) + 1,
        buffer_start=aln_length - 1 - len(rg), buffer_end=aln_length - 1,
    )


# ---------------------------------------------------------------------------
# XLA band scan (score and traceback)
# ---------------------------------------------------------------------------
#
# Row i's band cell k is H column o_i + 1 + k. With d = o_i - o_{i-1} >= 0,
# its "up" source is previous-row cell k + d and its "diag" source cell
# k + d - 1; sources past the previous band are -inf, and the cell left of
# a band is column 0 (free, 0) only when the band starts at offset 0. Row 0
# is the free boundary (all 0). Extending the previous row by one left cell
# and ``d_max`` -inf cells turns both sources into one dynamic slice.

def _band_rows(reads, refs, offsets, params: AlignmentParameters, band: int,
               d_max: int, local: bool, canonical: bool, emit: bool,
               mrp=None):
    """Shared band scan. Returns (per-row outputs, final carry)."""
    from versalignlib_tpu.alphabet import make_validity
    from versalignlib_tpu.ops.xla import _row_solve, _row_solve_open, _sub_row

    reads = reads.astype(jnp.int32)
    refs = refs.astype(jnp.int32)
    b, m = reads.shape
    w = band
    neg = jnp.int32(NEG_INF_I32)
    affine = params.affine
    gap_read = jnp.int32(params.score_gap_read)
    gap_ref = jnp.int32(params.score_gap_ref)
    open_read = jnp.int32(params.gap_open_read)
    open_ref = jnp.int32(params.gap_open_ref)
    vfn = make_validity(params.matrix)
    d_s, u_s, l_s, s_s = (jnp.uint8(3), jnp.uint8(1), jnp.uint8(2),
                          jnp.uint8(0))  # Trace.DIAG/UP/LEFT/START
    neg_tail = jnp.full((b, d_max), neg, jnp.int32)
    neg_col = jnp.full((b, 1), neg, jnp.int32)

    def body(carry, x):
        i, o, read_col = x
        prev, f_prev, prev_o, best, best_i, best_j, keep = carry
        first = i == 0
        d = o - prev_o
        lv = jnp.where(first | (prev_o == 0), 0, neg)
        fill = jnp.where(first, 0, neg)
        ext = jnp.concatenate(
            [jnp.broadcast_to(lv, (b, 1)), prev,
             jnp.broadcast_to(fill, (b, d_max))], axis=1)
        src = jax.lax.dynamic_slice(ext, (0, d), (b, w + 1))
        diag_src, up_src = src[:, :w], src[:, 1:]
        ref_band = jax.lax.dynamic_slice(refs, (0, o), (b, w))
        sub = _sub_row(read_col[:, None], ref_band, params.score_match,
                       params.score_mismatch, params.matrix)
        diag_v = diag_src + sub
        lb = jnp.broadcast_to(jnp.where(o == 0, 0, neg), (b, 1))
        if affine:
            f_ext_src = jnp.concatenate([neg_col, f_prev, neg_tail], axis=1)
            f_up = jax.lax.dynamic_slice(f_ext_src, (0, d + 1), (b, w))
            f_v = jnp.maximum(jnp.maximum(up_src + open_ref, f_up) + gap_ref,
                              neg)
            t = jnp.maximum(diag_v, f_v)
        else:
            up_v = up_src + gap_ref
            t = jnp.maximum(jnp.maximum(diag_v, up_v), neg)
        if local:
            t = jnp.maximum(t, 0)
        t_full = jnp.concatenate([lb, t], axis=1)
        if affine:
            e = jnp.maximum(_row_solve_open(t_full, open_read, gap_read), neg)
            cur = jnp.maximum(t, e)
        else:
            h = _row_solve(t_full, gap_read)
            cur = h[:, 1:]
            left_v = h[:, :-1] + gap_read

        ptr = None
        if emit:
            if canonical:
                second, third = ((f_v, e) if affine else (up_v, left_v))
                hp = jnp.where(cur == diag_v, d_s,
                               jnp.where(cur == second, u_s,
                                         jnp.where(cur == third, l_s, s_s)))
                if local:
                    hp = jnp.where(cur == 0, s_s, hp)
            else:
                second, third = ((e, f_v) if affine else (left_v, up_v))
                valid = vfn(read_col[:, None]) & vfn(ref_band)
                hp = jnp.where((cur == diag_v) & valid, d_s,
                               jnp.where(cur == second, l_s,
                                         jnp.where(cur == third, u_s, s_s)))
            if affine:
                e_prev = jnp.concatenate([neg_col, e[:, :-1]], axis=1)
                e_ext = (e == e_prev + gap_read).astype(jnp.uint8)
                f_ext = (f_v == f_up + gap_ref).astype(jnp.uint8)
                hp = hp | (e_ext << 2) | (f_ext << 3)
            ptr = hp

        row_max = jnp.max(cur, axis=1)
        if local:
            row_arg = jnp.argmax(cur, axis=1).astype(jnp.int32)
            upd = row_max > best
            best = jnp.where(upd, row_max, best)
            best_i = jnp.where(upd, i, best_i)
            best_j = jnp.where(upd, o + row_arg, best_j)
        elif emit:
            keep = jnp.where((mrp == i)[:, None], cur, keep)
        else:
            # NW overlap: the last column n (band cell w-1 when the band
            # touches it) of every row, and the final row below.
            best = jnp.where(o + w == refs.shape[1],
                             jnp.maximum(best, cur[:, w - 1]), best)
        f_next = f_v if affine else f_prev
        out = (cur, f_next, o, best, best_i, best_j, keep)
        return out, (ptr if emit else None)

    zeros_b = jnp.zeros((b,), jnp.int32)
    init = (
        jnp.zeros((b, w), jnp.int32),
        jnp.full((b, w), neg, jnp.int32),
        offsets[0],
        zeros_b if local else jnp.full((b,), neg, jnp.int32),
        zeros_b, zeros_b,
        jnp.full((b, w), neg, jnp.int32),
    )
    xs = (jnp.arange(m, dtype=jnp.int32), offsets, reads.T)
    return jax.lax.scan(body, init, xs)


@functools.partial(jax.jit,
                   static_argnames=("params", "algorithm", "band", "d_max"))
def banded_score_device(reads, refs, offsets, params: AlignmentParameters,
                        algorithm: Algorithm, band: int, d_max: int):
    """(B, m), (B, n) codes + (m,) band offsets -> (B,) int32 scores."""
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    carry, _ = _band_rows(reads, refs, offsets, params, band, d_max, local,
                          canonical=True, emit=False)
    last, best = carry[0], carry[3]
    if local:
        return best
    return jnp.maximum(jnp.maximum(best, jnp.max(last, axis=1)), 0)


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "band", "d_max", "canonical"))
def banded_align_device(reads, refs, offsets, mrp, max_ref_pos,
                        params: AlignmentParameters, algorithm: Algorithm,
                        band: int, d_max: int, canonical: bool = True):
    """Band pointer fill: returns (ptr (B, m, W) uint8 band-relative codes,
    start_read (B,), start_ref (B,), score (B,)) — the end-cell rules of
    ``banded_align_oracle`` (-1/-1/0 for an empty NW alignment)."""
    local = Algorithm(algorithm) == Algorithm.SMITH_WATERMAN
    carry, ptr = _band_rows(reads, refs, offsets, params, band, d_max, local,
                            canonical, emit=True, mrp=mrp)
    ptr = jnp.transpose(ptr, (1, 0, 2))
    if local:
        return ptr, carry[4], carry[5], carry[3]
    keep = carry[6]
    o = offsets[jnp.maximum(mrp, 0)]
    limit = max_ref_pos + 1 - o          # band cells at valid ref positions
    k = jnp.arange(band, dtype=jnp.int32)[None, :]
    vals = jnp.where(k < limit[:, None], keep, jnp.iinfo(jnp.int32).min)
    arg = jnp.argmax(vals, axis=1).astype(jnp.int32)
    empty = (mrp < 0) | (limit <= 0)
    start_r = jnp.where(empty, -1, mrp)
    start_f = jnp.where(empty, -1, o + arg)
    score = jnp.where(empty, 0,
                      jnp.take_along_axis(vals, arg[:, None], axis=1)[:, 0])
    return ptr, start_r, start_f, score


def _band_setup(m: int, n: int, band: int):
    band = min(band, n)
    offsets = band_offsets(m, m, n, band)
    d_max = max(int(np.diff(offsets).max(initial=1)), 1)
    return band, offsets, d_max


def banded_score_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    band: int = 512,
) -> np.ndarray:
    """Banded batch scoring: (B, m) x (B, n) -> (B,) int32 (``band`` is
    clamped to the ref length)."""
    b, m = reads.shape
    n = refs.shape[1]
    if b == 0 or m == 0 or n == 0:
        return np.zeros(b, dtype=np.int32)
    band, offsets, d_max = _band_setup(m, n, band)
    out = banded_score_device(jnp.asarray(reads), jnp.asarray(refs),
                              jnp.asarray(offsets), params,
                              Algorithm(algorithm), band, d_max)
    return np.asarray(out, dtype=np.int32)


#: pointer-plane bytes per device round of the banded align path
BANDED_CHUNK_BYTES = 1 << 30


def banded_align_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    band: int = 512,
    raw: bool = False,
    chunk_pairs: int | None = None,
    tie=None,
):
    """Banded full alignment: XLA band scan + host band walk.

    Semantics: ``banded_align_oracle`` (both tie flavors, linear and affine
    gaps). The (B, m, W) uint8 pointer plane bounds the batch, so pairs go
    to the device ``chunk_pairs`` at a time (default: about
    ``BANDED_CHUNK_BYTES`` of plane per round), one chunk ahead of the host
    decode.
    """
    from versalignlib_tpu.ops.traceback import last_valid_positions
    from versalignlib_tpu.types import AlignmentBatch, TieBreak

    algorithm = Algorithm(algorithm)
    reads = np.asarray(reads)
    refs = np.asarray(refs)
    b, m = reads.shape
    n = refs.shape[1]
    if m == 0 or n == 0:
        from versalignlib_tpu.ops import traceback as tb

        return [
            tb.decode_one(np.zeros((1, 1), np.uint8), reads[i], refs[i],
                          -1, -1, params, algorithm, 0)
            for i in range(b)
        ]
    band, offsets, d_max = _band_setup(m, n, band)
    tie_v = TieBreak.DIAG_UP_LEFT if tie is None else TieBreak(tie)
    canonical = tie_v == TieBreak.DIAG_UP_LEFT
    mrp = last_valid_positions(reads, tie_v, params.matrix)
    max_ref_pos = last_valid_positions(refs, tie_v, params.matrix)
    if chunk_pairs is None:
        chunk_pairs = max(1, BANDED_CHUNK_BYTES // (m * band))
    offsets_dev = jnp.asarray(offsets)

    def dispatch(lo):
        sl = slice(lo, lo + chunk_pairs)
        return lo, banded_align_device(
            jnp.asarray(reads[sl]), jnp.asarray(refs[sl]), offsets_dev,
            jnp.asarray(mrp[sl]), jnp.asarray(max_ref_pos[sl]), params,
            algorithm, band, d_max, canonical)

    def decode(lo, dev):
        sl = slice(lo, lo + chunk_pairs)
        ptr, start_r, start_f, score = (np.asarray(x) for x in dev)
        try:
            from versalignlib_tpu.native import decode_banded_native

            return decode_banded_native(
                ptr, band, offsets, reads[sl], refs[sl], start_r, start_f,
                params, algorithm, score, raw=raw)
        except ImportError:
            if raw:
                raise  # raw mode requires the native decoder
            return [
                _banded_decode_one(ptr[k], reads[sl][k], refs[sl][k], offsets,
                                   band, int(start_r[k]), int(start_f[k]),
                                   int(score[k]), params)
                for k in range(ptr.shape[0])
            ]

    results, pending = [], None
    for lo in range(0, b, chunk_pairs):
        nxt = dispatch(lo)
        if pending is not None:
            results.append(decode(*pending))
        pending = nxt
    if pending is not None:
        results.append(decode(*pending))
    if raw:
        return AlignmentBatch.concat(results)
    return [a for chunk in results for a in chunk]


def _banded_decode_one(ptr, read, ref, offsets, band, start_i, start_j,
                       score, params):
    """Host walk over one pair's (m, W) band-relative pointer plane (the
    Python fallback; the native decoder implements the same walk in C++).
    Linear codes are 2-bit, affine 4-bit (hptr | e_ext<<2 | f_ext<<3)."""
    m = read.shape[0]
    rows = np.arange(m)[:, None]
    cols = offsets[:m, None] + np.arange(band)[None, :]
    in_band = np.zeros((m, ref.shape[0]), dtype=bool)
    in_band[rows, cols] = True
    dense = np.zeros((m + 1, ref.shape[0] + 1), dtype=np.uint8)
    dense[rows + 1, cols + 1] = ptr
    return _banded_oracle_walk(dense, in_band, read, ref, start_i, start_j,
                               score, params.affine)
