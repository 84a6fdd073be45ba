"""Dense score kernel for NVIDIA GPUs: Pallas through Triton.

Design (inter-pair, the reference's SIMD idea, SSEKernel.cpp:269-318, with
one pair per GPU thread):

- pairs sit on the block's lanes: program ``p`` owns pairs
  ``[p*BP, (p+1)*BP)``; the codes are transposed to (length, B) so every
  row/column load of a block is one coalesced (BP,) vector;
- the DP runs the reference's row-major cell order (DefaultKernel.cpp:93-128)
  sequentially per pair: a strip of ``R`` read rows advances down each ref
  column in registers (row ``r`` takes row ``r-1``'s fresh value as its
  "up"), so the boundary H row between strips is loaded and stored once per
  ``R`` cells;
- that boundary row (and the Gotoh F row for affine gaps) lives in a
  global-memory buffer of shape (n+1, B) that the kernel returns and the
  wrapper drops; each block's slice is a few hundred KB and stays in L2;
- tail pairs pad with all-zero (invalid) sequences, which score 0 — the
  reference's tail-batch fill-up (SSEKernel.cpp:84-128).

Semantics are the numpy oracle's (ops/oracle.py, ops/gotoh.py) bit for bit;
tests run the kernel in Pallas interpret mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm

#: -inf stand-in safe against int32 adds
NEG_INF_I32 = -(2**30)

#: Launch shape, swept on an H100 at 512x512 (PERF.md, "Kernel
#: decisions"): strip rows and column unroll (longer strips win until the
#: unrolled strip body's compile time grows), and pairs per program — 64
#: once the batch gives every SM about two programs, else 32 (one warp per
#: 32 pairs either way).
STRIP_ROWS = 32
COL_UNROLL = 1
WIDE_BLOCK_MIN_PAIRS = 256 * 64


def block_pairs_for(b: int) -> int:
    """Pairs per program for a batch of ``b`` pairs."""
    return 64 if b >= WIDE_BLOCK_MIN_PAIRS else 32


def make_sub_fn(params: AlignmentParameters):
    """(row_prep, col_prep, sub_of) triple for in-kernel substitution scores.

    Default scoring: the reference's 6x6 table as arithmetic (alphabet.py):
    invalid codes map to distinct per-side sentinels (-2 read, -1 ref) so the
    equality never fires across validity; the ref side carries ``fbase``
    (mismatch if the ref base is valid, else 0) and the read side a
    full-width validity mask folded in with one AND.

    Generic S x S ``params.matrix``: each strip row's matrix row is packed
    once into W int32 words of biased fields (4 bits when the entry span is
    <= 15, else 8), so a cell pays W selects and one variable-shift field
    extract instead of a gather; when that is not cheaper, an (S-1)-select
    chain. Matrix row/col 0 are zero, so padding scores 0.
    """
    match = jnp.int32(params.score_match)
    mismatch = jnp.int32(params.score_mismatch)
    if params.matrix is None:
        def row_prep(rc):
            rv = (rc >= 1) & (rc <= 4)
            return (jnp.where(rv, rc, jnp.int32(-2)),
                    jnp.where(rv, jnp.int32(-1), jnp.int32(0)))

        def col_prep(ref_col):
            fv = (ref_col >= 1) & (ref_col <= 4)
            return (jnp.where(fv, ref_col, jnp.int32(-1)),
                    jnp.where(fv, mismatch, jnp.int32(0)))

        def sub_of(rctx, cctx):
            rc2, rmask = rctx
            fc2, fbase = cctx
            return jnp.where(rc2 == fc2, match, fbase) & rmask

        return row_prep, col_prep, sub_of

    M = params.matrix
    S = len(M)
    entries = [M[a][s] for a in range(S) for s in range(S)]
    lo, hi = min(entries), max(entries)
    fw = 4 if hi - lo <= 15 else 8
    W = -(-S // (32 // fw))
    if hi - lo <= 255 and W + 3 < S - 1:
        fpw = 32 // fw                       # fields per word
        fmask = (1 << fw) - 1
        bias = -lo

        def _word(a: int, w: int) -> int:
            v = 0
            for k in range(fpw):
                s_col = fpw * w + k
                f = (M[a][s_col] + bias) if s_col < S else bias
                v |= (f & fmask) << (fw * k)
            return v - (1 << 32) if v >= (1 << 31) else v

        all_bias = _word(0, 0)  # row 0 is all-zero (validated) = pure bias
        packed = [[_word(a, w) for w in range(W)] for a in range(S)]
        idx_shift = fpw.bit_length() - 1     # log2(fields per word)
        sh_shift = fw.bit_length() - 1       # log2(field bits)

        def row_prep(rc):
            words = []
            for w in range(W):
                acc = jnp.full_like(rc, all_bias)  # codes 0 / >= S: sub 0
                for a in range(1, S):
                    if packed[a][w] != all_bias:
                        acc = jnp.where(rc == a, jnp.int32(packed[a][w]), acc)
                words.append(acc)
            return words

        def col_prep(ref_col):
            masks = [(ref_col >> idx_shift) == w for w in range(W)]
            return masks, (ref_col & (fpw - 1)) << sh_shift

        def sub_of(words, cctx):
            masks, fshift = cctx
            word = jnp.full_like(fshift, all_bias)  # codes >= W*fpw: sub 0
            for w in range(W):
                word = jnp.where(masks[w], words[w], word)
            # Arithmetic shift then mask is exact even when the top field
            # sets the sign bit; fields are biased non-negative.
            return ((word >> fshift) & fmask) - bias

        return row_prep, col_prep, sub_of

    def row_prep(rc):
        rows = []
        for s_col in range(S):
            acc = jnp.zeros_like(rc)  # M[0][s] == 0; codes >= S fall through
            for a in range(1, S):
                if M[a][s_col] != 0:
                    acc = jnp.where(rc == a, jnp.int32(M[a][s_col]), acc)
            rows.append(acc)
        return rows

    def col_prep(ref_col):
        return [ref_col == s_col for s_col in range(1, S)]

    def sub_of(rows, masks):
        acc = rows[0]
        for s_col in range(1, S):
            acc = jnp.where(masks[s_col - 1], rows[s_col], acc)
        return acc

    return row_prep, col_prep, sub_of


def _score_kernel(reads_ref, refs_ref, out_ref, h_ref, f_ref, *, m, n, bp,
                  strip, unroll, params: AlignmentParameters, local: bool):
    """One block of ``bp`` pairs. reads (m, bp), refs (n, bp) int32 codes;
    h_ref (n+1, bp) boundary H row, f_ref (n, bp) boundary F row (affine;
    a (1, bp) placeholder otherwise); out (bp,) best scores."""
    gap_read = jnp.int32(params.score_gap_read)
    gap_ref = jnp.int32(params.score_gap_ref)
    open_read = jnp.int32(params.gap_open_read)
    open_ref = jnp.int32(params.gap_open_ref)
    affine = params.affine
    zero = jnp.zeros((bp,), jnp.int32)
    neg_inf = jnp.full((bp,), NEG_INF_I32, jnp.int32)
    row_prep, col_prep, sub_of = make_sub_fn(params)

    def init_h(j, c):
        h_ref[j, :] = zero
        return c

    jax.lax.fori_loop(0, n + 1, init_h, 0)
    if affine:
        def init_f(j, c):
            f_ref[j, :] = neg_inf
            return c

        jax.lax.fori_loop(0, n, init_f, 0)

    def strip_pass(i0, best, rows):
        """Rows i0..i0+rows-1 over every ref column."""
        rctxs = [row_prep(reads_ref[i0 + r, :]) for r in range(rows)]

        def column(j, carry):
            lefts, diags, evals, best = carry
            up = h_ref[j + 1, :]
            f_up = f_ref[j, :] if affine else None
            cctx = col_prep(refs_ref[j, :])
            new_lefts, new_diags, new_evals = [], [], []
            for r in range(rows):
                s = sub_of(rctxs[r], cctx)
                if affine:
                    # max(a+c, b+c) == max(a, b)+c: one add saved per arm.
                    f_val = jnp.maximum(up + open_ref, f_up) + gap_ref
                    e_val = jnp.maximum(lefts[r] + open_read,
                                        evals[r]) + gap_read
                    e_in = jnp.maximum(e_val, 0) if local else e_val
                    cur = jnp.maximum(jnp.maximum(diags[r] + s, f_val), e_in)
                    new_evals.append(e_val)
                    f_up = f_val
                else:
                    l_in = lefts[r] + gap_read
                    if local:
                        l_in = jnp.maximum(l_in, 0)
                    cur = jnp.maximum(jnp.maximum(diags[r] + s, up + gap_ref),
                                      l_in)
                if local:
                    best = jnp.maximum(best, cur)
                new_diags.append(up)
                new_lefts.append(cur)
                up = cur
            h_ref[j + 1, :] = up
            if affine:
                f_ref[j, :] = f_up
            return (new_lefts, new_diags,
                    new_evals if affine else evals, best)

        def columns(c, carry):
            for u in range(unroll):
                carry = column(c * unroll + u, carry)
            return carry

        carry = ([zero] * rows, [zero] * rows, [neg_inf] * rows, best)
        carry = jax.lax.fori_loop(0, n // unroll, columns, carry)
        for j in range((n // unroll) * unroll, n):
            carry = column(j, carry)
        lefts, _, _, best = carry
        if not local:
            # NW overlap: max over the LAST column of every row
            # (DefaultKernel.cpp:177); lefts[r] holds H[i0+r][n].
            for r in range(rows):
                best = jnp.maximum(best, lefts[r])
        return best

    best = jax.lax.fori_loop(
        0, m // strip, lambda s, b: strip_pass(s * strip, b, strip), zero)
    if m % strip:
        best = strip_pass((m // strip) * strip, best, m % strip)
    if not local:
        # ... and over the entire final row (DefaultKernel.cpp:189-191),
        # clamped >= 0 because the reference's globalMax starts at 0.
        best = jax.lax.fori_loop(
            0, n + 1, lambda j, b: jnp.maximum(b, h_ref[j, :]), best)
        best = jnp.maximum(best, 0)
    out_ref[:] = best


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "interpret", "block_pairs",
                     "strip", "unroll"),
)
def score_batch_triton(reads, refs, params: AlignmentParameters,
                       algorithm: Algorithm, interpret: bool = False,
                       block_pairs: int | None = None,
                       strip: int = STRIP_ROWS, unroll: int = COL_UNROLL):
    """(B, m), (B, n) uint8/int32 codes -> (B,) int32 scores.

    ``block_pairs`` (pairs per program, a multiple of 32 on the card)
    defaults to :func:`block_pairs_for` the batch."""
    b, m = reads.shape
    n = refs.shape[1]
    if b == 0 or m == 0 or n == 0:
        return jnp.zeros((b,), jnp.int32)
    block_pairs = block_pairs or block_pairs_for(b)
    g = -(-b // block_pairs)
    b_pad = g * block_pairs

    def lanes(x):  # (B, L) -> (L, B_pad) int32, pairs on the minor axis
        x = jnp.pad(x.astype(jnp.int32), ((0, b_pad - b), (0, 0)))
        return x.T

    kernel = functools.partial(
        _score_kernel, m=m, n=n, bp=block_pairs, strip=min(strip, m),
        unroll=max(1, min(unroll, n)), params=params,
        local=Algorithm(algorithm) == Algorithm.SMITH_WATERMAN)
    f_rows = n if params.affine else 1
    out, _, _ = pl.pallas_call(
        kernel,
        grid=(g,),
        in_specs=[
            pl.BlockSpec((m, block_pairs), lambda i: (0, i)),
            pl.BlockSpec((n, block_pairs), lambda i: (0, i)),
        ],
        out_specs=[
            pl.BlockSpec((block_pairs,), lambda i: (i,)),
            pl.BlockSpec((n + 1, block_pairs), lambda i: (0, i)),
            pl.BlockSpec((f_rows, block_pairs), lambda i: (0, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b_pad,), jnp.int32),
            jax.ShapeDtypeStruct((n + 1, b_pad), jnp.int32),
            jax.ShapeDtypeStruct((f_rows, b_pad), jnp.int32),
        ],
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, block_pairs // 32), num_stages=1),
        interpret=interpret,
        name="dense_score",
    )(lanes(reads), lanes(refs))
    return out[:b]
