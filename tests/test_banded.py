"""Banded long-pair scoring vs banded oracle + dense equivalence."""

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu.ops import oracle
from versalignlib_tpu.ops.banded import band_offsets, banded_score_batch, banded_score_oracle
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm


def _oracle_batch(reads, refs, p, band, algorithm):
    m = reads.shape[1]
    n = refs.shape[1]
    offs = band_offsets(m, m, n, band)
    return np.array(
        [banded_score_oracle(r, f, p, band, algorithm, offs)
         for r, f in zip(reads, refs)],
        dtype=np.int32,
    )


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("shape,band", [
    ((6, 40, 56), 16),
    ((5, 64, 32), 24),   # n < m: band clamps to left region
    ((4, 30, 90), 16),   # n >> m: steep band steps (d > 1)
])
def test_banded_matches_oracle(rng, default_params, algorithm, shape, band):
    b, m, n = shape
    reads = random_codes(rng, b, m, padded=True, n_prob=0.05)
    refs = random_codes(rng, b, n, padded=True, n_prob=0.05)
    got = banded_score_batch(reads, refs, default_params, algorithm,
                             band=band)
    want = _oracle_batch(reads, refs, default_params, min(band, n), algorithm)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
def test_full_band_equals_dense(rng, default_params, algorithm):
    reads = random_codes(rng, 8, 24, padded=True)
    refs = random_codes(rng, 8, 24, padded=True)
    got = banded_score_batch(reads, refs, default_params, algorithm,
                             band=24)
    want = oracle.score_alignments(algorithm, reads, refs, default_params)
    np.testing.assert_array_equal(got, want)


def test_wide_band_finds_distant_hit(default_params):
    # A hit far off-diagonal is invisible to a narrow band but found by a
    # wide one — the expected approximation tradeoff.
    from versalignlib_tpu.alphabet import pad_and_encode

    read = "ACGTACGTAC" + "T" * 50
    ref = "G" * 50 + "ACGTACGTAC"
    reads = pad_and_encode([read])
    refs = pad_and_encode([ref])
    narrow = banded_score_batch(reads, refs, default_params,
                                Algorithm.SMITH_WATERMAN, band=8)
    wide = banded_score_batch(reads, refs, default_params,
                              Algorithm.SMITH_WATERMAN, band=60)
    assert wide[0] == 20
    assert narrow[0] < wide[0]

# ---------------------------------------------------------------------------
# Banded alignment (traceback) vs the banded align oracle
# ---------------------------------------------------------------------------

def _align_oracle_batch(reads, refs, p, band, algorithm):
    from versalignlib_tpu.ops.banded import banded_align_oracle

    m, n = reads.shape[1], refs.shape[1]
    offs = band_offsets(m, m, n, min(band, n))
    return [banded_align_oracle(r, f, p, min(band, n), algorithm, offs)
            for r, f in zip(reads, refs)]


AFFINE_PARAMS = AlignmentParameters(
    score_match=2, score_mismatch=-1, score_gap_read=-1, score_gap_ref=-1,
    gap_open_read=-4, gap_open_ref=-4)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("shape,band", [
    ((6, 40, 56), 16),
    ((5, 64, 32), 24),   # n < m: band clamps left
    ((4, 30, 90), 16),   # steep band steps (d > 1)
    ((5, 30, 36), 12),
    ((4, 10, 12), 1),    # one-cell band: in-band cells can be unreachable
])
def test_banded_align_matches_oracle(rng, default_params, algorithm, affine,
                                     shape, band):
    from versalignlib_tpu.ops.banded import banded_align_batch

    p = AFFINE_PARAMS if affine else default_params
    b, m, n = shape
    reads = random_codes(rng, b, m, padded=True, n_prob=0.05)
    refs = random_codes(rng, b, n, padded=True, n_prob=0.05)
    got = banded_align_batch(reads, refs, p, algorithm, band=band)
    want = _align_oracle_batch(reads, refs, p, band, algorithm)
    for g, w in zip(got, want):
        assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)
        assert (g.read_start, g.read_end, g.ref_start, g.ref_end) == \
            (w.read_start, w.read_end, w.ref_start, w.ref_end)
        # Padding rows must never leak into outputs (round-1 defect).
        assert "\0" not in g.read and "\0" not in g.ref
        assert g.read_end <= m


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
def test_banded_align_sse_flavor_matches_oracle(rng, default_params,
                                                algorithm, affine):
    """SSE tie flavor on the banded path (validity-gated DIAG > LEFT > UP,
    flavored NW boundaries): band scan bit-equal to the flavored oracle."""
    from versalignlib_tpu.ops.banded import banded_align_batch, banded_align_oracle
    from versalignlib_tpu.types import TieBreak

    p = AFFINE_PARAMS if affine else default_params
    tie = TieBreak.DIAG_LEFT_UP
    b, m, n, band = 6, 30, 36, 12
    reads = random_codes(rng, b, m, padded=True, n_prob=0.1)
    refs = random_codes(rng, b, n, padded=True, n_prob=0.1)
    got = banded_align_batch(reads, refs, p, algorithm, band=band, tie=tie)
    offs = band_offsets(m, m, n, band)
    want = [banded_align_oracle(r, f, p, band, algorithm, offs, tie=tie)
            for r, f in zip(reads, refs)]
    for g, w in zip(got, want):
        assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)
        assert "\0" not in g.read and "\0" not in g.ref


def test_banded_align_full_band_equals_dense(rng, default_params):
    from versalignlib_tpu.ops.banded import banded_align_batch
    from versalignlib_tpu.types import TieBreak

    reads = random_codes(rng, 6, 20, n_prob=0.1)
    refs = random_codes(rng, 6, 20, n_prob=0.1)
    for tie in (TieBreak.DIAG_UP_LEFT, TieBreak.DIAG_LEFT_UP):
        got = banded_align_batch(reads, refs, default_params,
                                 Algorithm.SMITH_WATERMAN, band=20, tie=tie)
        want = oracle.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs,
                                         default_params, tie)
        for g, w in zip(got, want):
            assert (g.read, g.ref, g.score, g.cigar) == (
                w.read, w.ref, w.score, w.cigar), tie


def test_banded_affine_full_band_equals_dense_gotoh(rng):
    from versalignlib_tpu.ops import gotoh
    from versalignlib_tpu.ops.banded import banded_align_batch

    reads = random_codes(rng, 5, 18)
    refs = random_codes(rng, 5, 18)
    got = banded_align_batch(reads, refs, AFFINE_PARAMS,
                             Algorithm.SMITH_WATERMAN, band=18)
    want = [gotoh.sw_align_affine(r, f, AFFINE_PARAMS)
            for r, f in zip(reads, refs)]
    for g, w in zip(got, want):
        assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)


def test_banded_align_nw_padded_reads_stay_clean(default_params):
    # NW traceback must start on the last VALID read row, not the padded
    # final row.
    from versalignlib_tpu.ops.banded import banded_align_batch

    reads = np.zeros((2, 10), dtype=np.uint8)
    refs = np.zeros((2, 12), dtype=np.uint8)
    rng2 = np.random.default_rng(7)
    reads[0, :5] = rng2.integers(1, 5, 5)   # 5 valid bases + 5 pad
    refs[0, :8] = rng2.integers(1, 5, 8)
    reads[1, :] = rng2.integers(1, 5, 10)   # fully valid
    refs[1, :] = rng2.integers(1, 5, 12)
    alns = banded_align_batch(reads, refs, default_params,
                              Algorithm.NEEDLEMAN_WUNSCH, band=10)
    want = _align_oracle_batch(reads, refs, default_params, 10,
                               Algorithm.NEEDLEMAN_WUNSCH)
    for a, w, m_valid in zip(alns, want, (5, 10)):
        assert "\0" not in a.read and "\0" not in a.ref
        assert a.read_end <= m_valid
        assert (a.read, a.ref, a.score, a.cigar) == (w.read, w.ref, w.score, w.cigar)


def test_banded_align_narrow_band_snp(default_params):
    # Nearly identical 60bp pair, one substitution: 60M through a 16-band.
    from versalignlib_tpu.ops.banded import banded_align_batch

    rng = np.random.default_rng(13)
    seq = rng.integers(1, 5, size=(3, 60)).astype(np.uint8)
    mut = seq.copy()
    mut[:, 30] = (mut[:, 30] % 4) + 1
    alns = banded_align_batch(seq, mut, default_params,
                              Algorithm.SMITH_WATERMAN, band=16)
    for a in alns:
        assert a.cigar == "60M"
        assert a.score in (117, 120)  # one mismatch (or silent same-base "mutation")


def test_banded_affine_scores(rng):
    from versalignlib_tpu.ops import gotoh
    from versalignlib_tpu.ops.banded import band_offsets

    p = AlignmentParameters(score_match=2, score_mismatch=-1, score_gap_read=-1,
                            score_gap_ref=-1, gap_open_read=-4, gap_open_ref=-4)
    reads = random_codes(rng, 5, 32, padded=True)
    refs = random_codes(rng, 5, 40, padded=True)
    band = 16
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = banded_score_batch(reads, refs, p, algorithm, band=band)
        want = _oracle_batch(reads, refs, p, band, algorithm)
        np.testing.assert_array_equal(got, want)
    # full band degenerates to the dense Gotoh scores
    got = banded_score_batch(reads, refs, p, Algorithm.SMITH_WATERMAN,
                             band=40)
    want = gotoh.score_alignments_affine(Algorithm.SMITH_WATERMAN, reads, refs, p)
    np.testing.assert_array_equal(got, want)


def test_banded_align_steep_band(rng, default_params):
    # n >> m: per-row band steps d > 1; SW path sum must replay the score.
    from versalignlib_tpu.ops.banded import banded_align_batch

    reads = random_codes(rng, 4, 20)
    refs = random_codes(rng, 4, 70)
    alns = banded_align_batch(reads, refs, default_params,
                              Algorithm.SMITH_WATERMAN, band=16)
    scores = banded_score_batch(reads, refs, default_params,
                                Algorithm.SMITH_WATERMAN, band=16)
    assert [a.score for a in alns] == [int(s) for s in scores]
    for a, r, f in zip(alns, reads, refs):
        cost = 0
        for rc, fc in zip(a.read, a.ref):
            if rc == "-" or fc == "-":
                cost += -3
            else:
                cost += 2 if rc == fc else -1
        assert cost == a.score, (a, cost)


def test_banded_python_fallback_matches_native(rng, default_params):
    # The python walker and the C++ decoder implement the same walk.
    from versalignlib_tpu.ops import banded as bd
    from versalignlib_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    reads = random_codes(rng, 4, 24, padded=True)
    refs = random_codes(rng, 4, 30, padded=True)
    for p in (default_params, AFFINE_PARAMS):
        for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
            with_native = bd.banded_align_batch(
                reads, refs, p, algorithm, band=12)
            # Force the python fallback by monkeypatching the import point.
            import versalignlib_tpu.native as nat
            real = nat.decode_banded_native
            try:
                def _raise(*a, **k):
                    raise ImportError("forced fallback")
                nat.decode_banded_native = _raise
                pure = bd.banded_align_batch(
                    reads, refs, p, algorithm, band=12)
            finally:
                nat.decode_banded_native = real
            for g, w in zip(with_native, pure):
                assert (g.read, g.ref, g.score, g.cigar,
                        g.read_start, g.ref_start) == \
                    (w.read, w.ref, w.score, w.cigar,
                     w.read_start, w.ref_start)


def test_banded_raw_batch_matches_objects(rng, default_params):
    from versalignlib_tpu import native
    from versalignlib_tpu.ops.banded import banded_align_batch

    if not native.available():
        pytest.skip("native library unavailable")
    reads = random_codes(rng, 6, 24, padded=True)
    refs = random_codes(rng, 6, 30, padded=True)
    objs = banded_align_batch(reads, refs, default_params,
                              Algorithm.NEEDLEMAN_WUNSCH, band=12)
    batch = banded_align_batch(reads, refs, default_params,
                               Algorithm.NEEDLEMAN_WUNSCH, band=12, raw=True)
    for got, want in zip(batch, objs):
        assert (got.read, got.ref, got.score, got.cigar) == \
            (want.read, want.ref, want.score, want.cigar)


def test_banded_align_multi_chunk_matches_single_shot(rng, default_params):
    # Pair-chunked dispatch (the plane-budget path) must be invisible:
    # three rounds with a ragged tail == one single-shot call.
    from versalignlib_tpu.ops.banded import banded_align_batch

    b = 2 * 64 + 37  # 3 rounds of 64, ragged tail
    reads = random_codes(rng, b, 16, padded=True, n_prob=0.05)
    refs = random_codes(rng, b, 20, padded=True, n_prob=0.05)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        chunked = banded_align_batch(reads, refs, default_params, algorithm,
                                     band=12, chunk_pairs=64)
        single = banded_align_batch(reads, refs, default_params, algorithm,
                                    band=12)
        assert len(chunked) == len(single) == b
        for g, w in zip(chunked, single):
            assert (g.read, g.ref, g.score, g.cigar,
                    g.read_start, g.read_end, g.ref_start, g.ref_end) == \
                (w.read, w.ref, w.score, w.cigar,
                 w.read_start, w.read_end, w.ref_start, w.ref_end)


def test_banded_align_multi_chunk_raw_concat(rng, default_params):
    from versalignlib_tpu import native
    from versalignlib_tpu.ops.banded import banded_align_batch

    if not native.available():
        pytest.skip("native library unavailable")
    b = 64 + 11
    reads = random_codes(rng, b, 16, padded=True)
    refs = random_codes(rng, b, 20, padded=True)
    chunked = banded_align_batch(reads, refs, default_params,
                                 Algorithm.SMITH_WATERMAN, band=12,
                                 chunk_pairs=64, raw=True)
    single = banded_align_batch(reads, refs, default_params,
                                Algorithm.SMITH_WATERMAN, band=12, raw=True)
    assert len(chunked) == len(single) == b
    for i in (0, 63, 64, b - 1):
        g, w = chunked[i], single[i]
        assert (g.read, g.ref, g.score, g.cigar) == \
            (w.read, w.ref, w.score, w.cigar)
