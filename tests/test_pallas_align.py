"""Dense align path (XLA pointer fill + host decode) vs oracle."""

import pytest

from tests.conftest import random_codes
from versalignlib_tpu.ops import oracle
from versalignlib_tpu.ops.xla import align_pairs
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, TieBreak


def _check(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.read == w.read, (i, g, w)
        assert g.ref == w.ref, (i, g, w)
        assert g.score == w.score, (i, g, w)
        assert g.cigar == w.cigar, (i, g, w)
        assert (g.read_start, g.read_end, g.ref_start, g.ref_end) == (
            w.read_start, w.read_end, w.ref_start, w.ref_end,
        ), (i, g, w)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("tie", [TieBreak.DIAG_UP_LEFT, TieBreak.DIAG_LEFT_UP])
def test_align_matches_oracle(rng, algorithm, tie, default_params):
    reads = random_codes(rng, 16, 15, padded=True, n_prob=0.08)
    refs = random_codes(rng, 16, 21, padded=True, n_prob=0.08)
    got = align_pairs(reads, refs, default_params, algorithm, tie)
    want = oracle.compute_alignments(algorithm, reads, refs, default_params, tie)
    _check(got, want)


@pytest.mark.parametrize("n", [7, 9, 18, 32])
def test_ref_widths(rng, default_params, n):
    reads = random_codes(rng, 6, 10, padded=True)
    refs = random_codes(rng, 6, n, padded=True)
    got = align_pairs(reads, refs, default_params, Algorithm.SMITH_WATERMAN,
                      TieBreak.DIAG_UP_LEFT)
    want = oracle.compute_alignments(
        Algorithm.SMITH_WATERMAN, reads, refs, default_params
    )
    _check(got, want)


def test_raw_columns_match_objects(rng, default_params):
    from versalignlib_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")
    reads = random_codes(rng, 9, 12, padded=True, n_prob=0.05)
    refs = random_codes(rng, 9, 14, padded=True, n_prob=0.05)
    objs = align_pairs(reads, refs, default_params, Algorithm.SMITH_WATERMAN)
    batch = align_pairs(reads, refs, default_params, Algorithm.SMITH_WATERMAN,
                        raw=True)
    assert [batch[i] for i in range(len(batch))] == objs


def test_chunked_batches(rng, default_params):
    reads = random_codes(rng, 9, 8)
    refs = random_codes(rng, 9, 8)
    got = align_pairs(
        reads, refs, default_params, Algorithm.NEEDLEMAN_WUNSCH,
        TieBreak.DIAG_UP_LEFT, chunk_pairs=4,
    )
    want = oracle.compute_alignments(
        Algorithm.NEEDLEMAN_WUNSCH, reads, refs, default_params
    )
    _check(got, want)


def test_affine_align_matches_gotoh(rng):
    from versalignlib_tpu.ops import gotoh

    p = AlignmentParameters(score_match=2, score_mismatch=-1, score_gap_read=-1,
                            score_gap_ref=-1, gap_open_read=-4, gap_open_ref=-4)
    reads = random_codes(rng, 14, 12, padded=True, n_prob=0.05)
    refs = random_codes(rng, 14, 18, padded=True, n_prob=0.05)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = align_pairs(reads, refs, p, algorithm)
        want = gotoh.compute_alignments_affine(algorithm, reads, refs, p)
        for g, w in zip(got, want):
            assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)


def test_python_fallback_matches_native(rng, monkeypatch):
    """Without the native library the Python walkers decode the same
    planes (linear and affine)."""
    import versalignlib_tpu.native as nat

    p_aff = AlignmentParameters(gap_open_read=-3, gap_open_ref=-3)
    reads = random_codes(rng, 7, 11, padded=True, n_prob=0.05)
    refs = random_codes(rng, 7, 13, padded=True, n_prob=0.05)
    for p in (AlignmentParameters(), p_aff):
        for algorithm in Algorithm:
            with_native = align_pairs(reads, refs, p, algorithm)

            def _raise(*a, **k):
                raise ImportError("forced fallback")

            monkeypatch.setattr(nat, "decode_batch_native", _raise)
            pure = align_pairs(reads, refs, p, algorithm)
            monkeypatch.undo()
            assert pure == with_native
