"""Generic S x S substitution matrices (additive: the reference's only
alphabet is the 6x6 DNA table, DefaultKernel.h:83-96)."""

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu.alphabet import (PROTEIN_ALPHABET, blosum62,
                                       encode_custom, substitution_scores)
from versalignlib_tpu.ops import gotoh, oracle
from versalignlib_tpu.ops.pallas_backend import PallasBackend
from versalignlib_tpu.ops.xla import XLABackend, align_pairs
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, TieBreak


def _random_matrix(rng, s):
    """Asymmetric random matrix with zero padding row/col (catches a/b
    transposition bugs the symmetric DNA table cannot)."""
    m = rng.integers(-4, 5, size=(s, s))
    np.fill_diagonal(m, rng.integers(3, 7, size=s))
    m[0, :] = 0
    m[:, 0] = 0
    return tuple(tuple(int(v) for v in row) for row in m)


@pytest.fixture()
def mat_params(rng):
    return AlignmentParameters(score_gap_read=-3, score_gap_ref=-3,
                               matrix=_random_matrix(rng, 6))


def test_matrix_validation():
    with pytest.raises(ValueError, match="square"):
        AlignmentParameters(matrix=((0, 0), (0, 1), (0, 2)))
    with pytest.raises(ValueError, match="row 0"):
        AlignmentParameters(matrix=((1, 0), (0, 2)))
    p = AlignmentParameters(matrix=[[0, 0], [0, 3]])  # lists normalize
    assert p.matrix == ((0, 0), (0, 3)) and p.sub_size == 2


def test_substitution_scores_matrix_lookup(rng, mat_params):
    m = np.asarray(mat_params.matrix)
    a = rng.integers(0, 9, size=(5, 7))   # incl. out-of-range codes
    b = rng.integers(0, 9, size=(5, 7))
    got = substitution_scores(a, b, 2, -1, mat_params.matrix)
    want = m[np.where(a < 6, a, 0), np.where(b < 6, b, 0)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
def test_matrix_backends_match_oracle(rng, mat_params, algorithm):
    reads = random_codes(rng, 12, 20, padded=True, n_prob=0.1)
    refs = random_codes(rng, 12, 26, padded=True, n_prob=0.1)
    want_s = oracle.score_alignments(algorithm, reads, refs, mat_params)
    xla = XLABackend()
    np.testing.assert_array_equal(
        xla.score_alignments(algorithm, reads, refs, mat_params), want_s)
    pallas = PallasBackend(interpret=True)
    np.testing.assert_array_equal(
        pallas.score_alignments(algorithm, reads, refs, mat_params), want_s)

    want_a = oracle.compute_alignments(algorithm, reads, refs, mat_params,
                                       TieBreak.DIAG_UP_LEFT)
    got_x = xla.compute_alignments(algorithm, reads, refs, mat_params,
                                   TieBreak.DIAG_UP_LEFT)
    got_p = pallas.compute_alignments(algorithm, reads, refs, mat_params,
                                      TieBreak.DIAG_UP_LEFT)
    for g, w in zip(got_x, want_a):
        assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)
    for g, w in zip(got_p, want_a):
        assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)


def test_matrix_affine_matches_gotoh(rng):
    p = AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                            gap_open_read=-4, gap_open_ref=-4,
                            matrix=_random_matrix(rng, 6))
    reads = random_codes(rng, 8, 16, padded=True)
    refs = random_codes(rng, 8, 20, padded=True)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        want = gotoh.compute_alignments_affine(algorithm, reads, refs, p)
        got = align_pairs(reads, refs, p, algorithm)
        for g, w in zip(got, want):
            assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)
        want_s = gotoh.score_alignments_affine(algorithm, reads, refs, p)
        np.testing.assert_array_equal(
            XLABackend().score_alignments(algorithm, reads, refs, p), want_s)
        np.testing.assert_array_equal(
            PallasBackend(interpret=True).score_alignments(
                algorithm, reads, refs, p), want_s)


def test_matrix_banded(rng, mat_params):
    from versalignlib_tpu.ops.banded import (band_offsets, banded_align_batch,
                                             banded_align_oracle,
                                             banded_score_batch,
                                             banded_score_oracle)

    reads = random_codes(rng, 5, 30, padded=True)
    refs = random_codes(rng, 5, 36, padded=True)
    band = 12
    offs = band_offsets(30, 30, 36, band)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = banded_score_batch(reads, refs, mat_params, algorithm,
                                 band=band)
        want = np.array([
            banded_score_oracle(r, f, mat_params, band, algorithm, offs)
            for r, f in zip(reads, refs)])
        np.testing.assert_array_equal(got, want)
        got_a = banded_align_batch(reads, refs, mat_params, algorithm,
                                   band=band)
        want_a = [banded_align_oracle(r, f, mat_params, band, algorithm, offs)
                  for r, f in zip(reads, refs)]
        for g, w in zip(got_a, want_a):
            assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)


def test_matrix_sse_flavor_validity_gate():
    """SSE-flavor DIAG gating generalizes "A/C/G/T" to nonzero-scoring codes
    (alphabet.valid_code_mask): a code with an all-zero matrix row/col (the
    N analogue) blocks DIAG pointers under TieBreak.DIAG_LEFT_UP."""
    m = ((0, 0, 0), (0, 3, 0), (0, 0, 0))  # code 2 scores 0 vs everything
    p = AlignmentParameters(score_gap_read=-2, score_gap_ref=-2, matrix=m)
    reads = np.array([[1, 2, 1]], dtype=np.uint8)
    refs = np.array([[1, 2, 1]], dtype=np.uint8)
    can = oracle.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs,
                                    p, TieBreak.DIAG_UP_LEFT)[0]
    sse = oracle.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs,
                                    p, TieBreak.DIAG_LEFT_UP)[0]
    # The walk from the unique max at (3,3) hits the zero-sub diag tie at
    # (2,2): canonical walks through it, the SSE flavor's validity gate
    # stops there (mirroring the DNA flavor's N behavior).
    assert (can.cigar, can.score) == ("3M", 6)
    assert (sse.cigar, sse.score) == ("1M", 6)


def test_matrix_sse_flavor_cross_backend(rng):
    """Matrix mode under the SSE flavor: the XLA fill's tracebacks (objects
    and raw columns) bit-equal to the flavored oracle, incl. an interior
    zero row/col code."""
    m = np.array(_random_matrix(rng, 7), dtype=np.int64)
    m[4, :] = 0
    m[:, 4] = 0  # N-analogue: code 4 is score-invalid
    p = AlignmentParameters(score_gap_read=-3, score_gap_ref=-3,
                            matrix=tuple(tuple(int(v) for v in r) for r in m))
    reads = rng.integers(1, 7, size=(8, 10)).astype(np.uint8)
    refs = rng.integers(1, 7, size=(8, 13)).astype(np.uint8)
    reads[:, -1] *= rng.integers(0, 2, size=8).astype(np.uint8)  # some padding
    tie = TieBreak.DIAG_LEFT_UP
    be = XLABackend()
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        want = oracle.compute_alignments(algorithm, reads, refs, p, tie)
        got_x = be.compute_alignments(algorithm, reads, refs, p, tie)
        got_p = list(align_pairs(reads, refs, p, algorithm, tie, raw=True))
        for i, (w, gx, gp) in enumerate(zip(want, got_x, got_p)):
            assert (gx.read, gx.ref, gx.score, gx.cigar) == (
                w.read, w.ref, w.score, w.cigar), ("xla", algorithm, i)
            assert (gp.read, gp.ref, gp.score, gp.cigar) == (
                w.read, w.ref, w.score, w.cigar), ("raw", algorithm, i)


def test_blosum62_protein_alignment():
    # Identical peptide: score = sum of BLOSUM62 diagonal entries; one
    # substitution W->F scores blosum62[W][F] = 1.
    p = AlignmentParameters(score_gap_read=-11, score_gap_ref=-11,
                            matrix=blosum62())
    pep = "MKTWQERLLA"
    codes = encode_custom([pep, pep.replace("W", "F")], PROTEIN_ALPHABET)
    m = np.asarray(p.matrix)
    self_score = int(m[codes[0], codes[0]].sum())
    got = oracle.score_alignments(Algorithm.SMITH_WATERMAN, codes[:1],
                                  codes[:1], p)
    assert got[0] == self_score
    aln = oracle.compute_alignments(Algorithm.SMITH_WATERMAN, codes[:1],
                                    codes[1:], p)[0]
    assert aln.cigar == "10M"
    assert aln.score == self_score - m[codes[0][3], codes[0][3]] + 1  # W->F
    # And the XLA backend agrees on the protein pair.
    np.testing.assert_array_equal(
        XLABackend().score_alignments(Algorithm.SMITH_WATERMAN, codes[:1],
                                      codes[1:], p),
        oracle.score_alignments(Algorithm.SMITH_WATERMAN, codes[:1], codes[1:], p))
