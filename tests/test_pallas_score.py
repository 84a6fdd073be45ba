"""Pallas/Triton dense score kernel vs oracle (interpret mode on CPU).

The compiled kernel runs only on a CUDA device; chip_smoke.py compares it
there with the XLA scan at 16,384 pairs of 512x512. These tests pin its
semantics portably, at small launch shapes.
"""

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu.ops import gotoh, oracle
from versalignlib_tpu.ops.triton_score import score_batch_triton
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm

PARAM_SETS = [
    AlignmentParameters(),
    AlignmentParameters(score_match=3, score_mismatch=-2, score_gap_read=-1, score_gap_ref=-2),
]


def _kernel(reads, refs, p, algorithm, **launch):
    launch = {"block_pairs": 8, "strip": 4, "unroll": 2, **launch}
    return np.asarray(score_batch_triton(reads, refs, p, algorithm,
                                         interpret=True, **launch))


def _want(reads, refs, p, algorithm):
    if p.affine:
        return gotoh.score_alignments_affine(algorithm, reads, refs, p)
    return oracle.score_alignments(algorithm, reads, refs, p)


@pytest.mark.parametrize("p", PARAM_SETS)
@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
def test_scores_match_oracle(rng, p, algorithm):
    reads = random_codes(rng, 30, 19, padded=True, n_prob=0.1)
    refs = random_codes(rng, 30, 26, padded=True, n_prob=0.1)
    np.testing.assert_array_equal(_kernel(reads, refs, p, algorithm),
                                  _want(reads, refs, p, algorithm))


@pytest.mark.parametrize("n", [7, 9, 12, 16])  # column-unroll remainders
def test_unroll_factors(rng, default_params, n):
    reads = random_codes(rng, 10, 11, padded=True)  # strip remainder 3
    refs = random_codes(rng, 10, n, padded=True)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = _kernel(reads, refs, default_params, algorithm, unroll=4)
        want = oracle.score_alignments(algorithm, reads, refs, default_params)
        np.testing.assert_array_equal(got, want)


def test_all_invalid(default_params):
    reads = np.zeros((5, 8), dtype=np.uint8)
    refs = np.zeros((5, 8), dtype=np.uint8)
    np.testing.assert_array_equal(
        _kernel(reads, refs, default_params, Algorithm.SMITH_WATERMAN),
        np.zeros(5))


def test_backend_adapter(rng, default_params):
    from versalignlib_tpu.ops.pallas_backend import PallasBackend

    backend = PallasBackend(interpret=True)
    reads = random_codes(rng, 8, 10)
    refs = random_codes(rng, 8, 10)
    got = backend.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs, default_params)
    want = oracle.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs, default_params)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block_pairs,strip,unroll", [
    (4, 1, 1), (16, 8, 1), (8, 16, 3),   # strip > m: one remainder strip
])
def test_launch_shapes(rng, block_pairs, strip, unroll):
    p = AlignmentParameters(gap_open_read=-4, gap_open_ref=-3)
    reads = random_codes(rng, 21, 12, padded=True, n_prob=0.05)
    refs = random_codes(rng, 21, 10, padded=True, n_prob=0.05)
    for algorithm in Algorithm:
        got = _kernel(reads, refs, p, algorithm, block_pairs=block_pairs,
                      strip=strip, unroll=unroll)
        np.testing.assert_array_equal(got, _want(reads, refs, p, algorithm))


@pytest.mark.parametrize("b,want", [(1, 32), (4096, 32), (16383, 32),
                                    (16384, 64), (262144, 64)])
def test_block_pairs_follow_batch(b, want):
    """Wide blocks only once the batch gives every SM about two programs."""
    from versalignlib_tpu.ops.triton_score import block_pairs_for

    assert block_pairs_for(b) == want


def test_empty_shapes(default_params):
    for shape_r, shape_f in (((0, 5), (0, 5)), ((3, 0), (3, 4)),
                             ((3, 4), (3, 0))):
        got = _kernel(np.zeros(shape_r, np.uint8), np.zeros(shape_f, np.uint8),
                      default_params, Algorithm.NEEDLEMAN_WUNSCH)
        np.testing.assert_array_equal(got, np.zeros(shape_r[0]))
