"""Affine (Gotoh) oracle vs brute-force triple loop + linear degeneration."""

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu.alphabet import base_score_matrix, encode
from versalignlib_tpu.ops import gotoh, oracle
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm

NEG = -(2**30)


def brute_affine(read, ref, p, local):
    bs = base_score_matrix(p.score_match, p.score_mismatch)
    m, n = len(read), len(ref)
    h = np.zeros((m + 1, n + 1), dtype=np.int64)
    e = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    f = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            f[i][j] = max(h[i - 1][j] + p.gap_open_ref + p.score_gap_ref,
                          f[i - 1][j] + p.score_gap_ref)
            e[i][j] = max(h[i][j - 1] + p.gap_open_read + p.score_gap_read,
                          e[i][j - 1] + p.score_gap_read)
            cand = max(h[i - 1][j - 1] + bs[read[i - 1]][ref[j - 1]], e[i][j], f[i][j])
            h[i][j] = max(cand, 0) if local else cand
    return h


def brute_sw_affine_score(read, ref, p):
    return int(brute_affine(read, ref, p, True).max())


def brute_nw_affine_score(read, ref, p):
    h = brute_affine(read, ref, p, False)
    return int(max(0, h[1:, -1].max(), h[-1, :].max()))


AFFINE_PARAMS = [
    AlignmentParameters(score_match=2, score_mismatch=-1, score_gap_read=-1,
                        score_gap_ref=-1, gap_open_read=-4, gap_open_ref=-4),
    AlignmentParameters(score_match=3, score_mismatch=-2, score_gap_read=-2,
                        score_gap_ref=-1, gap_open_read=-6, gap_open_ref=-3),
]


@pytest.mark.parametrize("p", AFFINE_PARAMS)
def test_affine_scores_match_brute(rng, p):
    reads = random_codes(rng, 15, 13, padded=True, n_prob=0.05)
    refs = random_codes(rng, 15, 17, padded=True, n_prob=0.05)
    for read, ref in zip(reads, refs):
        assert gotoh.sw_score_affine(read, ref, p) == brute_sw_affine_score(read, ref, p)
        assert gotoh.nw_score_affine(read, ref, p) == brute_nw_affine_score(read, ref, p)


def test_affine_reduces_to_linear(rng, default_params):
    # gap_open = 0 must reproduce the linear oracle's scores exactly.
    reads = random_codes(rng, 20, 14, padded=True, n_prob=0.1)
    refs = random_codes(rng, 20, 14, padded=True, n_prob=0.1)
    for read, ref in zip(reads, refs):
        assert gotoh.sw_score_affine(read, ref, default_params) == oracle.sw_score(
            read, ref, default_params
        )
        assert gotoh.nw_score_affine(read, ref, default_params) == oracle.nw_score(
            read, ref, default_params
        )


def test_affine_prefers_one_long_gap():
    # With affine costs, one 2-gap beats two 1-gaps.
    p = AlignmentParameters(score_match=2, score_mismatch=-3, score_gap_read=-1,
                            score_gap_ref=-1, gap_open_read=-3, gap_open_ref=-3)
    read = encode("ACGTACGTAC")
    ref = encode("ACGTCGTAC")  # one base deleted from read's view
    a = gotoh.sw_align_affine(read, ref, p)
    assert a.score == 2 * 9 - 3 - 1  # 9 matches, one opened 1-gap
    # Two separated mismatches vs a long gap:
    read2 = encode("AAAACCCCGGGG")
    ref2 = encode("AAAAGGGG")
    b = gotoh.sw_align_affine(read2, ref2, p)
    assert b.cigar == "4M4I4M"
    assert b.score == 8 * 2 - 3 - 4 * 1


@pytest.mark.parametrize("p", AFFINE_PARAMS)
def test_affine_traceback_score_consistency(rng, p):
    # The walked path must rebuild exactly the reported score.
    reads = random_codes(rng, 12, 12, padded=True)
    refs = random_codes(rng, 12, 15, padded=True)
    for read, ref in zip(reads, refs):
        a = gotoh.sw_align_affine(read, ref, p)
        cost = 0
        gap_r = gap_f = False
        for rc, fc in zip(a.read, a.ref):
            if rc == "-":
                cost += p.score_gap_read + (0 if gap_r else p.gap_open_read)
                gap_r, gap_f = True, False
            elif fc == "-":
                cost += p.score_gap_ref + (0 if gap_f else p.gap_open_ref)
                gap_r, gap_f = False, True
            else:
                cost += (p.score_match if rc == fc else p.score_mismatch) if (
                    rc in "ACGT" and fc in "ACGT") else 0
                gap_r = gap_f = False
        assert cost == a.score, (a, cost)


def test_affine_batch_api(rng):
    p = AFFINE_PARAMS[0]
    reads = random_codes(rng, 6, 10)
    refs = random_codes(rng, 6, 10)
    scores = gotoh.score_alignments_affine(Algorithm.SMITH_WATERMAN, reads, refs, p)
    alns = gotoh.compute_alignments_affine(Algorithm.SMITH_WATERMAN, reads, refs, p)
    assert all(int(s) == a.score for s, a in zip(scores, alns))


def test_affine_device_backends_match_oracle(rng):
    """XLA + Triton kernel (interpret) affine scores vs Gotoh oracle."""
    import jax.numpy as jnp

    from versalignlib_tpu.ops.pallas_backend import PallasBackend
    from versalignlib_tpu.ops.xla import score_batch

    p = AFFINE_PARAMS[0]
    reads = random_codes(rng, 20, 13, padded=True, n_prob=0.05)
    refs = random_codes(rng, 20, 16, padded=True, n_prob=0.05)
    pallas = PallasBackend(interpret=True)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        want = gotoh.score_alignments_affine(alg, reads, refs, p)
        got_x = np.asarray(score_batch(jnp.asarray(reads), jnp.asarray(refs), p, alg))
        got_p = pallas.score_alignments(alg, reads, refs, p)
        np.testing.assert_array_equal(got_x, want)
        np.testing.assert_array_equal(got_p, want)


def test_affine_engine_routing(rng):
    from versalignlib_tpu import AlignmentEngine

    p = AFFINE_PARAMS[0]
    engine = AlignmentEngine(params=p, backend="xla")
    scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, ["ACGTACGT"], ["ACGGTACG"])
    alns = engine.compute_alignments(Algorithm.SMITH_WATERMAN, ["ACGTACGT"], ["ACGGTACG"])
    assert int(scores[0]) == alns[0].score


def test_affine_sse_flavor_cross_backend(rng):
    """SSE-flavor affine pointers (validity-gated DIAG > LEFT(E) > UP(F), no
    zero-force, N-invalid boundaries): the XLA fill's objects and raw
    columns bit-equal to the flavored Gotoh oracle."""
    from versalignlib_tpu.ops.xla import XLABackend
    from versalignlib_tpu.types import TieBreak

    p = AFFINE_PARAMS[0]
    tie = TieBreak.DIAG_LEFT_UP
    backend = XLABackend()
    reads = random_codes(rng, 16, 12, padded=True, n_prob=0.15)
    refs = random_codes(rng, 16, 16, padded=True, n_prob=0.15)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        want = gotoh.compute_alignments_affine(alg, reads, refs, p, tie)
        got_x = backend.compute_alignments(alg, reads, refs, p, tie)
        got_p = list(backend.compute_alignments(alg, reads, refs, p, tie,
                                                raw=True))
        for i, (w, gx, gp) in enumerate(zip(want, got_x, got_p)):
            assert (gx.read, gx.ref, gx.score, gx.cigar) == (
                w.read, w.ref, w.score, w.cigar), ("xla", alg, i, gx, w)
            assert (gp.read, gp.ref, gp.score, gp.cigar) == (
                w.read, w.ref, w.score, w.cigar), ("raw", alg, i, gp, w)


def test_affine_sse_flavor_boundary_differs():
    """The SSE flavor's N-invalid boundary rule must actually bite: an N in
    the read shortens the NW end row (canonical counts N valid)."""
    from versalignlib_tpu.types import TieBreak

    p = AFFINE_PARAMS[0]
    read, ref = encode("ANGTAC"), encode("ATGTAC")
    can = gotoh.nw_align_affine(read, ref, p, TieBreak.DIAG_UP_LEFT)
    sse = gotoh.nw_align_affine(read, ref, p, TieBreak.DIAG_LEFT_UP)
    assert (can.read, can.cigar, can.score, can.read_end) == (
        "ANGTAC", "6M", 10, 6)
    assert (sse.read, sse.cigar, sse.score, sse.read_end) == ("A", "1M", 2, 1)


def test_xla_affine_align_matches_oracle(rng):
    """Device affine pointer plane + native decode vs the Gotoh oracle."""
    from versalignlib_tpu.ops.xla import XLABackend
    from versalignlib_tpu.types import TieBreak

    p = AFFINE_PARAMS[1]
    backend = XLABackend()
    reads = random_codes(rng, 24, 14, padded=True, n_prob=0.05)
    refs = random_codes(rng, 24, 19, padded=True, n_prob=0.05)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = backend.compute_alignments(alg, reads, refs, p, TieBreak.DIAG_UP_LEFT)
        want = gotoh.compute_alignments_affine(alg, reads, refs, p)
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g.read, g.ref, g.score, g.cigar) == (
                w.read, w.ref, w.score, w.cigar), (i, alg, g, w)
            assert (g.read_start, g.read_end, g.ref_start, g.ref_end) == (
                w.read_start, w.read_end, w.ref_start, w.ref_end), (i, alg)


def test_oracle_batch_entry_points_route_affine(rng):
    """oracle.score_alignments/compute_alignments honor p.affine (they
    previously computed the LINEAR model silently for affine params)."""
    from versalignlib_tpu.ops import oracle

    p = AFFINE_PARAMS[1]
    reads = random_codes(rng, 12, 16, padded=True, n_prob=0.1)
    refs = random_codes(rng, 12, 17, padded=True, n_prob=0.1)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = oracle.score_alignments(alg, reads, refs, p)
        want = gotoh.score_alignments_affine(alg, reads, refs, p)
        assert np.array_equal(got, want), alg
        ga = oracle.compute_alignments(alg, reads, refs, p)
        wa = gotoh.compute_alignments_affine(alg, reads, refs, p)
        assert ga == wa, alg


def test_pallas_align_batch_routes_affine(rng):
    """The pallas backend's align path honors p.affine (interleaved invalid
    codes once exposed a path that ran the LINEAR model silently)."""
    from versalignlib_tpu.ops.pallas_backend import PallasBackend
    from versalignlib_tpu.types import TieBreak

    p = AFFINE_PARAMS[1]
    reads = random_codes(rng, 24, 16, padded=True, n_prob=0.2)
    refs = random_codes(rng, 24, 17, padded=True, n_prob=0.2)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        got = PallasBackend(interpret=True).compute_alignments(
            alg, reads, refs, p, TieBreak.DIAG_UP_LEFT)
        want = gotoh.compute_alignments_affine(alg, reads, refs, p)
        assert got == want, alg
