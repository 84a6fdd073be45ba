"""Traceback outputs three ways: raw column store, objects, oracle.

The device fills (dense XLA scans, banded XLA band scan) feed the native
walker, which returns either an ``AlignmentBatch`` column store (``raw``)
or ``Alignment`` objects. These tests gate that both are IDENTICAL to the
numpy oracles (which are golden-gated against the compiled reference
kernels) across algorithms, tie flavors, edge sequences, odd shapes,
matrix mode, affine gaps and chunk boundaries.
"""

import numpy as np
import pytest

from versalignlib_tpu.alphabet import pad_and_encode
from versalignlib_tpu.ops import gotoh, oracle
from versalignlib_tpu.ops.banded import (band_offsets, banded_align_batch,
                                         banded_align_oracle)
from versalignlib_tpu.ops.xla import align_pairs
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, TieBreak

P = AlignmentParameters()
AFFINE = AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                             gap_open_read=-4, gap_open_ref=-4)


@pytest.fixture(autouse=True)
def _needs_native():
    from versalignlib_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")


def _rand_codes(rng, b, m):
    return rng.integers(0, 6, size=(b, m)).astype(np.uint8)


def _fields(a):
    return (a.read, a.ref, a.score, a.cigar, a.read_start, a.read_end,
            a.ref_start, a.ref_end)


def _three(reads, refs, params, algorithm, tie=TieBreak.DIAG_UP_LEFT, **kw):
    """Raw rows, objects and oracle alignments must all agree."""
    objs = align_pairs(reads, refs, params, algorithm, tie, **kw)
    batch = align_pairs(reads, refs, params, algorithm, tie, raw=True, **kw)
    if params.affine:
        want = gotoh.compute_alignments_affine(algorithm, reads, refs,
                                               params, tie)
    else:
        want = oracle.compute_alignments(algorithm, reads, refs, params, tie)
    assert len(batch) == len(objs) == len(want)
    assert [batch[i] for i in range(len(batch))] == objs
    assert [_fields(a) for a in objs] == [_fields(w) for w in want]


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("tie", [TieBreak.DIAG_UP_LEFT,
                                 TieBreak.DIAG_LEFT_UP])
def test_raw_objects_oracle_agree(rng, algorithm, tie):
    reads = ["".join(rng.choice(list("ACGTacgtNn"),
                                size=int(rng.integers(4, 30))))
             for _ in range(21)] + ["", "NNNN", "ACGT"]
    refs = ["".join(rng.choice(list("ACGTacgtNn"),
                               size=int(rng.integers(4, 40))))
            for _ in range(21)] + ["ACGT", "", "tttt"]
    r = pad_and_encode(reads, max(len(s) for s in reads))
    f = pad_and_encode(refs, max(len(s) for s in refs))
    _three(r, f, P, algorithm, tie)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("shape", [(13, 17), (9, 61), (30, 37)])
def test_odd_shapes(rng, algorithm, shape):
    m, n = shape
    _three(_rand_codes(rng, 9, m), _rand_codes(rng, 9, n), P, algorithm)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
def test_gap_heavy_runs(rng, algorithm):
    # Cheap read-gaps force long LEFT runs.
    p = AlignmentParameters(score_match=2, score_mismatch=-1,
                            score_gap_read=-1, score_gap_ref=-4)
    _three(_rand_codes(rng, 13, 8), _rand_codes(rng, 13, 50), p, algorithm)


def test_matrix_mode(rng):
    # 6x6 matrix with a negative diagonal entry exercises matrix-aware
    # validity + substitution.
    mat = rng.integers(-3, 4, size=(6, 6)).astype(np.int32)
    mat[0, :] = 0
    mat[:, 0] = 0
    p = AlignmentParameters(matrix=tuple(map(tuple, mat.tolist())))
    r, f = _rand_codes(rng, 11, 14), _rand_codes(rng, 11, 23)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        for tie in (TieBreak.DIAG_UP_LEFT, TieBreak.DIAG_LEFT_UP):
            _three(r, f, p, algorithm, tie)


def test_multi_chunk_boundaries(rng):
    # chunk_pairs=16 -> three device rounds; pairs at the seams must agree.
    r, f = _rand_codes(rng, 40, 12), _rand_codes(rng, 40, 19)
    _three(r, f, P, Algorithm.SMITH_WATERMAN, chunk_pairs=16)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("tie", [TieBreak.DIAG_UP_LEFT,
                                 TieBreak.DIAG_LEFT_UP])
def test_affine_raw_objects_oracle_agree(rng, algorithm, tie):
    for (m, n) in ((12, 18), (9, 35), (21, 13)):
        _three(_rand_codes(rng, 11, m), _rand_codes(rng, 11, n), AFFINE,
               algorithm, tie)


def test_affine_long_gap_chains(rng):
    # Cheap extends force multi-row F chains and long E runs.
    p = AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                            gap_open_read=-2, gap_open_ref=-2)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        _three(_rand_codes(rng, 13, 40), _rand_codes(rng, 13, 7), p, algorithm)
        _three(_rand_codes(rng, 13, 7), _rand_codes(rng, 13, 40), p, algorithm)


def test_engine_raw_option(rng):
    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.ops.pallas_backend import PallasBackend

    reads = ["ACGTACGTAA", "TTTTGGGG", "acgtn"]
    refs = ["ACGGACGTAA", "TTTTGGGGCC", "ACGTN"]
    ap = AlignmentParameters(gap_open_read=-4, gap_open_ref=-4)
    for params in (P, ap):
        ex = AlignmentEngine(backend="xla", params=params)
        ep = AlignmentEngine(backend="xla", params=params)
        ep.backend = PallasBackend(interpret=True)
        eo = AlignmentEngine(backend="oracle", params=params)
        for algorithm in (Algorithm.SMITH_WATERMAN,
                          Algorithm.NEEDLEMAN_WUNSCH):
            objs = ex.compute_alignments(algorithm, reads, refs)
            assert list(ex.compute_alignments(algorithm, reads, refs,
                                              raw=True)) == objs
            assert list(ep.compute_alignments(algorithm, reads, refs,
                                              raw=True)) == objs
            assert [_fields(a) for a in objs] == [
                _fields(a) for a in eo.compute_alignments(algorithm, reads,
                                                          refs)]
            with pytest.raises(ValueError, match="raw"):
                eo.compute_alignments(algorithm, reads, refs, raw=True)


# ---------------------------------------------------------------------------
# Banded traceback (band-relative plane, band-edge stop semantics)
# ---------------------------------------------------------------------------

def _three_banded(reads, refs, params, algorithm, band, tie=None, **kw):
    objs = banded_align_batch(reads, refs, params, algorithm, band=band,
                              tie=tie, **kw)
    batch = banded_align_batch(reads, refs, params, algorithm, band=band,
                               tie=tie, raw=True, **kw)
    m, n = reads.shape[1], refs.shape[1]
    bw = min(band, n)
    offs = band_offsets(m, m, n, bw)
    want = [banded_align_oracle(r, f, params, bw, algorithm, offs, tie=tie)
            for r, f in zip(reads, refs)]
    assert [batch[i] for i in range(len(batch))] == objs
    assert [_fields(a) for a in objs] == [_fields(w) for w in want]


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("tie", [TieBreak.DIAG_UP_LEFT,
                                 TieBreak.DIAG_LEFT_UP])
def test_banded_raw_objects_oracle_agree(rng, algorithm, tie):
    for (m, n, band) in ((24, 40, 8), (17, 61, 24), (40, 24, 8)):
        _three_banded(_rand_codes(rng, 11, m), _rand_codes(rng, 11, n), P,
                      algorithm, band, tie)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
def test_banded_affine(rng, algorithm):
    for (m, n, band) in ((24, 40, 16), (17, 61, 24), (40, 9, 9)):
        _three_banded(_rand_codes(rng, 11, m), _rand_codes(rng, 11, n),
                      AFFINE, algorithm, band)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
def test_banded_band_edge_runs(rng, algorithm):
    # Cheap read-gaps force LEFT/E runs into the band's low edge — the
    # banded walk's hard-stop boundary (dense NW would UP-chain instead).
    lin = AlignmentParameters(score_match=2, score_mismatch=-1,
                              score_gap_read=-1, score_gap_ref=-4)
    aff = AlignmentParameters(score_gap_read=-1, score_gap_ref=-1,
                              gap_open_read=-2, gap_open_ref=-2)
    for params in (lin, aff):
        _three_banded(_rand_codes(rng, 13, 8), _rand_codes(rng, 13, 50),
                      params, algorithm, 32)


def test_banded_long_drift(rng):
    # Long mutated copies: the band drifts along the whole read, so walks
    # cross many offset steps.
    m, n = 200, 400
    reads = rng.integers(1, 5, size=(4, m)).astype(np.uint8)
    refs = np.zeros((4, n), np.uint8)
    for i in range(4):
        s = np.concatenate([reads[i], reads[i]])[:n]
        mut = rng.random(n) < 0.1
        refs[i] = np.where(mut, rng.integers(1, 5, size=n), s)
    for params in (P, AFFINE):
        for algorithm in (Algorithm.SMITH_WATERMAN,
                          Algorithm.NEEDLEMAN_WUNSCH):
            _three_banded(reads, refs, params, algorithm, 64)


def test_banded_raw_and_model(rng):
    from versalignlib_tpu.models import AlignmentModel

    r, f = _rand_codes(rng, 9, 40), _rand_codes(rng, 9, 70)
    _three_banded(r, f, P, Algorithm.SMITH_WATERMAN, 16, chunk_pairs=4)
    model = AlignmentModel(name="b", algorithm=Algorithm.SMITH_WATERMAN,
                           banded=True, band=16)
    assert model.align(r, f) == banded_align_batch(
        r, f, P, Algorithm.SMITH_WATERMAN, band=16)


def test_cigar_only_columns(rng):
    # gapped=False: same score/coords/CIGAR columns, no gapped strings.
    r, f = _rand_codes(rng, 17, 16), _rand_codes(rng, 17, 21)
    for params in (P, AFFINE):
        for algorithm in (Algorithm.SMITH_WATERMAN,
                          Algorithm.NEEDLEMAN_WUNSCH):
            full = align_pairs(r, f, params, algorithm, raw=True)
            cig = align_pairs(r, f, params, algorithm, raw=True,
                              gapped=False)
            assert cig.read_gapped is None
            np.testing.assert_array_equal(cig.meta[:, :6], full.meta[:, :6])
            rows_full = full.to_json_rows()
            for row in rows_full:
                del row["read"], row["ref"]
            assert cig.to_json_rows() == rows_full


def test_dense_model_backends_agree(rng):
    """AlignmentModel.align gives identical tracebacks on every backend."""
    from versalignlib_tpu.models import AlignmentModel

    r, f = _rand_codes(rng, 7, 24), _rand_codes(rng, 7, 33)
    model = AlignmentModel(name="d", algorithm=Algorithm.SMITH_WATERMAN)
    a_xla = model.align(r, f, backend="xla")
    a_orc = model.align(r, f, backend="oracle")
    assert [_fields(a) for a in a_xla] == [_fields(a) for a in a_orc]
