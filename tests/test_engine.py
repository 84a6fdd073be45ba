"""Public API: AlignmentEngine end-to-end over raw strings."""

import numpy as np
import pytest

import versalignlib_tpu as val
from versalignlib_tpu import Algorithm, AlignmentEngine, AlignmentParameters


def test_engine_score_and_align_strings():
    engine = AlignmentEngine(backend="xla")
    reads = ["ACGTACGT", "TTTT", "acgt"]
    refs = ["ACGTACGT", "GGGGTTTTGGGG", "ACGT"]
    scores = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
    np.testing.assert_array_equal(scores, [16, 8, 8])
    alns = engine.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
    assert alns[0].cigar == "8M"
    assert alns[1].read == "TTTT"
    assert alns[1].ref == "TTTT"


def test_engine_validates_counts():
    engine = AlignmentEngine(backend="oracle")
    with pytest.raises(ValueError):
        engine.score_alignments(Algorithm.SMITH_WATERMAN, ["ACGT"], ["ACGT", "ACGT"])


def test_engine_backend_registry():
    assert "oracle" in val.available_backends()
    assert "xla" in val.available_backends()
    with pytest.raises(KeyError):
        val.get_backend("nonexistent")


def test_engine_auto_backend():
    engine = AlignmentEngine(backend="auto")
    # auto must pick something that works
    scores = engine.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, ["ACGT"], ["TTACGT"])
    assert scores[0] == 8


def test_params_interface():
    p = AlignmentParameters()
    assert p.param_int("score_match") == 2
    assert p.has_key("score_gap_read")
    assert not p.has_key("bogus")
    with pytest.raises(KeyError):
        p.param_int("bogus")
    with pytest.raises(ValueError):
        AlignmentParameters(score_gap_read=1)


def test_empty_and_degenerate_batches():
    import numpy as np

    from versalignlib_tpu.ops.pallas_backend import PallasBackend
    from versalignlib_tpu.params import DEFAULT_PARAMETERS

    eng = AlignmentEngine(backend="xla")
    assert eng.score_alignments(Algorithm.SMITH_WATERMAN, [], []).shape == (0,)
    assert eng.compute_alignments(Algorithm.SMITH_WATERMAN, [], []) == []
    np.testing.assert_array_equal(
        eng.score_alignments(Algorithm.SMITH_WATERMAN, ["", "ACGT"], ["ACGT", "ACGT"]),
        [0, 8],
    )
    np.testing.assert_array_equal(
        eng.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, ["", ""], ["", ""]), [0, 0]
    )
    pb = PallasBackend(interpret=True)
    out = pb.score_alignments(
        Algorithm.SMITH_WATERMAN, np.zeros((0, 5), np.uint8),
        np.zeros((0, 5), np.uint8), DEFAULT_PARAMETERS,
    )
    assert out.shape == (0,)


def test_auto_backend_skips_interpret_pallas_on_cpu():
    # On the CPU test mesh, "auto" must not pick the (interpreter-mode)
    # Pallas backend — the XLA scan backend is the fast portable choice.
    import versalignlib_tpu as val

    assert val.get_backend("auto").name == "xla"
    # Explicit selection still works.
    assert val.get_backend("pallas").name == "pallas"


@pytest.mark.parametrize("platform,want", [("gpu", "pallas"), ("cpu", "xla")])
def test_auto_backend_routes_by_capability(monkeypatch, platform, want):
    """"auto" picks the GPU kernel backend only where it compiles (a CUDA
    device), and no backend turns the interpreter on by itself."""
    from versalignlib_tpu import dispatch
    from versalignlib_tpu.ops.pallas_backend import PallasBackend
    from versalignlib_tpu.utils import capabilities
    from versalignlib_tpu.utils.capabilities import DeviceCapabilities

    caps = DeviceCapabilities(platform, "fake " + platform, 1,
                              80 << 30 if platform == "gpu" else None)
    monkeypatch.setattr(capabilities, "probe", lambda: caps)
    monkeypatch.setattr("versalignlib_tpu.ops.pallas_backend.probe",
                        lambda: caps)
    monkeypatch.setattr(dispatch._REGISTRY["pallas"], "instance", None)
    assert dispatch.get_backend("auto").name == want
    assert PallasBackend().interpret is False
    assert PallasBackend().is_available() == (platform == "gpu")
    assert PallasBackend(interpret=True).is_available()


def test_cross_backend_consistency_sweep():
    """All backends agree on random shapes/params (scores + alignments)."""
    import numpy as np

    from tests.conftest import random_codes
    from versalignlib_tpu import AlignmentParameters, get_backend
    from versalignlib_tpu.ops.pallas_backend import PallasBackend
    from versalignlib_tpu.types import TieBreak

    rng = np.random.default_rng(99)
    backends = [get_backend("oracle"), get_backend("xla"),
                PallasBackend(interpret=True)]
    for trial in range(4):
        p = AlignmentParameters(
            score_match=int(rng.integers(1, 4)),
            score_mismatch=-int(rng.integers(1, 4)),
            score_gap_read=-int(rng.integers(1, 4)),
            score_gap_ref=-int(rng.integers(1, 4)),
        )
        b = int(rng.integers(3, 10))
        mlen = int(rng.integers(2, 24))
        nlen = int(rng.integers(2, 24))
        reads = random_codes(rng, b, mlen, padded=True, n_prob=0.1)
        refs = random_codes(rng, b, nlen, padded=True, n_prob=0.1)
        for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
            scores = [bk.score_alignments(algorithm, reads, refs, p) for bk in backends]
            np.testing.assert_array_equal(scores[0], scores[1], err_msg=str((trial, algorithm)))
            np.testing.assert_array_equal(scores[0], scores[2], err_msg=str((trial, algorithm)))
            alns = [bk.compute_alignments(algorithm, reads, refs, p, TieBreak.DIAG_UP_LEFT)
                    for bk in backends]
            for a0, a1, a2 in zip(*alns):
                assert (a0.read, a0.ref, a0.score, a0.cigar) == \
                       (a1.read, a1.ref, a1.score, a1.cigar) == \
                       (a2.read, a2.ref, a2.score, a2.cigar), (trial, algorithm)


def test_cross_backend_consistency_sweep_extended():
    """Randomized agreement sweep over the ADDITIVE surfaces: affine gaps,
    custom matrices, and banded align — every trial draws params/shapes and
    checks oracle == xla == pallas (and band scan == banded oracle)."""
    import numpy as np

    from tests.conftest import random_codes
    from versalignlib_tpu import AlignmentParameters, get_backend
    from versalignlib_tpu.ops.banded import (band_offsets, banded_align_batch,
                                             banded_align_oracle)
    from versalignlib_tpu.ops.pallas_backend import PallasBackend
    from versalignlib_tpu.types import TieBreak

    rng = np.random.default_rng(1234)
    backends = [get_backend("oracle"), get_backend("xla"),
                PallasBackend(interpret=True)]
    for trial in range(4):
        affine = bool(rng.integers(0, 2))
        use_matrix = bool(rng.integers(0, 2))
        matrix = None
        if use_matrix:
            mm = rng.integers(-3, 4, size=(6, 6))
            np.fill_diagonal(mm, rng.integers(2, 6, size=6))
            mm[0, :] = 0
            mm[:, 0] = 0
            matrix = tuple(tuple(int(v) for v in r) for r in mm)
        p = AlignmentParameters(
            score_match=int(rng.integers(1, 4)),
            score_mismatch=-int(rng.integers(1, 4)),
            score_gap_read=-int(rng.integers(1, 4)),
            score_gap_ref=-int(rng.integers(1, 4)),
            gap_open_read=-int(rng.integers(1, 5)) if affine else 0,
            gap_open_ref=-int(rng.integers(1, 5)) if affine else 0,
            matrix=matrix,
        )
        b = int(rng.integers(3, 8))
        mlen = int(rng.integers(6, 24))
        nlen = int(rng.integers(6, 28))
        reads = random_codes(rng, b, mlen, padded=True, n_prob=0.1)
        refs = random_codes(rng, b, nlen, padded=True, n_prob=0.1)
        ctx = (trial, affine, use_matrix)
        for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
            scores = [bk.score_alignments(algorithm, reads, refs, p)
                      for bk in backends]
            np.testing.assert_array_equal(scores[0], scores[1], err_msg=str(ctx))
            np.testing.assert_array_equal(scores[0], scores[2], err_msg=str(ctx))
            alns = [bk.compute_alignments(algorithm, reads, refs, p,
                                          TieBreak.DIAG_UP_LEFT)
                    for bk in backends]
            for a0, a1, a2 in zip(*alns):
                assert (a0.read, a0.ref, a0.score, a0.cigar) == \
                       (a1.read, a1.ref, a1.score, a1.cigar) == \
                       (a2.read, a2.ref, a2.score, a2.cigar), ctx

            # banded align vs its oracle at a random band
            band = int(rng.integers(4, nlen + 1))
            offs = band_offsets(mlen, mlen, nlen, min(band, nlen))
            got = banded_align_batch(reads, refs, p, algorithm, band=band)
            want = [banded_align_oracle(r, f, p, min(band, nlen), algorithm, offs)
                    for r, f in zip(reads, refs)]
            for g, w in zip(got, want):
                assert (g.read, g.ref, g.score, g.cigar) == \
                    (w.read, w.ref, w.score, w.cigar), (ctx, band)
