"""One-vs-many search scores: bit-exact vs the oracle cross product.

The device path tiles the read x panel pairs on the device and scores them
through the resolved score path (the XLA scan here on the CPU).
"""

import numpy as np
import pytest

from versalignlib_tpu.ops import oracle
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.search import _cross_scores
from versalignlib_tpu.types import Algorithm

ALGOS = (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH)

PARAM_SETS = [
    AlignmentParameters(),
    AlignmentParameters(score_match=3, score_mismatch=-2,
                        score_gap_read=-2, score_gap_ref=-4),
    AlignmentParameters(gap_open_read=-5, gap_open_ref=-5),   # affine
]


def _oracle_cross(algo, reads, refs, p):
    b, r = reads.shape[0], refs.shape[0]
    rr = np.repeat(reads, r, axis=0)
    ff = np.tile(refs, (b, 1))
    if p.affine:
        from versalignlib_tpu.ops import gotoh

        return gotoh.score_alignments_affine(algo, rr, ff, p).reshape(b, r)
    return oracle.score_alignments(algo, rr, ff, p).reshape(b, r)


@pytest.mark.parametrize("params", PARAM_SETS)
@pytest.mark.parametrize("algo", ALGOS)
def test_cross_scores_exact_both_orientations(rng, params, algo):
    # b > r and r > b; codes include 0 (padding) and 5 (N) to cover the
    # full 6x6 semantics.
    for b, m, r, n in ((13, 17, 4, 9), (3, 9, 21, 12)):
        reads = rng.integers(0, 6, size=(b, m)).astype(np.uint8)
        refs = rng.integers(0, 6, size=(r, n)).astype(np.uint8)
        got = np.asarray(_cross_scores(reads, refs, params, algo, "xla"))
        want = _oracle_cross(algo, reads, refs, params)
        assert np.array_equal(got, want), (b, r, algo, params.affine)


def test_cross_scores_matrix_mode(rng):
    mat = tuple(tuple(int(3 if (a == s and a) else (-2 if a and s else 0))
                      for s in range(6)) for a in range(6))
    p = AlignmentParameters(score_gap_read=-3, score_gap_ref=-3, matrix=mat)
    reads = rng.integers(0, 6, size=(6, 11)).astype(np.uint8)
    refs = rng.integers(0, 6, size=(10, 14)).astype(np.uint8)
    got = np.asarray(_cross_scores(reads, refs, p, Algorithm.SMITH_WATERMAN,
                                   "xla"))
    want = _oracle_cross(Algorithm.SMITH_WATERMAN, reads, refs, p)
    assert np.array_equal(got, want)


def test_search_path_uses_kernel(rng, default_params):
    """score_matrix/best_hits with impl='xla' route through the tiled
    cross product and still match the oracle exactly."""
    from versalignlib_tpu.search import best_hits, score_matrix

    reads = rng.integers(1, 5, size=(9, 20)).astype(np.uint8)
    panel = rng.integers(1, 5, size=(5, 24)).astype(np.uint8)
    got = score_matrix(reads, panel, default_params, impl="xla")
    want = _oracle_cross(Algorithm.SMITH_WATERMAN, reads, panel,
                         default_params)
    assert np.array_equal(got, want)
    arg, best, _ = best_hits(reads, panel, default_params, impl="xla",
                             align=False)
    assert np.array_equal(arg, want.argmax(axis=1))
    assert np.array_equal(best, want.max(axis=1))


def test_score_impl_routing(monkeypatch):
    """impl='auto' picks the GPU kernel only on a CUDA device; explicit
    impls pass through; unknown names are rejected."""
    from versalignlib_tpu import dispatch
    from versalignlib_tpu.ops import triton_score, xla
    from versalignlib_tpu.utils import capabilities
    from versalignlib_tpu.utils.capabilities import DeviceCapabilities

    gpu = DeviceCapabilities("gpu", "NVIDIA H100 80GB HBM3", 1, 80 << 30)
    cpu = DeviceCapabilities("cpu", "cpu", 8, None)
    for caps, want in ((gpu, "pallas"), (cpu, "xla")):
        monkeypatch.setattr(capabilities, "probe", lambda c=caps: c)
        assert dispatch.resolve_score_impl() == want
        assert dispatch.resolve_score_impl("xla") == "xla"
    assert dispatch.device_score_fn("pallas") is triton_score.score_batch_triton
    assert dispatch.device_score_fn("xla") is xla.score_batch
    with pytest.raises(ValueError, match="impl"):
        dispatch.resolve_score_impl("mosaic")


def test_search_kernel_under_mesh(rng, default_params):
    """shard_map + the tiled cross product on the CPU mesh."""
    from versalignlib_tpu.parallel import make_mesh
    from versalignlib_tpu.search import score_matrix

    mesh = make_mesh(8)
    reads = rng.integers(1, 5, size=(11, 16)).astype(np.uint8)
    panel = rng.integers(1, 5, size=(3, 16)).astype(np.uint8)
    got = score_matrix(reads, panel, default_params, impl="xla", mesh=mesh)
    want = _oracle_cross(Algorithm.SMITH_WATERMAN, reads, panel,
                         default_params)
    assert np.array_equal(got, want)
