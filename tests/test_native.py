"""Native C++ decoder vs pure-Python decoder equivalence."""

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu import native
from versalignlib_tpu.ops import oracle
from versalignlib_tpu.ops.xla import align_batch
from versalignlib_tpu.ops import traceback as tb
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, TieBreak

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH])
def test_native_matches_python_decode(rng, default_params, algorithm):
    import jax.numpy as jnp

    reads = random_codes(rng, 32, 17, padded=True, n_prob=0.05)
    refs = random_codes(rng, 32, 23, padded=True, n_prob=0.05)
    ptr, sr, sf, best = align_batch(
        jnp.asarray(reads), jnp.asarray(refs), default_params, algorithm,
        TieBreak.DIAG_UP_LEFT,
    )
    ptr, sr, sf, best = map(np.asarray, (ptr, sr, sf, best))
    scores = best if algorithm == Algorithm.SMITH_WATERMAN else best
    got = native.decode_batch_native(
        ptr, reads, refs, sr, sf, default_params, algorithm, scores
    )
    want = [
        tb.decode_one(ptr[i], reads[i], refs[i], int(sr[i]), int(sf[i]),
                      default_params, algorithm, int(scores[i]))
        for i in range(len(reads))
    ]
    for g, w in zip(got, want):
        assert g == w, (g, w)


def test_native_dense_plane_matches_oracle(rng, default_params):
    from versalignlib_tpu.ops.xla import align_pairs

    reads = random_codes(rng, 16, 12, padded=True)
    refs = random_codes(rng, 16, 16, padded=True)
    # align_pairs routes the (B, m, n) plane through the native decoder.
    got = align_pairs(
        reads, refs, default_params, Algorithm.SMITH_WATERMAN,
        TieBreak.DIAG_UP_LEFT,
    )
    want = oracle.compute_alignments(
        Algorithm.SMITH_WATERMAN, reads, refs, default_params
    )
    for g, w in zip(got, want):
        assert (g.read, g.ref, g.score, g.cigar) == (w.read, w.ref, w.score, w.cigar)


def test_native_texts_preserved(default_params):
    from versalignlib_tpu.alphabet import encode
    from versalignlib_tpu.ops.xla import align_pairs

    reads = np.stack([encode("acGTac")])
    refs = np.stack([encode("ACgtAC")])
    got = align_pairs(
        reads, refs, default_params, Algorithm.SMITH_WATERMAN,
        TieBreak.DIAG_UP_LEFT,
        read_texts=["acGTac"], ref_texts=["ACgtAC"],
    )
    assert got[0].read == "acGTac"
    assert got[0].ref == "ACgtAC"


def test_native_fasta_matches_python(tmp_path):
    from versalignlib_tpu.alphabet import pad_and_encode
    from versalignlib_tpu.io.fasta import parse_fasta

    fa = tmp_path / "z.fa"
    fa.write_text(
        ">a\nACGTacgt\nNNTT\n>bad\nAC GT\n>b\nGGGG\n\nignored\n>c desc\nc\n"
    )
    codes, lengths = native.parse_fasta_codes(fa)
    seqs = parse_fasta(fa)
    want = pad_and_encode(seqs)
    assert codes.shape == want.shape
    np.testing.assert_array_equal(codes, want)
    assert list(lengths) == [len(s) for s in seqs]


def test_native_fasta_missing_file(tmp_path):
    with pytest.raises(OSError):
        native.parse_fasta_codes(tmp_path / "nope.fa")


def test_native_decoder_fuzz_vs_python(rng, default_params):
    """Random pointer matrices + random start cells: native == python walk."""
    from versalignlib_tpu.ops import traceback as tb

    for trial in range(20):
        m = int(rng.integers(1, 20))
        n = int(rng.integers(1, 20))
        b = 8
        ptr = rng.integers(0, 4, size=(b, m, n)).astype(np.uint8)
        reads = rng.integers(0, 6, size=(b, m)).astype(np.uint8)
        refs = rng.integers(0, 6, size=(b, n)).astype(np.uint8)
        sr = rng.integers(-1, m, size=b).astype(np.int32)
        sf = rng.integers(-1, n, size=b).astype(np.int32)
        for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
            got = native.decode_batch_native(
                ptr, reads, refs, sr, sf, default_params, algorithm, None
            )
            want = [
                tb.decode_one(ptr[i], reads[i], refs[i], int(sr[i]), int(sf[i]),
                              default_params, algorithm, None)
                for i in range(b)
            ]
            for g, w in zip(got, want):
                assert g == w, (trial, algorithm, g, w)


def test_raw_alignment_batch_matches_objects(rng, default_params):
    # raw=True column store must materialize identical Alignments lazily.
    import io as _io

    from tests.conftest import random_codes
    from versalignlib_tpu import native
    from versalignlib_tpu.ops.xla import align_pairs
    from versalignlib_tpu.types import Algorithm, TieBreak

    if not native.available():
        pytest.skip("native library unavailable")
    reads = random_codes(rng, 20, 14, padded=True)
    refs = random_codes(rng, 20, 18, padded=True)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        objs = align_pairs(reads, refs, default_params, alg,
                           TieBreak.DIAG_UP_LEFT)
        batch = align_pairs(reads, refs, default_params, alg,
                            TieBreak.DIAG_UP_LEFT, raw=True)
        assert len(batch) == len(objs)
        np.testing.assert_array_equal(batch.scores, [a.score for a in objs])
        for got, want in zip(batch, objs):
            assert (got.read, got.ref, got.score, got.cigar,
                    got.read_start, got.ref_start) == \
                (want.read, want.ref, want.score, want.cigar,
                 want.read_start, want.ref_start)
        buf = _io.StringIO()
        batch.write_to(buf)
        lines = buf.getvalue().splitlines()
        assert len(lines) == 3 * len(objs)
        assert lines[0] == objs[0].read and lines[1] == objs[0].ref


def test_raw_affine_batch_matches_objects(rng):
    # The affine dense path's raw column store (API parity with the linear
    # and banded raw modes).
    from tests.conftest import random_codes
    from versalignlib_tpu import native
    from versalignlib_tpu.ops.xla import align_pairs
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.types import Algorithm, TieBreak

    if not native.available():
        pytest.skip("native library unavailable")
    p = AlignmentParameters(score_match=2, score_mismatch=-1,
                            score_gap_read=-1, score_gap_ref=-1,
                            gap_open_read=-4, gap_open_ref=-4)
    reads = random_codes(rng, 16, 14, padded=True)
    refs = random_codes(rng, 16, 18, padded=True)
    for alg in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        objs = align_pairs(reads, refs, p, alg, TieBreak.DIAG_UP_LEFT)
        batch = align_pairs(reads, refs, p, alg, TieBreak.DIAG_UP_LEFT,
                            raw=True)
        assert len(batch) == len(objs)
        np.testing.assert_array_equal(batch.scores, [a.score for a in objs])
        for got, want in zip(batch, objs):
            assert (got.read, got.ref, got.score, got.cigar,
                    got.read_start, got.ref_start) == \
                (want.read, want.ref, want.score, want.cigar,
                 want.read_start, want.ref_start)
