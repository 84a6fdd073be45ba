"""Position-specific scoring (ops/pssm.py): oracle and device-scan parity.

The oracle is the established numpy fills with a precomputed sub plane, so
the key gates are (a) a PSSM built from a single sequence reproduces plain
sequence scoring bit-for-bit, and (b) the device profile scan equals the
oracle on random profiles/pools across algorithms, gap models, entry
ranges, and invalid codes.
"""

import numpy as np
import pytest

from versalignlib_tpu.ops import oracle
from versalignlib_tpu.ops.pssm import (profile_search, profile_sub_plane,
                                       pssm_from_sequences,
                                       pssm_scores_device,
                                       score_profile_oracle, validate_pssm)
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm

P_LIN = AlignmentParameters()
P_AFF = AlignmentParameters(gap_open_read=-4, gap_open_ref=-4)


def _rand_pssm(rng, m, s, lo, hi):
    P = rng.integers(lo, hi + 1, size=(m, s)).astype(np.int32)
    P[:, 0] = 0
    return P


def test_validate_rejects_bad_tables():
    with pytest.raises(ValueError):
        validate_pssm(np.zeros((4,), dtype=np.int32))
    bad = np.ones((4, 6), dtype=np.int32)
    with pytest.raises(ValueError):
        validate_pssm(bad)  # col 0 nonzero
    with pytest.raises(ValueError):
        pssm_scores_device(bad, np.ones((2, 3), np.uint8), P_LIN,
                           Algorithm.SMITH_WATERMAN)


@pytest.mark.parametrize("lo,hi", [(-4, 11), (-600, 1000)])
def test_pack_extract_roundtrip(rng, lo, hi):
    """A one-row profile scores each code's own entry (0 outside the
    table): the device gather == profile_sub_plane, any entry range."""
    codes = np.arange(256, dtype=np.uint8)
    for s in (4, 6, 25):
        P = _rand_pssm(rng, 1, s, lo, hi)
        got = np.asarray(pssm_scores_device(
            P, codes[:, None], AlignmentParameters(score_gap_read=-1,
                                                   score_gap_ref=-1),
            Algorithm.NEEDLEMAN_WUNSCH))
        want = np.maximum(profile_sub_plane(P, codes)[0], 0)
        assert np.array_equal(got, want), s


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("params", [P_LIN, P_AFF])
def test_single_sequence_profile_reduces_to_sequence_scoring(
        rng, algorithm, params):
    """P[i, s] = match/mismatch of read[i] vs s == plain sequence scores."""
    reads = rng.integers(0, 7, size=(5, 11)).astype(np.uint8)
    refs = rng.integers(0, 7, size=(16, 14)).astype(np.uint8)
    want_all = oracle.score_alignments(algorithm, np.repeat(reads, 16, 0),
                                       np.tile(refs, (5, 1)), params)
    for ri, read in enumerate(reads):
        P = np.zeros((read.size, 6), dtype=np.int32)
        for i, c in enumerate(read):
            if 1 <= c <= 4:
                for s in range(1, 5):
                    P[i, s] = (params.score_match if s == c
                               else params.score_mismatch)
        got = score_profile_oracle(P, refs, params, algorithm)
        assert np.array_equal(got, want_all[ri * 16:(ri + 1) * 16]), ri


@pytest.mark.parametrize("algorithm", [Algorithm.SMITH_WATERMAN,
                                       Algorithm.NEEDLEMAN_WUNSCH])
@pytest.mark.parametrize("params", [P_LIN, P_AFF])
@pytest.mark.parametrize("lo,hi,s", [(-4, 11, 6), (-30, 90, 25)])
def test_kernel_matches_oracle(rng, algorithm, params, lo, hi, s):
    P = _rand_pssm(rng, 9, s, lo, hi)
    pool = rng.integers(0, min(s + 3, 28), size=(37, 13)).astype(np.uint8)
    got = np.asarray(pssm_scores_device(P, pool, params, algorithm))
    want = score_profile_oracle(P, pool, params, algorithm)
    assert np.array_equal(got, want)


def test_kernel_multi_block_and_odd_shapes(rng):
    """A large pool + odd lengths."""
    P = _rand_pssm(rng, 5, 6, -3, 5)
    pool = rng.integers(0, 7, size=(1061, 7)).astype(np.uint8)
    got = np.asarray(pssm_scores_device(P, pool, P_LIN,
                                        Algorithm.SMITH_WATERMAN))
    want = score_profile_oracle(P, pool, P_LIN, Algorithm.SMITH_WATERMAN)
    assert np.array_equal(got, want)


def test_profile_sub_plane_outside_codes():
    P = np.zeros((3, 6), dtype=np.int32)
    P[:, 1] = 7
    ref = np.array([1, 5, 6, 200, 0], dtype=np.int32)
    plane = profile_sub_plane(P, ref)
    assert plane[0].tolist() == [7, 0, 0, 0, 0]


def test_pssm_from_sequences_and_search(rng):
    """Planted motif instances rank above random pool entries end-to-end."""
    from versalignlib_tpu.alphabet import pad_and_encode

    motif = "ACGTACGTGGCC"
    insts = []
    for _ in range(40):
        seq = list(motif)
        j = int(rng.integers(0, len(seq)))
        seq[j] = "ACGT"[int(rng.integers(0, 4))]
        insts.append("".join(seq))
    P = pssm_from_sequences(pad_and_encode(insts))
    assert P.shape == (len(motif), 6) and np.all(P[:, 0] == 0)
    assert P[0, 1] > 0  # consensus A scores positive

    pool = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(50)]
    planted = sorted(int(i) for i in rng.choice(50, size=5, replace=False))
    for i in planted:
        s = pool[i]
        pool[i] = s[:9] + motif + s[9 + len(motif):]
    scores, idx = profile_search(P, pool, k=5)
    assert sorted(int(i) for i in idx) == planted
    # Backend parity on the same pool.
    s2, i2 = profile_search(P, pool, k=5, backend="oracle")
    assert np.array_equal(scores, s2) and np.array_equal(idx, i2)


def test_cli_pssm_mode(rng, tmp_path):
    """--pssm-from end-to-end: build profile, scan panel, write TSV."""
    from versalignlib_tpu.cli import main

    motif = "ACGTACGTGGCC"
    with open(tmp_path / "motif.fa", "w") as f:
        for k in range(30):
            s = list(motif)
            s[int(rng.integers(0, len(s)))] = "ACGT"[int(rng.integers(0, 4))]
            f.write(f">inst{k}\n{''.join(s)}\n")
    pool = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(30)]
    for i in (3, 17):
        pool[i] = pool[i][:10] + motif + pool[i][10 + len(motif):]
    with open(tmp_path / "panel.fa", "w") as f:
        for i, s in enumerate(pool):
            f.write(f">p{i}\n{s}\n")
    rc = main(["--pssm-from", str(tmp_path / "motif.fa"),
               "--panel", str(tmp_path / "panel.fa"),
               "--outdir", str(tmp_path), "--top", "2"])
    assert rc == 0
    lines = (tmp_path / "hits_pssm.tsv").read_text().splitlines()
    assert lines[0] == ("rank\tpanel_index\tpanel_name\tscore\tstart\tend"
                        "\tprofile_span\tcigar")
    top = sorted(int(line.split("\t")[1]) for line in lines[1:])
    assert top == [3, 17]
    # planted motif coordinates: ref span starts at the plant position 10
    for line in lines[1:]:
        cols = line.split("\t")
        assert int(cols[4]) == 10 and int(cols[5]) >= 10


def test_multi_profile_search(rng):
    """Multi-profile search == per-profile runs, mixed shapes included."""
    Ps = [_rand_pssm(rng, 8, 6, -4, 9) for _ in range(3)]
    Ps.append(_rand_pssm(rng, 11, 9, -4, 9))   # another (m, S)
    pool = rng.integers(0, 7, size=(70, 21)).astype(np.uint8)
    res = profile_search(Ps, pool, k=4)
    for i, P in enumerate(Ps):
        s1, i1 = profile_search(P, pool, k=4)
        assert np.array_equal(res[i][0], s1) and np.array_equal(res[i][1], i1)
        want = score_profile_oracle(P, pool, P_LIN, Algorithm.SMITH_WATERMAN)
        s_o, i_o = profile_search(P, pool, k=4, backend="oracle")
        assert np.array_equal(s1, s_o) and np.array_equal(i1, i_o), i
        assert np.array_equal(np.sort(want)[::-1][:4], s1), i


def test_calibrate_profile_separates_planted(rng):
    """Profile E-values: planted motif hits get tiny E, random pool large."""
    from versalignlib_tpu.ops.pssm import calibrate_profile

    motif = "TATAAAGGCGCCTTAA"
    insts = []
    for _ in range(60):
        s = list(motif)
        s[int(rng.integers(0, len(s)))] = "ACGT"[int(rng.integers(0, 4))]
        insts.append("".join(s))
    from versalignlib_tpu.alphabet import pad_and_encode

    P = pssm_from_sequences(pad_and_encode(insts))
    cal = calibrate_profile(P, n=64, samples=256, backend="oracle")
    assert cal.lam > 0 and cal.k > 0

    pool = ["".join(rng.choice(list("ACGT"), size=64)) for _ in range(24)]
    pool[7] = pool[7][:20] + motif + pool[7][20 + len(motif):]
    scores, idx = profile_search(P, pool, k=24, backend="oracle")
    ev = {int(i): cal.evalue(int(s), P.shape[0], 24 * 64)
          for s, i in zip(scores, idx)}
    others = [e for i, e in ev.items() if i != 7]
    assert ev[7] < 1e-3
    assert ev[7] < min(others) / 100


def test_cli_pssm_stats(rng, tmp_path):
    """--pssm-from --stats adds bitscore/evalue columns."""
    from versalignlib_tpu.cli import main

    motif = "ACGTACGTGGCC"
    with open(tmp_path / "motif.fa", "w") as f:
        for k in range(20):
            f.write(f">i{k}\n{motif}\n")
    pool = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(12)]
    pool[4] = pool[4][:10] + motif + pool[4][10 + len(motif):]
    with open(tmp_path / "panel.fa", "w") as f:
        for i, s in enumerate(pool):
            f.write(f">p{i}\n{s}\n")
    rc = main(["--pssm-from", str(tmp_path / "motif.fa"),
               "--panel", str(tmp_path / "panel.fa"),
               "--outdir", str(tmp_path), "--top", "2", "--stats",
               "--stats-samples", "96", "--backend", "oracle"])
    assert rc == 0
    lines = (tmp_path / "hits_pssm.tsv").read_text().splitlines()
    assert lines[0].endswith("bitscore\tevalue")
    top = lines[1].split("\t")
    assert int(top[1]) == 4 and float(top[9]) < 0.05


def test_profile_search_chunked_matches_single_sweep(rng):
    """Pool chunking is invisible: same top-k as one sweep (both modes)."""
    P = _rand_pssm(rng, 6, 6, -3, 6)
    P2 = _rand_pssm(rng, 6, 6, -3, 6)
    pool = rng.integers(0, 7, size=(53, 11)).astype(np.uint8)
    a = profile_search(P, pool, k=7, chunk=8)
    b = profile_search(P, pool, k=7)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    am = profile_search([P, P2], pool, k=7, chunk=10)
    bm = profile_search([P, P2], pool, k=7)
    for (s1, i1), (s2, i2) in zip(am, bm):
        assert np.array_equal(s1, s2) and np.array_equal(i1, i2)


# ---------------------------------------------------------------------------
# Hit coordinates + traceback (round-5 full-interface parity)
# ---------------------------------------------------------------------------

def test_device_coords_match_oracle_argmax(rng):
    """The device scan's argmax fold == the oracle's row-major
    strict-first-win scan, linear and affine."""
    from versalignlib_tpu.ops.pssm import profile_argmax_oracle

    P = _rand_pssm(rng, 17, 6, -4, 9)
    pool = rng.integers(0, 7, size=(70, 33)).astype(np.uint8)
    for p in (P_LIN, P_AFF):
        s, r, c = pssm_scores_device(P, pool, p, Algorithm.SMITH_WATERMAN,
                                     with_coords=True)
        so, ro, co = profile_argmax_oracle(P, pool, p)
        assert np.array_equal(np.asarray(s), so)
        assert np.array_equal(np.asarray(r), ro)
        assert np.array_equal(np.asarray(c), co)


def test_profile_hits_and_alignments(rng):
    """hits=True returns coordinates; alignments walk back to a consistent
    start and reproduce the score; device and oracle backends agree."""
    P = _rand_pssm(rng, 12, 6, -3, 8)
    pool = rng.integers(0, 7, size=(40, 25)).astype(np.uint8)
    hd = profile_search(P, pool, k=6, backend="auto", hits=True,
                        alignments=True)
    ho = profile_search(P, pool, k=6, backend="oracle", hits=True,
                        alignments=True)
    for a, b in zip(hd, ho):
        assert (a.index, a.score, a.end_row, a.end_col) == \
            (b.index, b.score, b.end_row, b.end_col)
        assert a.alignment.cigar == b.alignment.cigar
        assert a.alignment.score == a.score
        # end coords are the walk start: ref_end is exclusive
        assert a.alignment.ref_end - 1 == a.end_col
        assert a.alignment.read_end - 1 == a.end_row


def test_profile_hit_alignment_rescored(rng):
    """The emitted gapped alignment re-scores to the reported score under
    the profile model (sub from P rows, linear gaps)."""
    from versalignlib_tpu.ops.pssm import profile_consensus_text

    P = _rand_pssm(rng, 10, 6, -3, 7)
    pool = rng.integers(1, 5, size=(30, 22)).astype(np.uint8)
    hits = profile_search(P, pool, k=4, backend="oracle", hits=True,
                          alignments=True)
    cons = profile_consensus_text(P)
    table = "\0ATCGN"
    for h in hits:
        a = h.alignment
        rp, fp = a.read_start, a.ref_start
        total = 0
        for rc, fc in zip(a.read, a.ref):
            if rc == "-":
                total += P_LIN.score_gap_read
                fp += 1
            elif fc == "-":
                total += P_LIN.score_gap_ref
                rp += 1
            else:
                assert rc == cons[rp]
                code = int(pool[h.index][fp])
                total += int(P[rp][code]) if code < 6 else 0
                rp += 1
                fp += 1
        assert total == h.score


def test_profile_hits_multi_and_evalue(rng):
    """Multi-profile hits mode + calibration columns."""
    from versalignlib_tpu.ops.pssm import calibrate_profile

    P1 = _rand_pssm(rng, 8, 6, -2, 6)
    P2 = _rand_pssm(rng, 8, 6, -2, 6)
    pool = rng.integers(1, 5, size=(25, 20)).astype(np.uint8)
    cal = calibrate_profile(P1, P_LIN, n=20, samples=64, backend="oracle")
    out = profile_search([P1, P2], pool, k=3, backend="auto", hits=True,
                         calibration=cal)
    assert len(out) == 2 and len(out[0]) == 3
    for hits in out:
        assert all(h.evalue is not None and h.bitscore is not None
                   for h in hits)
        # E-values are monotone decreasing in score within a hit list
        ss = [h.score for h in hits]
        es = [h.evalue for h in hits]
        assert all(e1 <= e2 * (1 + 1e-9) for (s1, e1), (s2, e2)
                   in zip(zip(ss, es), zip(ss[1:], es[1:])) if s1 >= s2)


def test_profile_hits_nw_rejected(rng):
    P = _rand_pssm(rng, 8, 6, -2, 6)
    pool = rng.integers(1, 5, size=(10, 16)).astype(np.uint8)
    with pytest.raises(ValueError):
        profile_search(P, pool, algorithm=Algorithm.NEEDLEMAN_WUNSCH,
                       hits=True)
