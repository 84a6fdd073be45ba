"""FASTA I/O, model families, CLI, capabilities, checkpoint, profiling."""

import io
import json

import numpy as np
import pytest

from tests.conftest import random_codes
from versalignlib_tpu.io.fasta import parse_fasta, parse_fasta_with_names, write_fasta
from versalignlib_tpu.models import (
    affine_smith_waterman,
    banded_needleman_wunsch,
    needleman_wunsch,
    smith_waterman,
)
from versalignlib_tpu.ops import oracle
from versalignlib_tpu.types import Algorithm
from versalignlib_tpu.utils.checkpoint import ScoreCheckpoint, run_scored_batch
from versalignlib_tpu.utils.profiling import GcupsMeter


# --- FASTA -----------------------------------------------------------------

def test_parse_fasta_basic():
    fa = io.StringIO(">a\nACGT\nTTTT\n>b\nGGGG\n")
    assert parse_fasta(fa) == ["ACGTTTTT", "GGGG"]


def test_parse_fasta_space_discards_record():
    # Reference behavior (versalignUtil.h:76-81): a space kills the record.
    fa = io.StringIO(">a\nACG T\nACGT\n>b\nCCCC\n")
    assert parse_fasta(fa) == ["CCCC"]


def test_parse_fasta_empty_line_terminates_record():
    fa = io.StringIO(">a\nACGT\n\nTTTT\n>b\nGG\n")
    # ACGT flushed at the blank line; TTTT ignored (no active record).
    assert parse_fasta(fa) == ["ACGT", "GG"]


def test_parse_fasta_no_trailing_newline(tmp_path):
    p = tmp_path / "x.fa"
    p.write_text(">a\nACGT")
    assert parse_fasta(p) == ["ACGT"]


def test_fasta_roundtrip(tmp_path):
    p = tmp_path / "y.fa"
    write_fasta(p, ["ACGT" * 30, "TT"], names=["r1", "r2"])
    assert parse_fasta(p) == ["ACGT" * 30, "TT"]
    assert parse_fasta_with_names(p)[0][0] == "r1"


# --- models ----------------------------------------------------------------

def test_model_families(rng, default_params):
    reads = random_codes(rng, 8, 12)
    refs = random_codes(rng, 8, 14)
    sw = smith_waterman()
    scores = sw.score(reads, refs, backend="xla")
    want = oracle.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs, default_params)
    np.testing.assert_array_equal(scores, want)
    alns = sw.align(reads, refs, backend="xla")
    assert [a.score for a in alns] == [int(s) for s in scores]

    nw = needleman_wunsch()
    np.testing.assert_array_equal(
        nw.score(reads, refs, backend="xla"),
        oracle.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs, default_params),
    )


def test_affine_model():
    m = affine_smith_waterman(gap_open=-4, gap_extend=-1)
    s = m.score(["ACGTACGTAC"], ["ACGCGTAC"], backend="xla")
    a = m.align(["ACGTACGTAC"], ["ACGCGTAC"], backend="xla")
    assert int(s[0]) == a[0].score


def test_banded_model(rng, default_params):
    reads = random_codes(rng, 4, 40)
    refs = random_codes(rng, 4, 40)
    m = banded_needleman_wunsch(band=40)
    got = m.score(reads, refs)
    want = oracle.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs, default_params)
    np.testing.assert_array_equal(got, want)  # full band == dense
    alns = m.align(reads, refs)
    assert [a.score for a in alns] == [int(s) for s in got]


# --- CLI -------------------------------------------------------------------

def test_cli_end_to_end(tmp_path):
    from versalignlib_tpu.cli import main
    from versalignlib_tpu.io.fasta import write_fasta

    reads = ["ACGTACGT", "TTTTACGT"]
    refs = ["ACGTACGA", "ACGTAAAA"]
    write_fasta(tmp_path / "reads.fa", reads)
    write_fasta(tmp_path / "refs.fa", refs)
    rc = main([
        "--reads", str(tmp_path / "reads.fa"),
        "--refs", str(tmp_path / "refs.fa"),
        "--outdir", str(tmp_path), "--backend", "xla",
    ])
    assert rc == 0
    for fn in ("scores_smith_waterman.txt", "alignments_smith_waterman.txt",
               "scores_needleman_wunsch.txt", "alignments_needleman_wunsch.txt"):
        assert (tmp_path / fn).exists(), fn
    lines = (tmp_path / "scores_smith_waterman.txt").read_text().splitlines()
    assert lines[0] == "ACGTACGT"
    assert lines[2].lstrip("-").isdigit()


def test_cli_count_mismatch(tmp_path):
    from versalignlib_tpu.cli import main
    from versalignlib_tpu.io.fasta import write_fasta

    write_fasta(tmp_path / "reads.fa", ["ACGT"])
    write_fasta(tmp_path / "refs.fa", ["ACGT", "ACGT"])
    rc = main(["--reads", str(tmp_path / "reads.fa"),
               "--refs", str(tmp_path / "refs.fa"),
               "--outdir", str(tmp_path)])
    assert rc == 1


# --- checkpoint ------------------------------------------------------------

def test_checkpoint_resume(tmp_path, rng, default_params):
    reads = random_codes(rng, 25, 10)
    refs = random_codes(rng, 25, 10)
    calls = []

    def score_fn(r, f):
        calls.append(r.shape[0])
        return oracle.score_alignments(Algorithm.SMITH_WATERMAN, r, f, default_params)

    out1 = run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10)
    assert len(calls) == 3  # 10 + 10 + 5
    want = oracle.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs, default_params)
    np.testing.assert_array_equal(out1, want)

    # Resume: everything done -> no new calls.
    calls.clear()
    out2 = run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10)
    assert calls == []
    np.testing.assert_array_equal(out2, want)

    # Partial resume: drop one journal line, only that chunk re-runs.
    journal = tmp_path / "ck" / "done.jsonl"
    entries = [json.loads(x) for x in journal.read_text().splitlines()]
    journal.write_text("\n".join(json.dumps(e) for e in entries if e["chunk"] != 1) + "\n")
    calls.clear()
    out3 = run_scored_batch(tmp_path / "ck", reads, refs, score_fn, chunk=10)
    assert calls == [10]
    np.testing.assert_array_equal(out3, want)


def test_checkpoint_shape_mismatch(tmp_path):
    ScoreCheckpoint(tmp_path / "c2", total=10, chunk=5)
    with pytest.raises(ValueError):
        ScoreCheckpoint(tmp_path / "c2", total=20, chunk=5)


def test_table_checkpoint_resume(tmp_path):
    from versalignlib_tpu.utils.checkpoint import TableCheckpoint

    ck = TableCheckpoint(tmp_path / "t", total=11, chunk=4, width=3,
                         columns=("a", "b", "c"))
    assert [c for c, _, _ in ck.pending_chunks()] == [0, 1, 2]
    for c, lo, hi in ck.pending_chunks():
        ck.commit(c, lo, np.full((hi - lo, 3), c, dtype=np.int64))
    assert ck.is_complete()
    # Reopen: table persists, pending empty, meta guarded.
    ck2 = TableCheckpoint(tmp_path / "t", total=11, chunk=4, width=3,
                          columns=("a", "b", "c"))
    assert ck2.pending_chunks() == []
    assert list(ck2.table()[:, 0]) == [0] * 4 + [1] * 4 + [2] * 3
    with pytest.raises(ValueError, match="refusing"):
        TableCheckpoint(tmp_path / "t", total=11, chunk=4, width=2)
    # Drop a journal line -> exactly that chunk re-runs.
    journal = tmp_path / "t" / "done.jsonl"
    lines = [json.loads(x) for x in journal.read_text().splitlines()]
    journal.write_text("\n".join(
        json.dumps(e) for e in lines if e["chunk"] != 1) + "\n")
    ck3 = TableCheckpoint(tmp_path / "t", total=11, chunk=4, width=3,
                          columns=("a", "b", "c"))
    assert [c for c, _, _ in ck3.pending_chunks()] == [1]


def test_bulk_map_pipeline_resumes(tmp_path, rng, monkeypatch):
    import importlib.util
    import pathlib

    from versalignlib_tpu import map_reads
    from versalignlib_tpu.io.fasta import write_fasta
    from versalignlib_tpu.io.fastq import write_fastq
    from versalignlib_tpu.alphabet import reverse_complement

    spec = importlib.util.spec_from_file_location(
        "bulk_map", pathlib.Path(__file__).parent.parent / "scripts" /
        "bulk_map.py")
    bulk_map = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bulk_map)

    bases = np.array(list("ACGT"))
    panel = ["".join(rng.choice(bases, size=40)) for _ in range(3)]
    reads = [panel[i % 3][5:30] for i in range(10)]
    reads[4] = reverse_complement(reads[4])
    pf = tmp_path / "panel.fa"
    rf = tmp_path / "reads.fastq"
    write_fasta(pf, panel)
    write_fastq(rf, reads)
    ck = tmp_path / "ckpt"
    argv = ["--reads", str(rf), "--panel", str(pf), "--ckpt", str(ck),
            "--chunk", "4"]
    monkeypatch.setattr("sys.argv", ["bulk_map.py"] + argv)
    assert bulk_map.main() == 0
    table1 = np.load(ck / "table.npy")
    want = map_reads(reads, panel, backend="oracle", align=False)
    assert np.array_equal(table1[:, 0], want.index)
    assert np.array_equal(table1[:, 2], want.strand)
    assert np.array_equal(table1[:, 3], want.mapq)
    hits = (ck / "hits.tsv").read_text().splitlines()
    assert hits[0] == "read\thit_index\tscore\tstrand\tmapq"
    assert len(hits) == 11 and hits[5].startswith("read4\t")
    # Kill/resume: drop one chunk from the journal, rerun, identical table.
    journal = ck / "done.jsonl"
    lines = [json.loads(x) for x in journal.read_text().splitlines()]
    journal.write_text("\n".join(
        json.dumps(e) for e in lines if e["chunk"] != 2) + "\n")
    assert bulk_map.main() == 0
    assert np.array_equal(np.load(ck / "table.npy"), table1)

    # --sam: per-chunk parts assemble into a SAM matching the direct path.
    ck2 = tmp_path / "ckpt_sam"
    monkeypatch.setattr("sys.argv", ["bulk_map.py", "--reads", str(rf),
                                     "--panel", str(pf), "--ckpt", str(ck2),
                                     "--chunk", "4", "--sam"])
    assert bulk_map.main() == 0
    sam = (ck2 / "alignments.sam").read_text()
    recs = [l for l in sam.splitlines() if not l.startswith("@")]
    assert len(recs) == 10
    from versalignlib_tpu.alphabet import reverse_complement as _rc
    from versalignlib_tpu.io.sam import write_sam
    import io as _io

    direct = map_reads(reads, panel, backend="oracle")
    oriented = [_rc(r) if s else r for r, s in zip(reads, direct.strand)]
    buf = _io.StringIO()
    write_sam(buf, direct.alignments, oriented,
              [panel[j] for j in direct.index],
              read_names=[f"read{i}" for i in range(10)],
              ref_names=[f"seq{j}" for j in direct.index],
              strands=direct.strand, mapqs=direct.mapq)
    want = [l for l in buf.getvalue().splitlines() if not l.startswith("@")]
    assert recs == want
    # SAM parts are resume-safe: drop a chunk, rerun, identical output.
    journal2 = ck2 / "done.jsonl"
    lines = [json.loads(x) for x in journal2.read_text().splitlines()]
    journal2.write_text("\n".join(
        json.dumps(e) for e in lines if e["chunk"] != 1) + "\n")
    assert bulk_map.main() == 0
    assert (ck2 / "alignments.sam").read_text() == sam


# --- profiling / capabilities ----------------------------------------------

def test_gcups_meter():
    meter = GcupsMeter()
    with meter.measure(1_000_000):
        pass
    assert meter.calls == 1
    assert meter.gcups > 0
    assert "GCUPS" in meter.report()


def test_capabilities_probe():
    from versalignlib_tpu.utils.capabilities import probe

    caps = probe()
    assert caps.platform in ("cpu", "gpu")
    assert caps.num_devices >= 1
    assert caps.device_kind


# --- debug -----------------------------------------------------------------

def test_debug_dump_matrices(default_params):
    from versalignlib_tpu.alphabet import encode
    from versalignlib_tpu.debug import dump_matrices, format_matrix

    read, ref = encode("ACGT"), encode("ACGT")
    h, ptr = dump_matrices(read, ref, default_params, Algorithm.SMITH_WATERMAN)
    assert h.shape == (5, 5)
    assert int(h[4, 4]) == 8
    text = format_matrix(h, ptr)
    assert "\\" in text  # diagonal pointers on the match path

    p_aff = default_params.replace(gap_open_read=-4, gap_open_ref=-4,
                                   score_gap_read=-1, score_gap_ref=-1)
    h, e, f, ptr = dump_matrices(read, ref, p_aff, Algorithm.SMITH_WATERMAN)
    assert h.shape == e.shape == f.shape == (5, 5)


# --- timers / logging ------------------------------------------------------

def test_timer_and_bench_result():
    from versalignlib_tpu.utils.timers import BenchResult, Timer, time_batched_call

    t = Timer()
    t.start()
    t.stop()
    assert t.elapsed_seconds() >= 0
    assert t.elapsed_micros() >= 0

    calls = []
    res = time_batched_call(
        lambda: calls.append(1), cells_per_call=1000, pairs_per_call=10,
        warmup=1, iters=3,
    )
    assert len(calls) == 4
    assert isinstance(res, BenchResult)
    assert res.gcups > 0 and res.pairs_per_second > 0


def test_logging_reference_levels():
    import logging

    from versalignlib_tpu.utils import logging as vlog

    records = []

    class Sink(logging.Handler):
        def emit(self, record):
            records.append((record.levelno, record.name, record.getMessage()))

    root = logging.getLogger("versalignlib_tpu")
    sink = Sink()
    root.addHandler(sink)
    vlog.set_level("INFO")
    try:
        vlog.log(0, "test-component", "info message")
        vlog.log(3, "test-component", "drastic message", "extra line")
        vlog.log(2, "test-component", "sparse level")
    finally:
        vlog.set_level("WARNING")
        root.removeHandler(sink)
    levels = [r[0] for r in records]
    # Reference numeric levels: 0=INFO, 3=DRASTIC(CRITICAL), 2 falls to ERROR
    # (CustomLogger.h:22-35).
    assert levels == [logging.INFO, logging.CRITICAL, logging.ERROR]
    assert records[0][1] == "versalignlib_tpu.test-component"
    assert "extra line" in records[1][2]


def test_engine_tie_flavor(rng, default_params):
    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.ops import oracle
    from versalignlib_tpu.types import TieBreak

    reads = random_codes(rng, 10, 12, padded=True, n_prob=0.1)
    refs = random_codes(rng, 10, 12, padded=True, n_prob=0.1)
    for tie in (TieBreak.DIAG_UP_LEFT, TieBreak.DIAG_LEFT_UP):
        engine = AlignmentEngine(backend="xla", tie=tie)
        got = engine.compute_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs)
        want = oracle.compute_alignments(Algorithm.NEEDLEMAN_WUNSCH, reads, refs,
                                         default_params, tie)
        for g, w in zip(got, want):
            assert (g.read, g.ref, g.cigar) == (w.read, w.ref, w.cigar)


def test_cli_selftest_and_bench_table(tmp_path, capsys):
    from versalignlib_tpu.cli import main

    rc = main(["--selftest", "--outdir", str(tmp_path), "--backend", "xla"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "SMITH_WATERMAN" in out and "NEEDLEMAN_WUNSCH" in out
    assert (tmp_path / "scores_needleman_wunsch.txt").exists()

def test_cli_reference_compat_output(tmp_path):
    # --reference-compat writes the reference's exact byte formats:
    # scores = "<read>\t<score>" lines (main.cpp:135-139); alignments = two
    # gapped strings + a blank line (main.cpp:146-153).
    from versalignlib_tpu.cli import main

    rc = main(["--selftest", "--outdir", str(tmp_path), "--backend", "xla",
               "--reference-compat"])
    assert rc == 0
    score_lines = (tmp_path / "scores_smith_waterman.txt").read_text().splitlines()
    assert len(score_lines) == 128
    for line in score_lines:
        read, score = line.split("\t")
        assert set(read) <= set("ACGT") and int(score) >= 0
    aln_text = (tmp_path / "alignments_smith_waterman.txt").read_text()
    groups = aln_text.split("\n\n")
    assert len([g for g in groups if g.strip()]) == 128
    first = groups[0].splitlines()
    assert len(first) == 2 and len(first[0]) == len(first[1])
    assert "\t" not in aln_text  # no CIGAR/score extension lines


def test_affine_sse_tie_flavor_through_engine(rng):
    # The SSE flavor is defined across the additive affine surface: every
    # backend must agree with the flavored Gotoh oracle.
    from versalignlib_tpu.dispatch import AlignmentEngine
    from versalignlib_tpu.ops import gotoh
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.types import Algorithm, TieBreak

    p = AlignmentParameters(score_match=2, score_mismatch=-1,
                            score_gap_read=-1, score_gap_ref=-1,
                            gap_open_read=-4, gap_open_ref=-4)
    reads = random_codes(rng, 6, 8, padded=True, n_prob=0.15)
    refs = random_codes(rng, 6, 8, padded=True, n_prob=0.15)
    want = gotoh.compute_alignments_affine(
        Algorithm.SMITH_WATERMAN, reads, refs, p, TieBreak.DIAG_LEFT_UP)
    for backend in ("oracle", "xla"):
        engine = AlignmentEngine(params=p, backend=backend,
                                 tie=TieBreak.DIAG_LEFT_UP)
        got = engine.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
        for g, w in zip(got, want):
            assert (g.read, g.ref, g.score, g.cigar) == (
                w.read, w.ref, w.score, w.cigar), backend


def test_capabilities_dense_gate(monkeypatch):
    """Memory comes from the device's own memory_stats (None where it
    reports none); the GPU kernels are claimed only for CUDA devices; a
    failing probe raises instead of reporting a made-up device."""
    import jax

    from versalignlib_tpu.utils import capabilities
    from versalignlib_tpu.utils.capabilities import DeviceCapabilities

    class FakeDevice:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return {"bytes_limit": 60 << 30, "bytes_in_use": 0}

    capabilities.probe.cache_clear()
    monkeypatch.setattr(jax, "devices", lambda: [FakeDevice()] * 4)
    monkeypatch.setattr(jax, "local_devices", lambda: [FakeDevice()] * 4)
    caps = capabilities.probe()
    assert caps == DeviceCapabilities("gpu", "NVIDIA H100 80GB HBM3", 4,
                                      60 << 30)
    assert caps.gpu_kernels
    capabilities.probe.cache_clear()

    def broken():
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "local_devices", broken)
    with pytest.raises(RuntimeError):
        capabilities.probe()
    capabilities.probe.cache_clear()
    monkeypatch.undo()
    cpu = capabilities.probe()
    assert not cpu.gpu_kernels and cpu.memory_bytes is None


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_helper(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the cache sits
    at the fixed <checkout>/.jax_cache."""
    import pathlib

    import jax

    from versalignlib_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.enable_compile_cache()
            root = pathlib.Path(__file__).resolve().parent.parent
            assert got == str(root / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            assert compile_cache.enable_compile_cache() == got  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_iter_fasta_streaming_matches_parse(tmp_path):
    from versalignlib_tpu.io.fasta import (iter_fasta, iter_fasta_chunks,
                                           parse_fasta, write_fasta)

    seqs = ["ACGT" * k for k in range(1, 30)]
    path = tmp_path / "s.fa"
    write_fasta(path, seqs, width=7)
    # plus a space-invalidated record and an empty-line-terminated one
    with open(path, "a") as f:
        f.write(">bad\nACG T\nACGT\n>trunc\nAC\n\nGT\n>ok\nTTTT\n")
    want = parse_fasta(path)
    assert list(iter_fasta(path)) == want
    chunks = list(iter_fasta_chunks(path, chunk_records=10))
    assert [s for c in chunks for s in c] == want
    assert all(len(c) <= 10 for c in chunks)


def test_cli_banded_matrix_tie_flags(tmp_path):
    from versalignlib_tpu.cli import main

    # banded CLI path
    rc = main(["--selftest", "--outdir", str(tmp_path / "b"), "--band", "16"])
    assert rc == 0
    assert (tmp_path / "b" / "alignments_smith_waterman.txt").exists()
    # blosum62 protein path (selftest data is DNA chars, all in the protein
    # alphabet, so it encodes fine)
    rc = main(["--selftest", "--outdir", str(tmp_path / "m"),
               "--matrix", "blosum62", "--backend", "xla",
               "--gap-read", "-11", "--gap-ref", "-11"])
    assert rc == 0
    # sse tie flavor
    rc = main(["--selftest", "--outdir", str(tmp_path / "t"), "--tie", "sse",
               "--backend", "xla"])
    assert rc == 0
    # matrix file without alphabet -> argparse error
    mf = tmp_path / "m.tsv"
    mf.write_text("0 0\n0 3\n")
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        main(["--selftest", "--outdir", str(tmp_path), "--matrix", str(mf)])
    rc = main(["--selftest", "--outdir", str(tmp_path / "mf"),
               "--matrix", str(mf), "--alphabet", "A", "--backend", "xla"])
    assert rc == 0


def test_protein_model_family():
    from versalignlib_tpu.models import (affine_needleman_wunsch,
                                         protein_smith_waterman)

    m = protein_smith_waterman()
    aln = m.align(["MKTWQERLLA"], ["MKTFQERLLA"], backend="oracle")[0]
    assert aln.cigar == "10M"
    nw = affine_needleman_wunsch()
    assert nw.params.affine and nw.algorithm.name == "NEEDLEMAN_WUNSCH"


def test_prefetch_to_device_stages_arrays_in_order(rng):
    from versalignlib_tpu.io.staging import prefetch_to_device

    chunks = [(c, c * 10, rng.integers(0, 9, size=(4, 6)).astype(np.uint8),
               rng.integers(0, 9, size=(4, 7)).astype(np.uint8))
              for c in range(5)]
    out = list(prefetch_to_device(iter(chunks), depth=2))
    assert [(o[0], o[1]) for o in out] == [(c[0], c[1]) for c in chunks]
    for got, want in zip(out, chunks):
        # ndarrays staged to device (jax.Array), metadata passed through.
        assert not isinstance(got[2], np.ndarray)
        np.testing.assert_array_equal(np.asarray(got[2]), want[2])
        np.testing.assert_array_equal(np.asarray(got[3]), want[3])

    # Depth >= len(chunks) and empty iterators both behave.
    assert len(list(prefetch_to_device(iter(chunks), depth=9))) == 5
    assert list(prefetch_to_device(iter([]), depth=2)) == []
    import pytest as _pytest
    with _pytest.raises(ValueError):
        next(prefetch_to_device(iter(chunks), depth=0))


def test_sam_output_known_case():
    import io as _io

    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.io.sam import write_sam
    from versalignlib_tpu.types import Algorithm

    engine = AlignmentEngine(backend="oracle")
    reads = ["ACGTACGT", "GGGG"]
    refs = ["TTACGTACGTTT", "CCCC"]
    alns = engine.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
    buf = _io.StringIO()
    write_sam(buf, alns, reads, refs, read_names=["r0", "r1"],
              ref_names=["chr0", "chr1"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("@HD")
    assert "@SQ\tSN:chr0\tLN:12" in lines
    rec = [l for l in lines if l.startswith("r0\t")][0].split("\t")
    # Full read matches ref at 0-based pos 2: POS=3, no soft clips.
    assert rec[1] == "0" and rec[2] == "chr0" and rec[3] == "3"
    assert rec[5] == "8M" and rec[9] == "ACGTACGT"
    assert f"AS:i:{alns[0].score}" in rec
    # Perfect 8M match: zero edits, MD is the plain match count.
    assert "NM:i:0" in rec and "MD:Z:8" in rec
    # All-mismatch pair: SW empty alignment -> unmapped record.
    rec1 = [l for l in lines if l.startswith("r1\t")][0].split("\t")
    assert rec1[1] == "4" and rec1[5] == "*"


def test_sam_records_consistent_on_random_batch(rng):
    import io as _io
    import re

    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.io.sam import write_sam
    from versalignlib_tpu.types import Algorithm

    bases = np.array(list("ACGT"))
    reads = ["".join(rng.choice(bases, size=int(rng.integers(8, 20))))
             for _ in range(16)]
    refs = ["".join(rng.choice(bases, size=int(rng.integers(10, 24))))
            for _ in range(16)]
    engine = AlignmentEngine(backend="oracle")
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        alns = engine.compute_alignments(algorithm, reads, refs)
        buf = _io.StringIO()
        write_sam(buf, alns, reads, refs)
        recs = [l.split("\t") for l in buf.getvalue().splitlines()
                if not l.startswith("@")]
        assert len(recs) == 16
        for rec, read, ref, aln in zip(recs, reads, refs, alns):
            if rec[1] == "4":
                continue
            ops = re.findall(r"(\d+)([MIDS])", rec[5])
            read_consumed = sum(int(n) for n, op in ops if op in "MIS")
            ref_consumed = sum(int(n) for n, op in ops if op in "MD")
            assert read_consumed == len(read), rec
            # Edge D/I are normalized away: POS may sit past ref_start
            # (leading D advances it) and the span may end before ref_end
            # (trailing D dropped), but stays within the aligned window.
            pos0 = int(rec[3]) - 1
            assert aln.ref_start <= pos0 and pos0 + ref_consumed <= aln.ref_end
            body = [op for _, op in ops if op != "S"]
            assert body and body[0] == "M" and body[-1] == "M", rec


def test_sam_record_normalizes_edge_ops():
    from versalignlib_tpu.io.sam import sam_record
    from versalignlib_tpu.types import Alignment

    # Leading deletion: POS advances past it, CIGAR starts with M.
    aln = Alignment(read="--ACGT", ref="TTACGT", score=8, cigar="2D4M",
                    read_start=0, read_end=4, ref_start=0, ref_end=6)
    rec = sam_record(aln, "ACGTGG", "r", "c").split("\t")
    assert rec[3] == "3" and rec[5] == "4M2S"
    # Trailing insertion folds into the soft clip.
    aln = Alignment(read="ACGTT", ref="ACGT-", score=6, cigar="4M1I",
                    read_start=1, read_end=6, ref_start=0, ref_end=4)
    rec = sam_record(aln, "GACGTT", "r", "c").split("\t")
    assert rec[3] == "1" and rec[5] == "1S4M1S"
    # Only-deletion alignment: nothing aligned -> unmapped.
    aln = Alignment(read="--", ref="TT", score=0, cigar="2D",
                    read_start=0, read_end=2, ref_start=0, ref_end=2)
    rec = sam_record(aln, "AC", "r", "c").split("\t")
    assert rec[1] == "4" and rec[5] == "*"


def test_sam_record_nm_md_and_qual():
    from versalignlib_tpu.io.sam import sam_record
    from versalignlib_tpu.types import Alignment

    # Mixed window: 2 match, 1 mismatch (ref C), 1M, insertion of 2,
    # deletion of ref GA, then 2 match.
    aln = Alignment(read="ACTTGG--CT", ref="ACCT--GACT", score=5,
                    cigar="4M2I2D2M", read_start=1, read_end=9,
                    ref_start=0, ref_end=8)
    rec = sam_record(aln, "AACTTGGCTA", "r", "c", qual="IIIIIIIIII").split("\t")
    assert rec[5] == "1S4M2I2D2M1S"
    assert rec[10] == "IIIIIIIIII"
    # NM = 1 mismatch + 2 inserted + 2 deleted = 5.
    assert "NM:i:5" in rec
    # MD = 2 match, mismatch C, 1 match, ^GA deletion, 2 match.
    assert "MD:Z:2C1^GA2" in rec
    # Edge trimming keeps NM/MD consistent with the emitted window: the
    # leading 2D is folded into POS, so its ref bases leave NM and MD.
    aln = Alignment(read="--ACGT", ref="TTACGT", score=8, cigar="2D4M",
                    read_start=0, read_end=4, ref_start=0, ref_end=6)
    rec = sam_record(aln, "ACGTGG", "r", "c").split("\t")
    assert rec[5] == "4M2S" and "NM:i:0" in rec and "MD:Z:4" in rec
    assert rec[10] == "*"
    # Adjacent mismatches produce the canonical 0-separated MD runs.
    aln = Alignment(read="AAAA", ref="ACCA", score=2, cigar="4M",
                    read_start=0, read_end=4, ref_start=0, ref_end=4)
    rec = sam_record(aln, "AAAA", "r", "c").split("\t")
    assert "NM:i:2" in rec and "MD:Z:1C0C1" in rec
    # Quality length must match the read.
    import pytest as _pytest
    with _pytest.raises(ValueError, match="quality length"):
        sam_record(aln, "AAAA", "r", "c", qual="II")


def test_parse_records_format_sniffed(tmp_path):
    from versalignlib_tpu.io.fastq import parse_records

    fa = tmp_path / "x.fa"
    fa.write_text(">a desc\nACGT\n>b\nGGTT\n")
    assert parse_records(fa) == [("a", "ACGT", None), ("b", "GGTT", None)]
    fq = tmp_path / "x.fq"
    fq.write_text("@a\nACGT\n+\nII!I\n@b\nGG\n+\n#J\n")
    assert parse_records(fq) == [("a", "ACGT", "II!I"), ("b", "GG", "#J")]


def test_write_sam_batch_matches_python_writer(rng, default_params):
    """The native batch formatter must be byte-identical to write_sam on
    the materialized alignments — randomized, with reverse strands, quals,
    unmapped records, linear and affine gap models."""
    import io as _io

    from versalignlib_tpu import native
    from versalignlib_tpu.io.sam import write_sam, write_sam_batch
    from versalignlib_tpu.ops.xla import align_pairs
    from versalignlib_tpu.params import AlignmentParameters

    if not native.available():
        pytest.skip("native library unavailable")
    p_aff = AlignmentParameters(score_match=2, score_mismatch=-1,
                                score_gap_read=-1, score_gap_ref=-1,
                                gap_open_read=-4, gap_open_ref=-4)
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        for params in (default_params, p_aff):
            b = 24
            reads = rng.integers(0, 6, size=(b, 30)).astype(np.uint8)
            refs = rng.integers(0, 6, size=(b, 40)).astype(np.uint8)
            reads[0, :] = 0     # all-padding pair -> unmapped record
            batch = align_pairs(reads, refs, params, algorithm, raw=True)
            from versalignlib_tpu.alphabet import decode

            seqs = [decode(r) for r in reads]
            names = [f"q{i}" for i in range(b)]
            rnames = [f"c{i % 3}" for i in range(b)]
            strands = [i % 2 for i in range(b)]
            mapqs = [int(v) for v in rng.integers(0, 61, size=b)]
            quals = ["".join(chr(33 + int(x))
                             for x in rng.integers(0, 40, size=len(s)))
                     for s in seqs]
            ref_strs = [decode(f) for f in refs]
            want_buf = _io.StringIO()
            write_sam(want_buf, list(batch), seqs, ref_strs,
                      read_names=names, ref_names=rnames, strands=strands,
                      mapqs=mapqs, quals=quals)
            got_buf = _io.StringIO()
            write_sam_batch(got_buf, batch, seqs, ref_strs,
                            read_names=names, ref_names=rnames,
                            strands=strands, mapqs=mapqs, quals=quals)
            assert got_buf.getvalue() == want_buf.getvalue(), (
                algorithm, params.affine)
            # No-quals variant too ('*' column).
            want_buf = _io.StringIO()
            write_sam(want_buf, list(batch), seqs, ref_strs,
                      read_names=names, ref_names=rnames)
            got_buf = _io.StringIO()
            write_sam_batch(got_buf, batch, seqs, ref_strs,
                            read_names=names, ref_names=rnames)
            assert got_buf.getvalue() == want_buf.getvalue()


def test_sam_md_reconstructs_reference(rng, default_params):
    """The samtools contract: SEQ + CIGAR + MD alone must reconstruct the
    aligned reference segment. Randomized over SW and NW alignments with
    indels; validates CIGAR/POS/NM/MD mutual consistency end to end."""
    import re

    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.io.sam import sam_record

    engine = AlignmentEngine(backend="oracle")
    bases = np.array(list("ACGT"))
    for algorithm in (Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH):
        reads, refs = [], []
        for _ in range(24):
            ref = "".join(rng.choice(bases, size=int(rng.integers(30, 60))))
            lo = int(rng.integers(0, 10))
            frag = list(ref[lo : lo + 25])
            for _ in range(int(rng.integers(0, 4))):  # mutate: snp/ins/del
                k = int(rng.integers(0, len(frag)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    frag[k] = str(rng.choice(bases))
                elif op == 1:
                    frag.insert(k, str(rng.choice(bases)))
                elif len(frag) > 5:
                    del frag[k]
            reads.append("".join(frag))
            refs.append(ref)
        alns = engine.compute_alignments(algorithm, reads, refs)
        for aln, read, ref in zip(alns, reads, refs):
            rec = sam_record(aln, read, "r", "c").split("\t")
            if rec[1] == "4":
                continue
            pos = int(rec[3]) - 1
            cigar = re.findall(r"(\d+)([MIDS])", rec[5])
            md = rec[-1].removeprefix("MD:Z:")
            nm = int(rec[-2].removeprefix("NM:i:"))
            # Walk CIGAR to collect the read bases consumed by M columns.
            seq_i, m_bases, n_ins, n_del = 0, [], 0, 0
            for n, op in cigar:
                n = int(n)
                if op in "SI":
                    seq_i += n
                    n_ins += n if op == "I" else 0
                elif op == "M":
                    m_bases.extend(rec[9][seq_i : seq_i + n])
                    seq_i += n
                else:
                    n_del += n
            # Replay MD over the M/D columns to rebuild the ref segment.
            rebuilt, mi, mismatches = [], 0, 0
            for tok in re.findall(r"(\d+|\^[A-Z]+|[A-Z])", md):
                if tok.isdigit():
                    take = int(tok)
                    rebuilt.extend(m_bases[mi : mi + take])
                    mi += take
                elif tok.startswith("^"):
                    rebuilt.extend(tok[1:])
                else:
                    rebuilt.append(tok)   # mismatch: MD names the REF base
                    mi += 1
                    mismatches += 1
            want = ref[pos : pos + len(rebuilt)]
            assert "".join(rebuilt) == want, (read, ref, rec)
            assert nm == mismatches + n_ins + n_del, rec


def test_fastq_roundtrip_and_sniff(tmp_path, rng):
    from versalignlib_tpu.io.fastq import (iter_fastq_chunks, parse_fastq,
                                           parse_fastq_with_names,
                                           parse_sequences, sniff_format,
                                           write_fastq)

    bases = np.array(list("ACGT"))
    seqs = ["".join(rng.choice(bases, size=int(rng.integers(5, 20))))
            for _ in range(7)]
    quals = ["".join(chr(33 + int(q)) for q in rng.integers(0, 40, len(s)))
             for s in seqs]
    fq = tmp_path / "reads.fastq"
    write_fastq(fq, seqs, names=[f"r{i}" for i in range(7)], qualities=quals)
    assert sniff_format(fq) == "fastq"
    assert parse_fastq(fq) == seqs
    assert parse_sequences(fq) == seqs
    recs = parse_fastq_with_names(fq)
    assert [r[0] for r in recs] == [f"r{i}" for i in range(7)]
    assert [r[2] for r in recs] == quals
    chunks = list(iter_fastq_chunks(fq, chunk_records=3))
    assert [len(c) for c in chunks] == [3, 3, 1]
    assert [s for c in chunks for s in c] == seqs

    # FASTA routes through the same front door.
    from versalignlib_tpu.io.fasta import write_fasta

    fa = tmp_path / "reads.fasta"
    write_fasta(fa, seqs)
    assert sniff_format(fa) == "fasta"
    assert parse_sequences(fa) == seqs


def test_fastq_rejects_malformed(tmp_path):
    import pytest as _pytest

    from versalignlib_tpu.io.fastq import parse_fastq, sniff_format

    bad_header = tmp_path / "h.fastq"
    bad_header.write_text("not_a_header\nACGT\n+\nIIII\n")
    with _pytest.raises(ValueError, match="@"):
        parse_fastq(bad_header)
    bad_sep = tmp_path / "s.fastq"
    bad_sep.write_text("@r0\nACGT\nIIII\nACGT\n")
    with _pytest.raises(ValueError, match=r"\+"):
        parse_fastq(bad_sep)
    bad_qual = tmp_path / "q.fastq"
    bad_qual.write_text("@r0\nACGT\n+\nII\n")
    with _pytest.raises(ValueError, match="length"):
        parse_fastq(bad_qual)
    truncated = tmp_path / "t.fastq"
    truncated.write_text("@r0\nACGT\n")
    with _pytest.raises(ValueError, match="truncated"):
        parse_fastq(truncated)
    with _pytest.raises(ValueError, match="sniff"):
        sniff_format(bad_header)
    # '@' followed by only whitespace: structured empty name, not a crash.
    from versalignlib_tpu.io.fastq import parse_fastq_with_names

    ws = tmp_path / "w.fastq"
    ws.write_text("@ \nACGT\n+\nIIII\n")
    assert parse_fastq_with_names(ws) == [("", "ACGT", "IIII")]


def test_fasta_fastq_crlf_streams():
    # CRLF data via caller-supplied streams (files translate newlines; raw
    # streams must not leak '\r' into sequences/qualities).
    import io as _io

    from versalignlib_tpu.io.fasta import iter_fasta, parse_fasta
    from versalignlib_tpu.io.fastq import parse_fastq_with_names

    fa = ">a\r\nACGT\r\nTTTT\r\n\r\n>b\r\nGG\r\n"
    assert list(iter_fasta(_io.StringIO(fa))) == ["ACGTTTTT", "GG"]
    assert parse_fasta(_io.StringIO(fa)) == ["ACGTTTTT", "GG"]
    fq = "@r0\r\nACGT\r\n+\r\nIIII\r\n"
    assert parse_fastq_with_names(_io.StringIO(fq)) == [("r0", "ACGT", "IIII")]


def test_cli_sse_flavor_on_additive_modes(tmp_path):
    # --tie sse now composes with affine gaps and banded mode (previously
    # an argparse error).
    from versalignlib_tpu.cli import main

    rc = main(["--selftest", "--outdir", str(tmp_path / "aff"),
               "--backend", "oracle", "--tie", "sse", "--gap-open", "-4",
               "--gap-read", "-1", "--gap-ref", "-1"])
    assert rc == 0
    rc = main(["--selftest", "--outdir", str(tmp_path / "band"),
               "--backend", "xla", "--tie", "sse", "--band", "32"])
    assert rc == 0
    for sub in ("aff", "band"):
        text = (tmp_path / sub / "alignments_smith_waterman.txt").read_text()
        assert len([l for l in text.splitlines() if l.strip()]) > 0


def test_cli_accepts_fastq_inputs(tmp_path, rng):
    from versalignlib_tpu.cli import main
    from versalignlib_tpu.io.fastq import write_fastq

    bases = np.array(list("ACGT"))
    reads = ["".join(rng.choice(bases, size=20)) for _ in range(8)]
    refs = ["".join(rng.choice(bases, size=30)) for _ in range(8)]
    rq = tmp_path / "reads.fastq"
    fq = tmp_path / "refs.fastq"
    write_fastq(rq, reads)
    write_fastq(fq, refs)
    rc = main(["--reads", str(rq), "--refs", str(fq),
               "--outdir", str(tmp_path / "out"), "--backend", "oracle"])
    assert rc == 0
    scores = (tmp_path / "out" / "scores_smith_waterman.txt").read_text()
    assert len(scores.splitlines()) == 3 * 8  # read/ref/score per pair
    assert scores.splitlines()[0] == reads[0]


def test_cli_sam_flag(tmp_path):
    from versalignlib_tpu.cli import main

    rc = main(["--selftest", "--outdir", str(tmp_path), "--backend", "xla",
               "--sam"])
    assert rc == 0
    for algo in ("smith_waterman", "needleman_wunsch"):
        sam = tmp_path / f"alignments_{algo}.sam"
        text = sam.read_text()
        assert text.startswith("@HD")
        assert len([l for l in text.splitlines()
                    if not l.startswith("@")]) == 128
