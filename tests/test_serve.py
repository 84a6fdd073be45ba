"""Serving layer: microbatching dispatcher + HTTP JSON front end.

Runs entirely on the oracle backend (CPU) — the serving logic is
device-agnostic; kernel correctness is gated elsewhere.
"""

import json
import queue
import threading

import numpy as np
import pytest

from versalignlib_tpu import AlignmentEngine
from versalignlib_tpu.serve import (AlignServer, BatchingAligner, _bucket,
                                    parse_algorithm)
from versalignlib_tpu.types import Algorithm


@pytest.fixture
def engine():
    return AlignmentEngine(backend="oracle")


def _random_pairs(rng, n, lo=8, hi=24):
    bases = np.array(list("ACGT"))
    reads = ["".join(rng.choice(bases, size=int(rng.integers(lo, hi))))
             for _ in range(n)]
    refs = ["".join(rng.choice(bases, size=int(rng.integers(lo, hi))))
            for _ in range(n)]
    return reads, refs


def test_bucket_and_algorithm_parsing():
    assert _bucket(1) == 32 and _bucket(32) == 32 and _bucket(33) == 64
    assert _bucket(512) == 512 and _bucket(513) == 1024
    assert parse_algorithm("sw") is Algorithm.SMITH_WATERMAN
    assert parse_algorithm("NW") is Algorithm.NEEDLEMAN_WUNSCH
    assert parse_algorithm(Algorithm.SMITH_WATERMAN) is Algorithm.SMITH_WATERMAN
    assert parse_algorithm(1) is Algorithm.NEEDLEMAN_WUNSCH
    with pytest.raises(ValueError, match="unknown algorithm"):
        parse_algorithm("bogus")


def test_batching_coalesces_requests(engine, rng):
    # Enqueue BEFORE starting the dispatcher: deterministic coalescing.
    aligner = BatchingAligner(engine, max_wait_ms=50, start=False)
    reqs = []
    for _ in range(4):
        reads, refs = _random_pairs(rng, 3)
        reqs.append((reads, refs,
                     aligner.submit(reads, refs, "sw", "score")))
    nw_reads, nw_refs = _random_pairs(rng, 2)
    nw_fut = aligner.submit(nw_reads, nw_refs, "nw", "score")
    aligner.start()
    for reads, refs, fut in reqs:
        want = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
        assert fut.result(timeout=30) == [int(v) for v in want]
    want = engine.score_alignments(Algorithm.NEEDLEMAN_WUNSCH, nw_reads, nw_refs)
    assert nw_fut.result(timeout=30) == [int(v) for v in want]
    s = aligner.stats()
    # 5 requests over 2 (algorithm, mode) groups -> exactly 2 device batches.
    assert s["requests"] == 5 and s["batches"] == 2
    assert s["batched_pairs"] == 14 and s["max_batch_pairs"] == 12
    aligner.close()


def test_align_mode_scatters_per_request(engine, rng):
    with BatchingAligner(engine, max_wait_ms=50, start=False) as aligner:
        r1, f1 = _random_pairs(rng, 2)
        r2, f2 = _random_pairs(rng, 3)
        fut1 = aligner.submit(r1, f1, "sw", "align")
        fut2 = aligner.submit(r2, f2, "sw", "align")
        aligner.start()
        a1 = fut1.result(timeout=30)
        a2 = fut2.result(timeout=30)
    assert len(a1) == 2 and len(a2) == 3
    # Bucketed padding must not change results: compare against the direct
    # engine on the unpadded batch (padding is semantics-free by design).
    want = engine.compute_alignments(Algorithm.SMITH_WATERMAN, r1 + r2,
                                     f1 + f2)
    for got, exp in zip(a1 + a2, want):
        assert (got.read, got.ref, got.score, got.cigar) == (
            exp.read, exp.ref, exp.score, exp.cigar)


def test_submit_validation_and_backpressure(engine):
    aligner = BatchingAligner(engine, max_queue=2, start=False)
    with pytest.raises(ValueError, match="counts differ"):
        aligner.submit(["AC"], [], "sw", "score")
    with pytest.raises(ValueError, match="mode"):
        aligner.submit(["AC"], ["AC"], "sw", "fancy")
    assert aligner.submit([], [], "sw", "score").result() == []  # no device
    aligner.submit(["AC"], ["AC"])
    aligner.submit(["AC"], ["AC"])
    with pytest.raises(queue.Full):
        aligner.submit(["AC"], ["AC"])
    # Drain: start, let both resolve, close; then submits are rejected.
    aligner.start()
    aligner.close()
    with pytest.raises(RuntimeError, match="closed"):
        aligner.submit(["AC"], ["AC"])


def test_concurrent_submitters_one_device_stream(engine, rng):
    # 8 client threads flood; every result must be exact and the dispatcher
    # must batch at least some of them together.
    aligner = BatchingAligner(engine, max_wait_ms=20)
    errors = []

    def client(seed):
        local = np.random.default_rng(seed)
        for _ in range(5):
            reads, refs = _random_pairs(local, 2)
            got = aligner.score(reads, refs, "sw")
            want = engine.score_alignments(
                Algorithm.SMITH_WATERMAN, reads, refs)
            if got != [int(v) for v in want]:
                errors.append((reads, refs, got, list(want)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    s = aligner.stats()
    assert s["requests"] == 40 and s["errors"] == 0
    assert s["batches"] <= s["requests"]
    aligner.close()


def _http(method, addr, path, body=None):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=30)
    try:
        payload = json.dumps(body) if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_submit_call_runs_on_dispatcher(engine):
    import threading as _t

    with BatchingAligner(engine, max_wait_ms=5) as aligner:
        names = []
        fut = aligner.submit_call(
            lambda: names.append(_t.current_thread().name) or 42)
        assert fut.result(timeout=30) == 42
        assert names == ["versalign-dispatch"]
        boom = aligner.submit_call(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            boom.result(timeout=30)
        assert aligner.stats()["errors"] == 1


def test_http_map_endpoint(engine, rng):
    from versalignlib_tpu import map_reads
    from versalignlib_tpu.alphabet import reverse_complement

    aligner = BatchingAligner(engine, max_wait_ms=5)
    with AlignServer(aligner, port=0, max_request_pairs=64,
                     max_map_cross=500) as server:
        server.start()
        addr = server.address
        bases = np.array(list("ACGT"))
        panel = ["".join(rng.choice(bases, size=40)) for _ in range(4)]
        reads = [panel[2][5:25], reverse_complement(panel[1][10:30])]
        status, out = _http("POST", addr, "/v1/map",
                            {"reads": reads, "panel": panel, "align": True})
        assert status == 200
        want = map_reads(reads, panel, engine.params, backend="oracle")
        for h, i in zip(out["hits"], range(len(reads))):
            assert h["index"] == int(want.index[i])
            assert h["score"] == int(want.score[i])
            assert h["strand"] == int(want.strand[i])
            assert h["mapq"] == int(want.mapq[i])
            assert h["alignment"]["cigar"] == want.alignments[i].cigar
        # align defaults off: no alignment key.
        status, out = _http("POST", addr, "/v1/map",
                            {"reads": reads, "panel": panel})
        assert status == 200 and "alignment" not in out["hits"][0]
        # Validation: bad body and the reads x panel x strands work bound.
        status, _ = _http("POST", addr, "/v1/map", {"reads": reads})
        assert status == 400
        big = ["ACGT"] * 65          # 65 * 4 panel * 2 strands = 520 > 500
        status, err = _http("POST", addr, "/v1/map",
                            {"reads": big, "panel": panel})
        assert status == 413 and "split" in err["error"]
        # Single-strand halves the work: 260 pairs fits under the bound.
        status, _ = _http("POST", addr, "/v1/map",
                          {"reads": big, "panel": panel,
                           "both_strands": False})
        assert status == 200
        # Degenerate: empty panel -> every read an unmapped placeholder
        # (not a handler crash), index -1.
        status, out = _http("POST", addr, "/v1/map",
                            {"reads": reads, "panel": [], "align": True})
        assert status == 200
        assert [h["index"] for h in out["hits"]] == [-1, -1]
        assert all(h["alignment"]["cigar"] == "" for h in out["hits"])


def test_mixed_endpoint_stress_and_close_under_traffic(engine, rng):
    """Score and map requests racing on one server: every response is
    valid; closing with requests in flight neither hangs nor corrupts."""
    aligner = BatchingAligner(engine, max_wait_ms=10)
    server = AlignServer(aligner, port=0)
    server.start()
    addr = server.address
    bases = np.array(list("ACGT"))
    panel = ["".join(rng.choice(bases, size=30)) for _ in range(3)]
    errors = []

    def score_client(seed):
        local = np.random.default_rng(seed)
        for _ in range(6):
            reads, refs = _random_pairs(local, 2)
            status, out = _http("POST", addr, "/v1/score",
                                {"reads": reads, "refs": refs})
            want = engine.score_alignments(
                __import__("versalignlib_tpu").Algorithm.SMITH_WATERMAN,
                reads, refs)
            if status != 200 or out["scores"] != [int(v) for v in want]:
                errors.append((status, out))

    def map_client(seed):
        local = np.random.default_rng(seed)
        for _ in range(4):
            reads = [panel[int(local.integers(0, 3))][5:25]]
            status, out = _http("POST", addr, "/v1/map",
                                {"reads": reads, "panel": panel})
            if status != 200 or out["hits"][0]["score"] != 40:
                errors.append((status, out))

    threads = ([threading.Thread(target=score_client, args=(i,))
                for i in range(4)]
               + [threading.Thread(target=map_client, args=(100 + i,))
                  for i in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    # Close while a late request is in flight: the submitter gets a clean
    # error or result, never a hang.
    fut = aligner.submit(["ACGT"], ["ACGT"])
    server.close()  # drains + closes the aligner
    try:
        fut.result(timeout=30)
    except RuntimeError:
        pass  # "closed during submit" is an acceptable outcome
    with pytest.raises(RuntimeError, match="closed"):
        aligner.submit(["ACGT"], ["ACGT"])


def test_http_server_end_to_end(engine, rng):
    aligner = BatchingAligner(engine, max_wait_ms=5)
    with AlignServer(aligner, port=0, max_request_pairs=8) as server:
        server.start()
        addr = server.address

        status, health = _http("GET", addr, "/healthz")
        assert status == 200 and health["ok"] and health["backend"] == "oracle"

        reads, refs = _random_pairs(rng, 4)
        status, out = _http("POST", addr, "/v1/score",
                            {"reads": reads, "refs": refs, "algorithm": "sw"})
        want = engine.score_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
        assert status == 200 and out["scores"] == [int(v) for v in want]

        status, out = _http("POST", addr, "/v1/align",
                            {"reads": ["ACGTACGT"], "refs": ["TTACGTACGTTT"],
                             "algorithm": "nw"})
        assert status == 200
        aln = out["alignments"][0]
        exp = engine.compute_alignments(
            Algorithm.NEEDLEMAN_WUNSCH, ["ACGTACGT"], ["TTACGTACGTTT"])[0]
        assert aln["score"] == exp.score and aln["cigar"] == exp.cigar
        assert aln["read"] == exp.read and aln["ref_start"] == exp.ref_start

        # Error paths: 400 malformed, 404 unknown, 413 oversized.
        status, err = _http("POST", addr, "/v1/score",
                            {"reads": ["AC"], "refs": []})
        assert status == 400 and "differ" in err["error"]
        status, _ = _http("POST", addr, "/v1/score", {"reads": ["AC"]})
        assert status == 400
        status, _ = _http("GET", addr, "/nope")
        assert status == 404
        big_reads, big_refs = _random_pairs(rng, 9)
        status, err = _http("POST", addr, "/v1/score",
                            {"reads": big_reads, "refs": big_refs})
        assert status == 413 and "split" in err["error"]

        status, stats = _http("GET", addr, "/stats")
        assert status == 200 and stats["requests"] >= 2
        assert stats["errors"] == 0


def test_stats_split_queue_wait_vs_device(engine, rng):
    """/stats separates queue-wait from device-batch time (r5): both
    counters advance and mean derivations appear."""
    with BatchingAligner(engine, max_wait_ms=5.0) as ba:
        reads, refs = _random_pairs(rng, 6)
        ba.score(reads, refs)
        ba.align(reads[:3], refs[:3])
        s = ba.stats()
    assert s["device_sum_s"] > 0 and s["device_max_s"] > 0
    assert s["queue_wait_sum_s"] >= 0 and "queue_wait_max_s" in s
    assert "mean_queue_wait_s" in s and "mean_device_s" in s
    # device time is part of each batch's latency accounting
    assert s["device_sum_s"] <= s["latency_sum_s"] + 1e-9


def test_align_raw_path_matches_materialized(rng):
    """The serving raw column-store path (device backend + native decoder)
    returns the same JSON rows as materialized Alignment objects."""
    pytest.importorskip("versalignlib_tpu.native")
    from versalignlib_tpu.serve import _alignment_json

    eng = AlignmentEngine(backend="xla")
    reads, refs = _random_pairs(rng, 5, lo=10, hi=20)
    batch = eng.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs,
                                   raw=True)
    objs = eng.compute_alignments(Algorithm.SMITH_WATERMAN, reads, refs)
    rows = batch.to_json_rows()
    assert len(rows) == len(objs) == 5
    for row, obj in zip(rows, objs):
        want = _alignment_json(obj)
        assert row == want
    # slices are zero-copy views with consistent content
    sl = batch.slice(1, 4)
    assert len(sl) == 3
    assert sl.to_json_rows() == rows[1:4]


def test_align_raw_requires_device_backend(engine):
    with pytest.raises(ValueError):
        engine.compute_alignments(Algorithm.SMITH_WATERMAN, ["ACGT"],
                                  ["ACGT"], raw=True)


def test_http_align_raw_path_end_to_end(rng):
    """HTTP /v1/align over a device backend exercises the raw
    column-store serialization path end-to-end; response equals the
    materialized form field-for-field."""
    pytest.importorskip("versalignlib_tpu.native")
    import http.client

    eng = AlignmentEngine(backend="xla")
    reads, refs = _random_pairs(rng, 4, lo=10, hi=18)
    with BatchingAligner(eng) as ba, AlignServer(ba) as server:
        server.start()
        conn = http.client.HTTPConnection(*server.address, timeout=120)
        body = json.dumps({"reads": reads, "refs": refs, "algorithm": "sw"})
        conn.request("POST", "/v1/align", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        out = json.loads(resp.read())["alignments"]
        conn.close()
    from versalignlib_tpu.serve import _alignment_json

    want = [_alignment_json(a) for a in eng.compute_alignments(
        Algorithm.SMITH_WATERMAN, reads, refs)]
    assert out == want


def test_http_align_cigar_only_fields(rng):
    """/v1/align with fields=cigar: CIGAR-only native decode — same rows
    minus the gapped strings, on both the raw and fallback paths."""
    import http.client

    for backend in ("xla", "oracle"):
        if backend == "xla":
            pytest.importorskip("versalignlib_tpu.native")
        eng = AlignmentEngine(backend=backend)
        reads, refs = _random_pairs(rng, 4, lo=10, hi=18)
        with BatchingAligner(eng) as ba, AlignServer(ba) as server:
            server.start()
            conn = http.client.HTTPConnection(*server.address, timeout=120)

            def post(body):
                conn.request("POST", "/v1/align", json.dumps(body),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 200
                return json.loads(resp.read())["alignments"]

            full = post({"reads": reads, "refs": refs, "algorithm": "sw"})
            compact = post({"reads": reads, "refs": refs, "algorithm": "sw",
                            "fields": "cigar"})
            conn.close()
        assert all("read" in r and "ref" in r for r in full)
        for f, c in zip(full, compact):
            assert "read" not in c and "ref" not in c
            assert c == {k: v for k, v in f.items()
                         if k not in ("read", "ref")}, backend
