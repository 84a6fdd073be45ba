#!/usr/bin/env python
"""Serving-layer benchmark: p50/p99 latency + throughput under concurrent
mixed score/align/map HTTP load, recorded as one JSON file.

The serving layer (versalignlib_tpu/serve.py) is functionally hardened by
tests/test_serve.py; this script publishes its NUMBERS on real hardware:

- stands up ``AlignServer`` over a ``BatchingAligner`` in-process (same
  topology as production: threading HTTP server in front, one dispatcher
  thread owning the device);
- drives it with N client threads over keep-alive HTTP connections, each
  issuing a randomized mix of POST /v1/score, /v1/align and /v1/map
  requests (the same surface tests/test_serve.py stress-covers);
- warms every (endpoint, shape-bucket) pair off the clock first — first
  compiles take seconds and would otherwise dominate the percentiles;
- spot-checks responses against the oracle backend before trusting the
  timing (a fast wrong server is not a result);
- reports per-endpoint p50/p90/p99/mean latency, aggregate request and
  pair throughput, and the dispatcher's own batching counters.

The artifact records the device kind and the measured per-batch device
time. Without a GPU the script exits non-zero.

Usage: python scripts/serve_bench.py [--duration 30] [--clients 8]
                                     [--out serve_bench.json]
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


sys.path.insert(0, str(ROOT))


# Workload shapes. Lengths are drawn just under their power-of-two buckets
# so the server's shape bucketing (serve._bucket) maps every request onto
# ONE compiled program per endpoint; counts are fixed per endpoint for the
# same reason. 60/30/10 mirrors a read-mapping service: mostly cheap
# rescoring, some tracebacks, occasional panel mapping.
SCORE_PAIRS = 32   # pairs per /v1/score request, reads<=128bp vs refs<=256bp
ALIGN_PAIRS = 8    # pairs per /v1/align request, 96-128bp
MAP_READS = 16     # reads per /v1/map request vs an 8-entry 256bp panel
MIX = (("score", 0.60), ("align", 0.30), ("map", 0.10))


def _rand_seq(rng, lo: int, hi: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))


def _make_bodies(rng, panel):
    """Pre-generate one request body per endpoint kind for a client."""
    return {
        "score": {"reads": [_rand_seq(rng, 100, 129) for _ in range(SCORE_PAIRS)],
                  "refs": [_rand_seq(rng, 200, 257) for _ in range(SCORE_PAIRS)],
                  "algorithm": "sw"},
        "align": {"reads": [_rand_seq(rng, 96, 129) for _ in range(ALIGN_PAIRS)],
                  "refs": [_rand_seq(rng, 96, 129) for _ in range(ALIGN_PAIRS)],
                  "algorithm": "sw"},
        "map": {"reads": [_rand_seq(rng, 100, 129) for _ in range(MAP_READS)],
                "panel": panel, "algorithm": "sw", "both_strands": True,
                "align": False},
    }


PATHS = {"score": "/v1/score", "align": "/v1/align", "map": "/v1/map"}


def _post(conn: http.client.HTTPConnection, path: str, body: dict):
    payload = json.dumps(body)
    conn.request("POST", path, body=payload,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise RuntimeError(f"{path} -> {resp.status}: {data[:200]!r}")
    return json.loads(data)


def _client_loop(addr, seed: int, stop: threading.Event, ready: threading.Event,
                 records: list, errors: list, panel) -> None:
    """One keep-alive client issuing the endpoint mix until `stop`."""
    rng = np.random.default_rng(seed)
    conn = http.client.HTTPConnection(*addr, timeout=300)
    kinds = [k for k, _ in MIX]
    probs = [p for _, p in MIX]
    try:
        ready.wait()
        while not stop.is_set():
            kind = rng.choice(kinds, p=probs)
            body = _make_bodies(rng, panel)[kind]
            t0 = time.perf_counter()
            try:
                _post(conn, PATHS[kind], body)
            except Exception as exc:  # noqa: BLE001 — recorded, not fatal
                errors.append(f"{kind}: {exc}")
                conn.close()
                conn = http.client.HTTPConnection(*addr, timeout=300)
                continue
            records.append((kind, time.perf_counter() - t0))
    finally:
        conn.close()


def _percentiles(lat_s: list) -> dict:
    ms = sorted(v * 1e3 for v in lat_s)
    if not ms:
        return {}
    pick = lambda q: ms[min(len(ms) - 1, int(q * len(ms)))]
    return {"count": len(ms), "p50_ms": round(pick(0.50), 2),
            "p90_ms": round(pick(0.90), 2), "p99_ms": round(pick(0.99), 2),
            "mean_ms": round(statistics.fmean(ms), 2),
            "max_ms": round(ms[-1], 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="timed load window, seconds")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--out", default="serve_bench.json")
    args = ap.parse_args(argv)

    import jax

    from versalignlib_tpu.dispatch import AlignmentEngine
    from versalignlib_tpu.serve import AlignServer, BatchingAligner
    from versalignlib_tpu.types import Algorithm

    from versalignlib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"[serve_bench] no GPU: JAX found {platform}")
    device_kind = jax.devices()[0].device_kind
    engine = AlignmentEngine()
    print(f"[serve_bench] {device_kind} backend={engine.backend.name}",
          file=sys.stderr)

    rng = np.random.default_rng(7)
    panel = [_rand_seq(rng, 240, 257) for _ in range(8)]

    aligner = BatchingAligner(engine, max_wait_ms=args.max_wait_ms)
    with AlignServer(aligner) as server:
        server.start()
        addr = server.address
        conn = http.client.HTTPConnection(*addr, timeout=600)

        # -- warm every (endpoint, bucket) off the clock -------------------
        # Coalescing can merge concurrent same-kind requests, growing the
        # PAIR-count bucket past a single request's: warm the single and the
        # merged buckets (the kernels tile pair blocks internally, so length
        # buckets dominate compile count; this is belt and braces).
        t0 = time.perf_counter()
        bodies = _make_bodies(rng, panel)
        for kind in ("score", "align", "map"):
            _post(conn, PATHS[kind], bodies[kind])
        big = {"reads": bodies["score"]["reads"] * args.clients,
               "refs": bodies["score"]["refs"] * args.clients,
               "algorithm": "sw"}
        _post(conn, PATHS["score"], big)
        big_a = {"reads": bodies["align"]["reads"] * args.clients,
                 "refs": bodies["align"]["refs"] * args.clients,
                 "algorithm": "sw"}
        _post(conn, PATHS["align"], big_a)
        warm_s = time.perf_counter() - t0
        print(f"[serve_bench] warmup {warm_s:.1f}s", file=sys.stderr)

        # -- correctness spot check vs the oracle backend ------------------
        got = _post(conn, PATHS["score"], bodies["score"])["scores"]
        oracle = AlignmentEngine(backend="oracle")
        want = [int(v) for v in oracle.score_alignments(
            Algorithm.SMITH_WATERMAN, bodies["score"]["reads"],
            bodies["score"]["refs"])]
        if got != want:
            raise SystemExit("[serve_bench] FATAL: served scores != oracle")
        conn.close()

        # -- timed concurrent load -----------------------------------------
        stop, ready = threading.Event(), threading.Event()
        records: list = []   # list.append is atomic under the GIL
        errors: list = []
        threads = [threading.Thread(
            target=_client_loop,
            args=(addr, 100 + i, stop, ready, records, errors, panel),
            daemon=True) for i in range(args.clients)]
        for t in threads:
            t.start()
        stats0 = aligner.stats()
        ready.set()
        t0 = time.perf_counter()
        time.sleep(args.duration)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        elapsed = time.perf_counter() - t0
        stats1 = aligner.stats()

    # -- align-path host-cost A/B: raw column store vs materialized --------
    # The raw path's win (no per-pair Python objects between decode and
    # JSON) is measured directly: one device fill, then response-building
    # timed both ways.
    ab = {}
    try:
        from versalignlib_tpu.serve import _alignment_json

        ar = [_rand_seq(rng, 120, 129) for _ in range(4096)]
        af = [_rand_seq(rng, 120, 129) for _ in range(4096)]
        from versalignlib_tpu.types import Algorithm as _Alg

        # Warm BOTH paths (compiles + chunk shapes), then time second runs.
        engine.compute_alignments(_Alg.SMITH_WATERMAN, ar, af, raw=True)
        engine.compute_alignments(_Alg.SMITH_WATERMAN, ar, af)
        t0 = time.perf_counter()
        batch = engine.compute_alignments(_Alg.SMITH_WATERMAN, ar, af,
                                          raw=True)
        rows_raw = batch.to_json_rows()
        t_raw_total = time.perf_counter() - t0
        t0 = time.perf_counter()
        objs = engine.compute_alignments(_Alg.SMITH_WATERMAN, ar, af)
        rows_obj = [_alignment_json(a) for a in objs]
        t_obj_total = time.perf_counter() - t0
        # Isolated response-build stage (fill/link excluded): re-decode from
        # the already-produced results.
        t0 = time.perf_counter()
        _ = batch.to_json_rows()
        t_json_raw = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ = [_alignment_json(a) for a in objs]
        t_json_obj = time.perf_counter() - t0
        assert rows_raw == rows_obj
        ab = {
            "pairs": 4096,
            "raw_total_s": round(t_raw_total, 3),
            "materialized_total_s": round(t_obj_total, 3),
            "align_path_speedup_total": round(
                t_obj_total / max(t_raw_total, 1e-9), 2),
            "json_stage_from_columns_s": round(t_json_raw, 4),
            "json_stage_from_objects_s": round(t_json_obj, 4),
            "identical_json": True,
            "note": "totals include the device fill and transfers; the "
                    "raw path's structural win is skipping 4096 Alignment "
                    "object materializations per batch",
        }
        print(f"[serve_bench] align-path A/B (warm): raw {t_raw_total:.2f}s"
              f" vs materialized {t_obj_total:.2f}s "
              f"({ab['align_path_speedup_total']}x)", file=sys.stderr)
    except Exception as exc:  # noqa: BLE001
        ab = {"error": str(exc)[:200]}

    by_kind = {k: [dt for kk, dt in records if kk == k] for k in PATHS}
    pairs = {"score": SCORE_PAIRS, "align": ALIGN_PAIRS, "map": MAP_READS}
    total_pairs = sum(pairs[k] * len(v) for k, v in by_kind.items())
    batches = stats1["batches"] - stats0["batches"]
    result = {
        "platform": platform,
        "device_kind": device_kind,
        "backend": engine.backend.name,
        "clients": args.clients,
        "duration_s": round(elapsed, 2),
        "max_wait_ms": args.max_wait_ms,
        "mix": dict(MIX),
        "requests_total": len(records),
        "requests_per_s": round(len(records) / elapsed, 1),
        "pairs_per_s": round(total_pairs / elapsed, 1),
        "errors": len(errors),
        "latency": {k: _percentiles(v) for k, v in by_kind.items()},
        "batching": {
            "batches": batches,
            "mean_batch_pairs": round(
                (stats1["batched_pairs"] - stats0["batched_pairs"])
                / max(1, batches), 1),
            "mean_device_batch_ms": round(
                (stats1["latency_sum_s"] - stats0["latency_sum_s"])
                / max(1, batches) * 1e3, 2),
            # queue wait (dispatcher behavior) vs device time (fill plus
            # transfers).
            "mean_queue_wait_ms": round(
                (stats1["queue_wait_sum_s"] - stats0["queue_wait_sum_s"])
                / max(1, stats1["requests"] - stats0["requests"]) * 1e3, 2),
            "max_queue_wait_ms": round(stats1["queue_wait_max_s"] * 1e3, 2),
            "device_sum_s": round(
                stats1["device_sum_s"] - stats0["device_sum_s"], 3),
            "align_path": "raw AlignmentBatch column store",
        },
        "align_path_ab": ab,
    }
    if errors:
        result["error_samples"] = errors[:5]
    Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
