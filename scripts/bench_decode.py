#!/usr/bin/env python
"""Host traceback-decoder throughput microbenchmark (CPU-only).

Synthesizes uint8 pointer planes shaped like real SW fills (full-length
walks, realistic run structure) and times the native C++ decoder alone —
the host stage of every traceback. Correctness is the
test suite's job (tests/test_native.py gates the decoder bit-exact against
the Python walker); this script only measures.

Usage: python scripts/bench_decode.py [--pairs 100000] [--len 128]
"""

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np


def synth_pointers(b: int, m: int, n: int, seed: int = 0):
    """Random pointer matrices biased like a real SW path region:
    mostly DIAG with occasional UP/LEFT runs, START sprinkled so walks
    terminate at varying lengths."""
    rng = np.random.default_rng(seed)
    # codes: 0 START (2%), 1 UP (9%), 2 LEFT (9%), 3 DIAG (80%)
    return rng.choice(
        np.array([0, 1, 2, 3], np.uint8), size=(b, m, n),
        p=[0.02, 0.09, 0.09, 0.80])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--len", type=int, dest="length", default=128)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from versalignlib_tpu.native import decode_batch_native
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.types import Algorithm

    b, m = args.pairs, args.length
    n = m
    print(f"[bench_decode] synthesizing {b} pairs {m}x{n} ...", flush=True)
    plane = synth_pointers(min(b, 20000), m, n)
    reps_factor = -(-b // plane.shape[0])
    plane = np.ascontiguousarray(np.tile(plane, (reps_factor, 1, 1))[:b])
    rng = np.random.default_rng(1)
    reads = rng.integers(1, 5, size=(b, m), dtype=np.uint8)
    refs = rng.integers(1, 5, size=(b, n), dtype=np.uint8)
    start_r = np.full(b, m - 1, np.int32)
    start_f = np.full(b, n - 1, np.int32)
    scores = rng.integers(0, 200, size=b).astype(np.int32)
    params = AlignmentParameters()

    for label, kw in (("cigar-only", dict(raw=True, gapped=False)),
                      ("raw", dict(raw=True)),
                      ("materialized", dict(raw=False))):
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = decode_batch_native(
                plane, reads, refs, start_r, start_f, params,
                Algorithm.SMITH_WATERMAN, scores,
                n_threads=args.threads, **kw)
            dt = time.perf_counter() - t0
            best = min(best, dt)
        rate = b / best
        print(f"[bench_decode] {label:>12}: {best*1e3:8.1f} ms  "
              f"{rate/1e3:9.1f}k alns/s", flush=True)
        if label == "materialized" and b > 30000:
            break  # one rep is plenty for the slow path


if __name__ == "__main__":
    main()
