#!/usr/bin/env python
"""Benchmark: batched 512x512 Smith-Waterman scoring on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
value = GCUPS (1e9 DP cell updates/sec) of the device score path that
``AlignmentEngine(backend="auto")`` runs (the Pallas/Triton kernel,
ops/triton_score.py) at B=16384 pairs; vs_baseline = value / 50.

Timing: inputs are generated on the device; after a warm-up call, three
calls are timed on the host clock, each ended with ``block_until_ready``,
and the median is reported. Scores of 24 sampled pairs are checked
bit-for-bit against the numpy oracle first. The card's name and power
limit go to stderr. Without a GPU the script exits non-zero.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def main() -> int:
    import jax
    import numpy as np

    from versalignlib_tpu.dispatch import device_score_fn, resolve_score_impl
    from versalignlib_tpu.ops import oracle
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.types import Algorithm
    from versalignlib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[bench] {dev.device_kind} | {smi.stdout.strip()}", file=sys.stderr)

    p = AlignmentParameters()
    alg = Algorithm.SMITH_WATERMAN
    b, m, n = 16384, 512, 512
    score = device_score_fn(resolve_score_impl())
    kr, kf = jax.random.split(jax.random.PRNGKey(42))
    reads = jax.random.randint(kr, (b, m), 1, 5, dtype=jax.numpy.int32)
    refs = jax.random.randint(kf, (b, n), 1, 5, dtype=jax.numpy.int32)

    got = np.asarray(score(reads, refs, p, alg).block_until_ready())
    sub = np.random.default_rng(7).integers(0, b, size=24)
    want = oracle.score_alignments(
        alg, np.asarray(reads)[sub].astype(np.uint8),
        np.asarray(refs)[sub].astype(np.uint8), p)
    if not np.array_equal(got[sub], want):
        print("[bench] FATAL: score mismatch vs oracle", file=sys.stderr)
        return 1

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        score(reads, refs, p, alg).block_until_ready()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    gcups = b * m * n / t / 1e9
    print(f"[bench] {m}x{n} SW B={b} median {t * 1e3:.3f} ms "
          f"(runs {', '.join(f'{x * 1e3:.3f}' for x in times)} ms)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "sw_512x512_score_gcups",
        "value": round(gcups, 2),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / 50.0, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
