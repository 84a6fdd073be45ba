"""Time the Triton dense score kernel against the XLA row scan on one GPU.

Usage: python scripts/score_kernel_ab.py [--pairs 16384] [--m 512] [--n 512]
           [--sweep]

Checks both against each other bit for bit, then prints one line per
variant with the median of 3 timed calls (after a warm-up), each ended with
``block_until_ready``. ``--sweep`` also times the kernel's launch shapes
(pairs per program, strip rows, column unroll).
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from versalignlib_tpu.alphabet import blosum62
from versalignlib_tpu.ops import triton_score, xla
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm


def _median_time(fn, reps: int = 3) -> float:
    fn().block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pairs", type=int, default=16384)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--block-pairs", default="32,64",
                    help="sweep: pairs per program (one warp per 32)")
    ap.add_argument("--strips", default="16,24,32,48")
    ap.add_argument("--unrolls", default="1,2")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {jax.devices()[0].device_kind} | {smi.stdout.strip()}")
    rng = np.random.default_rng(0)
    b, m, n = args.pairs, args.m, args.n
    dna = (jnp.asarray(rng.integers(1, 5, (b, m), dtype=np.uint8)),
           jnp.asarray(rng.integers(1, 5, (b, n), dtype=np.uint8)))
    prot = (jnp.asarray(rng.integers(1, 25, (b, m), dtype=np.uint8)),
            jnp.asarray(rng.integers(1, 25, (b, n), dtype=np.uint8)))
    cells = b * m * n
    variants = [
        ("linear", AlignmentParameters(), dna),
        ("affine", AlignmentParameters(gap_open_read=-4, gap_open_ref=-4),
         dna),
        ("blosum62", AlignmentParameters(
            matrix=blosum62(), score_gap_read=-2, score_gap_ref=-2), prot),
    ]
    for name, p, (r, f) in variants:
        for alg in Algorithm:
            want = xla.score_batch(r, f, p, alg)
            got = triton_score.score_batch_triton(r, f, p, alg)
            same = bool(jnp.array_equal(want, got))
            t_x = _median_time(lambda: xla.score_batch(r, f, p, alg))
            t_k = _median_time(
                lambda: triton_score.score_batch_triton(r, f, p, alg))
            print(f"{name} {alg.name} B={b} {m}x{n}: xla {t_x:.6f}s "
                  f"({cells / t_x / 1e9:.1f} GCUPS) triton {t_k:.6f}s "
                  f"({cells / t_k / 1e9:.1f} GCUPS) equal={same}",
                  flush=True)
            if not same:
                return 1
    if args.sweep:
        for name, p, (r, f) in variants:
            for bp in map(int, args.block_pairs.split(",")):
                for strip in map(int, args.strips.split(",")):
                    for unroll in map(int, args.unrolls.split(",")):
                        t = _median_time(
                            lambda: triton_score.score_batch_triton(
                                r, f, p, Algorithm.SMITH_WATERMAN,
                                block_pairs=bp, strip=strip, unroll=unroll))
                        print(f"sweep {name} bp={bp} "
                              f"strip={strip} unroll={unroll}: {t:.6f}s "
                              f"({cells / t / 1e9:.1f} GCUPS)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
