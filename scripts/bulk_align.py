#!/usr/bin/env python
"""Bulk alignment pipeline: millions of pairs, restartable, data-parallel.

BASELINE config 5 ("10M read-vs-reference SW alignments sharded
data-parallel"): streams pair chunks through the device score path (or the
full align+decode path), sharded over the device mesh when more than one
device is present, journaling completed chunks so a crash resumes where it
left off (utils/checkpoint.py).

Synthetic mode generates chunks deterministically from the seed, so resumes
regenerate identical data without holding 10M pairs in RAM.

Usage:
  python scripts/bulk_align.py --pairs 10000000 --len 128 --ckpt /tmp/run1
  python scripts/bulk_align.py --reads r.fa --refs f.fa --ckpt /tmp/run2 --mode align
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def synthetic_chunk(seed: int, chunk_index: int, n_pairs: int, length: int):
    rng = np.random.default_rng((seed, chunk_index))
    reads = rng.integers(1, 5, size=(n_pairs, length)).astype(np.uint8)
    refs = rng.integers(1, 5, size=(n_pairs, length)).astype(np.uint8)
    return reads, refs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=0, help="synthetic pair count")
    ap.add_argument("--len", dest="length", type=int, default=128)
    ap.add_argument("--reads")
    ap.add_argument("--refs")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--mode", choices=["score", "align"], default="score")
    ap.add_argument("--algorithm", choices=["sw", "nw"], default="sw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the dispatch-ahead H2D pipeline (A/B)")
    args = ap.parse_args()

    import jax

    from versalignlib_tpu.alphabet import pad_and_encode
    from versalignlib_tpu.dispatch import device_score_fn, resolve_score_impl
    from versalignlib_tpu.ops.xla import align_pairs
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.parallel import make_mesh
    from versalignlib_tpu.parallel.distributed import distributed_score_batch
    from versalignlib_tpu.types import Algorithm
    from versalignlib_tpu.utils.checkpoint import ScoreCheckpoint
    from versalignlib_tpu.utils.compile_cache import enable_compile_cache
    from versalignlib_tpu.utils.profiling import GcupsMeter

    enable_compile_cache()

    p = AlignmentParameters()
    algorithm = Algorithm.SMITH_WATERMAN if args.algorithm == "sw" else Algorithm.NEEDLEMAN_WUNSCH
    score = device_score_fn(resolve_score_impl())
    n_dev = len(jax.devices())
    mesh = make_mesh() if n_dev > 1 else None

    if args.pairs:
        total = args.pairs
        get_chunk = lambda c, lo, hi: synthetic_chunk(args.seed, c, hi - lo, args.length)
    else:
        if not (args.reads and args.refs):
            ap.error("--pairs or (--reads and --refs) required")
        from versalignlib_tpu.io.fastq import parse_sequences

        reads_all = pad_and_encode(parse_sequences(args.reads))
        refs_all = pad_and_encode(parse_sequences(args.refs))
        total = reads_all.shape[0]
        get_chunk = lambda c, lo, hi: (reads_all[lo:hi], refs_all[lo:hi])

    import jax.numpy as jnp

    ckpt = ScoreCheckpoint(args.ckpt, total=total, chunk=args.chunk)
    pending = ckpt.pending_chunks()
    done = -(-total // args.chunk) - len(pending)
    print(f"{total} pairs, chunk {args.chunk}: {done} chunks done, "
          f"{len(pending)} pending; devices={n_dev} mesh={'yes' if mesh else 'no'}")

    meter = GcupsMeter()
    t_start = time.perf_counter()

    if args.mode == "score" and mesh is None and not args.no_prefetch:
        # Dispatch-ahead pipeline: chunk k+1's H2D staging (async
        # device_put, io/staging.py) and fill overlap chunk k's D2H +
        # checkpoint commit; only the OLDEST in-flight result ever blocks.
        import collections

        from versalignlib_tpu.io.staging import prefetch_to_device

        kernel = lambda r, f: score(r, f, p, algorithm)  # noqa: E731
        staged = prefetch_to_device(
            ((c, lo, *get_chunk(c, lo, hi)) for c, lo, hi in pending),
            depth=2,
        )
        inflight = collections.deque()
        cells_total = 0

        def commit_oldest():
            c_, lo_, dev = inflight.popleft()
            ckpt.commit(c_, lo_, np.asarray(dev, dtype=np.int32))
            if (c_ % 8) == 0:
                rate = cells_total / max(time.perf_counter() - t_start, 1e-9)
                print(f"  chunk {c_}: {rate / 1e9:.1f} GCUPS aggregate")

        for c, lo, r_d, f_d in staged:
            cells_total += r_d.shape[0] * r_d.shape[1] * f_d.shape[1]
            inflight.append((c, lo, kernel(r_d, f_d)))
            if len(inflight) >= 2:
                commit_oldest()
        while inflight:
            commit_oldest()
        wall = time.perf_counter() - t_start
        print(f"DONE: {cells_total / max(wall, 1e-9) / 1e9:.1f} GCUPS "
              f"aggregate; wall {wall:.1f}s; "
              f"pairs/sec {len(pending) * args.chunk / max(wall, 1e-9):.0f}")
        print("score sum:", int(ckpt.scores().sum()))
        return 0

    for c, lo, hi in pending:
        reads, refs = get_chunk(c, lo, hi)
        cells = reads.shape[0] * reads.shape[1] * refs.shape[1]
        with meter.measure(cells):
            if args.mode == "score":
                if mesh is not None:
                    scores = distributed_score_batch(
                        reads, refs, p, algorithm, mesh=mesh)
                else:
                    scores = np.asarray(score(
                        jnp.asarray(reads), jnp.asarray(refs), p, algorithm
                    ), dtype=np.int32)
            else:
                # raw column-store results: the per-pair Alignment object
                # build costs ~6x the C++ decode (see types.AlignmentBatch).
                from versalignlib_tpu import native

                raw = native.available()
                # Alignments stream to per-chunk files; scores land in
                # the checkpoint.
                alns = align_pairs(reads, refs, p, algorithm, raw=raw)
                scores = (np.asarray(alns.scores, dtype=np.int32) if raw
                          else np.array([a.score for a in alns], dtype=np.int32))
                out = pathlib.Path(args.ckpt) / f"alignments_{c:06d}.txt"
                with open(out, "w") as f:
                    if raw:
                        alns.write_to(f)
                    else:
                        for a in alns:
                            f.write(f"{a.read}\n{a.ref}\n{a.cigar}\t{a.score}\n")
        ckpt.commit(c, lo, scores)
        if (c % 8) == 0:
            print(f"  chunk {c}: {meter.report()}")

    wall = time.perf_counter() - t_start
    print(f"DONE: {meter.report()}; wall {wall:.1f}s; "
          f"pairs/sec {meter.cells and (sum(1 for _ in pending) * args.chunk) / max(wall, 1e-9):.0f}")
    print("score sum:", int(ckpt.scores().sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
