#!/usr/bin/env python
"""Multi-host alignment driver.

Launch ONE copy of this script per host/process; together they score and/or
align a shared pair batch with zero cross-host pointer traffic (see
versalignlib_tpu/parallel/multihost.py). The reference has no multi-node
anything (SURVEY §2.6) — this is the multi-host analogue of its example
driver (/root/reference/src/impl/main.cpp:74-215).

GPU hosts: run ONE process per host; it owns all of that host's local
cards (one JAX process per card set — a second process on a card fails for
want of memory). Give every process the same rendezvous, the process
count and its own id (process 0's host serves the rendezvous):

    # on host i of N
    python scripts/multihost_align.py --reads reads.fa --refs refs.fa \
        --outdir out/ --coordinator host0:9911 --num-processes N \
        --process-id i

For CPU-based validation (CI, laptops) add a virtual device count (Gloo
stands in for the interconnect):

    python scripts/multihost_align.py ... \
        --coordinator localhost:9911 --num-processes 2 --process-id $i \
        --cpu-devices 4

Outputs (extended CLI formats, cli.py): process 0 writes
``scores_<algo>.txt`` for the WHOLE batch (scores are all-gathered);
every process writes ``alignments_<algo>.part<pid>-of<n>.txt`` covering
its contiguous pair slice, plus a ``manifest.json`` from process 0.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--refs", required=True)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--algorithm", choices=["sw", "nw", "both"], default="both")
    ap.add_argument("--mode", choices=["score", "align", "both"], default="both")
    ap.add_argument("--match", type=int, default=2)
    ap.add_argument("--mismatch", type=int, default=-1)
    ap.add_argument("--gap-read", type=int, default=-3)
    ap.add_argument("--gap-ref", type=int, default=-3)
    ap.add_argument("--gap-open", type=int, default=0,
                    help="affine gap-open penalty (0 = linear)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port rendezvous served by process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="force CPU platform with N local virtual devices "
                         "(validation without accelerators)")
    args = ap.parse_args(argv)

    if args.cpu_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()

    import jax

    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")

    from versalignlib_tpu.parallel import multihost
    from versalignlib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    multihost.initialize(args.coordinator, args.num_processes, args.process_id)
    pid, nproc = jax.process_index(), jax.process_count()

    from versalignlib_tpu.alphabet import pad_and_encode
    from versalignlib_tpu.cli import OUT_FILES, _write_alignments, _write_scores
    from versalignlib_tpu.io.fasta import parse_fasta
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.types import Algorithm

    reads = parse_fasta(args.reads)
    refs = parse_fasta(args.refs)
    if len(reads) != len(refs):
        print(f"Read count ({len(reads)}) does not equal ref count "
              f"({len(refs)})", file=sys.stderr)
        return 1
    r_enc = pad_and_encode(reads)
    f_enc = pad_and_encode(refs)
    params = AlignmentParameters(
        score_match=args.match, score_mismatch=args.mismatch,
        score_gap_read=args.gap_read, score_gap_ref=args.gap_ref,
        gap_open_read=args.gap_open, gap_open_ref=args.gap_open,
    )

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    algos = {"sw": [Algorithm.SMITH_WATERMAN],
             "nw": [Algorithm.NEEDLEMAN_WUNSCH],
             "both": [Algorithm.SMITH_WATERMAN, Algorithm.NEEDLEMAN_WUNSCH]}[
        args.algorithm]
    manifest = {"pairs": len(reads), "processes": nproc,
                "devices": jax.device_count(), "outputs": []}

    for algorithm in algos:
        t0 = time.time()
        if args.mode in ("score", "both"):
            scores = multihost.multihost_score_batch(
                r_enc, f_enc, params, algorithm)
            if pid == 0:
                path = outdir / OUT_FILES[(algorithm, "score")]
                _write_scores(path, reads, refs, scores)
                manifest["outputs"].append(path.name)
        if args.mode in ("align", "both"):
            alns, lo, hi = multihost.multihost_align_batch(
                r_enc, f_enc, params, algorithm)
            base = OUT_FILES[(algorithm, "align")].removesuffix(".txt")
            path = outdir / f"{base}.part{pid:03d}-of{nproc:03d}.txt"
            _write_alignments(path, alns)
            # Slices are deterministic, so process 0 can enumerate every
            # process's shard without communicating.
            manifest["outputs"].extend(
                {"file": f"{base}.part{p:03d}-of{nproc:03d}.txt",
                 "rows": list(multihost.process_slice(len(reads), p, nproc))}
                for p in range(nproc))
        print(f"[{pid}/{nproc}] {algorithm.name}: {len(reads)} pairs "
              f"in {time.time() - t0:.1f}s", flush=True)

    if pid == 0:
        (outdir / "manifest.json").write_text(json.dumps(manifest, indent=1))
    # All processes must reach the end before the coordinator (pid 0) exits.
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("versalign-multihost-done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
