#!/usr/bin/env python
"""Bulk read-mapping pipeline: millions of reads vs a panel, restartable.

The mapping twin of bulk_align.py: streams read chunks (FASTA/FASTQ,
O(chunk) memory) through ``search.map_reads`` against a fixed panel,
committing per-read results (hit index, score, strand, MAPQ) to a
journaled memmap (utils/checkpoint.TableCheckpoint) so a crash resumes at
the first unfinished chunk. The final ``hits.tsv`` is assembled from the
completed table. Read names in bulk mode are positional (``read<i>``) —
the table is indexed by input order, so joins back to names are trivial.

Usage:
  python scripts/bulk_map.py --reads big.fastq --panel panel.fa --ckpt /tmp/m1
  python scripts/bulk_map.py --synthetic 1000000 --panel panel.fa --ckpt /tmp/m2
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

COLUMNS = ("hit_index", "score", "strand", "mapq")


def synthetic_chunk(seed: int, chunk_index: int, n: int, panel_enc):
    """Reads planted from random panel slices (half reverse-complemented) —
    deterministic per (seed, chunk), so resumes regenerate identical data."""
    from versalignlib_tpu.alphabet import reverse_complement_codes

    rng = np.random.default_rng((seed, chunk_index))
    r, L = panel_enc.shape
    m = min(L, max(16, L // 2))  # clamp: panels shorter than 16bp
    idx = rng.integers(0, r, size=n)
    lo = rng.integers(0, L - m + 1, size=n)
    reads = panel_enc[idx[:, None], lo[:, None] + np.arange(m)[None, :]]
    flip = rng.random(n) < 0.5
    reads[flip] = reverse_complement_codes(reads[flip])
    return np.ascontiguousarray(reads)


def _write_sam_part(path, reads, hits, panel_enc, panel_names, params,
                    algorithm, lo) -> None:
    """One chunk's SAM records (no header): raw traceback of each read's
    winning pair through the device pointer fill, formatted by the native
    C++ layer (Python sam_record fallback when unavailable)."""
    from versalignlib_tpu import native
    from versalignlib_tpu.alphabet import (decode, pad_and_encode,
                                           reverse_complement_codes)
    from versalignlib_tpu.ops.xla import align_pairs

    reads_enc = (reads if isinstance(reads, np.ndarray)
                 else pad_and_encode(reads))
    rev = hits.strand.astype(bool)
    oriented = np.where(rev[:, None], reverse_complement_codes(reads_enc),
                        reads_enc)
    refs_sel = panel_enc[hits.index]
    raw_ok = native.available()
    batch = align_pairs(oriented, refs_sel, params, algorithm, raw=raw_ok)
    b = reads_enc.shape[0]
    seqs = [decode(r) for r in oriented]
    qnames = [f"read{lo + i}" for i in range(b)]
    rnames = [panel_names[j] for j in hits.index]
    if raw_ok:
        body = native.format_sam_native(
            batch, seqs, qnames, rnames,
            np.where(rev, 16, 0).astype(np.int32),
            np.full(b, 4, dtype=np.int32),
            hits.mapq.astype(np.int32))
        with open(path, "wb") as f:
            f.write(body)
    else:
        from versalignlib_tpu.io.sam import sam_record

        with open(path, "w") as f:
            for i in range(b):
                f.write(sam_record(batch[i], seqs[i], qnames[i], rnames[i],
                                   reverse=bool(rev[i]),
                                   mapq=int(hits.mapq[i])) + "\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", help="FASTA/FASTQ of reads (streamed)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate this many panel-derived reads instead")
    ap.add_argument("--panel", required=True, help="FASTA/FASTQ panel")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--algorithm", choices=["sw", "nw"], default="sw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--single-strand", action="store_true",
                    help="skip the reverse-complement sweep")
    ap.add_argument("--sam", action="store_true",
                    help="also traceback each winner and write "
                         "alignments.sam (per-chunk parts via the native "
                         "C++ formatter; resume-safe, assembled at the "
                         "end)")
    args = ap.parse_args()

    from versalignlib_tpu.alphabet import pad_and_encode
    from versalignlib_tpu.io.fastq import parse_sequences_with_names
    from versalignlib_tpu.params import AlignmentParameters
    from versalignlib_tpu.search import map_reads
    from versalignlib_tpu.types import Algorithm
    from versalignlib_tpu.utils.checkpoint import TableCheckpoint
    from versalignlib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    p = AlignmentParameters()
    algorithm = (Algorithm.SMITH_WATERMAN if args.algorithm == "sw"
                 else Algorithm.NEEDLEMAN_WUNSCH)
    panel_recs = parse_sequences_with_names(args.panel)
    panel_names = [(n.split() or [""])[0] or f"panel{i}"
                   for i, (n, _) in enumerate(panel_recs)]
    panel_seqs = [s for _, s in panel_recs]
    panel_enc = pad_and_encode(panel_seqs)

    if args.synthetic:
        total = args.synthetic
        chunks = (
            synthetic_chunk(args.seed, c, min((c + 1) * args.chunk, total)
                            - c * args.chunk, panel_enc)
            for c in range(-(-total // args.chunk)))
    else:
        if not args.reads:
            ap.error("--reads or --synthetic required")
        # Two streaming passes, O(chunk) memory each: count, then map —
        # the checkpoint needs the total up front, and millions of reads
        # must never be materialized at once.
        from versalignlib_tpu.io.fastq import (count_sequences,
                                               iter_sequence_chunks)

        total = count_sequences(args.reads)
        chunks = iter_sequence_chunks(args.reads, args.chunk)

    if args.synthetic:
        fingerprint = f"synthetic:{args.synthetic}:{args.seed}"
    else:
        st = pathlib.Path(args.reads).stat()
        fingerprint = f"{args.reads}:{st.st_size}:{st.st_mtime_ns}"
    fingerprint += f"|algo={args.algorithm}|panel={panel_enc.shape}"
    ckpt = TableCheckpoint(args.ckpt, total=total, chunk=args.chunk,
                           width=len(COLUMNS), columns=COLUMNS,
                           fingerprint=fingerprint)
    done = ckpt.done_chunks()
    n_chunks = -(-total // args.chunk)
    print(f"{total} reads vs {panel_enc.shape[0]}-entry panel, chunk "
          f"{args.chunk}: {len(done)} done, {n_chunks - len(done)} pending")

    t0 = time.perf_counter()
    mapped = 0
    for c, reads in enumerate(chunks):
        # The stream must advance through completed chunks (file order),
        # but their mapping is skipped on resume.
        if c in done:
            continue
        lo = c * args.chunk
        hits = map_reads(reads, panel_enc, p, algorithm, align=False,
                         both_strands=not args.single_strand)
        rows = np.stack([hits.index.astype(np.int64),
                         hits.score.astype(np.int64),
                         hits.strand.astype(np.int64),
                         hits.mapq.astype(np.int64)], axis=1)
        if args.sam:
            # SAM part written BEFORE the journal commit: crash-consistent.
            _write_sam_part(pathlib.Path(args.ckpt) / f"sam_{c:06d}.part",
                            reads, hits, panel_enc, panel_names, p,
                            algorithm, lo)
        ckpt.commit(c, lo, rows)
        mapped += rows.shape[0]
        if (c % 8) == 0:
            rate = mapped / max(time.perf_counter() - t0, 1e-9)
            print(f"  chunk {c}: {rate:.0f} reads/s aggregate")

    if args.sam:
        sam_out = pathlib.Path(args.ckpt) / "alignments.sam"
        with open(sam_out, "w") as f:
            f.write("@HD\tVN:1.6\tSO:unknown\n")
            for name, seq in zip(panel_names, panel_seqs):
                f.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
            f.write("@PG\tID:versalignlib_tpu\tPN:versalignlib_tpu\n")
            for c in range(n_chunks):
                part = pathlib.Path(args.ckpt) / f"sam_{c:06d}.part"
                f.write(part.read_text())
        print(f"wrote {sam_out}")

    table = ckpt.table()
    out = pathlib.Path(args.ckpt) / "hits.tsv"
    with open(out, "w") as f:
        f.write("read\t" + "\t".join(COLUMNS) + "\n")
        for i in range(total):
            f.write(f"read{i}\t" + "\t".join(str(int(v)) for v in table[i])
                    + "\n")
    wall = time.perf_counter() - t0
    print(f"DONE: {total} reads mapped; wall {wall:.1f}s; wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
