#!/usr/bin/env python
"""Smoke run of the aligner on one GPU: every phase of the main path,
compiled for the card, checked bit-exact against the numpy oracles.

Usage:
    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # only the 4-device mesh path

Phases (one card): device, score, align, banded, search, CLI + server.
Each prints one line before the last: the phase, its shapes, its wall time
(median of 3 timed runs after a warm-up, each ended with
``block_until_ready``), GCUPS where cells are counted, and whether it
matched. The last line of stdout is one JSON object naming the device as
JAX reports it. A failed phase or any mismatch raises, so the script exits
non-zero without that line; without a GPU it exits non-zero at once.
Everything runs in this one process (a second process would also reserve
the card's memory).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

SEED = 0
ORACLE_SAMPLE = 64
#: The shapes users run (README, examples): dense pairs, long pairs, search.
SIZES = {
    "score_pairs": 16384, "pairs": 4096, "length": 512,
    "long_pairs": 64, "long_length": 16384, "band": 512,
    "check_pairs": 4, "check_length": 2048, "check_band": 128,
    "reads": 1024, "read_length": 150, "panel": 256, "panel_length": 1000,
    "mesh_pairs": 4 * 16384,
}


def final_line(devices) -> str:
    """The closing JSON line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def timed(fn, reps: int = 3):
    """(result, median seconds): one warm-up call, then ``reps`` timed
    calls, each ended with ``block_until_ready``."""
    import jax

    out = jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def report(phase: str, shapes: str, seconds: float, match: bool,
           cells: int | None = None, extra: str = "") -> None:
    rate = f" {cells / seconds / 1e9:.1f} GCUPS" if cells else ""
    more = f" | {extra}" if extra else ""
    print(f"[{phase}] {shapes}: {seconds:.6f} s{rate}{more} "
          f"match={match}", flush=True)
    if not match:
        raise AssertionError(f"{phase} {shapes}: mismatch")


def _fields(a):
    return (a.read, a.ref, a.score, a.cigar, a.read_start, a.read_end,
            a.ref_start, a.ref_end)


def _bases(rng, b, length, hi=5):
    import numpy as np

    return rng.integers(1, hi, size=(b, length), dtype=np.uint8)


def _mutate(rng, seq, rate):
    import numpy as np

    out = seq.copy()
    hit = rng.random(out.shape) < rate
    out[hit] = rng.integers(1, 5, size=int(hit.sum()), dtype=np.uint8)
    return out


def _params():
    from versalignlib_tpu.alphabet import blosum62
    from versalignlib_tpu.params import AlignmentParameters

    return {
        "linear": AlignmentParameters(),
        "affine": AlignmentParameters(gap_open_read=-4, gap_open_ref=-4),
        "blosum62": AlignmentParameters(matrix=blosum62(), score_gap_read=-4,
                                        score_gap_ref=-4),
    }


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from versalignlib_tpu import native
    from versalignlib_tpu.utils.capabilities import probe

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"[device] {devices[0].device_kind} x{len(devices)} | "
          f"{smi.stdout.strip()}", flush=True)
    print(f"[device] capabilities {probe()}", flush=True)
    if not native.available():
        raise AssertionError("native decoder did not build")
    return devices


def phase_score(rng):
    import jax.numpy as jnp
    import numpy as np

    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.alphabet import PROTEIN_ALPHABET
    from versalignlib_tpu.ops import oracle, triton_score, xla
    from versalignlib_tpu.types import Algorithm

    m = n = SIZES["length"]
    params = _params()
    for label, b, hi in (
            ("linear", SIZES["score_pairs"], 5), ("affine", SIZES["pairs"], 5),
            ("blosum62", SIZES["pairs"], len(PROTEIN_ALPHABET) + 1)):
        p = params[label]
        engine = AlignmentEngine(params=p, backend="auto")
        if engine.backend.name != "pallas":
            raise AssertionError(f"auto picked {engine.backend.name}")
        for alg in Algorithm:
            reads, refs = _bases(rng, b, m, hi), _bases(rng, b, n, hi)
            got, t_e2e = timed(lambda: engine.score_alignments(alg, reads, refs))
            r_d, f_d = jnp.asarray(reads), jnp.asarray(refs)
            kern, t_k = timed(
                lambda: triton_score.score_batch_triton(r_d, f_d, p, alg))
            ref_x, t_x = timed(lambda: xla.score_batch(r_d, f_d, p, alg))
            ref_x = np.asarray(ref_x)
            sub = rng.choice(b, ORACLE_SAMPLE, replace=False)
            want = oracle.score_alignments(alg, reads[sub], refs[sub], p)
            ok = (np.array_equal(got, ref_x)
                  and np.array_equal(np.asarray(kern), ref_x)
                  and np.array_equal(got[sub], want))
            cells = b * m * n
            report(f"score {label} {alg.name}", f"B={b} {m}x{n} engine",
                   t_e2e, ok, cells,
                   f"kernel {t_k:.6f} s {cells / t_k / 1e9:.1f} GCUPS | "
                   f"xla scan {t_x:.6f} s {cells / t_x / 1e9:.1f} GCUPS")


def phase_align(rng):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.ops import oracle, xla
    from versalignlib_tpu.types import Algorithm, TieBreak

    b, m, n = SIZES["pairs"], SIZES["length"], SIZES["length"]
    params = _params()
    refs = _bases(rng, b, n)
    reads = np.stack([_mutate(rng, r, 0.1) for r in refs])
    sub = rng.choice(b, ORACLE_SAMPLE, replace=False)
    for label in ("linear", "affine"):
        p = params[label]
        for alg in Algorithm:
            for tie in TieBreak:
                engine = AlignmentEngine(params=p, backend="auto", tie=tie)
                objs, t_obj = timed(
                    lambda: engine.compute_alignments(alg, reads, refs))
                batch, t_raw = timed(lambda: engine.compute_alignments(
                    alg, reads, refs, raw=True))
                want = oracle.compute_alignments(alg, reads[sub], refs[sub],
                                                 p, tie)
                ok = (len(batch) == len(objs) == b
                      and all(batch[i] == objs[i] for i in range(b))
                      and [_fields(objs[i]) for i in sub]
                      == [_fields(w) for w in want])
                report(f"align {label} {alg.name} {tie.name}",
                       f"B={b} {m}x{n} objects", t_obj, ok, b * m * n,
                       f"raw {t_raw:.6f} s")

    # Where the align time goes: device fill, device->host copy, decode.
    p, alg, tie = params["linear"], Algorithm.SMITH_WATERMAN, TieBreak.DIAG_UP_LEFT
    r_d, f_d = jnp.asarray(reads), jnp.asarray(refs)
    _, t_fill = timed(lambda: xla.fill_pointers(r_d, f_d, p, alg, tie))
    d2h = []
    for _ in range(3):
        dev = jax.block_until_ready(xla.fill_pointers(r_d, f_d, p, alg, tie))
        t0 = time.perf_counter()
        host = jax.device_get(dev)
        d2h.append(time.perf_counter() - t0)
    _, t_dec = timed(lambda: xla.decode_pointers(
        host[0], reads, refs, *host[1:], p, alg, raw=True))
    report("align split linear SMITH_WATERMAN", f"B={b} {m}x{n} fill",
           t_fill, True, b * m * n,
           f"d2h {statistics.median(d2h):.6f} s "
           f"({host[0].nbytes / 2**20:.0f} MiB) | decode {t_dec:.6f} s")


def phase_banded(rng):
    import numpy as np

    from versalignlib_tpu import models
    from versalignlib_tpu.ops.banded import (band_offsets,
                                             banded_align_batch,
                                             banded_align_oracle,
                                             banded_score_oracle)
    from versalignlib_tpu.types import Algorithm, TieBreak

    params = _params()

    def pairs(b, length):
        refs = _bases(rng, b, length)
        return np.stack([_mutate(rng, r, 0.05) for r in refs]), refs

    nb, L, band = SIZES["long_pairs"], SIZES["long_length"], SIZES["band"]
    cl, cband = SIZES["check_length"], SIZES["check_band"]
    big_reads, big_refs = pairs(nb, L)
    small_reads, small_refs = pairs(SIZES["check_pairs"], cl)
    for label in ("linear", "affine"):
        p = params[label]
        for make, alg in ((models.banded_smith_waterman,
                           Algorithm.SMITH_WATERMAN),
                          (models.banded_needleman_wunsch,
                           Algorithm.NEEDLEMAN_WUNSCH)):
            big = make(band=band, params=p)
            scores, t_s = timed(lambda: big.score(big_reads, big_refs))
            alns, t_a = timed(lambda: big.align(big_reads, big_refs), reps=3)
            # SW: the traceback ends at the best cell. NW: the overlap score
            # also counts every row's last column, while the traceback ends
            # on the last valid read row (the reference's asymmetry).
            got_a = np.array([a.score for a in alns])
            ok_big = bool(np.all(got_a == scores) if alg == Algorithm.SMITH_WATERMAN
                          else np.all(got_a <= scores))
            report(f"banded {label} {alg.name}",
                   f"B={nb} {L}x{L} band {band} score", t_s, ok_big,
                   nb * L * band, f"align {t_a:.6f} s")

            small = make(band=cband, params=p)
            offs = band_offsets(cl, cl, cl, cband)
            got_s = small.score(small_reads, small_refs)
            want_s = [banded_score_oracle(r, f, p, cband, alg, offs)
                      for r, f in zip(small_reads, small_refs)]
            ok = list(got_s) == want_s
            for tie in TieBreak:
                got_a = banded_align_batch(small_reads, small_refs, p, alg,
                                           band=cband, tie=tie)
                want_a = [banded_align_oracle(r, f, p, cband, alg, offs,
                                              tie=tie)
                          for r, f in zip(small_reads, small_refs)]
                ok = ok and [_fields(a) for a in got_a] == [
                    _fields(a) for a in want_a]
            ok = ok and [_fields(a) for a in small.align(
                small_reads, small_refs)] == [
                _fields(a) for a in banded_align_batch(
                    small_reads, small_refs, p, alg, band=cband)]
            report(f"banded oracle {label} {alg.name}",
                   f"B={len(small_reads)} {cl}x{cl} band {cband} score + "
                   "align, both ties", 0.0, ok)


def phase_search(rng):
    import numpy as np

    from versalignlib_tpu.alphabet import (PROTEIN_ALPHABET, encode_custom,
                                           reverse_complement_codes)
    from versalignlib_tpu.ops import oracle
    from versalignlib_tpu.ops.pssm import profile_search, pssm_from_sequences
    from versalignlib_tpu.search import map_reads
    from versalignlib_tpu.translate import translated_search
    from versalignlib_tpu.types import Algorithm

    p = _params()["linear"]
    nr, lr = SIZES["reads"], SIZES["read_length"]
    npn, lp = SIZES["panel"], SIZES["panel_length"]
    panel = _bases(rng, npn, lp)
    src = rng.integers(0, npn, size=nr)
    starts = rng.integers(0, lp - lr, size=nr)
    reads = np.stack([_mutate(rng, panel[s, o:o + lr], 0.03)
                      for s, o in zip(src, starts)])
    flip = rng.random(nr) < 0.5
    reads[flip] = reverse_complement_codes(reads[flip])
    hits, t = timed(lambda: map_reads(reads, panel, p, both_strands=True))
    ref = map_reads(reads, panel, p, both_strands=True, impl="xla",
                    backend="xla")
    ok = (np.array_equal(hits.index, ref.index)
          and np.array_equal(hits.score, ref.score)
          and np.array_equal(hits.strand, ref.strand)
          and np.array_equal(hits.mapq, ref.mapq)
          and hits.alignments == ref.alignments)
    for i in rng.choice(nr, 2, replace=False):
        fwd = oracle.score_alignments(Algorithm.SMITH_WATERMAN,
                                      np.repeat(reads[i:i + 1], npn, 0),
                                      panel, p)
        rev = oracle.score_alignments(
            Algorithm.SMITH_WATERMAN,
            np.repeat(reverse_complement_codes(reads[i:i + 1]), npn, 0),
            panel, p)
        strand = int(rev.max() > fwd.max())
        best = (rev if strand else fwd)
        ok = ok and (int(hits.index[i]), int(hits.score[i]),
                     int(hits.strand[i])) == (int(best.argmax()),
                                              int(best.max()), strand)
    report("search map_reads both strands",
           f"{nr} reads x{lr} vs {npn} x{lp}", t, ok, 2 * nr * npn * lr * lp)

    motif = _bases(rng, 1, 24)[0]
    insts = np.stack([_mutate(rng, motif, 0.1) for _ in range(40)])
    P = pssm_from_sequences(insts)
    pool = _bases(rng, 512, 200)
    for k in range(0, 512, 7):
        o = int(rng.integers(0, 176))
        pool[k, o:o + 24] = _mutate(rng, motif, 0.1)
    got, t = timed(lambda: profile_search(P, pool, k=16, hits=True))
    want = profile_search(P, pool, k=16, hits=True, backend="oracle")
    ok = [(h.index, h.score, h.end_row, h.end_col) for h in got] == [
        (h.index, h.score, h.end_row, h.end_col) for h in want]
    report("search pssm", "24x6 profile vs 512 x200", t, ok,
           24 * 512 * 200)

    prot_panel = ["".join(rng.choice(list(PROTEIN_ALPHABET[:20]), size=100))
                  for _ in range(64)]
    dna = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(32)]
    params_t = _params()["blosum62"]
    th, t = timed(lambda: translated_search(dna, prot_panel, params_t,
                                            alignments=True))
    tx = translated_search(dna, prot_panel, params_t, impl="xla",
                           alignments=True)
    ok = (np.array_equal(th.scores, tx.scores)
          and np.array_equal(th.index, tx.index)
          and np.array_equal(th.frame, tx.frame)
          and th.alignments == tx.alignments)
    panel_codes = encode_custom(prot_panel, PROTEIN_ALPHABET)
    for i in (0, 1):
        prots = encode_custom(th.proteins[i], PROTEIN_ALPHABET)
        want = np.stack([oracle.score_alignments(
            Algorithm.SMITH_WATERMAN, np.repeat(prots[f:f + 1], 64, 0),
            panel_codes, params_t) for f in range(6)])
        ok = ok and np.array_equal(th.scores[i], want)
    report("search translated", "32 reads x300 (6 frames) vs 64 x100", t,
           ok, 32 * 6 * 100 * 64 * 100)


def phase_cli_server(rng):
    import http.client
    import tempfile

    import numpy as np

    from versalignlib_tpu import AlignmentEngine, cli
    from versalignlib_tpu.alphabet import pad_and_encode
    from versalignlib_tpu.ops import oracle
    from versalignlib_tpu.serve import (AlignServer, BatchingAligner,
                                        _alignment_json)
    from versalignlib_tpu.types import Algorithm

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = cli.main(["--selftest", "--outdir", tmp])
        dt = time.perf_counter() - t0
        files = sorted(q.name for q in pathlib.Path(tmp).iterdir())
        ok = rc == 0 and len(files) == 4 and all(
            (pathlib.Path(tmp) / f).stat().st_size > 0 for f in files)
    report("cli --selftest", "128 pairs 64x96, SW+NW score+align (one run)",
           dt, ok)

    def seqs(k, lo, hi):
        return ["".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))
                for _ in range(k)]

    engine = AlignmentEngine()
    reads, refs = seqs(32, 90, 128), seqs(32, 100, 128)
    panel = seqs(8, 200, 256)
    sw = Algorithm.SMITH_WATERMAN
    with BatchingAligner(engine) as ba, AlignServer(ba) as server:
        server.start()
        conn = http.client.HTTPConnection(*server.address, timeout=600)

        def post(path, body):
            conn.request("POST", path, json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            if resp.status != 200:
                raise AssertionError(f"{path}: HTTP {resp.status} {out}")
            return out

        pair = {"reads": reads, "refs": refs, "algorithm": "sw"}
        scores, t_s = timed(lambda: post("/v1/score", pair)["scores"])
        alns, t_a = timed(lambda: post("/v1/align", pair)["alignments"])
        mbody = {"reads": reads, "panel": panel, "algorithm": "sw",
                 "both_strands": False}
        hits, t_m = timed(lambda: post("/v1/map", mbody)["hits"])
        conn.close()
    r_enc, f_enc = pad_and_encode(reads), pad_and_encode(refs)
    ok = scores == [int(s) for s in oracle.score_alignments(
        sw, r_enc, f_enc, engine.params)]
    ok = ok and alns == [_alignment_json(a) for a in oracle.compute_alignments(
        sw, r_enc, f_enc, engine.params)]
    p_enc = pad_and_encode(panel)
    for i, h in enumerate(hits):
        s = oracle.score_alignments(sw, np.repeat(r_enc[i:i + 1], 8, 0),
                                    p_enc, engine.params)
        ok = ok and (h["index"], h["score"]) == (int(s.argmax()),
                                                 int(s.max()))
    report("server", "32 pairs /v1/score", t_s, ok, None,
           f"/v1/align {t_a:.6f} s | /v1/map 32 reads x 8 {t_m:.6f} s")


def phase_four_cards(rng):
    import jax
    import numpy as np

    from versalignlib_tpu import AlignmentEngine
    from versalignlib_tpu.ops import oracle
    from versalignlib_tpu.parallel import make_mesh
    from versalignlib_tpu.types import Algorithm

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four-cards needs 4 devices, "
                             f"found {len(jax.devices())}")
    mesh = make_mesh(4)
    b, m, n = SIZES["mesh_pairs"], SIZES["length"], SIZES["length"]
    refs = _bases(rng, b, n)
    reads = np.stack([_mutate(rng, r, 0.1) for r in refs])
    sub = rng.choice(b, ORACLE_SAMPLE, replace=False)
    four = AlignmentEngine(mesh=mesh)
    one = AlignmentEngine()
    p = one.params
    for alg in Algorithm:
        s4, t4 = timed(lambda: four.score_alignments(alg, reads, refs))
        s1, t1 = timed(lambda: one.score_alignments(alg, reads, refs))
        ok = (np.array_equal(s4, s1) and np.array_equal(
            s4[sub], oracle.score_alignments(alg, reads[sub], refs[sub], p)))
        cells = b * m * n
        report(f"4 cards score {alg.name}", f"B={b} {m}x{n} mesh(4)", t4, ok,
               cells, f"1 card {t1:.6f} s {cells / t1 / 1e9:.1f} GCUPS")

        a4, t4 = timed(lambda: four.compute_alignments(alg, reads, refs,
                                                       raw=True))
        a1, t1 = timed(lambda: one.compute_alignments(alg, reads, refs,
                                                      raw=True))
        ok = all(np.array_equal(getattr(a4, c), getattr(a1, c)) for c in
                 ("read_gapped", "ref_gapped", "cigar", "meta"))
        want = oracle.compute_alignments(alg, reads[sub], refs[sub], p)
        ok = ok and [_fields(a4[int(i)]) for i in sub] == [
            _fields(w) for w in want]
        report(f"4 cards align {alg.name}", f"B={b} {m}x{n} mesh(4) raw", t4,
               ok, cells, f"1 card {t1:.6f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device mesh path and its "
                         "comparison with one card")
    args = ap.parse_args(argv)
    import numpy as np

    from versalignlib_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = phase_device()
    rng = np.random.default_rng(SEED)
    if args.four_cards:
        phase_four_cards(rng)
    else:
        for phase in (phase_score, phase_align, phase_banded, phase_search,
                      phase_cli_server):
            t0 = time.perf_counter()
            phase(rng)
            print(f"[{phase.__name__}] done in "
                  f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
