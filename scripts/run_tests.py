#!/usr/bin/env python
"""Sharded test runner: the full suite, guaranteed to finish.

The monolithic ``pytest tests/`` run accumulates hundreds of XLA-CPU compiles
(an 8-device virtual CPU mesh, Pallas kernels in interpret mode) in ONE
process and has twice died with SIGSEGV/SIGABRT inside ``backend_compile``
at ~98% with no summary line — a crash that can mask real failures.  This runner executes each
test file in its OWN pytest subprocess (bounding per-process compile-state),
aggregates the per-file pass/fail/skip counts, and writes ``TESTS.json`` plus
a per-round copy ``TESTS_r{NN}.json`` at the repo root so "the suite passed"
is an auditable artifact.

Usage: python scripts/run_tests.py [-k EXPR] [--files f1 f2 ...]
Exit: 0 iff every subprocess exited 0 and no test failed/errored.
"""

import argparse
import glob
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

SUMMARY_RE = re.compile(
    r"(?:(\d+) failed)?(?:, )?(?:(\d+) passed)?(?:, )?(?:(\d+) skipped)?"
    r"(?:, )?(?:(\d+) deselected)?(?:, )?(?:(\d+) error(?:s)?)?"
    r"(?:, \d+ warnings?)? in [\d.]+s(?: \(\d+:\d+:\d+\))?")


def _infer_round() -> int:
    rounds = [int(m.group(1)) for f in glob.glob(str(ROOT / "BENCH_r*.json"))
              if (m := re.search(r"BENCH_r(\d+)\.json$", f))]
    return (max(rounds) + 1) if rounds else 1


def parse_counts(output: str) -> dict:
    """Pull pass/fail/skip counts from pytest's last summary line."""
    counts = {"failed": 0, "passed": 0, "skipped": 0, "deselected": 0,
              "errors": 0}
    for line in reversed(output.splitlines()):
        line = line.strip().strip("=").strip()
        m = SUMMARY_RE.fullmatch(line)
        if m:
            for key, grp in zip(counts, m.groups()):
                if grp:
                    counts[key] = int(grp)
            counts["summary"] = line
            return counts
        if line == "no tests ran" or "no tests ran in" in line:
            counts["summary"] = line
            return counts
    counts["summary"] = None  # crashed before printing a summary
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-k", default=None, help="pytest -k expression")
    ap.add_argument("--files", nargs="*", default=None,
                    help="explicit test files (default: tests/test_*.py)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-file timeout in seconds")
    args = ap.parse_args()

    files = args.files or sorted(
        str(p.relative_to(ROOT)) for p in (ROOT / "tests").glob("test_*.py"))
    results = []
    totals = {"failed": 0, "passed": 0, "skipped": 0, "errors": 0}
    t0 = time.time()
    ok = True
    for f in files:
        cmd = [sys.executable, "-m", "pytest", f, "-q",
               "-p", "no:cacheprovider"]
        if args.k:
            cmd += ["-k", args.k]
        start = time.time()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=args.timeout)
            rc, out = proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            rc = -9
            out = ((e.stdout or b"").decode(errors="replace")
                   + (e.stderr or b"").decode(errors="replace")
                   + "\n[run_tests] TIMEOUT")
        counts = parse_counts(out)
        dur = round(time.time() - start, 1)
        # pytest rc 5 = "no tests collected" (e.g. everything deselected
        # by -k): not a failure.
        file_ok = (rc == 0 or rc == 5) and counts["failed"] == 0 \
            and counts["errors"] == 0 and counts["summary"] is not None
        if rc == 5 and counts["summary"] is None:
            file_ok = True
        ok &= file_ok
        for k in totals:
            totals[k] += counts.get(k, 0)
        results.append({"file": f, "rc": rc, "ok": file_ok, "secs": dur,
                        **{k: counts[k] for k in
                           ("passed", "failed", "skipped")},
                        "summary": counts["summary"]})
        status = "ok " if file_ok else "FAIL"
        print(f"[{status}] {f}: {counts['summary'] or f'rc={rc} NO SUMMARY'}"
              f" ({dur}s)", flush=True)
        if not file_ok:
            tail = "\n".join(out.splitlines()[-30:])
            print(tail, flush=True)

    artifact = {
        "ok": ok,
        "total_passed": totals["passed"],
        "total_failed": totals["failed"],
        "total_skipped": totals["skipped"],
        "total_errors": totals["errors"],
        "files": results,
        "secs": round(time.time() - t0, 1),
        "command": "python scripts/run_tests.py",
        "note": "one pytest subprocess per test file; bounds XLA-CPU "
                "compile-state accumulation that SIGSEGVs the monolithic run",
    }
    out_path = ROOT / "TESTS.json"
    out_path.write_text(json.dumps(artifact, indent=1))
    rnd = _infer_round()
    (ROOT / f"TESTS_r{rnd:02d}.json").write_text(json.dumps(artifact, indent=1))
    print(f"\n{'OK' if ok else 'FAILED'}: {totals['passed']} passed, "
          f"{totals['failed']} failed, {totals['skipped']} skipped, "
          f"{totals['errors']} errors in {artifact['secs']}s "
          f"-> {out_path.name}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
