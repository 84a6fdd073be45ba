"""Multi-host layer: REAL multi-process validation on CPU.

Spawns two OS processes that rendezvous through ``jax.distributed``
(Gloo collectives standing in for the interconnect) and run the multi-host
driver (scripts/multihost_align.py) end-to-end: global-mesh sharded scoring
with a trailing XLA all-gather, per-host align + decode, per-host shard
files. Outputs must merge to exactly the single-process engine's results.
"""

import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import random_codes  # noqa: F401  (rng fixture pattern)
from versalignlib_tpu import AlignmentEngine
from versalignlib_tpu.io.fasta import write_fasta

REPO = pathlib.Path(__file__).resolve().parent.parent
DRIVER = REPO / "scripts" / "multihost_align.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _random_seqs(rng, n, lo, hi):
    out = []
    for _ in range(n):
        length = int(rng.integers(lo, hi + 1))
        s = "".join(rng.choice(list("ACGTacgtN"), size=length,
                               p=[.22, .22, .22, .22, .025, .025, .025, .025, .02]))
        out.append(s)
    return out


@pytest.fixture(scope="module")
def mh_run(tmp_path_factory):
    """One 2-process driver run shared by the assertions below."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("mh")
    b = 23  # odd: uneven process slices (12 + 11)
    reads = _random_seqs(rng, b, 18, 24)
    refs = _random_seqs(rng, b, 20, 30)
    write_fasta(tmp / "reads.fa", reads)
    write_fasta(tmp / "refs.fa", refs)

    port = _free_port()
    outdir = tmp / "out"
    import os

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(DRIVER),
             "--reads", str(tmp / "reads.fa"), "--refs", str(tmp / "refs.fa"),
             "--outdir", str(outdir), "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--cpu-devices", "2"],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return reads, refs, outdir


def _parse_scores(path):
    lines = path.read_text().splitlines()
    return [int(lines[i + 2]) for i in range(0, len(lines), 3)]


def _parse_alignments(path):
    lines = path.read_text().splitlines()
    out = []
    for i in range(0, len(lines), 3):
        cigar, score = lines[i + 2].split("\t")
        out.append((lines[i], lines[i + 1], int(score), cigar))
    return out


@pytest.mark.parametrize("name", ["smith_waterman", "needleman_wunsch"])
def test_multihost_scores_match_engine(mh_run, name):
    reads, refs, outdir = mh_run
    from versalignlib_tpu.types import Algorithm

    algorithm = (Algorithm.SMITH_WATERMAN if name == "smith_waterman"
                 else Algorithm.NEEDLEMAN_WUNSCH)
    got = _parse_scores(outdir / f"scores_{name}.txt")
    engine = AlignmentEngine(backend="oracle")
    want = engine.score_alignments(algorithm, reads, refs)
    assert got == list(map(int, want))


@pytest.mark.parametrize("name", ["smith_waterman", "needleman_wunsch"])
def test_multihost_alignment_shards_merge_exact(mh_run, name):
    reads, refs, outdir = mh_run
    from versalignlib_tpu.types import Algorithm

    algorithm = (Algorithm.SMITH_WATERMAN if name == "smith_waterman"
                 else Algorithm.NEEDLEMAN_WUNSCH)
    parts = sorted(outdir.glob(f"alignments_{name}.part*.txt"))
    assert len(parts) == 2
    merged = [a for p in parts for a in _parse_alignments(p)]
    assert len(merged) == len(reads)

    engine = AlignmentEngine(backend="oracle")
    want = engine.compute_alignments(algorithm, reads, refs)
    for g, w in zip(merged, want):
        assert g == (w.read, w.ref, w.score, w.cigar)


def test_multihost_manifest(mh_run):
    reads, _, outdir = mh_run
    man = json.loads((outdir / "manifest.json").read_text())
    assert man["pairs"] == len(reads)
    assert man["processes"] == 2
    assert man["devices"] == 4
    # Align shards tile the batch exactly.
    rows = sorted(o["rows"] for o in man["outputs"] if isinstance(o, dict)
                  if "alignments_smith_waterman" in o["file"])
    assert rows[0][0] == 0 and rows[-1][1] == len(reads)
    assert rows[0][1] == rows[1][0]
