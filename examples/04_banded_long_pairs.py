"""Banded alignment for LONG pairs (10-100kbp+).

Dense DP is O(m*n) memory; for long, mostly-colinear pairs the banded
model fills only a moving diagonal band, one row at a time. Semantics are
defined by the banded oracle (ops/banded.py); scores equal dense whenever
the true alignment stays inside the band.
"""

import numpy as np

from versalignlib_tpu import models

rng = np.random.default_rng(1)
bases = np.array(list("ACGT"))

# A 3kbp pair: the "read" is the ref with a 100bp deletion + scattered SNPs.
ref = "".join(rng.choice(bases, size=3000))
read = list(ref[:1200] + ref[1300:])
for k in rng.integers(0, len(read), size=20):
    read[int(k)] = str(rng.choice(bases))
read = "".join(read)

model = models.banded_smith_waterman(band=256)
aln = model.align([read], [ref])[0]
dels = [run for run in aln.cigar.replace("M", " M ").split() if "D" in run]
print(f"score={aln.score} cigar-ops={len(aln.cigar)} chars, "
      f"deletion runs: {dels}")
print(f"aligned read[{aln.read_start}:{aln.read_end}] to "
      f"ref[{aln.ref_start}:{aln.ref_end}]")
