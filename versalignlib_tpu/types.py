"""Result types and algorithm enums.

The ``Alignment`` dataclass is the TPU-native analogue of the reference's
``Alignment`` struct (/root/reference/include/AlignmentKernel.h:12-24): two
gapped strings plus start/end indices. We additionally carry the score, a
CIGAR string, and true sequence coordinates (the reference's ``readEnd`` /
``refEnd`` are buffer indices, always ``aln_length - 1``,
DefaultKernel.cpp:450-451 — kept here as the ``buffer_*`` compat fields).
"""

from __future__ import annotations

import dataclasses
import enum


class Algorithm(enum.IntEnum):
    """DP algorithm selector.

    Values match the reference's ``opt & 0xF`` switch
    (/root/reference/include/AlignmentKernel.h:26-32): 0 = Smith-Waterman
    (local), 1 = "Needleman-Wunsch" (actually semi-global / overlap — free
    leading+trailing gaps in the score path, see SURVEY.md §2.2).
    """

    SMITH_WATERMAN = 0
    NEEDLEMAN_WUNSCH = 1


class TieBreak(enum.IntEnum):
    """Traceback pointer flavor (priority on ties + backend-specific rules).

    The reference backends disagree (scores agree, tracebacks on ties may
    not). Each enum value selects the complete pointer semantics of a
    reference backend family:

    - ``DIAG_UP_LEFT`` (canonical; Default + OpenCL backends): priority
      DIAG > UP > LEFT, SW cells equal to 0 get START
      (DefaultKernel.cpp:240-248, alignment_kernels.cl:106-112), and N bases
      count as *valid* for the NW end-cell tracking (``char_to_score != 0``,
      DefaultKernel.cpp:308,348).
    - ``DIAG_LEFT_UP`` (SSE/AVX backends): priority DIAG > LEFT > UP via
      max-of-codes, DIAG only when both bases are A/C/G/T, no START force at
      zero SW cells, and N counts as *invalid* for NW end-cell tracking
      (SSEKernel.cpp:364-379,515-527,597-611).

    The additive surfaces (affine gaps, custom S x S matrices, banded
    alignment — the reference has none of these) extend both flavors
    uniformly: the SSE flavor's "A/C/G/T" validity generalizes to
    "nonzero-scoring code" (``alphabet.valid_code_mask`` — exactly A/C/G/T
    for the DNA table), and affine pointers order DIAG > LEFT(E) > UP(F)
    with no zero-force, extend still beating open on gap ties.
    """

    DIAG_UP_LEFT = 0  # canonical (Default + OpenCL backends)
    DIAG_LEFT_UP = 1  # SSE / AVX backends


class Trace(enum.IntEnum):
    """Pointer codes in traceback matrices (2 bits each when packed)."""

    START = 0
    UP = 1     # consume read base against a gap in ref (cost score_gap_ref)
    LEFT = 2   # consume ref base against a gap in read (cost score_gap_read)
    DIAG = 3   # consume both (cost match/mismatch)


class AlignMode(enum.Enum):
    """Score-only vs full traceback (the two AlignmentKernel virtuals,
    /root/reference/include/AlignmentKernel.h:40-43)."""

    SCORE = "score"
    ALIGN = "align"


@dataclasses.dataclass
class Alignment:
    """One pairwise alignment result.

    ``read`` / ``ref`` are the gapped strings ('-' for gaps), covering only
    the aligned window — the meaningful segment of the reference's
    ``aln_length``-sized buffers between ``readStart`` and the end
    (DefaultKernel.cpp:441-451).
    """

    read: str
    ref: str
    score: int
    cigar: str
    # True 0-based sequence coordinates of the aligned window: the alignment
    # covers read[read_start:read_end] and ref[ref_start:ref_end] (half-open).
    read_start: int
    read_end: int
    ref_start: int
    ref_end: int
    # Reference-compat buffer indices (Alignment struct semantics):
    # buffer_start == readStart == refStart (first used index in the
    # aln_length buffer); buffer_end == aln_length - 1.
    buffer_start: int = 0
    buffer_end: int = 0

    def __len__(self) -> int:
        return len(self.read)


class AlignmentBatch:
    """Column-store alignment results — zero Python objects per pair.

    The native decoder writes gapped strings/CIGARs/metadata into flat
    arrays; building one :class:`Alignment` dataclass per pair costs ~6x the
    C++ walk itself (measured 735k alns/s raw vs 119k materialized), so bulk
    pipelines request ``raw=True`` and consume the arrays directly (or index
    lazily — ``batch[i]`` materializes a single :class:`Alignment`).

    Columns: ``read_gapped``/``ref_gapped`` (b, aln_cap) uint8 ('-' gaps,
    NUL-padded tails), ``cigar`` (b, cigar_cap) uint8, ``meta`` (b, 8) int32
    [score, read_start, read_end, ref_start, ref_end, aln_len, buffer_start,
    cigar_len]. CIGAR-only batches (``gapped=False`` decode) carry ``None``
    gapped columns — score/coords/CIGAR only, for pipelines that never
    display gapped text.
    """

    def __init__(self, read_gapped, ref_gapped, cigar, meta):
        self.read_gapped = read_gapped
        self.ref_gapped = ref_gapped
        self.cigar = cigar
        self.meta = meta

    def __len__(self) -> int:
        return self.meta.shape[0]

    @property
    def scores(self):
        return self.meta[:, 0]

    def __getitem__(self, k: int) -> "Alignment":
        if self.read_gapped is None:
            raise ValueError("CIGAR-only AlignmentBatch (decoded with "
                             "gapped=False) cannot materialize Alignment "
                             "objects; read meta/cigar columns directly")
        (score, rs, re_, fs, fe, aln_len, buf_start, clen) = (
            int(x) for x in self.meta[k])
        return Alignment(
            read=self.read_gapped[k, :aln_len].tobytes().decode("latin-1"),
            ref=self.ref_gapped[k, :aln_len].tobytes().decode("latin-1"),
            score=score,
            cigar=self.cigar[k, :clen].tobytes().decode("ascii"),
            read_start=rs, read_end=re_, ref_start=fs, ref_end=fe,
            buffer_start=buf_start,
            buffer_end=self.read_gapped.shape[1] - 1,
        )

    def __iter__(self):
        return (self[k] for k in range(len(self)))

    def slice(self, lo: int, hi: int) -> "AlignmentBatch":
        """Zero-copy row-range view (numpy slicing) — e.g. per-request
        slices of a coalesced serving batch."""
        gapped = self.read_gapped is not None
        return AlignmentBatch(
            self.read_gapped[lo:hi] if gapped else None,
            self.ref_gapped[lo:hi] if gapped else None,
            self.cigar[lo:hi], self.meta[lo:hi])

    def to_json_rows(self) -> list[dict]:
        """Serialize straight from the columns (no Alignment objects) —
        the serving fast path. CIGAR-only batches omit gapped strings.

        One ``tolist()`` converts the whole meta block in C (per-field
        ``int(np_scalar)`` calls measured ~7x slower for 4096-pair
        batches); the byte columns decode row-wise (variable lengths)."""
        gapped = self.read_gapped is not None
        meta_l = self.meta.tolist()
        cig_b = self.cigar.tobytes()
        ccap = self.cigar.shape[1]
        if gapped:
            rg_b = self.read_gapped.tobytes()
            fg_b = self.ref_gapped.tobytes()
            acap = self.read_gapped.shape[1]
        rows = []
        for k, (score, rs, re_, fs, fe, aln_len, _bs, clen) in \
                enumerate(meta_l):
            row = {"score": score,
                   "cigar": cig_b[k * ccap:k * ccap + clen].decode("ascii"),
                   "read_start": rs, "read_end": re_,
                   "ref_start": fs, "ref_end": fe}
            if gapped:
                o = k * acap
                row["read"] = rg_b[o:o + aln_len].decode("latin-1")
                row["ref"] = fg_b[o:o + aln_len].decode("latin-1")
            rows.append(row)
        return rows

    @staticmethod
    def concat(batches: list["AlignmentBatch"]) -> "AlignmentBatch":
        import numpy as _np

        if not batches:
            empty = _np.zeros((0, 0), _np.uint8)
            return AlignmentBatch(empty, empty, empty,
                                  _np.zeros((0, 8), _np.int32))
        gapped = batches[0].read_gapped is not None
        return AlignmentBatch(
            _np.concatenate([b.read_gapped for b in batches]) if gapped else None,
            _np.concatenate([b.ref_gapped for b in batches]) if gapped else None,
            _np.concatenate([b.cigar for b in batches]),
            _np.concatenate([b.meta for b in batches]),
        )

    def write_to(self, fileobj, compat: bool = False) -> None:
        """Stream alignments to a text file without materializing objects
        (``compat``: the reference's two-lines+blank format, main.cpp:146-153;
        else the extended ``read/ref/cigar\\tscore`` format)."""
        if self.read_gapped is None:
            raise ValueError("CIGAR-only AlignmentBatch cannot write gapped "
                             "text; decode with gapped=True for display output")
        rg, fg, cg, meta = self.read_gapped, self.ref_gapped, self.cigar, self.meta
        for k in range(len(self)):
            aln_len = int(meta[k, 5])
            r = rg[k, :aln_len].tobytes().decode("latin-1")
            f = fg[k, :aln_len].tobytes().decode("latin-1")
            if compat:
                fileobj.write(f"{r}\n{f}\n\n")
            else:
                c = cg[k, : int(meta[k, 7])].tobytes().decode("ascii")
                fileobj.write(f"{r}\n{f}\n{c}\t{int(meta[k, 0])}\n")


def cigar_from_gapped(read_gapped: str, ref_gapped: str) -> str:
    """Derive a CIGAR string (M/I/D run-length) from two gapped strings.

    I = insertion to reference (gap in ref, consumes read) — the UP pointer;
    D = deletion from reference (gap in read, consumes ref) — the LEFT pointer.
    """
    if len(read_gapped) != len(ref_gapped):
        raise ValueError("gapped strings must have equal length")
    ops = []
    for rc, fc in zip(read_gapped, ref_gapped):
        if rc == "-":
            op = "D"
        elif fc == "-":
            op = "I"
        else:
            op = "M"
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return "".join(f"{n}{op}" for op, n in ops)
