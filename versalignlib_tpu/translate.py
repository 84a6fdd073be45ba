"""Six-frame translation + translated protein search (blastx-style).

ADDITIVE over the reference (DNA-only, /root/reference/src/Kernels/default/
DefaultKernel.h:43-60): translate DNA reads in all six reading frames
(three forward, three reverse-complement), score every translation against
a protein panel with a substitution matrix (BLOSUM62 by default) through
the framework's matrix-mode kernels, and report each read's best
(frame, panel entry) — the classic blastx workflow.

Conventions follow NCBI: stop codons translate to ``'*'`` (strongly
negative vs everything in BLOSUM62, +1 vs itself), codons containing any
non-ACGT base (N, padding) translate to ``'X'`` (mildly negative). Frames
are labeled +1/+2/+3 and -1/-2/-3; a reverse frame's protein reads along
the reverse complement, so a hit in frame -f starts near the READ's 3'
end. The compute path is the standard one-vs-many machinery
(search.score_matrix) on the device score path; nothing here is
translation-specific below the Python orchestration.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from versalignlib_tpu.alphabet import PROTEIN_ALPHABET, blosum62, encode_custom
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm

#: Standard genetic code, codon (DNA letters) -> amino acid letter.
GENETIC_CODE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

# DNA code layout (alphabet.py): A=1, T=2, C=3, G=4; N=5; pad/other=0.
_CODE_BASE = "\0ATCGN"
#: (6, 6, 6) codon-code -> amino letter; any non-ACGT component -> 'X'.
_CODON_AA = np.full((6, 6, 6), "X", dtype="U1")
for _c1 in range(1, 5):
    for _c2 in range(1, 5):
        for _c3 in range(1, 5):
            _CODON_AA[_c1, _c2, _c3] = GENETIC_CODE[
                _CODE_BASE[_c1] + _CODE_BASE[_c2] + _CODE_BASE[_c3]]

#: complement in code space: A(1)<->T(2), C(3)<->G(4); N/pad fixed.
_COMPLEMENT = np.array([0, 2, 1, 4, 3, 5], dtype=np.uint8)

FRAMES = (1, 2, 3, -1, -2, -3)


def translate_codes(codes: np.ndarray, frame: int) -> str:
    """Translate one encoded DNA sequence in one frame -> protein string.

    ``frame``: +1/+2/+3 read forward from offset frame-1; -1/-2/-3 read the
    reverse complement from offset |frame|-1. Trailing bases short of a
    full codon are dropped (NCBI convention).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if frame < 0:
        codes = _COMPLEMENT[codes[::-1]]
    off = abs(frame) - 1
    usable = (codes.size - off) // 3
    if usable <= 0:
        return ""
    c = codes[off:off + usable * 3].reshape(usable, 3)
    return "".join(_CODON_AA[c[:, 0], c[:, 1], c[:, 2]])


def translate_six_frames(seq) -> list[tuple[int, str]]:
    """DNA string or (L,) code array -> [(frame, protein), ...] for all 6."""
    if isinstance(seq, str):
        from versalignlib_tpu.alphabet import encode

        codes = encode(seq)
    else:
        codes = np.asarray(seq, dtype=np.uint8)
    return [(f, translate_codes(codes, f)) for f in FRAMES]


#: blastx-flavor defaults: BLOSUM62 with affine gaps (open 10, extend 1).
TRANSLATED_PARAMETERS = AlignmentParameters(
    score_gap_read=-1, score_gap_ref=-1,
    gap_open_read=-10, gap_open_ref=-10,
    matrix=blosum62(),
)


@dataclasses.dataclass
class TranslatedHits:
    """Per-read best translated hit. ``scores`` is the full (B, 6, R)
    score tensor (frames in :data:`FRAMES` order) for downstream ranking.

    The coordinate/alignment fields are populated by
    ``translated_search(..., alignments=True)``: the winning frame's
    protein-level alignment (vs the winning panel entry) plus its mapping
    back to DNA READ coordinates — 0-based inclusive [dna_start, dna_end]
    on the FORWARD strand of the read as given, ``strand`` '-' for reverse
    frames, and ``dna_cigar`` the protein CIGAR with counts scaled x3
    (codon granularity, the blastx convention). ``evalue``/``bitscore``
    come from a :func:`calibrate_translated` Gumbel fit.
    """

    index: np.ndarray    # (B,) best panel entry
    frame: np.ndarray    # (B,) best reading frame (+-1/2/3)
    score: np.ndarray    # (B,) int32 best score
    scores: np.ndarray   # (B, 6, R) int32
    proteins: list[list[str]]  # per read, the 6 frame translations
    alignments: list | None = None      # (B,) types.Alignment (protein-level)
    dna_start: np.ndarray | None = None  # (B,) 0-based read coord of hit
    dna_end: np.ndarray | None = None    # (B,) inclusive end read coord
    strand: np.ndarray | None = None     # (B,) '+'/'-'
    dna_cigar: list[str] | None = None   # (B,) codon-scaled CIGAR
    evalue: np.ndarray | None = None     # (B,) float
    bitscore: np.ndarray | None = None   # (B,) float

    def __len__(self) -> int:
        return self.index.shape[0]


def _scale_cigar_dna(cigar: str) -> str:
    """Protein CIGAR -> DNA CIGAR: every run length x3 (codon granularity)."""
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append(f"{3 * int(num)}{ch}")
            num = ""
    return "".join(out)


def map_protein_to_dna(frame: int, read_len: int, prot_start: int,
                       prot_end: int) -> tuple[int, int, str]:
    """Map an inclusive protein-coordinate range of one reading frame back
    to 0-based inclusive FORWARD-strand read coordinates.

    Forward frame +f: protein position i occupies read bases
    ``(f-1)+3i .. (f-1)+3i+2``. Reverse frame -f reads the reverse
    complement from offset f-1, so RC offset r maps to read index
    ``read_len-1-r`` and the range flips.
    """
    if frame > 0:
        off = frame - 1
        return off + 3 * prot_start, off + 3 * prot_end + 2, "+"
    off = -frame - 1
    rc_lo = off + 3 * prot_start
    rc_hi = off + 3 * prot_end + 2
    return read_len - 1 - rc_hi, read_len - 1 - rc_lo, "-"


def translated_search(
    reads,
    panel,
    params: AlignmentParameters | None = None,
    algorithm: Algorithm = Algorithm.SMITH_WATERMAN,
    impl: str = "auto",
    alignments: bool = False,
    calibration=None,
    panel_chunk: int | None = None,
    mesh=None,
    panel_axis: str = "reads",
) -> TranslatedHits:
    """Score DNA reads against a PROTEIN panel in all six reading frames.

    ``reads``: DNA strings or (B, L) uint8 code array; ``panel``: protein
    strings or a pre-encoded (R, n) uint8 code array (PROTEIN_ALPHABET).
    All 6*B translations are scored against the panel in one
    :func:`~versalignlib_tpu.search.score_matrix` sweep; ties on the fold keep the earlier frame in
    :data:`FRAMES` order, then the lower panel index (scan order, like
    best_hits).

    ``alignments=True`` adds the ``compute_alignments`` half of the
    interface (include/AlignmentKernel.h:40-43) for the winners: each
    read's winning (frame, entry) pair is aligned protein-vs-protein
    through the matrix-mode align pipeline (one batched device dispatch),
    and the hit is mapped back to DNA read coordinates
    (:func:`map_protein_to_dna`) with a codon-scaled CIGAR.
    ``calibration`` (:func:`calibrate_translated`) adds E-value/bitscore.

    ``panel_chunk``: fold the best hit per read ACROSS panel chunks instead
    of materializing the full (B, 6, R) host tensor — translated search
    then scales to the same panel sizes as search/refmap (``hits.scores``
    is None in this mode; the fold is lexicographic (score, frame order,
    panel index) so tie-breaks match the unchunked path exactly). ``mesh``/
    ``panel_axis`` pass through to :func:`~versalignlib_tpu.search.
    score_matrix` for sharded scans.
    """
    from versalignlib_tpu.search import score_matrix

    params = TRANSLATED_PARAMETERS if params is None else params
    if params.matrix is None:
        raise ValueError(
            "translated_search needs a protein substitution matrix "
            "(params.matrix); default TRANSLATED_PARAMETERS uses BLOSUM62")
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        read_codes = reads.astype(np.uint8)
    else:
        from versalignlib_tpu.alphabet import pad_and_encode

        read_codes = pad_and_encode(list(reads))
    b = read_codes.shape[0]
    # Translate each read's TRIMMED codes: in a padded batch, reverse
    # frames would otherwise reverse-complement the trailing padding to the
    # FRONT (leading 'X' residues), shifting every reverse-frame protein
    # coordinate off the true read by the pad length (r5 bug: negative
    # dna_start on mixed-length batches).
    read_lens = [int(nz.max()) + 1 if (nz := np.flatnonzero(read_codes[i])).size
                 else 0 for i in range(b)]
    proteins = [[translate_codes(read_codes[i][:read_lens[i]], f)
                 for f in FRAMES] for i in range(b)]
    flat = [p for per_read in proteins for p in per_read]
    queries = encode_custom(flat, PROTEIN_ALPHABET)
    if isinstance(panel, np.ndarray) and panel.ndim == 2:
        panel_codes = panel.astype(np.uint8)
        panel_texts = None
    else:
        panel_texts = list(panel)
        panel_codes = encode_custom(panel_texts, PROTEIN_ALPHABET)
    n_panel = panel_codes.shape[0]

    def fold_chunk(scores, lo):
        """(B, 6, Rc) -> per-read (score, frame_pos, panel_index): best
        panel entry per (read, frame) then best frame — argmax keeps the
        FIRST maximum, giving FRAMES-order then scan-order ties."""
        best_j = scores.argmax(axis=2)                        # (B, 6)
        best_per_frame = np.take_along_axis(
            scores, best_j[:, :, None], axis=2)[:, :, 0]      # (B, 6)
        best_f = best_per_frame.argmax(axis=1)                # (B,)
        rows = np.arange(scores.shape[0])
        return (best_per_frame[rows, best_f].astype(np.int32),
                best_f.astype(np.int32),
                (best_j[rows, best_f] + lo).astype(np.int32))

    if panel_chunk is None:
        scores = score_matrix(queries, panel_codes, params, algorithm,
                              impl=impl, mesh=mesh, panel_axis=panel_axis)
        scores = np.asarray(scores, dtype=np.int32).reshape(
            b, len(FRAMES), n_panel)
        best_s, best_f, idx = fold_chunk(scores, 0)
    else:
        # Streaming fold: chunks ascend in panel index, so "strictly
        # greater score, or equal score with strictly earlier frame"
        # reproduces the unchunked (score, frame, index) tie order (an
        # equal-score equal-frame later chunk always has a larger index).
        scores = None
        best_s = np.full(b, np.iinfo(np.int32).min, np.int32)
        best_f = np.zeros(b, np.int32)
        idx = np.zeros(b, np.int32)
        for lo in range(0, n_panel, panel_chunk):
            pc = panel_codes[lo:lo + panel_chunk]
            sc = np.asarray(score_matrix(
                queries, pc, params, algorithm, impl=impl, mesh=mesh,
                panel_axis=panel_axis), dtype=np.int32).reshape(
                    b, len(FRAMES), pc.shape[0])
            cs, cf, cj = fold_chunk(sc, lo)
            take = (cs > best_s) | ((cs == best_s) & (cf < best_f))
            best_s = np.where(take, cs, best_s)
            best_f = np.where(take, cf, best_f)
            idx = np.where(take, cj, idx)
    hits = TranslatedHits(
        index=idx.astype(np.int32),
        frame=np.array([FRAMES[f] for f in best_f], dtype=np.int32),
        score=best_s.astype(np.int32),
        scores=scores,
        proteins=proteins,
    )
    if calibration is not None:
        db_len = int(np.count_nonzero(panel_codes))
        qlens = np.maximum([len(proteins[i][best_f[i]]) for i in range(b)], 1)
        hits.bitscore = np.asarray(calibration.bit_score(hits.score))
        hits.evalue = np.asarray(
            [calibration.evalue(int(s), int(q), db_len)
             for s, q in zip(hits.score, qlens)])
    if not alignments:
        return hits

    # Winning pairs, one batched matrix-mode align dispatch (the affine
    # default routes through the Gotoh fill).
    win_prots = [proteins[i][best_f[i]] for i in range(b)]
    win_texts = [panel_texts[j] if panel_texts is not None else None
                 for j in idx]
    from versalignlib_tpu.ops.xla import align_pairs
    from versalignlib_tpu.types import TieBreak

    q_codes = encode_custom(win_prots, PROTEIN_ALPHABET)
    r_codes = panel_codes[idx]
    alns = align_pairs(
        q_codes, r_codes, params, Algorithm(algorithm),
        TieBreak.DIAG_UP_LEFT, read_texts=win_prots,
        ref_texts=win_texts if panel_texts is not None else None)
    dna_start = np.zeros(b, dtype=np.int32)
    dna_end = np.zeros(b, dtype=np.int32)
    strand = np.empty(b, dtype="U1")
    dna_cigar = []
    for i, a in enumerate(alns):
        # Alignment.read_end is EXCLUSIVE (reference buffer convention);
        # the DNA mapper wants the inclusive last aligned protein position.
        ds, de, st = map_protein_to_dna(
            int(hits.frame[i]), read_lens[i], a.read_start,
            max(a.read_end - 1, a.read_start))
        dna_start[i], dna_end[i], strand[i] = ds, de, st
        dna_cigar.append(_scale_cigar_dna(a.cigar))
    hits.alignments = alns
    hits.dna_start = dna_start
    hits.dna_end = dna_end
    hits.strand = strand
    hits.dna_cigar = dna_cigar
    return hits


def calibrate_translated(
    panel,
    params: AlignmentParameters | None = None,
    read_len: int = 300,
    samples: int = 256,
    seed: int = 0,
    impl: str = "auto",
):
    """Gumbel calibration for translated-search scores: E-values for
    :func:`translated_search` hits.

    Samples random uniform-ACGT DNA reads of ``read_len``, runs the SAME
    six-frame pipeline against the given panel, and fits the extreme-value
    law to the per-(read, entry) best-over-frames scores — the six-frame
    multiple-testing factor is absorbed into the fitted K (each null score
    IS a six-frame max, exactly like a real hit's). Effective per-
    comparison search space: ``read_len//3`` query residues x the median
    panel entry length.
    """
    from versalignlib_tpu.stats import calibrate_scores

    params = TRANSLATED_PARAMETERS if params is None else params
    if isinstance(panel, np.ndarray) and panel.ndim == 2:
        panel_codes = panel.astype(np.uint8)
    else:
        panel_codes = encode_custom(list(panel), PROTEIN_ALPHABET)
    rng = np.random.default_rng(seed)
    reads = rng.integers(1, 5, size=(samples, read_len)).astype(np.uint8)
    th = translated_search(reads, panel_codes, params, impl=impl)
    # per-(read, entry) best over frames: (B, R) maxima
    null = th.scores.max(axis=1).reshape(-1)
    n_eff = int(np.median((panel_codes != 0).sum(axis=1))) or 1
    return calibrate_scores(null, max(read_len // 3, 1), n_eff,
                            samples=null.size)
