"""Host-side traceback decode: pointer matrices -> gapped strings + CIGAR.

Device fills emit an *inner* pointer matrix of shape
(read_len, ref_len) (uint8 codes from :class:`~versalignlib_tpu.types.Trace`)
plus the traceback start cell; the boundary row/column of the reference's
(m+1)x(n+1) matrix is implied (row 0 / col 0 = START; NW col 0 = UP,
DefaultKernel.cpp:304,395). The walk itself is inherently sequential and
data-dependent, so it runs on the host, mirroring
the reference's scalar per-lane backtracks (SSEKernel.cpp:785-860,
OpenCLKernel collect path). A native C++ decoder (versalignlib_tpu.native)
accelerates batch decode; this module is the pure-Python fallback and the
semantics definition.

For NW the score is reconstructed during the walk (the reference's Alignment
struct carries no score; we add it): score at the traceback start cell equals
the path-start boundary value plus the sum of step costs along the path.
"""

from __future__ import annotations

import numpy as np

from versalignlib_tpu.alphabet import substitution_scores
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import (Algorithm, Alignment, TieBreak, Trace,
                                    cigar_from_gapped)


def last_valid_positions(codes: np.ndarray, tie: TieBreak = TieBreak.DIAG_UP_LEFT,
                         matrix=None) -> np.ndarray:
    """Reference max_*_pos per row: index before the first invalid code, else
    len-1 (DefaultKernel.cpp:308,348). Canonical flavor counts any nonzero
    code valid; the SSE flavor only nonzero-scoring codes."""
    if TieBreak(tie) == TieBreak.DIAG_UP_LEFT:
        invalid = codes == 0
    else:
        from versalignlib_tpu.alphabet import make_validity

        invalid = ~make_validity(matrix)(codes)
    return np.where(invalid.any(axis=1), invalid.argmax(axis=1) - 1,
                    codes.shape[1] - 1).astype(np.int32)


def _text_from_codes(codes: np.ndarray) -> str:
    table = "\0ATCGN"
    return "".join(table[int(c)] if 0 <= int(c) <= 5 else "\0" for c in codes)


def decode_one(
    ptr_inner: np.ndarray,
    read: np.ndarray,
    ref: np.ndarray,
    start_read_pos: int,
    start_ref_pos: int,
    params: AlignmentParameters,
    algorithm: Algorithm,
    score: int | None = None,
    read_text: str | None = None,
    ref_text: str | None = None,
) -> Alignment:
    """Decode one pair's traceback.

    ``ptr_inner[i, j]`` is the pointer of DP cell (i+1, j+1). ``score`` may be
    given (SW: the kernel's best score); if None it is reconstructed.
    """
    m, n = ptr_inner.shape
    is_nw = algorithm == Algorithm.NEEDLEMAN_WUNSCH
    if read_text is None:
        read_text = _text_from_codes(read)
    if ref_text is None:
        ref_text = _text_from_codes(ref)

    rp, fp = int(start_read_pos), int(start_ref_pos)
    read_chars: list[str] = []
    ref_chars: list[str] = []
    path_cost = 0
    steps = 0
    while True:
        if rp < 0 and fp < 0:
            bt = Trace.START
        elif rp < 0:
            bt = Trace.START  # boundary row 0 is all START
        elif fp < 0:
            bt = Trace.UP if is_nw else Trace.START  # boundary col 0
        else:
            bt = ptr_inner[rp, fp]
        if bt == Trace.START:
            break
        if bt == Trace.UP:
            read_chars.append(read_text[rp])
            ref_chars.append("-")
            path_cost += params.score_gap_ref
            rp -= 1
        elif bt == Trace.LEFT:
            read_chars.append("-")
            ref_chars.append(ref_text[fp])
            path_cost += params.score_gap_read
            fp -= 1
        else:
            read_chars.append(read_text[rp])
            ref_chars.append(ref_text[fp])
            path_cost += int(
                substitution_scores(
                    np.int32(read[rp]), np.int32(ref[fp]),
                    params.score_match, params.score_mismatch, params.matrix,
                )
            )
            rp -= 1
            fp -= 1
        steps += 1
        if steps > m + n:
            raise RuntimeError("traceback did not terminate")

    if score is None:
        # Path start boundary value: H[rp+1][fp+1] on the boundary — 0 on
        # row 0; (rp+1)*gap_ref on NW column 0 (DefaultKernel.cpp:305).
        if fp < 0 and rp >= 0 and is_nw:
            boundary = (rp + 1) * params.score_gap_ref
        else:
            boundary = 0
        score = boundary + path_cost

    read_g = "".join(reversed(read_chars))
    ref_g = "".join(reversed(ref_chars))
    aln_length = m + n
    return Alignment(
        read=read_g,
        ref=ref_g,
        score=int(score),
        cigar=cigar_from_gapped(read_g, ref_g),
        read_start=rp + 1,
        read_end=int(start_read_pos) + 1,
        ref_start=fp + 1,
        ref_end=int(start_ref_pos) + 1,
        buffer_start=aln_length - 1 - steps,
        buffer_end=aln_length - 1,
    )


def decode_batch(
    ptr_inner: np.ndarray,
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    scores: np.ndarray | None = None,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
) -> list[Alignment]:
    """Decode a batch; prefers the native C++ decoder, falls back to Python."""
    try:
        from versalignlib_tpu.native import decode_batch_native

        return decode_batch_native(
            ptr_inner, reads, refs, start_read_pos, start_ref_pos,
            params, algorithm, scores, read_texts, ref_texts,
        )
    except ImportError:
        pass
    out = []
    for i in range(ptr_inner.shape[0]):
        out.append(
            decode_one(
                ptr_inner[i], reads[i], refs[i],
                int(start_read_pos[i]), int(start_ref_pos[i]),
                params, algorithm,
                None if scores is None else int(scores[i]),
                None if read_texts is None else read_texts[i],
                None if ref_texts is None else ref_texts[i],
            )
        )
    return out


def decode_batch_affine(
    ptr: np.ndarray,
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    scores: np.ndarray,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
) -> list[Alignment]:
    """Decode affine 4-bit pointer planes (hptr | e_ext<<2 | f_ext<<3).

    Prefers the native C++ state machine; falls back to the Python walker in
    ops/gotoh.py. Scores must be supplied (the device kernels emit exact
    end-cell scores).
    """
    try:
        from versalignlib_tpu.native import decode_batch_native

        return decode_batch_native(
            ptr, reads, refs, start_read_pos, start_ref_pos, params,
            algorithm, scores, read_texts, ref_texts, affine=True,
        )
    except ImportError:
        pass
    from versalignlib_tpu.ops.gotoh import _affine_traceback

    is_nw = Algorithm(algorithm) == Algorithm.NEEDLEMAN_WUNSCH
    out = []
    m, n = reads.shape[1], refs.shape[1]
    for i in range(ptr.shape[0]):
        full = np.zeros((m + 1, n + 1), np.uint8)
        full[1:, 1:] = ptr[i]
        out.append(
            _affine_traceback(
                reads[i], refs[i], full, int(start_read_pos[i]),
                int(start_ref_pos[i]), int(scores[i]),
                None if read_texts is None else read_texts[i],
                None if ref_texts is None else ref_texts[i],
                nw_boundary=is_nw,
            )
        )
    return out
