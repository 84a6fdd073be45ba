"""Native (C++) runtime components, loaded via ctypes.

Build: ``make -C versalignlib_tpu/native`` (or automatic on first import).
The reference ships its runtime as dlopen'd C++ shared objects
(/root/reference/src/util/versalignUtil.cpp:35-76); here the native layer
covers the host-side hot paths around the device fills — batch traceback
decode and FASTA parsing — behind pure-Python fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).parent
_SO = _DIR / "_versalign_native.so"
_SRC = sorted((_DIR / "src").glob("*.cpp"))
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> None:
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-o", str(_SO), *[str(s) for s in _SRC],
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            srcs_mtime = max(s.stat().st_mtime for s in _SRC)
            if not _SO.exists() or _SO.stat().st_mtime < srcs_mtime:
                _build()
            lib = ctypes.CDLL(str(_SO))
        except Exception as exc:  # missing toolchain etc. -> python fallback
            _build_error = str(exc)
            from versalignlib_tpu.utils.logging import get_logger

            get_logger("native").warning(
                "native decoder build unavailable (%s); falling back to the "
                "pure-Python walkers — correct but slower for large batches",
                _build_error.splitlines()[0] if _build_error else "unknown",
            )
            return None
        lib.val_fasta_scan.restype = ctypes.c_int
        lib.val_fasta_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.val_fasta_read.restype = ctypes.c_int
        lib.val_fasta_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.val_decode_banded.restype = ctypes.c_int
        lib.val_decode_banded.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,   # ptr, band, offsets
            ctypes.c_void_p, ctypes.c_void_p,                 # reads, refs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # starts, scores
            ctypes.c_int, ctypes.c_int, ctypes.c_int,         # b, m, n
            ctypes.c_int,                                     # is_affine
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out bufs
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,      # cigar_cap, meta, threads
        ]
        lib.val_decode_batch.restype = ctypes.c_int
        lib.val_decode_batch.argtypes = [
            ctypes.c_void_p,                                  # ptr
            ctypes.c_void_p, ctypes.c_void_p,                 # reads, refs
            ctypes.c_char_p, ctypes.c_char_p,                 # texts
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # starts, scores
            ctypes.c_int, ctypes.c_int, ctypes.c_int,         # b, m, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scoring
            ctypes.c_int, ctypes.c_int,                       # is_nw, is_affine
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out bufs
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,      # cigar_cap, meta, threads
        ]
        lib.val_format_sam.restype = ctypes.c_int64
        lib.val_format_sam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # gapped, aln_cap
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,   # cigar, cap, meta
            ctypes.c_char_p, ctypes.c_void_p,                 # seqs, offsets
            ctypes.c_char_p, ctypes.c_void_p,                 # quals, offsets
            ctypes.c_char_p, ctypes.c_void_p,                 # qnames, offsets
            ctypes.c_char_p, ctypes.c_void_p,                 # rnames, offsets
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # flags x2, mapq
            ctypes.c_int,                                     # b
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out, caps, lens
            ctypes.c_int,                                     # threads
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch_native(
    ptr: np.ndarray,  # (b, m, n) uint8 pointer plane
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params,
    algorithm,
    scores: np.ndarray | None = None,
    read_texts: list[str] | None = None,
    ref_texts: list[str] | None = None,
    n_threads: int | None = None,
    affine: bool = False,
    raw: bool = False,
    gapped: bool = True,
):
    """Batch traceback decode through the C++ library.

    ``raw=True`` returns an :class:`~versalignlib_tpu.types.AlignmentBatch`
    column store instead of a list of ``Alignment`` objects — the per-object
    Python materialization costs ~6x the C++ walk, so bulk pipelines should
    stay raw. ``gapped=False`` (raw only) skips the gapped-string columns
    entirely — the walk emits CIGAR + coordinates alone, cutting decode time
    for CIGAR-bound pipelines (the reference's gapped buffers are a display
    format, include/AlignmentKernel.h:12-24; score/coords/CIGAR carry the
    same information).

    Raises ImportError if the native library is unavailable (callers fall
    back to the Python decoder).
    """
    from versalignlib_tpu.types import Algorithm, Alignment, AlignmentBatch

    lib = _load()
    if lib is None:
        raise ImportError(f"native decoder unavailable: {_build_error}")

    ptr_arr = np.ascontiguousarray(ptr, dtype=np.uint8)

    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    refs = np.ascontiguousarray(refs, dtype=np.uint8)
    b, m = reads.shape
    n = refs.shape[1]
    start_r = np.ascontiguousarray(start_read_pos, dtype=np.int32)
    start_f = np.ascontiguousarray(start_ref_pos, dtype=np.int32)
    scores_arr = (
        None if scores is None else np.ascontiguousarray(scores, dtype=np.int32)
    )

    rt_buf = ft_buf = None
    if read_texts is not None:
        rt_buf = b"".join(
            t.encode("latin-1").ljust(m, b"\0")[:m] for t in read_texts
        )
    if ref_texts is not None:
        ft_buf = b"".join(
            t.encode("latin-1").ljust(n, b"\0")[:n] for t in ref_texts
        )

    if not gapped and not raw:
        raise ValueError("gapped=False requires raw=True (Alignment objects "
                         "carry gapped strings)")
    aln_cap = m + n
    cigar_cap = 3 * aln_cap + 16
    read_g = np.zeros((b, aln_cap), dtype=np.uint8) if gapped else None
    ref_g = np.zeros((b, aln_cap), dtype=np.uint8) if gapped else None
    cigar = np.zeros((b, cigar_cap), dtype=np.uint8)
    meta = np.zeros((b, 8), dtype=np.int32)

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)

    rc = lib.val_decode_batch(
        ptr_arr.ctypes.data_as(ctypes.c_void_p),
        reads.ctypes.data_as(ctypes.c_void_p), refs.ctypes.data_as(ctypes.c_void_p),
        rt_buf, ft_buf,
        start_r.ctypes.data_as(ctypes.c_void_p),
        start_f.ctypes.data_as(ctypes.c_void_p),
        None if scores_arr is None else scores_arr.ctypes.data_as(ctypes.c_void_p),
        b, m, n,
        params.score_match, params.score_mismatch,
        params.score_gap_read, params.score_gap_ref,
        1 if Algorithm(algorithm) == Algorithm.NEEDLEMAN_WUNSCH else 0,
        1 if affine else 0,
        None if read_g is None else read_g.ctypes.data_as(ctypes.c_void_p),
        None if ref_g is None else ref_g.ctypes.data_as(ctypes.c_void_p),
        cigar.ctypes.data_as(ctypes.c_void_p),
        cigar_cap,
        meta.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"val_decode_batch failed: {rc}")

    if raw:
        return AlignmentBatch(read_g, ref_g, cigar, meta)
    out = []
    rg_bytes = read_g.tobytes()
    fg_bytes = ref_g.tobytes()
    cg_bytes = cigar.tobytes()
    for k in range(b):
        (score, rs, re_, fs, fe, aln_len, buf_start, clen) = (int(x) for x in meta[k])
        base = k * aln_cap
        cb = k * cigar_cap
        out.append(
            Alignment(
                read=rg_bytes[base : base + aln_len].decode("latin-1"),
                ref=fg_bytes[base : base + aln_len].decode("latin-1"),
                score=score,
                cigar=cg_bytes[cb : cb + clen].decode("ascii"),
                read_start=rs,
                read_end=re_,
                ref_start=fs,
                ref_end=fe,
                buffer_start=buf_start,
                buffer_end=aln_cap - 1,
            )
        )
    return out


def parse_fasta_codes(path) -> tuple[np.ndarray, np.ndarray]:
    """Native fused FASTA parse + encode + pad.

    Returns (codes (n, max_len) uint8, lengths (n,) int64). Raises
    ImportError when the native library is unavailable (callers fall back to
    io.fasta.parse_fasta + alphabet.pad_and_encode).
    """
    lib = _load()
    if lib is None:
        raise ImportError(f"native fasta parser unavailable: {_build_error}")
    import ctypes as ct

    n = ct.c_int64()
    mx = ct.c_int64()
    path_b = str(path).encode()
    if lib.val_fasta_scan(path_b, ct.byref(n), ct.byref(mx)) != 0:
        raise OSError(f"cannot read FASTA file: {path}")
    codes = np.zeros((n.value, max(mx.value, 1)), dtype=np.uint8)
    lengths = np.zeros(n.value, dtype=np.int64)
    if n.value:
        rc = lib.val_fasta_read(
            path_b, codes.ctypes.data_as(ct.c_void_p), n.value,
            codes.shape[1], lengths.ctypes.data_as(ct.c_void_p),
        )
        if rc != 0:
            raise OSError(f"FASTA parse failed: {path}")
    return codes, lengths


def decode_banded_native(
    ptr: np.ndarray,        # (b, m, band) uint8 band-relative pointers
    band: int,
    offsets: np.ndarray,    # (m,) int32 band start per row
    reads: np.ndarray,
    refs: np.ndarray,
    start_read_pos: np.ndarray,
    start_ref_pos: np.ndarray,
    params,
    algorithm,
    scores: np.ndarray,
    n_threads: int | None = None,
    raw: bool = False,
):
    """Banded traceback decode through the C++ library (linear or affine).

    ``raw=True`` returns an :class:`~versalignlib_tpu.types.AlignmentBatch`
    (see :func:`decode_batch_native`).
    """
    from versalignlib_tpu.types import Alignment, AlignmentBatch

    lib = _load()
    if lib is None:
        raise ImportError(f"native decoder unavailable: {_build_error}")
    import ctypes as ct

    ptr = np.ascontiguousarray(ptr, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    refs = np.ascontiguousarray(refs, dtype=np.uint8)
    start_r = np.ascontiguousarray(start_read_pos, dtype=np.int32)
    start_f = np.ascontiguousarray(start_ref_pos, dtype=np.int32)
    scores = np.ascontiguousarray(scores, dtype=np.int32)
    b, m = reads.shape
    n = refs.shape[1]
    aln_cap = m + n
    cigar_cap = 3 * aln_cap + 16
    read_g = np.zeros((b, aln_cap), dtype=np.uint8)
    ref_g = np.zeros((b, aln_cap), dtype=np.uint8)
    cigar = np.zeros((b, cigar_cap), dtype=np.uint8)
    meta = np.zeros((b, 8), dtype=np.int32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    rc = lib.val_decode_banded(
        ptr.ctypes.data_as(ct.c_void_p), band,
        offsets.ctypes.data_as(ct.c_void_p),
        reads.ctypes.data_as(ct.c_void_p), refs.ctypes.data_as(ct.c_void_p),
        start_r.ctypes.data_as(ct.c_void_p), start_f.ctypes.data_as(ct.c_void_p),
        scores.ctypes.data_as(ct.c_void_p),
        b, m, n,
        1 if params.affine else 0,
        read_g.ctypes.data_as(ct.c_void_p), ref_g.ctypes.data_as(ct.c_void_p),
        cigar.ctypes.data_as(ct.c_void_p), cigar_cap,
        meta.ctypes.data_as(ct.c_void_p), n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"val_decode_banded failed: {rc}")
    if raw:
        return AlignmentBatch(read_g, ref_g, cigar, meta)
    out = []
    rg_bytes = read_g.tobytes()
    fg_bytes = ref_g.tobytes()
    cg_bytes = cigar.tobytes()
    for k in range(b):
        (score, rs, re_, fs, fe, aln_len, buf_start, clen) = (int(x) for x in meta[k])
        base = k * aln_cap
        cb = k * cigar_cap
        out.append(Alignment(
            read=rg_bytes[base : base + aln_len].decode("latin-1"),
            ref=fg_bytes[base : base + aln_len].decode("latin-1"),
            score=score,
            cigar=cg_bytes[cb : cb + clen].decode("ascii"),
            read_start=rs, read_end=re_, ref_start=fs, ref_end=fe,
            buffer_start=buf_start, buffer_end=aln_cap - 1,
        ))
    return out


def format_sam_native(
    batch,                   # types.AlignmentBatch (column store)
    seqs: list[str],         # oriented SEQ strings
    qnames: list[str],
    rnames: list[str],
    flags_mapped: np.ndarray,
    flags_unmapped: np.ndarray,
    mapqs: np.ndarray,
    quals: list[str] | None = None,
    n_threads: int | None = None,
) -> bytes | None:
    """Batch SAM record formatting through C++ (None = lib unavailable).

    Returns the concatenated record lines (with trailing newlines) for the
    whole batch; headers are the caller's job. Semantics are io/sam.py's
    (edge normalization, NM/MD) — gated byte-for-byte by tests.
    """
    lib = _load()
    if lib is None:
        return None
    b = len(batch)
    if b == 0:
        return b""

    def _concat(strings):
        off = np.zeros(b + 1, dtype=np.int64)
        for i, s in enumerate(strings):
            off[i + 1] = off[i] + len(s)
        return "".join(strings).encode("latin-1"), off

    seq_b, seq_off = _concat(seqs)
    qn_b, qn_off = _concat(qnames)
    rn_b, rn_off = _concat(rnames)
    if quals is not None and any(q is not None for q in quals):
        if any(q is None for q in quals):
            raise ValueError("mixed qual/None per batch is not supported "
                             "by the native formatter")
        ql_b, ql_off = _concat(quals)
        ql_ptr = ql_b
        ql_off_ptr = ql_off.ctypes.data
    else:
        ql_ptr = None
        ql_off_ptr = None

    meta = np.ascontiguousarray(batch.meta, dtype=np.int32)
    read_g = np.ascontiguousarray(batch.read_gapped)
    ref_g = np.ascontiguousarray(batch.ref_gapped)
    cigar = np.ascontiguousarray(batch.cigar)
    aln_cap = read_g.shape[1]
    cigar_cap = cigar.shape[1]
    fm = np.ascontiguousarray(flags_mapped, dtype=np.int32)
    fu = np.ascontiguousarray(flags_unmapped, dtype=np.int32)
    mq = np.ascontiguousarray(mapqs, dtype=np.int32)

    # Airtight per-record output bound: names + seq + qual + soft-clipped
    # CIGAR + MD (2 chars/column) + fixed fields/tags.
    per = (np.diff(qn_off) + np.diff(rn_off) + 2 * np.diff(seq_off)
           + cigar_cap + 2 * meta[:, 5].astype(np.int64) + 128)
    caps = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(per, out=caps[1:])
    out = np.zeros(int(caps[-1]), dtype=np.uint8)
    lens = np.zeros(b, dtype=np.int64)
    threads = n_threads or min(8, os.cpu_count() or 1)
    total = lib.val_format_sam(
        read_g.ctypes.data, ref_g.ctypes.data, aln_cap,
        cigar.ctypes.data, cigar_cap, meta.ctypes.data,
        seq_b, seq_off.ctypes.data,
        ql_ptr, ql_off_ptr,
        qn_b, qn_off.ctypes.data,
        rn_b, rn_off.ctypes.data,
        fm.ctypes.data, fu.ctypes.data, mq.ctypes.data,
        b, out.ctypes.data, caps.ctypes.data, lens.ctypes.data, threads)
    if total < 0:
        raise RuntimeError("val_format_sam overflow (bound bug)")
    return out[:total].tobytes()  # compacted in C++
