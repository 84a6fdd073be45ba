"""Minimizer seeding for genome-scale mapping (host-side, vectorized).

ADDITIVE — the reference aligns 1:1 pairs only. ``refmap.py``'s exhaustive
window tiling is exact but O(reads x genome) cells: practical to
bacterial-genome scale on one accelerator, not for long reads against large
genomes. The standard fix is seed-and-extend (minimap2 lineage): index the
reference's (w, k)-minimizers once, find anchor matches per read, chain
colinear anchors, and only run DP inside the chained region — which this
framework then does with the device band scan (``longread.py``).

Everything here is NumPy-vectorized host code (index building is IO/hash
bound, not DP bound — the device's job starts at extension):

- k-mers pack 2 bits/base into int64 (k <= 31); windows containing N or
  padding yield no minimizer (the reference treats both as never-matching,
  so seeds through them would be junk).
- **Canonical** k-mers: min(kmer, revcomp) — one index serves both
  strands; the minimizer records which orientation won so anchors carry
  strand.
- Minimizers: the position of the minimum 64-bit mixed hash in each
  w-window of consecutive k-mers (rightmost wins ties — any deterministic
  rule works; ties are astronomically rare for a 64-bit hash).
- The index is two sorted arrays (hash, packed position) + searchsorted
  lookup — no Python dict, O(log M) per query, trivially serializable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from versalignlib_tpu.alphabet import pad_and_encode

#: splitmix64 finalizer: an invertible 64-bit mix (public-domain constant
#: set), decorrelating lexicographically-close k-mers.
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _MIX1
    x ^= x >> np.uint64(27)
    x *= _MIX2
    x ^= x >> np.uint64(31)
    return x


def _pack_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(L,) codes -> (L-k+1,) packed 2-bit k-mers + validity mask.

    Codes 1..4 (ACGT) map to 2-bit 0..3; any other code (padding, N)
    invalidates every k-mer covering it.
    """
    L = codes.shape[0]
    n = L - k + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool))
    b2 = (codes.astype(np.int64) - 1)
    ok = (b2 >= 0) & (b2 < 4)
    b2 = np.where(ok, b2, 0).astype(np.uint64)
    kv = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for j in range(k):
        kv = (kv << np.uint64(2)) | b2[j : j + n]
        valid &= ok[j : j + n]
    return kv, valid


def _revcomp_kmers(kv: np.ndarray, k: int) -> np.ndarray:
    """Packed reverse-complement: complement (base ^ 3 in our 2-bit map:
    A<->T is 0<->1? no — codes A1 T2 C3 G4 -> 2-bit A0 T1 C2 G3; the
    complement pairs are A-T (0-1) and C-G (2-3), i.e. base ^ 1)."""
    comp = kv ^ np.uint64(0x5555555555555555 & ((1 << (2 * k)) - 1))
    # reverse the k 2-bit fields
    out = np.zeros_like(kv)
    tmp = comp.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | (tmp & np.uint64(3))
        tmp >>= np.uint64(2)
    return out


def minimizers(
    seq, k: int = 15, w: int = 10,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, hashes, strands) of the (w, k)-minimizers of one sequence.

    ``seq``: string or (L,) uint8 codes. ``strands[i]`` is 0 when the
    forward k-mer is canonical at that position, 1 when the
    reverse-complement is. Deduplicated consecutive windows (the standard
    compaction: one entry per distinct (pos, hash)).
    """
    if 2 * k > 62:
        raise ValueError(f"k={k} too large for 2-bit int64 packing")
    codes = (seq if isinstance(seq, np.ndarray)
             else pad_and_encode([seq])[0])
    kv, valid = _pack_kmers(codes, k)
    n = kv.shape[0]
    if n < w:
        return (np.zeros(0, np.int64), np.zeros(0, np.uint64),
                np.zeros(0, np.int8))
    rc = _revcomp_kmers(kv, k)
    fwd_canon = kv <= rc
    canon = np.where(fwd_canon, kv, rc)
    h = _mix64(canon)
    # Invalid k-mers hash to the max so they never win a window; windows
    # whose winner is invalid are dropped afterwards.
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    # Sliding argmin over w consecutive hashes (rightmost minimum wins:
    # argmin on the REVERSED window). Memory: one (n-w+1, w) view.
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    amin = w - 1 - np.argmin(win[:, ::-1], axis=1)
    pos = np.arange(win.shape[0], dtype=np.int64) + amin
    keep = valid[pos]
    pos = pos[keep]
    # Compact: consecutive windows usually pick the same position.
    if pos.size:
        first = np.ones(pos.shape[0], dtype=bool)
        first[1:] = pos[1:] != pos[:-1]
        pos = pos[first]
    return pos, h[pos], (~fwd_canon[pos]).astype(np.int8)


@dataclasses.dataclass(frozen=True)
class MinimizerIndex:
    """Sorted-array minimizer index over one or more reference sequences.

    ``hashes`` sorted ascending; ``pos``/``ref_id``/``strand`` aligned.
    Lookup = searchsorted (O(log M)); repeat-filtering happens at query
    time (``max_occ``).
    """

    hashes: np.ndarray     # (M,) uint64 sorted
    pos: np.ndarray        # (M,) int64 position within its reference
    ref_id: np.ndarray     # (M,) int32
    strand: np.ndarray     # (M,) int8: canonical orientation at that site
    k: int
    w: int
    ref_lengths: tuple[int, ...]

    def __len__(self) -> int:
        return self.hashes.shape[0]

    def lookup(self, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) ranges into the sorted arrays for each query hash."""
        lo = np.searchsorted(self.hashes, h, side="left")
        hi = np.searchsorted(self.hashes, h, side="right")
        return lo, hi

    def save(self, path) -> None:
        np.savez_compressed(
            path, hashes=self.hashes, pos=self.pos, ref_id=self.ref_id,
            strand=self.strand,
            meta=np.array([self.k, self.w], dtype=np.int64),
            ref_lengths=np.array(self.ref_lengths, dtype=np.int64))

    @classmethod
    def load(cls, path) -> "MinimizerIndex":
        with np.load(path) as z:
            return cls(hashes=z["hashes"], pos=z["pos"],
                       ref_id=z["ref_id"], strand=z["strand"],
                       k=int(z["meta"][0]), w=int(z["meta"][1]),
                       ref_lengths=tuple(int(v) for v in z["ref_lengths"]))


def build_index(
    references, k: int = 15, w: int = 10, chunk: int = 1 << 20,
) -> MinimizerIndex:
    """Index reference sequences' minimizers (O(chunk) working memory).

    Long references process in overlapping chunks (overlap w+k so no
    window is lost at a boundary; duplicate picks in the overlap dedupe
    on (ref, pos)).
    """
    if isinstance(references, (str, np.ndarray)) and getattr(
            references, "ndim", 1) == 1:
        references = [references]
    enc = [r if isinstance(r, np.ndarray) else pad_and_encode([r])[0]
           for r in references]
    all_h, all_p, all_r, all_s = [], [], [], []
    for rid, codes in enumerate(enc):
        L = codes.shape[0]
        overlap = w + k
        for lo in range(0, max(L - k + 1, 1), chunk):
            part = codes[lo : lo + chunk + overlap]
            pos, h, s = minimizers(part, k, w)
            # Overlap regions re-emit the same (pos, hash) picks — the
            # global (ref, pos) dedupe below removes them.
            all_h.append(h)
            all_p.append(pos + lo)
            all_r.append(np.full(pos.shape[0], rid, dtype=np.int32))
            all_s.append(s)
    if not all_h:
        return MinimizerIndex(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                              np.zeros(0, np.int32), np.zeros(0, np.int8),
                              k, w, tuple(len(e) for e in enc))
    h = np.concatenate(all_h)
    p = np.concatenate(all_p)
    r = np.concatenate(all_r)
    s = np.concatenate(all_s)
    # Dedupe on (ref, pos) — chunk overlaps emit duplicates.
    order = np.lexsort((p, r))
    h, p, r, s = h[order], p[order], r[order], s[order]
    first = np.ones(p.shape[0], dtype=bool)
    first[1:] = (p[1:] != p[:-1]) | (r[1:] != r[:-1])
    h, p, r, s = h[first], p[first], r[first], s[first]
    order = np.argsort(h, kind="stable")
    return MinimizerIndex(h[order], p[order], r[order], s[order], k, w,
                          tuple(len(e) for e in enc))
