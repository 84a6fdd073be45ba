"""AlignmentModel: a configured, executable alignment pipeline."""

from __future__ import annotations

import dataclasses

import numpy as np

from versalignlib_tpu.alphabet import pad_and_encode
from versalignlib_tpu.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak


@dataclasses.dataclass(frozen=True)
class AlignmentModel:
    """Immutable model config; hashable, so it can key jit caches.

    ``banded`` models route through the band scan (ops/banded.py); dense
    models go through the backend dispatcher.
    """

    name: str
    algorithm: Algorithm
    params: AlignmentParameters = DEFAULT_PARAMETERS
    tie: TieBreak = TieBreak.DIAG_UP_LEFT
    banded: bool = False
    band: int = 512
    #: custom alphabet string for encoding (None = the reference DNA table);
    #: char i maps to code i+1, code 0 stays the padding sentinel.
    alphabet: str | None = None

    def _encode_seqs(self, seqs):
        if self.alphabet is None:
            return pad_and_encode(seqs)
        from versalignlib_tpu.alphabet import encode_custom

        return encode_custom(seqs, self.alphabet)

    def _encode(self, reads, refs):
        if isinstance(reads, np.ndarray) and reads.dtype == np.uint8 and reads.ndim == 2:
            reads_enc = reads
        else:
            reads_enc = self._encode_seqs(reads)
        if isinstance(refs, np.ndarray) and refs.dtype == np.uint8 and refs.ndim == 2:
            refs_enc = refs
        else:
            refs_enc = self._encode_seqs(refs)
        if reads_enc.shape[0] != refs_enc.shape[0]:
            raise ValueError(
                f"read/ref counts differ: {reads_enc.shape[0]} vs {refs_enc.shape[0]}"
            )
        return reads_enc, refs_enc

    def score(self, reads, refs, backend: str = "auto") -> np.ndarray:
        reads_enc, refs_enc = self._encode(reads, refs)
        if self.banded:
            from versalignlib_tpu.ops.banded import banded_score_batch

            return banded_score_batch(
                reads_enc, refs_enc, self.params, self.algorithm,
                band=self.band,
            )
        from versalignlib_tpu.dispatch import get_backend

        return np.asarray(
            get_backend(backend).score_alignments(
                self.algorithm, reads_enc, refs_enc, self.params
            ),
            dtype=np.int32,
        )

    def align(self, reads, refs, backend: str = "auto") -> list[Alignment]:
        if self.banded:
            from versalignlib_tpu.ops.banded import banded_align_batch

            reads_enc, refs_enc = self._encode(reads, refs)
            return banded_align_batch(
                reads_enc, refs_enc, self.params, self.algorithm,
                band=self.band, tie=self.tie,
            )
        reads_enc, refs_enc = self._encode(reads, refs)
        from versalignlib_tpu.dispatch import get_backend

        return get_backend(backend).compute_alignments(
            self.algorithm, reads_enc, refs_enc, self.params, self.tie
        )
