"""versalignlib_tpu — a GPU pairwise sequence-alignment framework in JAX.

A from-scratch rebuild of the capabilities of ``t-neumann/versalignLib``
(Smith-Waterman local and semi-global "Needleman-Wunsch" alignment, batched
scoring and full-traceback alignment, pluggable kernel backends, FASTA
ingestion, benchmarking):

- the dense score fill is a Pallas/Triton GPU kernel with one pair per
  thread (replacing the reference's SSE2/AVX2 lanes and OpenCL work items,
  /root/reference/src/Kernels/AVX-SSE/SSEKernel.h:24,
  /root/reference/src/Kernels/OpenCL/opencl_c/opencl_definitions.cl:47);
- pure-XLA ``lax.scan`` fills serve as the portable path and the pointer
  fill for traceback (replacing the reference's scalar OpenMP
  DefaultKernel, /root/reference/src/Kernels/default/DefaultKernel.cpp);
- backends register in a dispatcher keyed by name and routed by device
  capability, replacing the reference's dlopen'd shared objects
  (/root/reference/src/util/versalignUtil.cpp:35-76);
- batches scale over a multi-device ``jax.sharding.Mesh`` data-parallel
  layout (the reference is single-node OpenMP only).
"""

from versalignlib_tpu.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak
from versalignlib_tpu.alphabet import encode, decode, pad_and_encode
from versalignlib_tpu.dispatch import (
    AlignmentEngine,
    available_backends,
    get_backend,
    register_backend,
)
from versalignlib_tpu.search import (
    PairedHits,
    SearchHits,
    best_hits,
    map_read_pairs,
    map_reads,
    score_matrix,
)
from versalignlib_tpu.refmap import (
    ReferenceHits,
    WindowIndex,
    map_to_reference,
    tile_references,
)
from versalignlib_tpu.stats import (GumbelCalibration, ROBINSON_FREQS,
                                    calibrate, calibrate_islands,
                                    karlin_lambda)
from versalignlib_tpu.seed import MinimizerIndex, build_index, minimizers
from versalignlib_tpu.longread import LongReadHits, find_chains, map_long_reads
from versalignlib_tpu.ops.pssm import (ProfileHit, calibrate_profile,
                                       profile_search,
                                       pssm_from_sequences)
from versalignlib_tpu.translate import (TranslatedHits, calibrate_translated,
                                        translate_six_frames,
                                        translated_search)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy serving-layer exports: keep `import versalignlib_tpu` free of
    # HTTP/threading machinery until a server is actually wanted.
    if name in ("BatchingAligner", "AlignServer"):
        from versalignlib_tpu import serve

        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BatchingAligner",
    "AlignServer",
    "AlignmentParameters",
    "DEFAULT_PARAMETERS",
    "Algorithm",
    "Alignment",
    "TieBreak",
    "AlignmentEngine",
    "available_backends",
    "get_backend",
    "register_backend",
    "encode",
    "decode",
    "pad_and_encode",
    "score_matrix",
    "best_hits",
    "map_reads",
    "map_read_pairs",
    "SearchHits",
    "PairedHits",
    "map_to_reference",
    "ReferenceHits",
    "tile_references",
    "WindowIndex",
    "GumbelCalibration",
    "calibrate",
    "karlin_lambda",
    "MinimizerIndex",
    "build_index",
    "minimizers",
    "map_long_reads",
    "LongReadHits",
    "find_chains",
    "profile_search",
    "ProfileHit",
    "calibrate_profile",
    "pssm_from_sequences",
    "translated_search",
    "calibrate_translated",
    "translate_six_frames",
    "TranslatedHits",
    "__version__",
]
