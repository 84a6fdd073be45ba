"""Dispatcher backend for the hand-written GPU kernels.

Score path: the Pallas/Triton dense score kernel (ops/triton_score.py).
Align path: the XLA pointer fill plus the host decode (ops/xla.py
``align_pairs``), mirroring the reference split between device DP fill and
scalar backtrack (SSEKernel.cpp:785-860).

The kernel compiles only for CUDA devices
(:attr:`~versalignlib_tpu.utils.capabilities.DeviceCapabilities.gpu_kernels`),
the analogue of the reference's CPUID gate on the AVX backend
(/root/reference/src/util/versalignUtil.cpp:78-181, main.cpp:80-83).
``interpret=True`` runs it in the Pallas interpreter (tests only).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from versalignlib_tpu.ops import triton_score, xla
from versalignlib_tpu.types import Algorithm
from versalignlib_tpu.utils.capabilities import probe


class PallasBackend:
    name = "pallas"

    def __init__(self, interpret: bool = False):
        self.interpret = interpret

    def is_available(self) -> bool:
        return self.interpret or probe().gpu_kernels

    def score_alignments(self, algorithm, reads, refs, params):
        out = triton_score.score_batch_triton(
            jnp.asarray(reads), jnp.asarray(refs), params,
            Algorithm(algorithm), self.interpret)
        return np.asarray(out, dtype=np.int32)

    def compute_alignments(self, algorithm, reads, refs, params, tie,
                           raw: bool = False, gapped: bool = True):
        return xla.align_pairs(reads, refs, params, algorithm, tie, raw=raw,
                               gapped=gapped)
