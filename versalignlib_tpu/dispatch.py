"""Backend dispatcher.

Replacement for the reference's runtime plugin system: where
versalignLib ``dlopen``s one of four shared objects and resolves
``spawn_alignment_kernel`` (/root/reference/src/util/versalignUtil.cpp:35-76,
/root/reference/src/impl/main.cpp:29-39,227-238), we keep a registry of
backend objects keyed by name. Each backend implements the two-method surface
of the reference's ``AlignmentKernel`` interface
(/root/reference/include/AlignmentKernel.h:34-44):

    score_alignments(algorithm, reads, refs)   -> (n,) int32 scores
    compute_alignments(algorithm, reads, refs) -> list[Alignment]

Backends self-describe availability from the probed device capabilities
(utils/capabilities.py; the hand-written GPU kernels compile only on CUDA
devices), the analogue of the reference's CPUID gate on the AVX backend
(/root/reference/src/util/versalignUtil.cpp:91-181). This module is the one
place that routes by capability: "auto" backends here, and the device score
path of traced callers (search, mesh) through :func:`resolve_score_impl`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import numpy as np

from versalignlib_tpu.alphabet import pad_and_encode
from versalignlib_tpu.params import AlignmentParameters, DEFAULT_PARAMETERS
from versalignlib_tpu.types import Algorithm, Alignment, TieBreak
from versalignlib_tpu.utils.logging import get_logger

_log = get_logger("dispatch")


class Backend(Protocol):
    """Structural interface every kernel backend implements."""

    name: str

    def is_available(self) -> bool: ...

    def score_alignments(
        self, algorithm: Algorithm, reads: np.ndarray, refs: np.ndarray,
        params: AlignmentParameters,
    ) -> np.ndarray: ...

    def compute_alignments(
        self, algorithm: Algorithm, reads: np.ndarray, refs: np.ndarray,
        params: AlignmentParameters, tie: TieBreak,
    ) -> list[Alignment]: ...


@dataclasses.dataclass
class _Registration:
    factory: Callable[[], Backend]
    priority: int  # higher = preferred by "auto"
    instance: Backend | None = None


_REGISTRY: dict[str, _Registration] = {}


def register_backend(name: str, factory: Callable[[], Backend], priority: int = 0) -> None:
    """Register a backend factory (lazily instantiated)."""
    _REGISTRY[name] = _Registration(factory=factory, priority=priority)


def get_backend(name: str) -> Backend:
    if name == "auto":
        return _auto_backend()
    reg = _REGISTRY.get(name)
    if reg is None:
        raise KeyError(f"Unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    if reg.instance is None:
        reg.instance = reg.factory()
    return reg.instance


def available_backends() -> list[str]:
    """Names of registered backends whose availability probe passes."""
    out = []
    for name in _REGISTRY:
        try:
            if get_backend(name).is_available():
                out.append(name)
        except Exception as exc:  # probe failures mean "unavailable"
            _log.warning("backend %s availability probe failed: %s", name, exc)
    return out


def resolve_score_impl(impl: str = "auto") -> str:
    """Device score path for traced callers: "pallas" (the GPU kernel) where
    it compiles, "xla" (the row scan) otherwise."""
    if impl == "auto":
        from versalignlib_tpu.utils.capabilities import probe

        return "pallas" if probe().gpu_kernels else "xla"
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown score impl {impl!r}; use auto|pallas|xla")
    return impl


def device_score_fn(impl: str):
    """Traceable ``(reads, refs, params, algorithm) -> (B,) scores`` for a
    resolved impl (see :func:`resolve_score_impl`)."""
    if impl == "pallas":
        from versalignlib_tpu.ops.triton_score import score_batch_triton

        return score_batch_triton
    from versalignlib_tpu.ops.xla import score_batch

    return score_batch


def _auto_backend() -> Backend:
    best = None
    best_prio = None
    for name, reg in _REGISTRY.items():
        try:
            backend = get_backend(name)
            if not backend.is_available():
                continue
        except Exception:
            continue
        if best_prio is None or reg.priority > best_prio:
            best, best_prio = backend, reg.priority
    if best is None:
        raise RuntimeError("No alignment backend available")
    return best


class AlignmentEngine:
    """User-facing entry point: scoring + full alignment over string batches.

    Plays the role of the reference example driver's kernel handling
    (/root/reference/src/impl/main.cpp:74-215): pads/encodes sequences,
    selects a backend, runs batches.
    """

    def __init__(
        self,
        params: AlignmentParameters = DEFAULT_PARAMETERS,
        backend: str = "auto",
        tie: TieBreak = TieBreak.DIAG_UP_LEFT,
        mesh=None,
    ) -> None:
        """``mesh``: optional jax.sharding.Mesh — scoring and alignment then
        run data-parallel over its ``data`` axis (parallel/distributed.py)."""
        self.params = params
        self.backend = get_backend(backend)
        self.tie = tie
        self.mesh = mesh

    def _prepare(self, reads, refs) -> tuple[np.ndarray, np.ndarray]:
        if isinstance(reads, np.ndarray) and reads.dtype == np.uint8 and reads.ndim == 2:
            reads_enc = reads
        else:
            reads_enc = pad_and_encode(reads)
        if isinstance(refs, np.ndarray) and refs.dtype == np.uint8 and refs.ndim == 2:
            refs_enc = refs
        else:
            refs_enc = pad_and_encode(refs)
        if reads_enc.shape[0] != refs_enc.shape[0]:
            # Same validation as main.cpp:93-102.
            raise ValueError(
                f"read/ref counts differ: {reads_enc.shape[0]} vs {refs_enc.shape[0]}"
            )
        return reads_enc, refs_enc

    def score_alignments(
        self, algorithm: Algorithm, reads, refs
    ) -> np.ndarray:
        reads_enc, refs_enc = self._prepare(reads, refs)
        if self.mesh is not None:
            from versalignlib_tpu.parallel.distributed import distributed_score_batch

            impl = "xla" if self.backend.name == "xla" else "auto"
            return distributed_score_batch(
                reads_enc, refs_enc, self.params, algorithm,
                mesh=self.mesh, impl=impl,
            )
        return np.asarray(
            self.backend.score_alignments(algorithm, reads_enc, refs_enc, self.params),
            dtype=np.int32,
        )

    def compute_alignments(
        self, algorithm: Algorithm, reads, refs, raw: bool = False,
        gapped: bool = True,
    ) -> list[Alignment]:
        """``raw=True``: return the
        :class:`~versalignlib_tpu.types.AlignmentBatch` column store instead
        of per-pair ``Alignment`` objects — no Python object materialization
        (serving/bulk hot path; requires the native decoder and a device
        backend). ``gapped=False`` (raw only): CIGAR-only columns — the walk
        skips gapped-string emission entirely (score/coords/CIGAR carry the
        same information; the gapped buffers are a display format)."""
        reads_enc, refs_enc = self._prepare(reads, refs)
        if raw and not supports_raw(self.backend):
            raise ValueError("raw alignment batches require the native "
                             "decoder and a device backend")
        if self.mesh is not None:
            from versalignlib_tpu.parallel.distributed import (
                distributed_align_batch,
            )

            return distributed_align_batch(
                reads_enc, refs_enc, self.params, algorithm, self.tie,
                mesh=self.mesh, raw=raw, gapped=gapped,
            )
        if raw:
            return self.backend.compute_alignments(
                algorithm, reads_enc, refs_enc, self.params, self.tie,
                raw=True, gapped=gapped,
            )
        return self.backend.compute_alignments(
            algorithm, reads_enc, refs_enc, self.params, self.tie
        )


def supports_raw(backend: Backend) -> bool:
    """Whether ``backend`` can return raw column-store batches: a device
    backend with the native decoder built."""
    from versalignlib_tpu import native

    return backend.name != "oracle" and native.available()


# ---------------------------------------------------------------------------
# Built-in backend registrations (lazy imports keep startup light)
# ---------------------------------------------------------------------------

def _oracle_factory() -> Backend:
    from versalignlib_tpu.ops import gotoh, oracle

    class OracleBackend:
        name = "oracle"

        def is_available(self) -> bool:
            return True

        def score_alignments(self, algorithm, reads, refs, params):
            if params.affine:
                return gotoh.score_alignments_affine(algorithm, reads, refs, params)
            return oracle.score_alignments(algorithm, reads, refs, params)

        def compute_alignments(self, algorithm, reads, refs, params, tie):
            if params.affine:
                return gotoh.compute_alignments_affine(
                    algorithm, reads, refs, params, tie)
            return oracle.compute_alignments(algorithm, reads, refs, params, tie)

    return OracleBackend()


register_backend("oracle", _oracle_factory, priority=0)


def _xla_factory() -> Backend:
    from versalignlib_tpu.ops.xla import XLABackend

    return XLABackend()


register_backend("xla", _xla_factory, priority=10)


def _pallas_factory() -> Backend:
    from versalignlib_tpu.ops.pallas_backend import PallasBackend

    return PallasBackend()


register_backend("pallas", _pallas_factory, priority=20)
