"""Data-parallel batched alignment over a device mesh.

Replaces the reference's OpenMP ``parallel for`` over pairs
(DefaultKernel.cpp:45-48) across devices: the pair batch shards over the
``data`` mesh axis via ``shard_map``, every device runs the local path (the
GPU score kernel where it compiles, the XLA scans elsewhere; the XLA
pointer fill for alignment), and results are either left sharded (for
streaming pipelines) or gathered. The only collective is the trailing
gather of (B,)-shaped scores / pointer tensors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from versalignlib_tpu.parallel.mesh import DATA_AXIS, make_mesh
from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, TieBreak


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "mesh", "impl"),
)
def _distributed_score(reads, refs, params: AlignmentParameters,
                       algorithm: Algorithm, mesh: Mesh, impl: str):
    from versalignlib_tpu.dispatch import device_score_fn

    score = device_score_fn(impl)
    mapped = jax.shard_map(
        lambda r, f: score(r, f, params, algorithm),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS),
        check_vma=False,  # scan carries start unvarying; per-shard DP is pure
    )
    return mapped(reads, refs)


def _shard_rows(mesh: Mesh, *arrays):
    """Pad (B, L) arrays to a multiple of the data axis with all-invalid
    rows and place them sharded over it."""
    n_dev = mesh.devices.size
    b = arrays[0].shape[0]
    b_pad = -(-b // n_dev) * n_dev
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return [
        jax.device_put(jnp.asarray(np.pad(np.asarray(x),
                                          ((0, b_pad - b), (0, 0)))),
                       sharding)
        for x in arrays
    ]


def distributed_score_batch(
    reads,
    refs,
    params: AlignmentParameters,
    algorithm: Algorithm,
    mesh: Mesh | None = None,
    impl: str = "auto",
) -> np.ndarray:
    """Score a (B, m) x (B, n) batch sharded over ``mesh``'s data axis.

    B is padded to a multiple of the axis size with all-invalid pairs
    (score 0), the reference's tail-batch semantics, so any batch size works.
    """
    from versalignlib_tpu.dispatch import resolve_score_impl

    if mesh is None:
        mesh = make_mesh()
    b = reads.shape[0]
    reads, refs = _shard_rows(mesh, reads, refs)
    out = _distributed_score(reads, refs, params, Algorithm(algorithm), mesh,
                             resolve_score_impl(impl))
    return np.asarray(out)[:b].astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("params", "algorithm", "tie", "mesh"),
)
def distributed_align_device(reads, refs, params: AlignmentParameters,
                             algorithm: Algorithm, tie: TieBreak, mesh: Mesh):
    """Sharded pointer fill (linear or affine) through the XLA scans:
    (ptr (B, m, n) uint8, start_read, start_ref, score), all sharded."""
    from versalignlib_tpu.ops.xla import fill_pointers

    mapped = jax.shard_map(
        lambda r, f: fill_pointers(r, f, params, algorithm, tie),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS), P(DATA_AXIS),
                   P(DATA_AXIS)),
        check_vma=False,
    )
    return mapped(reads, refs)


def distributed_align_batch(
    reads,
    refs,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
    mesh: Mesh | None = None,
    raw: bool = False,
    gapped: bool = True,
    chunk_pairs: int | None = None,
):
    """Full alignment of a (B, m) x (B, n) batch sharded over ``mesh``.

    Every device fills the pointer planes of its shard; the host decodes
    them with the native walker one round behind the devices. Rounds hold
    ``chunk_pairs`` pairs (default: about ``xla.ALIGN_CHUNK_BYTES`` of plane
    per device). Pads are all-invalid pairs (the reference's tail-batch
    fill-up) and are cut off on the host. ``raw``/``gapped`` as in
    :meth:`~versalignlib_tpu.dispatch.AlignmentEngine.compute_alignments`.
    """
    from versalignlib_tpu.ops.xla import ALIGN_CHUNK_BYTES, decode_pointers
    from versalignlib_tpu.types import AlignmentBatch

    if mesh is None:
        mesh = make_mesh()
    algorithm = Algorithm(algorithm)
    reads = np.asarray(reads)
    refs = np.asarray(refs)
    b, m = reads.shape
    n = refs.shape[1]
    if chunk_pairs is None:
        chunk_pairs = mesh.devices.size * max(
            1, ALIGN_CHUNK_BYTES // max(m * n, 1))
    results, pending = [], None
    for lo in range(0, b, chunk_pairs):
        sl = slice(lo, lo + chunk_pairs)
        r_dev, f_dev = _shard_rows(mesh, reads[sl], refs[sl])
        dev = distributed_align_device(r_dev, f_dev, params, algorithm, tie,
                                       mesh)
        if pending is not None:
            results.append(decode_pointers(*pending))
        pending = (dev[0], reads[sl], refs[sl], *dev[1:], params, algorithm,
                   raw, gapped)
    if pending is not None:
        results.append(decode_pointers(*pending))
    if raw:
        return AlignmentBatch.concat(results)
    return [a for chunk in results for a in chunk]
