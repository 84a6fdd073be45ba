"""Multi-host data-parallel driver layer.

The reference is strictly single-node (SURVEY §2.6: no processes, no
network — its widest scope is an OpenMP ``parallel for`` over pairs,
/root/reference/src/Kernels/default/DefaultKernel.cpp:45-48). Across hosts
the mapping is process data-parallelism over the pair batch, one process
per host owning that host's local devices:

- **Scoring** runs as ONE global XLA program: every process feeds its
  contiguous row slice into a globally-sharded array
  (``jax.make_array_from_process_local_data``), ``shard_map`` over the
  global mesh runs the local kernel per device, and a single XLA
  all-gather (inserted by an ``out_shardings`` constraint) replicates the
  4-byte-per-pair scores over the interconnect.
- **Alignment** stays host-local by construction: pointer streams are
  megabytes per block and are decoded on the host that produced them, so
  each process aligns its slice on its OWN local-device mesh and emits a
  result shard. No pointer bytes ever cross hosts; cross-host traffic is
  zero (callers merge shard files, or gather scores only).

Both paths require ``jax.distributed.initialize`` to have run (see
:func:`initialize`) with an explicit coordinator address, process count
and process id. Validated in CI by spawning real multi-process CPU
workers (tests/test_multihost.py) — the same code path, with Gloo standing
in for the interconnect.
"""

from __future__ import annotations

import numpy as np

from versalignlib_tpu.params import AlignmentParameters
from versalignlib_tpu.types import Algorithm, TieBreak


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-process runtime (idempotent).

    Pass the coordinator address (``host:port`` of process 0) and the
    process topology explicitly; the no-argument form only works where a
    cluster environment tells JAX about them.
    """
    import jax

    # Must not touch jax.process_count()/devices() here — any backend query
    # initializes XLA and makes a later initialize() call illegal.
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def process_slice(b: int, process_id: int | None = None,
                  num_processes: int | None = None) -> tuple[int, int]:
    """Contiguous ``[lo, hi)`` row range of a B-pair batch owned by one
    process. Balanced to within one pair; any B works (trailing processes
    may own an empty range when B < num_processes)."""
    import jax

    p = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    lo = (b * p) // n
    hi = (b * (p + 1)) // n
    return lo, hi


def multihost_score_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    impl: str = "auto",
) -> np.ndarray:
    """Score a GLOBAL (B, m) × (B, n) encoded batch across all hosts.

    ``reads``/``refs`` must be identical on every process (each host
    parses the same inputs — they are sequences, not tensors, and FASTA
    parsing is a rounding error next to the fill). Returns the full (B,)
    int32 score vector on every host.

    The batch pads to the global device count with all-invalid pairs (the
    reference's tail fill-up, SSEKernel.cpp:84-128, lifted to many hosts); the
    only collective is the trailing score all-gather.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from versalignlib_tpu.dispatch import resolve_score_impl
    from versalignlib_tpu.parallel.distributed import _distributed_score
    from versalignlib_tpu.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh()  # all global devices, process-contiguous order
    n_dev = mesh.devices.size
    impl = resolve_score_impl(impl)

    reads = np.asarray(reads)
    refs = np.asarray(refs)
    b = reads.shape[0]
    b_pad = max(n_dev, -(-b // n_dev) * n_dev)
    r_pad = np.pad(reads, ((0, b_pad - b), (0, 0)))
    f_pad = np.pad(refs, ((0, b_pad - b), (0, 0)))

    # Rows owned by this process's devices: the mesh flattens jax.devices(),
    # which orders devices by process, so each process owns one contiguous
    # stripe of b_pad (device d gets rows [d*per, (d+1)*per)).
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    per_proc = b_pad // jax.process_count()
    lo = jax.process_index() * per_proc
    g_reads = jax.make_array_from_process_local_data(
        sharding, r_pad[lo : lo + per_proc])
    g_refs = jax.make_array_from_process_local_data(
        sharding, f_pad[lo : lo + per_proc])

    out = _distributed_score(g_reads, g_refs, params, Algorithm(algorithm),
                             mesh, impl)
    # Replicate: out_shardings P() makes XLA insert the all-gather.
    gathered = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )(out)
    return np.asarray(gathered.addressable_data(0))[:b].astype(np.int32)


def multihost_align_batch(
    reads: np.ndarray,
    refs: np.ndarray,
    params: AlignmentParameters,
    algorithm: Algorithm,
    tie: TieBreak = TieBreak.DIAG_UP_LEFT,
) -> tuple[list, int, int]:
    """Full alignment of a GLOBAL batch; this host computes and decodes
    its contiguous slice on its local devices.

    Returns ``(alignments, lo, hi)`` where ``alignments`` covers global
    rows ``[lo, hi)``. Pointer streams never leave the host that filled
    them (the whole point — they are ~KB-MB per pair vs 4 B for a score);
    callers persist per-host shards (scripts/multihost_align.py) or
    exchange scores only.
    """
    import jax

    from versalignlib_tpu.parallel.distributed import distributed_align_batch
    from versalignlib_tpu.parallel.mesh import make_mesh

    reads = np.asarray(reads)
    refs = np.asarray(refs)
    lo, hi = process_slice(reads.shape[0])
    if lo == hi:
        return [], lo, hi
    local_mesh = make_mesh(devices=jax.local_devices())
    alns = distributed_align_batch(
        reads[lo:hi], refs[lo:hi], params, algorithm, tie=tie,
        mesh=local_mesh,
    )
    return alns, lo, hi
