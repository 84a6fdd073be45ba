"""Asynchronous device staging: double-buffered H2D for bulk ingestion.

The reference's closest analogue is the OpenCL host path's zero-copy
``CL_MEM_USE_HOST_PTR`` buffers per batch
(/root/reference/src/Kernels/OpenCL/OpenCLKernel.cpp:68-74) — synchronous
by construction. Here ``jax.device_put`` dispatches the H2D copy
asynchronously, so staging chunk k+1 while chunk k computes hides the PCIe
transfer once steady state is reached. Used by scripts/bulk_align.py's
dispatch-ahead scoring loop.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np


def prefetch_to_device(
    chunks: Iterable[tuple],
    depth: int = 2,
    sharding=None,
) -> Iterator[tuple]:
    """Yield each chunk with its ndarrays staged on device ``depth`` ahead.

    ``chunks`` yields tuples whose ndarray elements are copied to device
    (``jax.device_put`` — async dispatch) while earlier chunks are still
    being consumed; non-array elements (indices, metadata) pass through
    untouched. ``depth`` bounds device memory: at most ``depth`` chunks'
    inputs are resident beyond the one being consumed. ``sharding``
    forwards to ``device_put`` (e.g. a NamedSharding for mesh runs).
    """
    import jax

    if depth < 1:
        raise ValueError("depth must be >= 1")

    def stage(item: tuple) -> tuple:
        return tuple(
            jax.device_put(x, sharding) if isinstance(x, np.ndarray) else x
            for x in item
        )

    queue: collections.deque = collections.deque()
    it = iter(chunks)
    try:
        for _ in range(depth):
            queue.append(stage(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(stage(next(it)))
        except StopIteration:
            pass
        yield out
