"""Runtime capability probing.

The analogue of the reference's CPUID gate (``check_avx2_support``,
/root/reference/src/util/versalignUtil.cpp:78-181, used to conditionally
register the AVX backend, main.cpp:80-83): probe the JAX platform once,
cache it, and let the dispatcher pick the best backend.
"""

from __future__ import annotations

import dataclasses
import functools

from versalignlib_tpu.utils.logging import get_logger

_log = get_logger("capabilities")


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    platform: str          # JAX platform of device 0: "gpu", "cpu", ...
    device_kind: str
    num_devices: int
    #: device memory the allocator may use (``memory_stats()["bytes_limit"]``);
    #: None where the device reports none (the CPU)
    memory_bytes: int | None

    @property
    def gpu_kernels(self) -> bool:
        """Whether the hand-written GPU kernels compile here (CUDA devices;
        JAX names that platform "gpu")."""
        return self.platform == "gpu"


@functools.lru_cache(maxsize=1)
def probe() -> DeviceCapabilities:
    import jax

    local = jax.local_devices()[0]  # memory stats need an addressable one
    stats = local.memory_stats() or {}
    caps = DeviceCapabilities(
        platform=local.platform,
        device_kind=local.device_kind,
        num_devices=len(jax.devices()),
        memory_bytes=stats.get("bytes_limit"),
    )
    _log.info("device capabilities: %s", caps)
    return caps
