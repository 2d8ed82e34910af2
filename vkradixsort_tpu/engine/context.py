"""DeviceContext — device/mesh discovery, and the compile-cache location.

Analog of the reference's ``GPUContext``
(engine/include/engine/core/GPUContext.h:15-111): where the reference
manages instance/device/queues/command-pool lifecycle by hand, in JAX the
runtime (PJRT) owns the device, so this context's job is discovery —
enumerate devices and build sharding meshes (replacing the reference's
interactive physical-device picker, GPUContext.cpp:152-195, with
deterministic selection).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import jax
import numpy as np

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    kind: str
    num_devices: int
    platform: str


class DeviceContext:
    """Deterministic device discovery + mesh construction."""

    def __init__(self, devices=None):
        self._devices = list(devices) if devices is not None else list(jax.devices())
        if not self._devices:
            raise RuntimeError("no JAX devices visible")

    @property
    def devices(self):
        return self._devices

    @property
    def info(self) -> DeviceInfo:
        d = self._devices[0]
        return DeviceInfo(
            kind=getattr(d, "device_kind", d.platform),
            num_devices=len(self._devices),
            platform=d.platform,
        )

    def mesh_1d(self, axis_name: str = "x", num_devices: int | None = None) -> jax.sharding.Mesh:
        """1-D mesh over all (or the first ``num_devices``) devices."""
        devs = self._devices if num_devices is None else self._devices[:num_devices]
        return jax.sharding.Mesh(np.asarray(devs), (axis_name,))


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a stable directory and
    return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing else is set. Otherwise the cache lives at ``<checkout>/.jax_cache``
    — a fixed path, because the path is part of the cache key. Scripts call
    this at start-up; importing the library sets nothing.
    """
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    path = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
