"""Worker layouts: the port's counterpart of the JAX package's meshes.

``sparknet_tpu/parallel/mesh.py`` :23-75 builds device meshes: a flat
(data, model) mesh and the (host, chip) pod mesh that the
``hierarchical`` strategy composes its two tiers on.  On one card the
port runs N logical workers one after another, so a layout is only the
shape: worker ``w = host · chips_per_host + chip``, the order in which
the JAX pod mesh lays out its devices.  ``shape`` carries the JAX mesh's
axis names and sizes, which round-checkpoint manifests record, so a
manifest written by either package names the same layout.
"""

from __future__ import annotations

import dataclasses

DATA_AXIS = "data"
MODEL_AXIS = "model"
HOST_AXIS = "host"   # the slow tier: τ-boundary weight averaging
CHIP_AXIS = "chip"   # the fast tier: the per-step gradient mean


@dataclasses.dataclass(frozen=True)
class Layout:
    """N logical workers on one device, by axis name."""
    axes: tuple[tuple[str, int], ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def n_workers(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n


def make_mesh(n_devices: int) -> Layout:
    """A flat layout of ``n_devices`` data-parallel workers (the JAX
    ``make_mesh(n)``: axes data x model, model 1)."""
    if n_devices < 1:
        raise ValueError(f"a layout needs >= 1 worker, got {n_devices}")
    return Layout(((DATA_AXIS, n_devices), (MODEL_AXIS, 1)))


def make_pod_mesh(n_hosts: int, chips_per_host: int) -> Layout:
    """A (host, chip) layout of ``n_hosts`` x ``chips_per_host`` workers,
    for the ``hierarchical`` strategy: the per-step gradient mean runs
    over a host's chips, the τ-boundary weight mean over hosts."""
    if n_hosts < 1:
        raise ValueError(f"pod mesh needs n_hosts >= 1, got {n_hosts}")
    if chips_per_host < 1:
        raise ValueError(
            f"pod mesh needs chips_per_host >= 1, got {chips_per_host}")
    return Layout(((HOST_AXIS, n_hosts), (CHIP_AXIS, chips_per_host)))
