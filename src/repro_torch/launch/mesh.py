"""Meshes as records.  On one card no mesh is built: a :class:`Mesh`
keeps the reference's axis names and sizes (a 16 x 16 pod, or 2 x 16 x 16
across pods) so that the sharding rules can compute the reference's
specs from it; nothing is placed by it."""
from __future__ import annotations

import contextlib
import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (roofline) or 2x16x16 multi-pod (dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    if len(tuple(shape)) != len(tuple(axes)):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                         f"{tuple(axes)}")
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def mesh_context(mesh: Mesh):
    """A no-op context: one card has no mesh to enter."""
    return contextlib.nullcontext(mesh)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    """The data-parallel axes of a production mesh (includes pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    """Devices along the data-parallel axes."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def chips(mesh: Mesh) -> int:
    return mesh.size
