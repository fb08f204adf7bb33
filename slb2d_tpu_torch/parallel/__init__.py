"""Meshes across devices and processes, parameter sweeps (the batched
engine, the stacked sweep kernel's routing, the "sweep" mesh) and the
sharded phi_y grid (the "space" mesh)."""

from .mesh import make_mesh  # noqa: F401
from .sweep import ParameterSweep  # noqa: F401
