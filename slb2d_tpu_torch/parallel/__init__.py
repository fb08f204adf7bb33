"""Parameter sweeps (the batched engine and the stacked sweep kernel's
routing)."""

from .sweep import ParameterSweep  # noqa: F401
