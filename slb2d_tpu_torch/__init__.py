"""slb2d_tpu_torch: the superlattice Boltzmann solver on PyTorch and CUDA.

The port of ``slb2d_tpu`` (JAX) to an NVIDIA H100: the same host schedule,
model and output formats, the stencil as plain PyTorch (``impl=torch``)
and the step loop as hand-written CUDA kernels: three launches per step
(``csrc/stepper.cu``) or temporal tiling (``impl=stream``,
``csrc/stepper_stream.cu``), ``impl=cuda`` taking whichever is faster at
the grid's shape; parameter sweeps as a batched torch engine and a
hand-written sweep kernel (``parallel/sweep.py``, ``csrc/sweep_stack.cu``).
Imports torch and numpy, never jax.
"""

from .config import SimConfig, parse_cmd  # noqa: F401
from .models.superlattice import SuperlatticeModel  # noqa: F401
from .ops.stencil import State, bootstrap_state, consts_from_model  # noqa: F401


def run_simulation(cfg, out=None, device=None):
    """Convenience: build and run a Simulation; returns the final State."""
    from .runtime.loop import Simulation
    return Simulation(cfg, out=out, device=device).run()

__version__ = "0.1.0"
