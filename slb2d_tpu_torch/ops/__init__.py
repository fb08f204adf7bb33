from .stencil import State, bootstrap_state, run_chunk  # noqa: F401
