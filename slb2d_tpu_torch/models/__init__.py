from .superlattice import SuperlatticeModel  # noqa: F401
