"""The port's models (models/superlattice.py) against the JAX package's,
and the grid parts a sweep shares among its points.

A sweep builds one ModelGrid (a0 and its ghost copy, the masks, the
weights, the Bessel multipliers) for each distinct grid key among its
points, and only the drive's scalars per point.  Each point model must
hold, bit for bit and dtype for dtype, what a standalone model of that
point's config holds, and what the JAX package's SuperlatticeModel (the
reference) holds; points of one key hold the same arrays; the sweep's
counters say how many shared; and a run leaves the shared arrays as
they were built.  Exact throughout: the same numpy expressions in the
same order.
"""

import numpy as np
import pytest
import torch

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu.config import SimConfig as JConfig
from slb2d_tpu.models.superlattice import SuperlatticeModel as JModel

from slb2d_tpu_torch import tracing
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.models.superlattice import (ModelGrid,
                                                  SuperlatticeModel,
                                                  grid_key, point_models)
from slb2d_tpu_torch.parallel.sweep import ParameterSweep

CPU = torch.device("cpu")
BASE = dict(display=4, E_dc=1.0, E_omega=2.0, omega=40.0, mu=1.0,
            alpha=0.9495, n_harmonics=6, phi_y_min=-10.0, phi_y_max=10.0,
            B=0.1, t_start=0.02, g_grid=24, dt=1e-3, quiet=True)
# name -> (the swept axes, meshed; the distinct grid keys among the points)
SWEEPS = {
    "E_dc x omega": ({"E_dc": [0.5, 1.0, 2.0], "omega": [30.0, 40.0]}, 1),
    "E_dc x mu": ({"E_dc": [0.5, 2.0], "mu": [0.5, 1.0, 2.0]}, 3),
}
CASES = [(name, dtype) for name in SWEEPS for dtype in ("f32", "f64")]


def _params(axes):
    grids = np.meshgrid(*[np.asarray(v) for v in axes.values()],
                        indexing="ij")
    return {k: g.ravel() for k, g in zip(axes, grids)}


def _sweep(name, dtype):
    axes, _ = SWEEPS[name]
    cfg = SimConfig(impl="torch", dtype=dtype, **BASE)
    tracing.reset()
    with tracing.recording():
        sweep = ParameterSweep(cfg, _params(axes), device=CPU)
    return sweep


def _point_kw(sweep, i):
    return {k: float(v[i]) for k, v in sweep.params.items()}


def _assert_same(got, want):
    """Every attribute of want (but cfg) in got, bit for bit, dtype for
    dtype."""
    names = set(vars(want)) - {"cfg"}
    assert set(vars(got)) - {"cfg"} == names
    for k in sorted(names):
        a, b = getattr(got, k), getattr(want, k)
        assert type(a) is type(b), k
        if isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype, k
            assert np.array_equal(a, b), k
        else:
            assert a == b, k


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("name,dtype", CASES)
def test_point_models_match_standalone_and_reference(name, dtype):
    """Each point model of a sweep against a standalone port model and
    the JAX package's model of the point's config."""
    sweep = _sweep(name, dtype)
    assert len(sweep.models) == sweep.B == 6
    for i, m in enumerate(sweep.models):
        kw = _point_kw(sweep, i)
        assert m.cfg == sweep.cfg.replace(**kw)
        _assert_same(m, SuperlatticeModel(m.cfg))
        _assert_same(m, JModel(JConfig(dtype=dtype, **{**BASE, **kw})))


@pytest.mark.parametrize("name,dtype", CASES)
def test_points_of_one_key_share_their_grid(name, dtype):
    """One grid part a distinct key: its points hold the same array
    objects, and the counters read the points and those that shared."""
    sweep = _sweep(name, dtype)
    _, keys = SWEEPS[name]
    by_key = {}
    for m in sweep.models:
        by_key.setdefault(grid_key(m.cfg), []).append(m)
    assert len(by_key) == keys
    assert len({id(m.a0) for m in sweep.models}) == keys
    grid_names = set(vars(ModelGrid(sweep.cfg)))
    for ms in by_key.values():
        for k in grid_names:
            assert len({id(getattr(m, k)) for m in ms}) == 1, k
    assert tracing.counters() == {"model.points": 6,
                                  "model.grids_shared": 6 - keys}


@pytest.mark.parametrize("name,dtype", CASES)
def test_a_run_leaves_the_shared_arrays_as_built(name, dtype):
    """After the batched engine's run, every grid's a0 and a0_ghost still
    equal a fresh build of them."""
    sweep = _sweep(name, dtype)
    out = sweep.run()
    assert np.all(np.isfinite(out["v_dr_av"]))
    for m in sweep.models:
        fresh = ModelGrid(m.cfg)
        assert np.array_equal(m.a0, fresh.a0)
        assert np.array_equal(m.a0_ghost, fresh.a0_ghost)


def test_point_models_count_only_while_spans_record():
    cfgs = [SimConfig(impl="torch", **{**BASE, "E_dc": e})
            for e in (0.5, 1.0)]
    models = point_models(cfgs)
    assert models[0].a0 is models[1].a0
    assert tracing.counters() == {}
