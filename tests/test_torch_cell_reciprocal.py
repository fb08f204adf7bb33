"""The identity the kernels' cell rests on: colf / xi and colf · (1 / xi)
are the same bits.

Every kernel's cell (csrc/half_step.cuh cell_update and half_step_cell)
computes inv_xi = colf * (1 / xi), where the plain version
(ops/stencil.py apply_half_step, the reciprocal form) computes colf / xi;
colf is the column mask, 0 or 1, and xi = nu2 + mu_t1², mu_t1 = n · ((E_dc
+ E_omega · cos + B · phi) · dt / 2).  For colf 1 both are rn(1 / xi), and
for colf 0 both are +0 as long as 1 / xi is finite.  These cases hold it
in numpy float32 and float64 (IEEE, round to nearest, no contraction, as
the kernels build with -fmad=false): over xi as the benchmark's cells
produce it, from their grids' phi and their drives' ranges with n up to
N, and over the ends of the normal range.
"""

import numpy as np
import pytest

import torch_support  # noqa: F401  (one torch thread)
from slb2d_tpu_torch.config import SimConfig
from slb2d_tpu_torch.models.superlattice import SuperlatticeModel

DTYPES = {"f32": np.float32, "f64": np.float64}

# (N, M) of the benchmark's grids: the maps, hires.*, tall.d4, wide.d4
GRIDS = ((40, 500), (100, 4000), (400, 4000), (100, 20000))

# the drives' ranges over the benchmark's traffic (E_dc from 0 in the
# paper map to 3; E_omega 1-3; B 0.05-0.3), at their ends and inside, and
# the drive's cosine across [-1, 1]
DRIVES = [(e_dc, e_om, b) for e_dc in (0.0, 1.7, 3.0)
          for e_om in (1.0, 3.0) for b in (0.05, 0.3)]
COSINES = (-1.0, -0.5, 0.0, 0.3, 1.0)


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def _same_bits(xi):
    """colf / xi and colf * (1 / xi) for colf 0 and 1, bit for bit."""
    D = xi.dtype.type
    one = D(1)
    for colf in (D(0), D(1)):
        div = colf / xi
        rcp = colf * (one / xi)
        assert np.array_equal(_bits(div), _bits(rcp)), (
            colf, xi[_bits(div) != _bits(rcp)][:4])


def _cells_xi(N, M, dtype):
    """xi at every (n, column) of an (N, M) grid in `dtype`, one array a
    drive and cosine of DRIVES x COSINES, in the kernels' operand
    order."""
    D = DTYPES[dtype]
    model = SuperlatticeModel(SimConfig(
        display=4, E_dc=1.0, E_omega=2.0, omega=1.0, B=0.1, t_start=10.0,
        n_harmonics=8, g_grid=M, mu=1.0, alpha=0.9495, phi_y_min=-10.0,
        phi_y_max=10.0, dt=1e-3, dtype=dtype))
    phi = np.asarray(model.phi, D)
    dt, nu2 = D(model.dt), D(model.nu2)
    nf = np.arange(N + 1, dtype=D)[:, None]
    for e_dc, e_om, b in DRIVES:
        for c in COSINES:
            cp = (D(e_dc) + D(e_om) * D(c) + D(b) * phi) * dt / D(2)
            mu_t1 = nf * cp[None, :]
            yield (nu2 + mu_t1 * mu_t1).ravel()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"N{g[0]}M{g[1]}")
def test_reciprocal_product_is_the_division_at_the_cells_xi(grid, dtype):
    """At every xi an (N, M) cell of the benchmark produces over the
    drives' ranges: xi is positive and normal (nu2 >= 1), and colf / xi
    and colf * (1 / xi) are the same bits for colf 0 and 1."""
    fi = np.finfo(DTYPES[dtype])
    for xi in _cells_xi(*grid, dtype):
        assert xi.dtype == DTYPES[dtype]
        assert bool(np.all(np.isfinite(xi))) and bool(np.all(xi >= fi.tiny))
        assert float(xi.min()) >= 1.0 and float(xi.max()) < 8.0
        _same_bits(xi)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_reciprocal_product_is_the_division_at_the_normal_ranges_ends(
        dtype):
    """At the ends of the normal range (the smallest normals, where 1 / xi
    is near the largest finite value; the largest, where 1 / xi is
    subnormal), at powers of two and their neighbours, and over random
    normals of every exponent: the same bits."""
    D = DTYPES[dtype]
    fi = np.finfo(D)
    ends = [fi.tiny, fi.max, D(1), D(2), D(0.5)]
    edge = [np.nextafter(v, D(np.inf)) for v in ends[:1]] + \
        [np.nextafter(v, D(0)) for v in ends[1:]] + \
        [np.nextafter(v, D(np.inf)) for v in ends[2:]]
    rng = np.random.default_rng(20241)
    lo, hi = np.log2(float(fi.tiny)), np.log2(float(fi.max))
    random = np.exp2(rng.uniform(lo, hi, 20000)).astype(D)
    random = random[np.isfinite(random) & (random >= fi.tiny)]
    powers = np.ldexp(D(1), np.arange(fi.minexp, fi.maxexp)).astype(D)
    xi = np.concatenate([np.asarray(ends + edge, D), random, powers,
                         np.nextafter(powers, D(np.inf)),
                         np.nextafter(powers, D(0))])
    xi = xi[np.isfinite(xi) & (xi >= fi.tiny)]
    assert xi.dtype == D and xi.size > 10000
    with np.errstate(under="ignore"):
        _same_bits(xi)
