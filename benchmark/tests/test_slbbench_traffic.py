"""The generator: the same seed gives the same requests, every seed the
same sizes; the warm-up request keeps the cell's shapes."""

import itertools

import numpy as np
import pytest

from harness import spec, traffic

CELLS = ("hires.d4", "hires.d77", "map.paper", "map.edc64")
SEED = 2**31 + 977          # seeds may pass 32 signed bits


def _first(cell, seed, n=5):
    return list(itertools.islice(
        traffic.requests(cell.config, cell.traffic, seed), n))


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_requests(name):
    cell = spec.load_cell(name)
    a, b = _first(cell, SEED), _first(cell, SEED)
    assert [r.argv() for r in a] == [r.argv() for r in b]
    assert [r.points for r in a] == [r.points for r in b]
    c = _first(cell, SEED + 1)
    assert [r.argv() for r in a] != [r.argv() for r in c]


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_the_same_sizes(name):
    cell = spec.load_cell(name)
    sizes = {(r.steps, r.av_steps, r.n_points)
             for seed in (1, 2, SEED) for r in _first(cell, seed, 3)}
    assert len(sizes) == 1


def test_the_cells_sizes():
    d4 = _first(spec.load_cell("hires.d4"), SEED, 1)[0]
    assert (d4.steps, d4.n_points) == (16281, 1)
    paper = _first(spec.load_cell("map.paper"), SEED, 1)[0]
    assert (paper.steps, paper.n_points) == (6048, 256)
    assert np.unique(paper.params["omega"]).size == 16
    edc = _first(spec.load_cell("map.edc64"), SEED, 1)[0]
    assert (edc.steps, edc.n_points) == (6384, 64)
    assert "omega" not in edc.params


@pytest.mark.parametrize("name", CELLS)
def test_draws_lie_in_their_ranges(name):
    cell = spec.load_cell(name)
    for r in _first(cell, SEED, 20):
        for k, (lo, hi) in cell.traffic["draw"].items():
            assert lo <= r.settings[k] <= hi


@pytest.mark.parametrize("name", CELLS)
def test_warm_request_keeps_the_shapes_and_cuts_the_steps(name):
    cell = spec.load_cell(name)
    warm = traffic.warm_request(cell.config, cell.traffic, SEED)
    first = _first(cell, SEED, 1)[0]
    assert warm.n_points == first.n_points
    for k in ("n-harmonics", "g-grid", "dtype", "display", "impl"):
        assert warm.settings[k] == first.settings[k]
    assert 500 <= warm.steps <= 2000 < first.steps
