"""Lattice-layer tests (parity: reference tests/test_lattice.py) plus
coverage of the vectorized coordinate/bond arrays."""

import numpy as np
import pytest

from bodge_tpu import CubicLattice, Lattice


def test_abstract_base_class():
    with pytest.raises(ValueError):
        Lattice((1, 1, 1))

    class Custom(Lattice):
        pass

    lat = Custom((1, 2, 3))
    with pytest.raises(NotImplementedError):
        lat[(0, 0, 0)]
    with pytest.raises(NotImplementedError):
        next(lat.sites())
    with pytest.raises(NotImplementedError):
        next(lat.bonds())
    with pytest.raises(NotImplementedError):
        next(lat.edges())
    assert str(lat) == "Custom(1, 2, 3)"
    assert lat.size == 6
    assert lat.dim == 2


def test_site_enumeration_and_indexing():
    lat = CubicLattice((3, 5, 7))
    count = 0
    for n, site in enumerate(lat.sites()):
        count += 1
        assert lat[site] == n  # contiguous, z fastest
        assert all(0 <= site[a] < lat.shape[a] for a in range(3))
    assert count == 3 * 5 * 7

    for bad in [(-1, 0, 0), (0, -1, 0), (0, 0, -1), (3, 0, 0), (0, 5, 0), (0, 0, 7)]:
        with pytest.raises(ValueError):
            lat[bad]


def test_bond_enumeration():
    lat = CubicLattice((2, 3, 5))
    total = 0
    for axis in (0, 1, 2):
        for a, b in lat.bonds(axis=axis):
            total += 1
            diff = np.subtract(b, a)
            assert abs(diff[axis]) == 1
            assert all(diff[other] == 0 for other in range(3) if other != axis)
    # Both directions of every nearest-neighbor link.
    assert total == 2 * ((2 - 1) * 3 * 5 + 2 * (3 - 1) * 5 + 2 * 3 * (5 - 1))

    with pytest.raises(ValueError):
        list(lat.bonds(axis=3))


def test_edge_enumeration():
    lat = CubicLattice((2, 3, 5))
    total = 0
    for axis, ends in ((0, (0, 1)), (1, (0, 2)), (2, (0, 4))):
        for a, b in lat.edges(axis=axis):
            total += 1
            assert {a[axis], b[axis]} == set(ends)
    assert total == 2 * (2 * 3 + 3 * 5 + 5 * 2)

    with pytest.raises(ValueError):
        list(lat.edges(axis=3))


def test_iter_contract():
    lat = CubicLattice((2, 2, 2))
    pairs = list(lat)
    n_sites = lat.size
    n_bonds = len(list(lat.bonds()))
    n_edges = len(list(lat.edges()))
    assert len(pairs) == n_sites + n_bonds + n_edges
    # On-site pairs come first.
    assert all(i == j for i, j in pairs[:n_sites])


# -- Vectorized arrays (extension of the reference) -------------------------


def test_site_coords_matches_generator():
    lat = CubicLattice((3, 4, 2))
    ref = np.array(list(lat.sites()))
    assert np.array_equal(lat.site_coords, ref)
    assert np.array_equal(lat.index_array(lat.site_coords), np.arange(lat.size))
    with pytest.raises(ValueError):
        lat.index_array(np.array([[3, 0, 0]]))


@pytest.mark.parametrize("shape", [(4, 3, 2), (5, 1, 1), (2, 2, 1)])
def test_bond_arrays_match_generator(shape):
    lat = CubicLattice(shape)
    gen = {(a, b) for a, b in ((tuple(x), tuple(y)) for x, y in lat.bonds())}
    src, dst = lat.bond_arrays()
    vec = {(tuple(a), tuple(b)) for a, b in zip(src.tolist(), dst.tolist())}
    assert gen == vec
    assert len(src) == len(list(lat.bonds()))


@pytest.mark.parametrize("shape", [(4, 3, 2), (5, 1, 1), (2, 2, 1)])
def test_edge_arrays_match_generator(shape):
    lat = CubicLattice(shape)
    gen = [(tuple(a), tuple(b)) for a, b in lat.edges()]
    src, dst = lat.edge_arrays()
    vec = [(tuple(a), tuple(b)) for a, b in zip(src.tolist(), dst.tolist())]
    assert sorted(gen) == sorted(vec)
