"""The port's getNeighborPairs (``nnpops_tpu_torch.neighbors.pairs``)
against the JAX package's on the same numpy inputs: pair order, -1/NaN
padding, the true count past the capacity and ``check_errors``, with and
without a box, and the masked pair list."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.neighbors.pairs import get_neighbor_pairs as j_pairs
from nnpops_tpu.neighbors.pairs import neighbor_pairs_masked as j_masked
from nnpops_tpu_torch.neighbors.pairs import (_triangular_pairs,
                                              get_neighbor_pairs,
                                              neighbor_pairs_masked)

BOX = np.diag([10.0, 12.0, 14.0]).astype(np.float32)
TRICLINIC = np.array([[10.0, 0, 0], [3.0, 12.0, 0], [-2.0, 4.0, 14.0]],
                     np.float32)


def positions(n, seed=7, width=20.0):
    rng = np.random.RandomState(seed)
    return (width * rng.rand(n, 3) - width / 2).astype(np.float32)


def assert_pairs_equal(got, want):
    for name, g, w in zip(('neighbors', 'deltas', 'distances', 'num_pairs'),
                          got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name in ('neighbors', 'num_pairs'):
            np.testing.assert_array_equal(g, w, name)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), name)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def test_triangular_decode_equals_jax():
    from nnpops_tpu.neighbors.pairs import _triangular_pairs as j_tri
    for n in (1, 2, 3, 50, 701):
        rows, cols = _triangular_pairs(n, 'cpu')
        jr, jc = j_tri(n)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))


@pytest.mark.parametrize('box', [None, 'rect', 'triclinic'])
@pytest.mark.parametrize('max_num_pairs', [-1, 40, 5000])
def test_pairs_equal_jax(box, max_num_pairs):
    b = {None: None, 'rect': BOX, 'triclinic': TRICLINIC}[box]
    pos = positions(60)
    cutoff = 4.5
    want = j_pairs(jnp.asarray(pos), cutoff, max_num_pairs,
                   None if b is None else jnp.asarray(b))
    got = get_neighbor_pairs(torch.tensor(pos), cutoff, max_num_pairs,
                             None if b is None else torch.tensor(b))
    assert_pairs_equal(got, want)
    if max_num_pairs == 40:
        assert int(got.num_pairs[0]) > 40          # the true count


def test_doctest_examples():
    """The documented examples of getNeighborPairs.py:99-139."""
    pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]])
    n, d, r, c = get_neighbor_pairs(pos, cutoff=3.0)
    np.testing.assert_array_equal(n.numpy(), [[1, 2, 2], [0, 0, 1]])
    np.testing.assert_allclose(d.numpy(), [[1, 0, 0], [2, 0, 0], [1, 0, 0]])
    assert int(c[0]) == 3
    n, d, r, c = get_neighbor_pairs(pos, cutoff=1.5, max_num_pairs=6)
    np.testing.assert_array_equal(n.numpy(), [[1, 2, -1, -1, -1, -1],
                                              [0, 1, -1, -1, -1, -1]])
    assert torch.isnan(r[2:]).all() and int(c[0]) == 2


def test_overflow_count_and_check_errors():
    pos = torch.zeros(5, 3)
    n, _, _, c = get_neighbor_pairs(pos, cutoff=1.0, max_num_pairs=3)
    assert int(c[0]) == 10 and tuple(n.shape) == (2, 3)
    with pytest.raises(RuntimeError, match='maximum number of pairs'):
        get_neighbor_pairs(pos, cutoff=1.0, max_num_pairs=3, check_errors=True)
    get_neighbor_pairs(pos, cutoff=1.0, max_num_pairs=10, check_errors=True)


def test_invalid_box_raises():
    with pytest.raises(ValueError, match='reduced form'):
        get_neighbor_pairs(torch.tensor(positions(10)), 2.0,
                           box_vectors=torch.tensor(TRICLINIC.T.copy()))


@pytest.mark.parametrize('max_num_pairs', [-1, 30])
def test_masked_pairs_equal_jax(max_num_pairs):
    pos = positions(40, seed=3)
    want = j_masked(jnp.asarray(pos), 4.0, max_num_pairs, jnp.asarray(BOX))
    got = neighbor_pairs_masked(torch.tensor(pos), 4.0, max_num_pairs,
                                torch.tensor(BOX))
    for name in ('atom1', 'atom2', 'mask', 'num_pairs'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ('deltas', 'distances'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # NaN-free gradient of sum r^2 over the pairs.
    p = torch.tensor(pos, requires_grad=True)
    m = neighbor_pairs_masked(p, 4.0, max_num_pairs, torch.tensor(BOX))
    (g,) = torch.autograd.grad(torch.sum(m.distances ** 2), p)
    assert torch.isfinite(g).all()
