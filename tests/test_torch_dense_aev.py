"""The port's dense AEV (``nnpops_tpu_torch.ops.aev.compute_aev``) and row
compaction (``ops.compaction.compact_rows``) against the JAX package on the
same numpy inputs: the TorchANI golden values, both modes and both angular
layouts (flat and factored), the finite-difference derivative validator,
the angular capacity, ``centers``, the gradient of exactly collinear
triples, and the compaction's indices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.ops import aev as jaev
from nnpops_tpu.ops.compaction import compact_rows as j_compact_rows
from nnpops_tpu.utils.water import make_water_box
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import species_from_atomic_numbers
from nnpops_tpu_torch.ops.aev import aev_forward, compute_aev
from nnpops_tpu_torch.ops.compaction import compact_rows

CASES = ('nonperiodic', 'periodic', 'triclinic')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several pytest workers on a few
    cores, where every small op's thread pool would contend with the
    others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def basis_kwargs(golden, torchani=True):
    rp = golden['radial_params']      # (eta, rs)
    ap = golden['angular_params']     # (eta, rs, zeta, thetas)
    return dict(
        num_species=2, radial_cutoff=4.5, angular_cutoff=3.5,
        radial_eta=tuple(rp[:, 0].tolist()), radial_rs=tuple(rp[:, 1].tolist()),
        angular_eta=tuple(ap[:, 0].tolist()), angular_rs=tuple(ap[:, 1].tolist()),
        angular_zeta=tuple(ap[:, 2].tolist()),
        angular_thetas=tuple(ap[:, 3].tolist()), torchani=torchani)


def golden_inputs(golden, case):
    pos = torch.tensor(golden['positions'])
    species = torch.tensor(golden['species'])
    box = None if case == 'nonperiodic' else torch.tensor(golden[f'{case}_box'])
    return pos, species, box


def assert_golden(got, expected, atol=1e-4, rtol=1e-3):
    got = np.asarray(got).ravel()
    expected = np.asarray(expected).ravel()
    diff = np.abs(expected - got)
    bad = (diff > atol) & (diff / np.maximum(np.abs(expected), 1e-30) > rtol)
    assert not bad.any(), f'{bad.sum()} mismatches, worst {diff.max()}'


@pytest.mark.parametrize('case', CASES)
def test_golden_values(golden_ani, case):
    basis = ANIBasis(**basis_kwargs(golden_ani))
    pos, species, box = golden_inputs(golden_ani, case)
    radial, angular = compute_aev(pos, species, basis, box=box)
    assert_golden(radial.numpy(), golden_ani[f'{case}_radial'])
    assert_golden(angular.numpy(), golden_ani[f'{case}_angular'])


def jax_aev(basis_kw, pos, species, box=None, **kw):
    jb = JBasis(**basis_kw)
    fn = jax.jit(lambda p, b: jaev.compute_aev(p, jnp.asarray(species), jb,
                                               box=b, **kw))
    radial, angular = fn(jnp.asarray(pos),
                         None if box is None else jnp.asarray(box))
    return np.asarray(radial), np.asarray(angular)


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('torchani', [True, False])
def test_matches_jax_flat_basis(golden_ani, case, torchani):
    kw = basis_kwargs(golden_ani, torchani)
    pos, species, box = golden_inputs(golden_ani, case)
    radial, angular = compute_aev(pos, species, ANIBasis(**kw), box=box)
    jr, ja = jax_aev(kw, pos.numpy(), species.numpy(),
                     None if box is None else box.numpy())
    np.testing.assert_allclose(radial.numpy(), jr, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(angular.numpy(), ja, rtol=1e-5, atol=1e-6)


def water(num=20, seed=1):
    w = make_water_box(num, seed=seed)
    return w, species_from_atomic_numbers(w.atomic_numbers)


@pytest.mark.parametrize('torchani', [True, False])
@pytest.mark.parametrize('capacity', [None, 12])
def test_matches_jax_ani2x_factored(torchani, capacity):
    """ANI-2x's factored angular grid, periodic, with and without an angular
    capacity that truncates (the compacted lists equal JAX's)."""
    w, sp = water()
    basis = ANIBasis.ani2x(torchani=torchani)
    assert basis.angular_rs_grid is not None
    radial, angular = compute_aev(torch.tensor(w.positions), torch.tensor(sp),
                                  basis, box=torch.tensor(w.box),
                                  angular_capacity=capacity)
    jb = JBasis.ani2x(torchani=torchani)
    jr, ja = jax.jit(lambda p, b: jaev.compute_aev(
        p, jnp.asarray(sp), jb, box=b, angular_capacity=capacity))(
            jnp.asarray(w.positions), jnp.asarray(w.box))
    np.testing.assert_allclose(radial.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(angular.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('torchani', [True, False])
def test_derivatives(golden_ani, case, torchani):
    """The finite-difference-along-gradient validator of every output
    element (step 1e-3, atol 1e-5, rtol 5e-3), as ``tests/test_aev.py``."""
    basis = ANIBasis(**basis_kwargs(golden_ani, torchani))
    pos, species, box = golden_inputs(golden_ani, case)

    def flat(p):
        return aev_forward(p, species, basis, box=box).reshape(-1)

    values = flat(pos)
    jac = torch.autograd.functional.jacobian(flat, pos).numpy()
    step = 1e-3
    with torch.no_grad():
        for i in range(values.shape[0]):
            grad = jac[i]
            norm = np.linalg.norm(grad)
            if norm < 1e-7:
                continue
            delta = torch.tensor(step / norm * grad)
            estimate = float(flat(pos + delta)[i] - flat(pos - delta)[i]) / (
                2 * step)
            assert np.isfinite(estimate)
            assert abs(norm - estimate) <= 1e-5 + 5e-3 * abs(norm), (
                f'output {i}: grad norm {norm} vs FD {estimate}')


def test_angular_capacity_compaction(golden_ani):
    """Capping the angular neighbors at the true maximum changes nothing."""
    basis = ANIBasis(**basis_kwargs(golden_ani))
    pos, species, _ = golden_inputs(golden_ani, 'nonperiodic')
    full = compute_aev(pos, species, basis)
    capped = compute_aev(pos, species, basis, angular_capacity=12)
    np.testing.assert_allclose(capped.angular.numpy(), full.angular.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(capped.radial.numpy(), full.radial.numpy())


def test_centers_equal_matching_rows():
    w, sp = water()
    basis = ANIBasis.ani2x()
    pos, box = torch.tensor(w.positions), torch.tensor(w.box)
    centers = torch.tensor([0, 5, 17, 31, 59])
    full = aev_forward(pos, torch.tensor(sp), basis, box=box,
                       angular_capacity=16)
    part = aev_forward(pos, torch.tensor(sp), basis, box=box,
                       angular_capacity=16, centers=centers)
    assert part.shape == (5, basis.aev_length)
    np.testing.assert_array_equal(part.numpy(), full[centers].numpy())


@pytest.mark.parametrize('torchani', [True, False])
def test_collinear_triple_gradient_matches_jax(torchani):
    """Exactly collinear and anticollinear triples put the torchani-mode
    cos_t on its clip bound (and the publication-mode cross product on its
    eps guard): the position gradient must split there as JAX's does."""
    pos = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                    [-1.5, 0.0, 0.0], [0.3, 1.1, -0.4]], np.float32)
    sp = species_from_atomic_numbers([8, 1, 1, 6, 1])
    weights = np.random.RandomState(0).randn(
        5, ANIBasis.ani2x().aev_length).astype(np.float32)
    basis = ANIBasis.ani2x(torchani=torchani)
    jb = JBasis.ani2x(torchani=torchani)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jnp.asarray(weights) * jaev.aev_forward(
        p, jnp.asarray(sp), jb))))(jnp.asarray(pos))
    p = torch.tensor(pos, requires_grad=True)
    torch.sum(torch.tensor(weights) * aev_forward(p, torch.tensor(sp), basis)
              ).backward()
    assert np.isfinite(p.grad.numpy()).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def compaction_cases():
    rng = np.random.RandomState(7)
    cases = {}
    for density in (0.1, 0.5, 0.9):
        cases[f'random-{density}'] = rng.rand(50, 40) < density
    edge = np.zeros((5, 40), bool)
    edge[1] = True                 # every entry valid
    edge[2, -1] = True             # only the last entry
    edge[3, 0] = True              # only the first entry
    edge[4, ::3] = True
    cases['edge-rows'] = edge      # row 0: no valid entry
    return cases


@pytest.mark.parametrize('name', sorted(compaction_cases()))
@pytest.mark.parametrize('capacity', [1, 7, 40, 55])
def test_compact_rows_equals_jax(name, capacity):
    valid = compaction_cases()[name]
    jidx, jkept = jax.jit(j_compact_rows, static_argnums=(1,))(
        jnp.asarray(valid), capacity)
    idx, kept = compact_rows(torch.tensor(valid), capacity)
    assert idx.dtype == torch.int32 and kept.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
