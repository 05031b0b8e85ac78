"""The port's PME (``nnpops_tpu_torch.ops.pme``): the OpenMM golden values
of the reference suite (rectangular, triclinic, exclusions), charge
derivatives and second derivatives on the pair path, and the B-spline
moduli, the spread and the spread-chunk count against the JAX package's on
the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import PMEConfig as JConfig
from nnpops_tpu.ops import pme as jpme
from nnpops_tpu_torch.config import PMEConfig
from nnpops_tpu_torch.ops import pme as tpme
from nnpops_tpu_torch.ops.pme import PME
from nnpops_tpu_torch.utils import make_water_box

# Fixtures and OpenMM golden values of the reference suite (TestPme.py).
POS_RECT = np.array([
    [0.7713206433, 0.02075194936, 0.6336482349],
    [0.7488038825, 0.4985070123, 0.2247966455],
    [0.1980628648, 0.7605307122, 0.1691108366],
    [0.08833981417, 0.6853598184, 0.9533933462],
    [0.003948266328, 0.5121922634, 0.8126209617],
    [0.6125260668, 0.7217553174, 0.2918760682],
    [0.9177741225, 0.7145757834, 0.542544368],
    [0.1421700476, 0.3733407601, 0.6741336151],
    [0.4418331744, 0.4340139933, 0.6177669785]], dtype=np.float32)
POS_TRI = np.array([
    [1.31396193, -0.9377441519, 0.9009447048],
    [1.246411648, 0.4955210369, -0.3256100634],
    [-0.4058114057, 1.281592137, -0.4926674903],
    [-0.7349805575, 1.056079455, 1.860180039],
    [-0.988155201, 0.5365767902, 1.437862885],
    [0.8375782005, 1.165265952, -0.1243717955],
    [1.753322368, 1.14372735, 0.627633104],
    [-0.5734898572, 0.1200222802, 1.022400845],
    [0.3254995233, 0.30204198, 0.8533009354]], dtype=np.float32)
CHARGES = np.array([(i - 4) * 0.1 for i in range(9)], dtype=np.float32)
BOX_RECT = np.diag([1.0, 1.1, 1.2]).astype(np.float32)
BOX_TRI = np.array([[1, 0, 0], [-0.1, 1.2, 0], [0.2, -0.15, 1.1]],
                   dtype=np.float32)
NO_EXCL = np.zeros((9, 0), dtype=np.int32)
EXCL_TRI = np.array([[3, -1], [-1, -1], [-1, 3], [0, 2], [-1, -1],
                     [-1, -1], [-1, -1], [-1, 8], [7, -1]], dtype=np.int32)

DDIRECT_RECT = [[-0.4068958163, 1.128490567, 0.2531163692],
                [8.175477028, -15.20702648, -5.499810219],
                [-0.2548360825, 0.003096142784, -0.67370224],
                [0.09854402393, 0.5804504156, 1.063418627],
                [0, 0, 0],
                [-7.859698296, 14.16478539, 5.236941814],
                [0.684042871, -1.312145352, 0.7057141662],
                [30.47141075, 6.726415634, -6.697656631],
                [-30.90804291, -6.084065914, 5.611977577]]
DRECIP_RECT = [[-0.6407046318, -27.59628105, -3.745499372],
               [30.76446915, -27.10591507, -82.14082336],
               [-15.06353951, 10.37030602, -38.38755035],
               [-7.421859741, 21.9861393, 39.86354828],
               [0, 0, 0],
               [-13.09759808, 6.393665314, 34.15939713],
               [19.53832817, -59.55260849, 33.96843338],
               [122.5542908, 60.35510254, -27.44270515],
               [-136.679245, 15.14429855, 43.89074326]]
DRECIP_TRI = [[-162.9051514, 32.17734528, -77.43495178],
              [11.11517906, 52.98329163, -83.18161011],
              [34.50453186, 8.428194046, -4.691772938],
              [-12.71308613, 20.7514267, -13.68377304],
              [0, 0, 0],
              [8.277475357, -3.927520275, 13.88403988],
              [-34.93006897, -7.739934444, 8.986465454],
              [45.33776474, -36.9358139, 40.34444809],
              [111.2698975, -65.63329315, 115.8478012]]
DDIRECT_EXCL = [[-998.2406773, -314.4639407, 379.7956738],
                [401.7656421, 153.7181283, -278.0072042],
                [2136.789297, -634.4331203, -1062.13192],
                [-0.6838558404, -0.7345126528, -3.655667043],
                [0, 0, 0],
                [0.05210044985, -2.530651058, 3.196419874],
                [-2139.175743, 634.0007806, 1060.564263],
                [21.9532636, -40.74009123, 38.42738517],
                [577.5399728, 205.183407, -138.1889512]]


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.tensor(np.asarray(a))


def pos_grad(fn, pos):
    p = t(pos).requires_grad_(True)
    (g,) = torch.autograd.grad(fn(p), p)
    return g.numpy()


def test_rectangular():
    """TestPme.py:16-63: energies rtol 1e-4, forces as the JAX suite."""
    pme = PME(14, 15, 16, 5, 4.985823141035867, 138.935, NO_EXCL,
              device='cpu')
    q, box = t(CHARGES), t(BOX_RECT)
    edir = float(pme.compute_direct(t(POS_RECT), q, 0.5, box))
    np.testing.assert_allclose(edir, 0.5811535194516182, rtol=1e-4)
    erec = float(pme.compute_reciprocal(t(POS_RECT), q, box))
    np.testing.assert_allclose(erec, -90.92361028496651, rtol=1e-4)
    np.testing.assert_allclose(
        pos_grad(lambda p: pme.compute_direct(p, q, 0.5, box), POS_RECT),
        DDIRECT_RECT, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        pos_grad(lambda p: pme.compute_reciprocal(p, q, box), POS_RECT),
        DRECIP_RECT, rtol=1e-3, atol=2e-3)


def test_triclinic():
    """TestPme.py:65-112."""
    pme = PME(14, 16, 15, 5, 5.0, 138.935, NO_EXCL, device='cpu')
    q, box = t(CHARGES), t(BOX_TRI)
    edir = float(pme.compute_direct(t(POS_TRI), q, 0.5, box))
    np.testing.assert_allclose(edir, -178.86083489656448, rtol=1e-4)
    erec = float(pme.compute_reciprocal(t(POS_TRI), q, box))
    np.testing.assert_allclose(erec, -200.9420623172533, rtol=1e-4)
    np.testing.assert_allclose(
        pos_grad(lambda p: pme.compute_reciprocal(p, q, box), POS_TRI),
        DRECIP_TRI, rtol=1e-3, atol=2e-3)


def test_exclusions():
    """TestPme.py:114-171: direct space skips and compensates; reciprocal
    space is unchanged."""
    pme = PME(14, 16, 15, 5, 5.0, 138.935, EXCL_TRI, device='cpu')
    q, box = t(CHARGES), t(BOX_TRI)
    edir = float(pme.compute_direct(t(POS_TRI), q, 0.5, box))
    np.testing.assert_allclose(edir, -204.22671127319336, rtol=1e-4)
    erec = float(pme.compute_reciprocal(t(POS_TRI), q, box))
    np.testing.assert_allclose(erec, -200.9420623172533, rtol=1e-4)
    np.testing.assert_allclose(
        pos_grad(lambda p: pme.compute_direct(p, q, 0.5, box), POS_TRI),
        DDIRECT_EXCL, rtol=2e-3, atol=2e-2)


def test_charge_derivatives():
    """TestPme.py:173-236: charge gradients against finite differences,
    and the chain rule."""
    excl = np.array([[6, -1], [-1, -1], [-1, -1], [6, -1], [-1, -1],
                     [-1, -1], [0, 3], [-1, -1], [-1, -1]], dtype=np.int32)
    pme = PME(14, 15, 16, 5, 4.985823141035867, 138.935, excl, device='cpu')
    pos, box = t(POS_RECT), t(BOX_RECT)

    def q_grad(fn):
        q = t(CHARGES).requires_grad_(True)
        (g,) = torch.autograd.grad(fn(q), q)
        return g.numpy()

    ddir = q_grad(lambda q: pme.compute_direct(pos, q, 0.5, box))
    drec = q_grad(lambda q: pme.compute_reciprocal(pos, q, box))
    delta = 1e-3
    for i in range(9):
        c1, c2 = CHARGES.copy(), CHARGES.copy()
        c1[i] += delta
        c2[i] -= delta
        fd_dir = (float(pme.compute_direct(pos, t(c1), 0.5, box))
                  - float(pme.compute_direct(pos, t(c2), 0.5, box))) / (2 * delta)
        fd_rec = (float(pme.compute_reciprocal(pos, t(c1), box))
                  - float(pme.compute_reciprocal(pos, t(c2), box))) / (2 * delta)
        np.testing.assert_allclose(ddir[i], fd_dir, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(drec[i], fd_rec, rtol=1e-3, atol=2e-2)
    d2 = q_grad(lambda q: 2.5 * pme.compute_direct(pos, q, 0.5, box))
    np.testing.assert_allclose(2.5 * ddir, d2, rtol=1e-5)


@pytest.mark.parametrize('term', ['direct', 'reciprocal'])
def test_second_derivatives_supported(term):
    """A superset of the reference (TestPme.py:296-318 forbids them), as in
    the JAX package: the gradient of |dE/dx|^2, against JAX's."""
    pme = PME(14, 16, 15, 5, 5.0, 138.935, NO_EXCL, device='cpu')
    jp = jpme.PME(14, 16, 15, 5, 5.0, 138.935, NO_EXCL)
    q, box = t(CHARGES), t(BOX_TRI)
    if term == 'direct':
        e_t = lambda p: pme.compute_direct(p, q, 0.5, box)  # noqa: E731
        e_j = lambda p: jp.compute_direct(p, jnp.asarray(CHARGES), 0.5,  # noqa: E731
                                          jnp.asarray(BOX_TRI))
    else:
        e_t = lambda p: pme.compute_reciprocal(p, q, box)  # noqa: E731
        e_j = lambda p: jp.compute_reciprocal(p, jnp.asarray(CHARGES),  # noqa: E731
                                              jnp.asarray(BOX_TRI))
    p = t(POS_TRI).requires_grad_(True)
    (g,) = torch.autograd.grad(e_t(p), p, create_graph=True)
    (hvp,) = torch.autograd.grad(torch.sum(g ** 2), p)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax.grad(e_j)(x) ** 2))(
        jnp.asarray(POS_TRI)))
    assert torch.isfinite(hvp).all()
    np.testing.assert_allclose(hvp.numpy(), want, rtol=2e-3,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize('grid, order', [((14, 15, 16), 5), ((32, 32, 32), 5),
                                         ((16, 24, 32), 4), ((64, 64, 64), 6)])
def test_bspline_moduli_equal_jax(grid, order):
    for a, b in zip(tpme.bspline_moduli(grid, order),
                    jpme.bspline_moduli(grid, order)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def water150():
    w = make_water_box(150, seed=0)
    return w, PMEConfig(32, 32, 32, 5, 0.6, 1389.35457), JConfig(
        32, 32, 32, 5, 0.6, 1389.35457)


@pytest.mark.parametrize('size', [32, 30], ids=['chunked', 'scatter'])
def test_spread_matches_jax(water150, size):
    """The port's one index_add spread against JAX's spread on water(150):
    at 32^3 JAX takes its chunked spread, at 30^3 (not a multiple of 8) its
    scatter-add. Values and the position and charge gradients of
    sum(grid^2)."""
    w = water150[0]
    cfg = PMEConfig(size, size, size, 5, 0.6, 1389.35457)
    jcfg = JConfig(size, size, size, 5, 0.6, 1389.35457)
    jpos, jq = jnp.asarray(w.positions), jnp.asarray(w.charges)
    jbox = jnp.asarray(w.box)
    assert jpme._chunkable(jcfg) == (size == 32)
    want = np.asarray(jpme.spread_charges(jpos, jq, jbox, jcfg))
    p, q = t(w.positions).requires_grad_(True), t(w.charges).requires_grad_(True)
    grid = tpme.spread_charges(p, q, t(w.box), cfg)
    scale = np.abs(want).max()
    np.testing.assert_allclose(grid.detach().numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    gp, gq = torch.autograd.grad(torch.sum(grid ** 2), (p, q))
    jgp, jgq = jax.grad(lambda a, b: jnp.sum(
        jpme.spread_charges(a, b, jbox, jcfg) ** 2), argnums=(0, 1))(jpos, jq)
    for got, ref in ((gp, jgp), (gq, jgq)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_spread_overflow_equals_jax(water150):
    w, cfg, jcfg = water150
    pos, q, box = t(w.positions), t(w.charges), t(w.box)
    got = tpme.spread_overflow(pos, q, box, cfg)
    want = jpme.spread_overflow(jnp.asarray(w.positions),
                                jnp.asarray(w.charges), jnp.asarray(w.box),
                                jcfg)
    assert got.dtype == torch.int32 and int(got) == int(want)
    assert tpme.spread_capacity(len(w.positions), cfg) == \
        jpme.spread_capacity(len(w.positions), jcfg)
    # Every atom piled into one chunk: the count reports it.
    piled = torch.rand(600, 3, generator=torch.Generator().manual_seed(0)) * 0.5
    assert int(tpme.spread_overflow(piled, torch.ones(600),
                                    t(np.diag([16.0] * 3).astype(np.float32)),
                                    PMEConfig(16, 16, 16, 5, 3.04, 138.935))
               ) > tpme.spread_capacity(600, PMEConfig(16, 16, 16, 5, 3.04,
                                                       138.935))


def test_reciprocal_energy_equals_jax(water150):
    w, cfg, jcfg = water150
    pme = PME(32, 32, 32, 5, 0.6, 1389.35457,
              np.full((len(w.positions), 1), -1, np.int32), device='cpu')
    jp = jpme.PME(32, 32, 32, 5, 0.6, 1389.35457,
                  np.full((len(w.positions), 1), -1, np.int32))
    got = float(pme.compute_reciprocal(t(w.positions), t(w.charges),
                                       t(w.box)))
    want = float(jp.compute_reciprocal(jnp.asarray(w.positions),
                                       jnp.asarray(w.charges),
                                       jnp.asarray(w.box)))
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_cell_list_route_raises():
    pme = PME(14, 15, 16, 5, 4.985823141035867, 138.935, NO_EXCL,
              device='cpu')
    with pytest.raises(NotImplementedError, match='A.6'):
        pme.compute_direct(t(POS_RECT), t(CHARGES), 0.5, t(BOX_RECT),
                           cell_list=object())
