"""The port's PME direct-space window path (``ops.cuda_pme``: the plan,
the kernel's plain version and the host side) against the JAX package's
(``ops.pallas_pme``, its Pallas kernel in interpret mode) on the JAX
suite's fixture: water(50, seed 3), cutoff 3.5, the 2 intramolecular
exclusions of every atom."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.ops import pallas_pme as jwin
from nnpops_tpu.ops.pme import PME as JPME
from nnpops_tpu.utils.water import make_water_box
from nnpops_tpu_torch.ops import cuda_pme
from nnpops_tpu_torch.ops.pme import PME

CUTOFF = 3.5
ALPHA, KE = 0.35, 138.935


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def setup():
    water = make_water_box(50, seed=3)        # box ~11.4 A, 3 cells of 3.5
    n = len(water.positions)
    excl = np.full((n, 2), -1, np.int32)
    for m in range(n // 3):
        o, h1, h2 = 3 * m, 3 * m + 1, 3 * m + 2
        excl[o] = [h1, h2]
        excl[h1] = [o, h2]
        excl[h2] = [o, h1]
    return water, excl


def both(exclusions, grid=16, order=5, alpha=ALPHA):
    return (PME(grid, grid, grid, order, alpha, KE, exclusions, device='cpu'),
            JPME(grid, grid, grid, order, alpha, KE, exclusions))


def t(a):
    return torch.tensor(np.asarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize('bucket', [False, True])
@pytest.mark.parametrize('margin', [1.25, 2.0])
def test_plan_equals_jax(setup, bucket, margin):
    water, _ = setup
    for pos, box in ((water.positions, water.box),
                     (make_water_box(867, seed=0).positions,
                      make_water_box(867, seed=0).box)):
        got = cuda_pme.plan_pme_window(box, 5.0 if len(pos) > 200 else CUTOFF,
                                       pos, margin=margin, bucket=bucket)
        want = jwin.plan_pme_window(box, 5.0 if len(pos) > 200 else CUTOFF,
                                    pos, margin=margin, bucket=bucket)
        assert got == want


@pytest.mark.parametrize('use_excl', [False, True])
def test_energy_matches_jax_and_pairs(setup, use_excl):
    water, excl = setup
    n = len(water.positions)
    exclusions = excl if use_excl else np.zeros((n, 0), np.int32)
    pme, jp = both(exclusions)
    plan = pme.plan_direct_window(water.box, CUTOFF, water.positions)
    assert plan == jp.plan_direct_window(water.box, CUTOFF, water.positions)
    pos, q, box = t(water.positions), t(water.charges), t(water.box)
    e_win = float(pme.compute_direct_window(pos, q, CUTOFF, box, plan))
    e_pair = float(pme.compute_direct(pos, q, CUTOFF, box))
    e_jax = float(jp.compute_direct_window(j(water.positions),
                                           j(water.charges), CUTOFF,
                                           j(water.box), plan))
    np.testing.assert_allclose(e_win, e_jax, rtol=2e-5)
    np.testing.assert_allclose(e_win, e_pair, rtol=2e-5)


def test_gradients_match_jax(setup):
    water, excl = setup
    pme, jp = both(excl)
    plan = pme.plan_direct_window(water.box, CUTOFF, water.positions)
    p = t(water.positions).requires_grad_(True)
    q = t(water.charges).requires_grad_(True)
    gp, gq = torch.autograd.grad(
        pme.compute_direct_window(p, q, CUTOFF, t(water.box), plan), (p, q))
    jgp, jgq = jax.grad(
        lambda a, b: jp.compute_direct_window(a, b, CUTOFF, j(water.box),
                                              plan),
        argnums=(0, 1))(j(water.positions), j(water.charges))
    for got, want in ((gp, jgp), (gq, jgq)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_plain_kernel_matches_pallas(setup):
    """The kernel's plain version against the Pallas kernel (interpret
    mode) on the same inputs, built by the port: row energies, and the
    cotangents of the four planes and the centers."""
    water, excl = setup
    pme, _ = both(excl)
    ncells3, c = pme.plan_direct_window(water.box, CUTOFF, water.positions)
    ins = cuda_pme.pme_window_inputs(
        t(water.positions), t(water.charges), t(water.box), pme.exclusions,
        ncells3, c)
    cx, cy, cz, cq, ctr, ex = (x.detach() for x in ins)
    fn = jwin.make_pme_window_kernel(CUTOFF, ALPHA, KE, ncells3, c,
                                     ex.shape[2], interpret=True)
    jargs = [j(x.numpy()) for x in (cx, cy, cz, cq, ctr)]
    want, vjp = jax.vjp(lambda *a: fn(*a, j(ex.numpy())), *jargs)
    rng = np.random.RandomState(0)
    g = rng.randn(*want.shape).astype(np.float32)
    want_grads = vjp(j(g))
    tins = [x.clone().requires_grad_(True) for x in (cx, cy, cz, cq, ctr)]
    got = cuda_pme.pme_window_plain(*tins, ex, ncells3, CUTOFF, ALPHA, KE)
    want = np.asarray(want)[..., 0]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    got_grads = torch.autograd.grad(got, tins, t(g[..., 0]))
    for name, a, b in zip(('candx', 'candy', 'candz', 'candq', 'centers'),
                          got_grads, want_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_wrapped_positions(setup):
    """Atoms outside the primary box wrap consistently; the plan's margin
    holds both configurations (the occupancy says so)."""
    water, _ = setup
    n = len(water.positions)
    pme, _ = both(np.zeros((n, 0), np.int32))
    plan = pme.plan_direct_window(water.box, CUTOFF, water.positions,
                                  margin=2.0)
    box, q = t(water.box), t(water.charges)
    pos = t(water.positions)
    pos2 = pos - 0.4 * torch.diagonal(box)[None, :]
    assert int(pme.direct_window_overflow(pos2, box, plan)) <= plan[1]
    e1 = float(pme.compute_direct_window(pos, q, CUTOFF, box, plan))
    e2 = float(pme.compute_direct_window(pos2, q, CUTOFF, box, plan))
    np.testing.assert_allclose(e2, e1, rtol=1e-5)


@pytest.mark.parametrize('shift', [0.0, 0.4])
def test_occupancy_equals_jax(setup, shift):
    """The occupancy count equals JAX's, below capacity and (translated
    into denser cells) above it."""
    water, _ = setup
    n = len(water.positions)
    pme, jp = both(np.zeros((n, 0), np.int32))
    plan = pme.plan_direct_window(water.box, CUTOFF, water.positions)
    pos = water.positions - shift * np.diag(water.box)[None, :]
    got = pme.direct_window_overflow(t(pos), t(water.box), plan)
    want = jp.direct_window_overflow(j(pos), j(water.box), plan)
    assert got.dtype == torch.int32 and int(got) == int(want)
    assert (int(got) > plan[1]) == (shift > 0)


@pytest.mark.parametrize('small, nbig', [(8, 1), (None, 13), (None, 26)])
def test_bucketed_count_overflow_equals_jax(setup, small, nbig):
    """With a bucketed plan the one overflow count equals JAX's
    ``direct_window_overflow`` exactly, and exceeds the capacity exactly
    when the occupancy JAX's bucketed ``pme_direct_window`` returns does
    (there the sentinel ``2^30 - 1``)."""
    water, _ = setup
    n = len(water.positions)
    pme, jp = both(np.zeros((n, 0), np.int32), grid=12, order=4, alpha=1.1)
    plan = pme.plan_direct_window(water.box, CUTOFF, water.positions)
    bplan = (plan[0], plan[1], small or max(8, plan[1] - 8), nbig)
    pos, box = water.positions, water.box
    got = pme.direct_window_overflow(t(pos), t(box), bplan)
    want = jp.direct_window_overflow(j(pos), j(box), bplan)
    assert got.dtype == torch.int32 and int(got) == int(want)
    want_c = jwin.pme_window_count_overflow(j(pos), j(box), bplan)
    assert (int(got) > plan[1]) == (int(want_c) > plan[1])
    _, jocc = jwin.pme_direct_window(
        j(pos), j(water.charges), j(box), jp.exclusions, CUTOFF, 1.1, KE,
        *bplan[:2], small_cap=bplan[2], num_big=bplan[3])
    assert (int(got) > plan[1]) == (int(jocc) > plan[1])
    if int(jocc) <= plan[1]:
        assert int(got) == int(jocc)
    if small == 8 and nbig == 1:
        assert int(got) > plan[1] and int(jocc) == 2 ** 30 - 1


@pytest.mark.parametrize('use_excl', [False, True])
def test_bucketed_matches_unbucketed(setup, use_excl):
    """A forced bucketed 4-tuple plan gives the unbucketed energy and
    position gradients (the port runs one launch either way) and JAX's
    bucketed energy."""
    water, excl = setup
    n = len(water.positions)
    pme, jp = both(excl if use_excl else np.zeros((n, 0), np.int32),
                   grid=12, order=4, alpha=1.1)
    plan = pme.plan_direct_window(water.box, CUTOFF, water.positions)
    bplan = (plan[0], plan[1], max(8, plan[1] - 8), 13)
    box, q = t(water.box), t(water.charges)
    assert int(pme.direct_window_overflow(t(water.positions), box, bplan)) \
        <= plan[1]

    def value_and_grad(p_plan):
        p = t(water.positions).requires_grad_(True)
        e = pme.compute_direct_window(p, q, CUTOFF, box, p_plan)
        (g,) = torch.autograd.grad(e, p)
        return float(e.detach()), g.numpy()

    e_ref, g_ref = value_and_grad(plan)
    e_b, g_b = value_and_grad(bplan)
    np.testing.assert_allclose(e_b, e_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_b, g_ref, rtol=1e-4, atol=1e-5)
    e_jax = float(jp.compute_direct_window(j(water.positions),
                                           j(water.charges), CUTOFF,
                                           j(water.box), bplan))
    np.testing.assert_allclose(e_b, e_jax, rtol=2e-5)


def test_wrapper_dispatch():
    """A CPU tensor takes the plain version; another device raises."""
    x = torch.zeros(27, 27 * 8)
    ctr = torch.full((27, 8, 4), cuda_pme.FAR)
    ex = torch.full((27, 8, 1), -1, dtype=torch.int32)
    out = cuda_pme.pme_window(x, x, x, x, ctr, ex, (3, 3, 3), 1.0, 0.3, 1.0)
    assert tuple(out.shape) == (27, 8) and not out.any()
    with pytest.raises(ValueError, match='no PME window kernel'):
        cuda_pme.pme_window(x.to('meta'), x, x, x, ctr, ex, (3, 3, 3), 1.0,
                            0.3, 1.0)
