"""The port's angular AEV (plain PyTorch version on the CPU) against the JAX
Pallas kernel in interpret mode. The CUDA kernel against the plain version
is in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis
from nnpops_tpu.neighbors.blocked import (build_blocked_payload,
                                          payload_from_blocked,
                                          plan_blocked_layout, select_blocked)
from nnpops_tpu.neighbors.cell_list import CellList
from nnpops_tpu.ops.pallas_aev import angular_aev_pallas
from nnpops_tpu_torch.neighbors.blocked import BlockedLayout
from nnpops_tpu_torch.ops import cuda_aev


def small_basis(torchani=True):
    return ANIBasis.from_grids(
        num_species=3, Rcr=4.2, Rca=3.1,
        EtaR=[16.0], ShfR=[0.9, 1.7, 2.5, 3.3],
        EtaA=[8.0], Zeta=[14.1], ShfA=[0.9, 1.6, 2.3], ShfZ=[0.2, 1.2, 2.2],
        torchani=torchani)


def port_layout(layout):
    return BlockedLayout(layout.num_species, layout.present, layout.rad_caps,
                         layout.ang_caps)


def make_inputs(basis, rad_mode, n=40, seed=0, box_width=9.0):
    """Deltas planes and angular mask from the JAX blocked payload (angular
    planes, or radial planes in rad mode)."""
    rng = np.random.RandomState(seed)
    positions = rng.rand(n, 3).astype(np.float32) * box_width
    species = rng.randint(0, 3, n).astype(np.int32)
    box = np.eye(3, dtype=np.float32) * box_width
    layout = plan_blocked_layout(positions, box, species, basis.radial_cutoff,
                                 basis.angular_cutoff, basis.num_species)
    cl = CellList.create(box, basis.radial_cutoff, capacity=layout.rad_total)
    if rad_mode:
        sel = select_blocked(cl, jnp.asarray(positions), jnp.asarray(box),
                             species, layout, basis.radial_cutoff,
                             basis.angular_cutoff)
        pay = payload_from_blocked(cl, jnp.asarray(positions), jnp.asarray(box),
                                   sel, rad_only=True)
        deltas = pay.rad_deltas
    else:
        pay = build_blocked_payload(cl, jnp.asarray(positions),
                                    jnp.asarray(box), species, layout,
                                    basis.radial_cutoff, basis.angular_cutoff)
        deltas = pay.ang_deltas
    return (np.asarray(deltas), np.asarray(pay.ang_mask), layout,
            layout.rad_total if rad_mode else None)


CASES = [(True, False), (False, False), (True, True), (False, True)]
IDS = ['torchani', 'publication', 'torchani-rad', 'publication-rad']


@pytest.mark.parametrize('torchani, rad_mode', CASES, ids=IDS)
def test_plain_matches_pallas_values_and_gradients(torchani, rad_mode):
    basis = small_basis(torchani)
    deltas, mask, layout, rad_width = make_inputs(basis, rad_mode,
                                                  seed=1 + rad_mode)
    kw = dict(basis=basis, layout=layout, block_size=16, rad_width=rad_width)

    def jloss(d):
        a = angular_aev_pallas(d, jnp.asarray(mask), **kw)
        return jnp.sum(a * a), a

    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(deltas))
    d = torch.tensor(deltas, requires_grad=True)
    got = cuda_aev.angular_aev(d, torch.tensor(mask), basis,
                               port_layout(layout), rad_width=rad_width)
    (ggot,) = torch.autograd.grad(torch.sum(got * got), d)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(ggot.numpy(), np.asarray(gwant),
                               rtol=2e-4, atol=2e-5)
    if rad_width is not None:
        # Cotangents land on the angular lanes of the radial planes only.
        lanes = cuda_aev._lane_positions(port_layout(layout), rad_width)
        rest = np.setdiff1d(np.arange(rad_width), lanes)
        assert np.all(ggot.numpy()[:, :, rest] == 0.0)


def water_positions(seed=0, molecules=20, spacing=3.5, n_side=3):
    """TIP3P-geometry waters with random orientations on a jittered cubic
    lattice: ``molecules`` waters (O, H, H) in a periodic box of edge
    ``n_side * spacing`` (10.5 A, above twice ANI-2x's radial cutoff)."""
    rng = np.random.RandomState(seed)
    angle = np.deg2rad(104.52) / 2
    template = 0.9572 * np.array([[0.0, 0.0, 0.0],
                                  [np.sin(angle), np.cos(angle), 0.0],
                                  [-np.sin(angle), np.cos(angle), 0.0]])
    sites = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing='ij'),
                     -1).reshape(-1, 3)[:molecules]
    box_len = n_side * spacing
    pos = []
    for site in sites:
        q, r = np.linalg.qr(rng.randn(3, 3))
        center = (site + 0.5 + rng.uniform(-0.15, 0.15, 3)) * spacing
        pos.append(center + template @ (q * np.sign(np.diag(r))).T)
    positions = (np.concatenate(pos) % box_len).astype(np.float32)
    species = np.tile(np.array([3, 0, 0], np.int32), molecules)  # O H H
    return positions, species, np.eye(3, dtype=np.float32) * box_len


def test_plain_matches_pallas_at_ani2x_grid():
    """The main path's grid: ANI-2x's angular terms (8 x 4, zeta 14.1,
    torchani mode) on a 60-atom periodic water box, the plain version
    against the JAX kernel in interpret mode, values and gradients."""
    basis = ANIBasis.ani2x()
    positions, species, box = water_positions()
    layout = plan_blocked_layout(positions, box, species, basis.radial_cutoff,
                                 basis.angular_cutoff, basis.num_species)
    cl = CellList.create(box, basis.radial_cutoff, capacity=layout.rad_total)
    pay = build_blocked_payload(cl, jnp.asarray(positions), jnp.asarray(box),
                                species, layout, basis.radial_cutoff,
                                basis.angular_cutoff)
    deltas, mask = np.asarray(pay.ang_deltas), np.asarray(pay.ang_mask)
    assert layout.present == (0, 3) and mask.sum() > 0

    def jloss(d):
        a = angular_aev_pallas(d, jnp.asarray(mask), basis=basis,
                               layout=layout, block_size=64)
        return jnp.sum(a * a), a

    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(deltas))
    d = torch.tensor(deltas, requires_grad=True)
    got = cuda_aev.angular_aev(d, torch.tensor(mask), basis,
                               port_layout(layout))
    (ggot,) = torch.autograd.grad(torch.sum(got * got), d)
    assert got.shape == want.shape == (60, basis.num_species_pairs * 32)
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(ggot.numpy(), np.asarray(gwant),
                               rtol=2e-4, atol=2e-5)


def test_fc_poly_matches_cosine_cutoff():
    r = torch.linspace(0.0, 3.5, 1001, dtype=torch.float64)
    t = torch.clamp((r / 3.5) ** 2, max=1.0)
    want = 0.5 * torch.cos(np.pi * r / 3.5) + 0.5
    np.testing.assert_allclose(cuda_aev.fc_poly_t(t).numpy(), want.numpy(),
                               atol=1e-11)
    dwant = -0.5 * np.pi / 3.5 * torch.sin(np.pi * r / 3.5)
    dgot = cuda_aev.dfc_poly_t(t) * 2.0 * r / 3.5 ** 2
    np.testing.assert_allclose(dgot.numpy(), dwant.numpy(), atol=1e-9)


@pytest.mark.parametrize('zeta', [14.1, 1.0, 0.5, 3.0])
def test_pow_split_matches_pow(zeta):
    base = torch.linspace(1e-3, 2.05, 257, dtype=torch.float64)
    np.testing.assert_allclose(cuda_aev.pow_split(base, zeta).numpy(),
                               (base ** zeta).numpy(), rtol=1e-12)


def test_segments_dispatch_to_plain_on_cpu():
    basis = small_basis()
    deltas, mask, layout, _ = make_inputs(basis, False, seed=3)
    lay = port_layout(layout)
    d, m = torch.tensor(deltas), torch.tensor(mask)
    np.testing.assert_array_equal(
        cuda_aev.angular_aev_segments(d, m, basis, lay).numpy(),
        cuda_aev.angular_aev_plain(d, m, basis, lay).numpy())


@pytest.mark.parametrize('rad_mode', [False, True], ids=['angular', 'rad'])
def test_kernel_spec_block_columns_match_lane_positions(rad_mode):
    """The CUDA kernel reads species block b's lanes from input columns
    blk_pos[b] + 0..blk_caps[b]-1 (it takes no lane table): the plain
    version's lane positions, and col_lane inverts them."""
    basis = small_basis()
    _, _, layout, rad_width = make_inputs(basis, rad_mode, seed=3)
    lay = port_layout(layout)
    spec = cuda_aev._AngularSpec(basis, lay, rad_width, torch.device('cpu'))
    lanes = cuda_aev._lane_positions(lay, rad_width)
    cols = np.concatenate([np.arange(spec.blk_pos[b],
                                     spec.blk_pos[b] + spec.blk_caps[b])
                           for b in range(spec.n_blk)])
    np.testing.assert_array_equal(cols, lanes)
    col_lane = spec.col_lane.numpy()
    np.testing.assert_array_equal(col_lane[lanes], np.arange(len(lanes)))
    assert (np.delete(col_lane, lanes) == -1).all()
    assert spec.n_seg == len(cuda_aev.triple_tables(lay).pair_ids)


def test_requires_factored_grid():
    basis = ANIBasis(num_species=2, radial_cutoff=4.0, angular_cutoff=3.0,
                     radial_eta=(16.0,), radial_rs=(1.0,),
                     angular_eta=(8.0, 4.0), angular_rs=(1.0, 2.0),
                     angular_zeta=(14.1, 8.0), angular_thetas=(0.5, 1.5))
    lay = BlockedLayout(num_species=2, present=(0, 1), rad_caps=(4, 4),
                        ang_caps=(3, 3))
    with pytest.raises(NotImplementedError):
        cuda_aev.angular_aev_plain(torch.zeros(3, 2, 6),
                                   torch.zeros(2, 6, dtype=torch.bool), basis, lay)
