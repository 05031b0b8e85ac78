"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX: the machine with the GPU has none. Inputs come from numpy
seeds through the port's own selection and payload. Every test needs a
CUDA device and skips without one. On the card, from the repository root
(``--noconftest``: ``tests/conftest.py`` configures JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from nnpops_tpu_torch import ANI2X_LAYER_DIMS, ANIBasis, _kernels
from nnpops_tpu_torch.models.ani import (ANIModel, init_ani_params,
                                         plain_energy_and_forces)
from nnpops_tpu_torch.neighbors.blocked import (payload_from_blocked,
                                                plan_blocked_layout,
                                                select_blocked)
from nnpops_tpu_torch.neighbors.cell_list import CellList
from nnpops_tpu_torch.ops import batched_nn, cuda_aev, cuda_nn
from nnpops_tpu_torch.utils import make_water_box

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (the CUDA kernels have no CPU mode)')
    return torch.device('cuda', torch.cuda.current_device())


def small_basis(torchani):
    return ANIBasis.from_grids(
        num_species=3, Rcr=4.2, Rca=3.1,
        EtaR=[16.0], ShfR=[0.9, 1.7, 2.5, 3.3],
        EtaA=[8.0], Zeta=[14.1], ShfA=[0.9, 1.6, 2.3], ShfZ=[0.2, 1.2, 2.2],
        torchani=torchani)


def angular_inputs(basis, rad_mode, dev, n=200, seed=4, box_width=14.0):
    rng = np.random.RandomState(seed)
    positions = rng.rand(n, 3).astype(np.float32) * box_width
    species = rng.randint(0, 3, n).astype(np.int32)
    box = np.eye(3, dtype=np.float32) * box_width
    layout = plan_blocked_layout(positions, box, species, basis.radial_cutoff,
                                 basis.angular_cutoff, basis.num_species)
    cl = CellList.create(box, basis.radial_cutoff, capacity=layout.rad_total)
    pos, tbox = torch.tensor(positions, device=dev), torch.tensor(box, device=dev)
    sel = select_blocked(cl, pos, tbox, species, layout, basis.radial_cutoff,
                         basis.angular_cutoff)
    pay = payload_from_blocked(cl, pos, tbox, sel, rad_only=rad_mode,
                               layout=layout)
    deltas = pay.rad_deltas if rad_mode else pay.ang_deltas
    return (deltas.contiguous(), pay.ang_mask.contiguous(), layout,
            layout.rad_total if rad_mode else None)


@pytest.mark.parametrize('torchani, rad_mode',
                         [(True, False), (False, False), (True, True),
                          (False, True)],
                         ids=['torchani', 'publication', 'torchani-rad',
                              'publication-rad'])
def test_angular_kernel_matches_plain(dev, torchani, rad_mode):
    basis = small_basis(torchani)
    deltas, mask, layout, rad_width = angular_inputs(basis, rad_mode, dev)
    d_k = deltas.clone().requires_grad_(True)
    d_p = deltas.clone().requires_grad_(True)
    before = _kernels.LAUNCHES['angular_aev_fwd']
    a_k = cuda_aev.angular_aev(d_k, mask, basis, layout, rad_width)
    assert _kernels.LAUNCHES['angular_aev_fwd'] == before + 1
    a_p = cuda_aev.place_angular(
        cuda_aev.angular_aev_plain(d_p, mask, basis, layout, rad_width),
        basis, layout)
    torch.testing.assert_close(a_k, a_p, rtol=3e-5, atol=3e-6)
    (g_k,) = torch.autograd.grad(a_k.square().sum(), d_k)
    (g_p,) = torch.autograd.grad(a_p.square().sum(), d_p)
    torch.testing.assert_close(g_k, g_p, rtol=2e-4, atol=2e-5)


def test_angular_wrapper_rejects_bad_input(dev):
    basis = small_basis(True)
    deltas, mask, layout, _ = angular_inputs(basis, False, dev)
    with pytest.raises(ValueError):
        cuda_aev.angular_aev(deltas.double(), mask, basis, layout)
    with pytest.raises(ValueError):
        cuda_aev.angular_aev(deltas, mask.float(), basis, layout)


def random_net(dims, num_models, in_dim, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    ens = batched_nn.init_ensemble(gen, in_dim, [dims], num_models)
    net = ens.networks[0]
    biases = tuple(0.1 * torch.randn(b.shape, generator=gen) for b in net.biases)
    return batched_nn.SpeciesNet(tuple(w.to(dev) for w in net.weights),
                                 tuple(b.to(dev) for b in biases))


@pytest.mark.parametrize('dims, num_models, in_dim',
                         [((32, 24, 16), 2, 64), (ANI2X_LAYER_DIMS[0], 8, 1008)],
                         ids=['narrow', 'ani2x-H'])
def test_fused_nn_kernel_matches_plain(dev, dims, num_models, in_dim):
    net = random_net(dims, num_models, in_dim, dev, seed=9)
    gen = torch.Generator().manual_seed(10)
    x = (0.3 * torch.randn(203, in_dim, generator=gen)).to(dev)
    e_k = cuda_nn.fused_species_net_fwd(x, net)
    e_kg, dx_k = cuda_nn.fused_species_net_fwdgrad(x, net)
    e_p, dx_p = cuda_nn.fused_species_net_plain(x, net, with_grad=True)
    # Normwise gates: a bf16 operand can round the other way when the f32
    # accumulation order differs, which moves a near-zero energy by more
    # than 1e-3 of itself but not of the block's scale.
    for e in (e_k, e_kg):
        assert float((e - e_p).abs().max()) <= 1e-3 * float(e_p.abs().max())
    assert float((dx_k - dx_p).abs().max()) <= 1e-2 * float(dx_p.abs().max())


def test_force_step_kernels_match_plain(dev):
    """The whole slice on water(150): kernels against plain versions."""
    water = make_water_box(150, seed=0)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(water.positions, water.box,
                                             impl='pallas', skin=0.25)
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0), basis,
                             device=dev)
    cl = model.create_cell_list(water.box, skin=0.25)
    pos = torch.tensor(water.positions, device=dev)
    box = torch.tensor(water.box, device=dev)
    sel = model.select(pos, box, cl)
    _kernels.reset_launch_counts()
    e_k, f_k = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    assert _kernels.LAUNCHES['angular_aev_fwd'] == 1
    assert _kernels.LAUNCHES['angular_aev_bwd'] == 1
    assert _kernels.LAUNCHES['fused_nn_fwdgrad'] == 2          # H and O
    e_p, f_p = plain_energy_and_forces(model, params, pos, box, cl, sel)
    assert _kernels.LAUNCHES['fused_nn_fwdgrad'] == 2
    np.testing.assert_allclose(float(e_k), float(e_p), rtol=1e-3)
    assert float((f_k - f_p).abs().max()) <= 5e-3 * float(f_p.abs().max())
