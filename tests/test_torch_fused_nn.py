"""The port's ensemble code against nnpops_tpu.ops: the fused net's plain
version against the JAX fused Pallas kernel (interpret mode), the grouped
XLA-path reference in f32 and bf16. The CUDA kernel against the plain
version is in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANI2X_LAYER_DIMS
from nnpops_tpu.ops import batched_nn as jnn
from nnpops_tpu.ops.pallas_nn import species_energies_fused as j_fused
from nnpops_tpu_torch.ops import batched_nn as tnn
from nnpops_tpu_torch.ops import cuda_nn


def jax_net(dims, num_models, in_dim, seed):
    ens = jnn.init_ensemble(jax.random.PRNGKey(seed), in_dim, [dims], num_models)
    net = ens.networks[0]
    # Non-zero biases so the bias paths are exercised.
    rng = np.random.RandomState(seed)
    biases = tuple(jnp.asarray(rng.randn(*b.shape).astype(np.float32) * 0.1)
                   for b in net.biases)
    return net._replace(biases=biases)


def port_net(net, requires_grad=False):
    def t(a):
        return torch.tensor(np.asarray(a), requires_grad=requires_grad)
    return tnn.SpeciesNet(tuple(t(w) for w in net.weights),
                          tuple(t(b) for b in net.biases))


NARROW = ((32, 24, 16), 2, 64)


def test_fused_plain_matches_jax_fused_kernel():
    dims, models, in_dim = NARROW
    jn = jax_net(dims, models, in_dim, seed=0)
    x = (np.random.RandomState(1).randn(37, in_dim) * 0.5).astype(np.float32)

    def jloss(xx):
        e = j_fused(jn, xx, interpret=True)
        return jnp.sum(e), e

    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    net = port_net(jn, requires_grad=True)
    got = cuda_nn.species_energies_fused(net, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    grads = torch.autograd.grad(got.sum(), [xt, *net.weights, *net.biases],
                                allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gwant), rtol=1e-4,
                               atol=1e-7)
    # Inference scope: no weight or bias gradients.
    assert all(g is None for g in grads[1:])
    # Without autograd the energy-only path gives the same energies.
    with torch.no_grad():
        np.testing.assert_array_equal(
            cuda_nn.species_energies_fused(net, xt).numpy(), got.detach().numpy())


def test_fused_plain_gradient_is_fwdgrad():
    """The plain fwdgrad's dx equals autograd through the plain forward."""
    dims, models, in_dim = NARROW
    net = port_net(jax_net(dims, models, in_dim, seed=2))
    x = torch.tensor(np.random.RandomState(3).randn(9, in_dim).astype(np.float32))
    e, dx = cuda_nn.fused_species_net_plain(x, net, with_grad=True)
    e0, none = cuda_nn.fused_species_net_plain(x, net)
    assert none is None
    np.testing.assert_array_equal(e.numpy(), e0.numpy())
    assert e.shape == (9, 1) and dx.shape == (9, in_dim)


@pytest.mark.parametrize('bf16', [False, True])
def test_grouped_rows_reference_matches_jax(bf16):
    """ensemble_energy_grouped_rows and its input gradient, f32 and bf16."""
    dims, models, in_dim = NARROW
    ens = jnn.init_ensemble(jax.random.PRNGKey(4), in_dim, [dims, dims[::-1]],
                            models)
    counts = (11, 6)
    x = (np.random.RandomState(5).randn(sum(counts), in_dim) * 0.5).astype(np.float32)
    cdt = jnp.bfloat16 if bf16 else None
    e_j, g_j = jax.value_and_grad(
        lambda xx: jnn.ensemble_energy_grouped_rows(ens, xx, counts, cdt))(
            jnp.asarray(x))
    params = tnn.EnsembleParams(tuple(port_net(n) for n in ens.networks))
    xt = torch.tensor(x, requires_grad=True)
    e_t = tnn.ensemble_energy_grouped_rows(
        params, xt, counts, torch.bfloat16 if bf16 else None)
    (g_t,) = torch.autograd.grad(e_t, xt)
    tol = dict(rtol=2e-2, atol=5e-3) if bf16 else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(e_t.detach()), float(e_j), **tol)
    scale = float(np.abs(np.asarray(g_j)).max())
    err = float(np.abs(g_t.numpy() - np.asarray(g_j)).max())
    assert err <= (3e-2 if bf16 else 1e-5) * scale


def test_fused_total_matches_jax_grouped_fused():
    from nnpops_tpu.ops.pallas_nn import ensemble_energy_grouped_rows_fused
    dims, models, in_dim = NARROW
    ens = jnn.init_ensemble(jax.random.PRNGKey(6), in_dim, [dims, dims], models)
    counts = (10, 0, 7)
    ens = ens._replace(networks=ens.networks + ens.networks[:1])
    x = (np.random.RandomState(7).randn(17, in_dim) * 0.5).astype(np.float32)
    want = ensemble_energy_grouped_rows_fused(ens, jnp.asarray(x), counts,
                                              interpret=True)
    params = tnn.EnsembleParams(tuple(port_net(n) for n in ens.networks))
    got = cuda_nn.ensemble_energy_grouped_rows_fused(params, torch.tensor(x),
                                                     counts)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_init_ensemble_fan_in_scaling():
    gen = torch.Generator().manual_seed(0)
    ens = tnn.init_ensemble(gen, 1008, ANI2X_LAYER_DIMS[:1], num_models=8,
                             device='cpu')
    w = ens.networks[0].weights
    assert [tuple(t.shape) for t in w] == [(8, 256, 1008), (8, 192, 256),
                                           (8, 160, 192), (8, 1, 160)]
    for t in w[:3]:
        np.testing.assert_allclose(float(t.std()) * np.sqrt(t.shape[2]), 1.0,
                                   rtol=0.05)
    assert all(float(b.abs().max()) == 0.0 for b in ens.networks[0].biases)
    again = tnn.init_ensemble(torch.Generator().manual_seed(0), 1008,
                              ANI2X_LAYER_DIMS[:1], num_models=8,
                              device='cpu')
    assert torch.equal(again.networks[0].weights[0], w[0])


def test_pack_pads_to_multiples_of_16():
    dims, models, in_dim = NARROW
    net = port_net(jax_net(dims, models, in_dim, 8))
    packed = cuda_nn.pack_species_net(net)
    # Packed once per net: the same tensors give the same buffers.
    assert cuda_nn.pack_species_net(tnn.SpeciesNet(*net)) is packed
    assert packed.dims == (64, 32, 32, 16, 1)
    assert packed.in_actual == 64 and packed.num_models == 2
    n_w = sum(2 * models * a * b for a, b in zip(packed.dims[:3], packed.dims[1:4]))
    assert packed.wbuf.numel() == n_w and packed.wbuf.dtype == torch.bfloat16
    assert packed.fbuf.numel() == models * (32 + 32 + 16 + 16 + 1)


def test_pack_follows_inplace_weight_updates():
    """An in-place update of any weight or bias packs the net anew."""
    dims, models, in_dim = NARROW
    net = port_net(jax_net(dims, models, in_dim, 8))
    x = torch.tensor(np.random.RandomState(9).randn(5, in_dim).astype(np.float32))
    packed = cuda_nn.pack_species_net(net)
    with torch.no_grad():
        net.biases[1].add_(0.5)
    repacked = cuda_nn.pack_species_net(net)
    assert repacked is not packed
    assert not torch.equal(repacked.fbuf, packed.fbuf)
    assert torch.equal(repacked.wbuf, packed.wbuf)
    assert cuda_nn.pack_species_net(net) is repacked
    # The plain reference sees the same update.
    e0 = cuda_nn.fused_species_net_plain(x, net)[0]
    with torch.no_grad():
        net.biases[-1].add_(1.0)
    e1 = cuda_nn.fused_species_net_plain(x, net)[0]
    torch.testing.assert_close(e1, e0 + 1.0)
