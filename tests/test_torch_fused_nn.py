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
    params = tnn.EnsembleParams((net,))
    got = cuda_nn.ensemble_energies(params, xt, (len(x),))
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
            cuda_nn.ensemble_energies(params, xt, (len(x),)).numpy(),
            got.detach().numpy())


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
    pe = cuda_nn.pack_ensemble(tnn.EnsembleParams((net,)))
    # Packed once per ensemble: the same tensors give the same buffers.
    assert cuda_nn.pack_ensemble(
        tnn.EnsembleParams((tnn.SpeciesNet(*net),))) is pe
    packed = pe.nets[0]
    # Hidden widths pad to 32 (the hidden stage's wgmma chunk), the input
    # to 8.
    assert packed.dims == (64, 32, 32, 32, 1)
    assert packed.in_actual == 64 and packed.num_models == 2
    # The first layer is its own [M d1, in] matrix (the models stacked); the
    # hidden layers follow in wbuf, each with its transpose.
    assert tuple(packed.w1.shape) == (models * 32, 64)
    assert packed.w1.dtype == torch.bfloat16
    n_w = sum(2 * models * a * b
              for a, b in zip(packed.dims[1:3], packed.dims[2:4]))
    assert packed.wbuf.numel() == n_w and packed.wbuf.dtype == torch.bfloat16
    # The vectors, then zeros to a multiple of 4 floats (16-byte loads).
    assert packed.fbuf.numel() == 4 * -(-models * (32 + 32 + 32 + 32 + 1) // 4)
    w2 = packed.hidden()[0]
    assert torch.equal(w2[:, :24, :32], net.weights[1].to(torch.bfloat16))


def test_pack_follows_inplace_weight_updates():
    """An in-place update of any weight or bias packs the ensemble anew."""
    dims, models, in_dim = NARROW
    net = port_net(jax_net(dims, models, in_dim, 8))
    params = tnn.EnsembleParams((net,))
    x = torch.tensor(np.random.RandomState(9).randn(5, in_dim).astype(np.float32))
    packed = cuda_nn.pack_ensemble(params)
    with torch.no_grad():
        net.biases[1].add_(0.5)
    repacked = cuda_nn.pack_ensemble(params)
    assert repacked is not packed
    assert not torch.equal(repacked.fbuf, packed.fbuf)
    assert torch.equal(repacked.wbuf, packed.wbuf)
    assert cuda_nn.pack_ensemble(params) is repacked
    # The plain reference sees the same update.
    e0 = cuda_nn.fused_species_net_plain(x, net)[0]
    with torch.no_grad():
        net.biases[-1].add_(1.0)
    e1 = cuda_nn.fused_species_net_plain(x, net)[0]
    torch.testing.assert_close(e1, e0 + 1.0)


# Three narrow species of different widths, one with a single row and one
# with none: the staged plain versions (the CPU path of the fused stages).
SPECIES_DIMS = [(32, 24, 16), (48, 16, 32), (16, 32, 16)]
SPECIES_COUNTS = (13, 1, 0)


def three_species(seed):
    models, in_dim = NARROW[1:]
    ens = jnn.init_ensemble(jax.random.PRNGKey(seed), in_dim, SPECIES_DIMS,
                            models)
    rng = np.random.RandomState(seed)
    nets = tuple(n._replace(biases=tuple(
        jnp.asarray(rng.randn(*b.shape).astype(np.float32) * 0.1)
        for b in n.biases)) for n in ens.networks)
    ens = ens._replace(networks=nets)
    x = (rng.randn(sum(SPECIES_COUNTS), in_dim) * 0.5).astype(np.float32)
    params = tnn.EnsembleParams(tuple(port_net(n) for n in ens.networks))
    return ens, params, x


def test_staged_plain_matches_jax_fused_kernel_per_species():
    """Per-atom energies and the input gradient of the staged plain
    versions against the JAX fused Pallas kernel (interpret mode), species
    by species."""
    ens, params, x = three_species(20)
    offs = np.cumsum((0,) + SPECIES_COUNTS)

    def jloss(xx):
        es = [j_fused(ens.networks[s], xx[offs[s]:offs[s + 1]], interpret=True)
              for s in range(3) if SPECIES_COUNTS[s]]
        e = jnp.concatenate(es)
        return jnp.sum(e), e

    (_, want), gwant = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    pe = cuda_nn.pack_ensemble(params)
    e, dx = cuda_nn.ensemble_plain(torch.tensor(x), pe, SPECIES_COUNTS, True)
    np.testing.assert_allclose(e.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gwant), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize('path', ['staged', 'fused-call'])
def test_staged_total_matches_jax_grouped_fused(path):
    """The grouped total and its gradient against JAX's grouped fused
    total: through the staged plain versions (what one launch set for every
    species computes), and through the fused call on a CPU tensor (the
    per-species oracle)."""
    from nnpops_tpu.ops.pallas_nn import ensemble_energy_grouped_rows_fused
    ens, params, x = three_species(21)
    want, gwant = jax.value_and_grad(
        lambda xx: ensemble_energy_grouped_rows_fused(
            ens, xx, SPECIES_COUNTS, interpret=True))(jnp.asarray(x))
    if path == 'staged':
        e, g = cuda_nn.ensemble_plain(torch.tensor(x),
                                      cuda_nn.pack_ensemble(params),
                                      SPECIES_COUNTS, True)
        got = torch.sum(e)
    else:
        xt = torch.tensor(x, requires_grad=True)
        got = cuda_nn.ensemble_energy_grouped_rows_fused(params, xt,
                                                         SPECIES_COUNTS)
        (g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gwant), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize('with_grad', [False, True])
def test_staged_plain_composition_equals_oracle(with_grad):
    """layer1_plain, hidden_plain and dx_plain composed equal the
    per-species oracle fused_species_net_plain."""
    _, params, x = three_species(22)
    xt = torch.tensor(x)
    pe = cuda_nn.pack_ensemble(params)
    h1, d1 = cuda_nn.layer1_plain(cuda_nn.to_bf16_input(xt, pe), pe,
                                  SPECIES_COUNTS, with_grad)
    assert h1.shape == (len(x), pe.kmax) and h1.dtype == torch.bfloat16
    assert (d1 is not None) == with_grad
    e, g1 = cuda_nn.hidden_plain(h1, d1, pe, SPECIES_COUNTS, with_grad)
    for s, r0, r1, ksp in cuda_nn.species_rows(pe, SPECIES_COUNTS):
        e_o, dx_o = cuda_nn.fused_species_net_plain(xt[r0:r1],
                                                    params.networks[s],
                                                    with_grad)
        np.testing.assert_allclose(e[r0:r1].numpy(), e_o.numpy(), rtol=1e-5,
                                   atol=1e-7)
        if with_grad:
            dx = cuda_nn.dx_plain(g1, pe, SPECIES_COUNTS)
            np.testing.assert_allclose(dx[r0:r1].numpy(), dx_o.numpy(),
                                       rtol=1e-4, atol=1e-7)
            # Columns past the species' M d1 stay 0.
            assert not bool(g1[r0:r1, ksp:].float().any())


def test_species_table_and_workspace():
    """The species table the kernels read, and the scratch layout."""
    _, params, _ = three_species(23)
    pe = cuda_nn.pack_ensemble(params)
    assert cuda_nn.pack_ensemble(params) is pe
    models = NARROW[1]
    # First hidden widths padded so that M d1 is a multiple of 64.
    d1 = [p.dims[1] for p in pe.nets]
    assert d1 == [32, 64, 32] and all(models * d % 64 == 0 for d in d1)
    meta = pe.meta
    assert meta[:8] == (3, models, 4, 64, 64, 128, 256, 64)
    rows = [meta[8 + 16 * s: 8 + 16 * (s + 1)] for s in range(3)]
    assert [r[:5] for r in rows] == [p.dims for p in pe.nets]
    assert [r[9] for r in rows] == [0, 64, 192]                  # w1row
    assert [r[10] for r in rows] == [0, pe.nets[0].wbuf.numel(),
                                     pe.nets[0].wbuf.numel()
                                     + pe.nets[1].wbuf.numel()]
    assert tuple(pe.w1cat.shape) == (256, 64)
    assert torch.equal(pe.w1cat_t, pe.w1cat.t())
    ws = cuda_nn.workspace(pe, SPECIES_COUNTS, True)
    n = sum(SPECIES_COUNTS)
    assert ws.ncnt == 2 and ws.h1 == 0
    assert ws.d1 >= n * pe.kmax * 2 and ws.epart >= ws.g1 + n * pe.kmax * 2
    assert all(o % 256 == 0 for o in ws[1:6])
    fwd = cuda_nn.workspace(pe, SPECIES_COUNTS, False)
    assert fwd.nbytes < ws.nbytes and fwd.d1 == fwd.g1
    buf = torch.zeros(ws.nbytes, dtype=torch.uint8)
    views = cuda_nn.workspace_views(buf, ws, pe, n)
    assert [tuple(v.shape) for v in views] == [
        (n, pe.kmax), (n, pe.kmax), (n, pe.kmax), (models, n), (2,)]


def test_pack_ensemble_rejects_mixed_nets():
    dims, models, in_dim = NARROW
    a = port_net(jax_net(dims, models, in_dim, 24))
    b = port_net(jax_net(dims, models + 1, in_dim, 25))
    with pytest.raises(ValueError):
        cuda_nn.pack_ensemble(tnn.EnsembleParams((a, b)))
    shallow = port_net(jax_net((32,), models, in_dim, 26))
    with pytest.raises(ValueError):
        cuda_nn.pack_species_net(shallow)


@pytest.mark.parametrize('models', [1, 3])
def test_pack_aligns_species_vectors(models):
    """With an odd model count b_last's M entries would leave the next
    species' vectors at an odd float: every species' vectors start on a
    16-byte boundary, and the staged plain versions still equal the
    oracle."""
    in_dim = NARROW[2]
    ens = jnn.init_ensemble(jax.random.PRNGKey(30 + models), in_dim,
                            SPECIES_DIMS, models)
    params = tnn.EnsembleParams(tuple(port_net(n) for n in ens.networks))
    pe = cuda_nn.pack_ensemble(params)
    foff = [pe.meta[8 + 16 * s + 11] for s in range(3)]
    assert foff[0] == 0 and all(o % 4 == 0 for o in foff)
    assert all(p.fbuf.numel() % 4 == 0 for p in pe.nets)
    counts = (9, 4, 1)
    x = torch.tensor((np.random.RandomState(models).randn(sum(counts), in_dim)
                      * 0.5).astype(np.float32))
    e, dx = cuda_nn.ensemble_plain(x, pe, counts, True)
    e_o, dx_o = cuda_nn.ensemble_oracle(params, x, counts, True)
    np.testing.assert_allclose(e.numpy(), e_o.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), dx_o.numpy(), rtol=1e-4, atol=1e-7)
