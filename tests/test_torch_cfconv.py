"""The port's CFConv (``nnpops_tpu_torch.ops.cfconv`` and
``ops.cuda_cfconv``) against the JAX package's on the same numpy inputs:
the SchNetPack golden values, input and position derivatives, the payload
and masked paths with the hand-written backward (values and position,
input and weight gradients at the JAX suite's own gates), the bf16 option,
and the backward's plain version against the Pallas kernel in interpret
mode. Weights cross over with ``params.cfconv_params_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import CFConvConfig as JConfig
from nnpops_tpu.models.schnet import CFConvStack as JStack
from nnpops_tpu.neighbors.cell_list import CellList as JCellList
from nnpops_tpu.ops.cfconv import CFConvParams as JParams
from nnpops_tpu.ops.cfconv import build_cfconv_neighbors as j_build
from nnpops_tpu.ops.cfconv import cfconv as j_cfconv
from nnpops_tpu.ops.cfconv import cfconv_from_payload as j_from_payload
from nnpops_tpu.ops.cfconv import cfconv_masked as j_masked
from nnpops_tpu.ops.cfconv import init_cfconv as j_init
from nnpops_tpu.ops.pallas_cfconv import make_cfconv_bwd_kernel
from nnpops_tpu_torch import _kernels
from nnpops_tpu_torch.config import CFConvConfig
from nnpops_tpu_torch.models.schnet import CFConvStack
from nnpops_tpu_torch.neighbors.cell_list import CellList
from nnpops_tpu_torch.ops import cfconv as tcf
from nnpops_tpu_torch.ops import cuda_cfconv
from nnpops_tpu_torch.params import cfconv_params_from_jax
from nnpops_tpu_torch.utils import make_water_box
from nnpops_tpu_torch.utils.profiling import recording

GOLDEN = dict(width=8, num_gaussians=5, cutoff=2.0, gaussian_width=0.5)
PAYLOAD = dict(width=8, num_gaussians=5, cutoff=4.0, gaussian_width=0.5)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(activation='ssp', **kw):
    return (CFConvConfig(activation=activation, **kw),
            JConfig(activation=activation, **kw))


def t(a):
    return torch.tensor(np.asarray(a))


def golden_case(golden, case):
    jparams = JParams.from_reference_layout(
        golden['w1'], golden['b1'], golden['w2'], golden['b2'])
    tparams = tcf.CFConvParams.from_reference_layout(
        golden['w1'], golden['b1'], golden['w2'], golden['b2'], device='cpu')
    box = (golden[f'{case}_box'] if case in ('periodic', 'triclinic')
           else None)
    x = 0.1 * np.arange(18 * 8, dtype=np.float32).reshape(18, 8)
    tcfg, jcfg = configs('tanh' if case == 'tanh' else 'ssp', **GOLDEN)
    return tparams, jparams, golden['positions'], box, x, tcfg, jcfg


def assert_golden(got, expected, atol=1e-4, rtol=1e-3):
    got, expected = np.asarray(got).ravel(), np.asarray(expected).ravel()
    diff = np.abs(expected - got)
    bad = (diff > atol) & (diff / np.maximum(np.abs(expected), 1e-30) > rtol)
    assert not bad.any(), f'{bad.sum()} mismatches, max diff {diff.max()}'


def assert_grads_close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol)


CASES = ['nonperiodic', 'periodic', 'triclinic', 'tanh']


@pytest.mark.parametrize('case', CASES)
def test_golden_values(golden_cfconv, case):
    """SchNetPack's outputs (TestCFConv.h:81-248; atol 1e-4, rtol 1e-3)."""
    tparams, _, pos, box, x, tcfg, _ = golden_case(golden_cfconv, case)
    nb = tcf.build_cfconv_neighbors(t(pos), tcfg.cutoff,
                                    None if box is None else t(box))
    assert_golden(tcf.cfconv(tparams, nb, t(x), tcfg).numpy(),
                  golden_cfconv[f'{case}_output'])


@pytest.mark.parametrize('case', CASES)
def test_input_and_position_derivatives_equal_jax(golden_cfconv, case):
    """Gradients of a random linear function of the output with respect to
    the inputs and the positions (the pair list rebuilt from them), against
    jax.grad: rtol 1e-4, atol 1e-5 of the gradient's scale."""
    tparams, jparams, pos, box, x, tcfg, jcfg = golden_case(golden_cfconv,
                                                            case)
    w = np.random.RandomState(0).randn(18, 8).astype(np.float32)

    def jloss(p, inp):
        nb = j_build(p, jcfg.cutoff,
                     None if box is None else jnp.asarray(box))
        return jnp.sum(j_cfconv(jparams, nb, inp, jcfg) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(pos),
                                                    jnp.asarray(x))
    tp = t(pos).requires_grad_(True)
    tx = t(x).requires_grad_(True)
    nb = tcf.build_cfconv_neighbors(tp, tcfg.cutoff,
                                    None if box is None else t(box))
    got = torch.autograd.grad(torch.sum(tcf.cfconv(tparams, nb, tx, tcfg)
                                        * t(w)), (tp, tx))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


@pytest.fixture(scope='module')
def water():
    """water(300) at width 8, a 4 A cutoff, 64 neighbor lanes (the JAX
    suite's payload fixture)."""
    w = make_water_box(300, seed=4)
    n = len(w.positions)
    rng = np.random.RandomState(3)
    x = rng.randn(n, 8).astype(np.float32)
    cot = rng.randn(n, 8).astype(np.float32)
    return w, x, cot


def payload_params(golden):
    jp = JParams.from_reference_layout(
        golden['w1'], golden['b1'], golden['w2'], golden['b2'])
    return cfconv_params_from_jax(jax.tree.map(np.asarray, jp),
                                  device='cpu'), jp


@pytest.mark.parametrize('custom, chunk, activation',
                         [(True, None, 'ssp'), (True, 100, 'ssp'),
                          (False, 100, 'ssp'), (True, 100, 'tanh')])
def test_payload_conv_matches_jax(golden_cfconv, water, custom, chunk,
                                  activation):
    """``cfconv_from_payload`` over ``build_payload``: value, and position,
    weight and input gradients against the same JAX function (the JAX
    suite's adjoint gate, rtol/atol 2e-4)."""
    w, x, cot = water
    tparams, jparams = payload_params(golden_cfconv)
    tcfg, jcfg = configs(activation, **PAYLOAD)
    jcl = JCellList.create(w.box, jcfg.cutoff, capacity=64)
    tcl = CellList.create(w.box, tcfg.cutoff, capacity=64)
    jbox = jnp.asarray(w.box)

    def jloss(p, prm, inp):
        out = j_from_payload(prm, jcl.build_payload(p, jbox), inp, jcfg,
                             chunk_size=chunk, custom_adjoint=custom)
        return jnp.sum(out * cot)

    jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(w.positions), jparams, jnp.asarray(x))
    tp = t(w.positions).requires_grad_(True)
    tprm = tcf.CFConvParams(*(a.clone().requires_grad_(True)
                              for a in tparams))
    tx = t(x).requires_grad_(True)
    out = tcf.cfconv_from_payload(tprm, tcl.build_payload(tp, t(w.box)), tx,
                                  tcfg, chunk_size=chunk,
                                  custom_adjoint=custom)
    tv = torch.sum(out * t(cot))
    tg = torch.autograd.grad(tv, (tp, *tprm, tx))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert_grads_close(tg, jax.tree_util.tree_leaves(jg), 2e-4, 2e-4)


@pytest.mark.parametrize('chunk, activation',
                         [(None, 'ssp'), (128, 'ssp'), (None, 'tanh'),
                          (128, 'tanh')])
def test_apply_distances_matches_jax(water, chunk, activation):
    """The production chain, ``select(build_mirror=True)`` +
    ``payload_distances_from_selection`` + ``CFConvStack.apply_distances``
    (two layers, ``cfconv_masked`` each), against JAX's: value rtol 1e-5,
    position/weight/input gradients rtol/atol 3e-4 (the JAX suite's
    mirror-adjoint gates)."""
    w, x, cot = water
    tcfg, jcfg = configs(activation, **PAYLOAD)
    jstack = JStack(jcfg, num_layers=2)
    jparams = jstack.init(jax.random.PRNGKey(7))
    tparams = tuple(cfconv_params_from_jax(jax.tree.map(np.asarray, p),
                                           device='cpu') for p in jparams)
    jcl = JCellList.create(w.box, jcfg.cutoff, capacity=64)
    tcl = CellList.create(w.box, tcfg.cutoff, capacity=64)
    jbox = jnp.asarray(w.box)

    def jloss(p, prm, inp):
        sel = jcl.select(p, jbox, build_mirror=True)
        d, idx, m = jcl.payload_distances_from_selection(p, jbox, sel)
        return jnp.sum(jstack.apply_distances(prm, d, idx, m, inp,
                                              chunk_size=chunk) * cot)

    jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(w.positions), jparams, jnp.asarray(x))
    tp = t(w.positions).requires_grad_(True)
    tprm = tuple(tcf.CFConvParams(*(a.clone().requires_grad_(True)
                                    for a in p)) for p in tparams)
    tx = t(x).requires_grad_(True)
    tbox = t(w.box)
    sel = tcl.select(tp, tbox, build_mirror=True)
    assert int(sel.max_neighbors) <= 64       # both directions of every pair
    d, idx, m = tcl.payload_distances_from_selection(tp, tbox, sel)
    tv = torch.sum(CFConvStack(tcfg, 2).apply_distances(
        tprm, d, idx, m, tx, chunk_size=chunk) * t(cot))
    leaves = [tp] + [a for p in tprm for a in p] + [tx]
    tg = torch.autograd.grad(tv, leaves)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert_grads_close(tg, jax.tree_util.tree_leaves(jg), 3e-4, 3e-4)


def test_bf16_compute_dtype(golden_cfconv, water):
    """bf16 filter-product operands with f32 accumulation stay within 1e-2
    of the f32 output's scale, and agree with JAX's bf16 path."""
    w, x, _ = water
    tparams, jparams = payload_params(golden_cfconv)
    tcfg, jcfg = configs(**PAYLOAD)
    tcl = CellList.create(w.box, tcfg.cutoff, capacity=64)
    jcl = JCellList.create(w.box, jcfg.cutoff, capacity=64)
    tpl = tcl.build_payload(t(w.positions), t(w.box))
    f32 = tcf.cfconv_from_payload(tparams, tpl, t(x), tcfg)
    bf16 = tcf.cfconv_from_payload(tparams, tpl, t(x), tcfg,
                                   compute_dtype=torch.bfloat16)
    scale = float(f32.abs().max())
    assert float((bf16 - f32).abs().max()) / scale < 1e-2
    jb = jax.jit(lambda p, b, inp: j_from_payload(
        jparams, jcl.build_payload(p, b), inp, jcfg,
        compute_dtype=jnp.bfloat16))(jnp.asarray(w.positions),
                                     jnp.asarray(w.box), jnp.asarray(x))
    np.testing.assert_allclose(bf16.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-3 * scale)


def tiny_backward_inputs():
    """16 rows, 128 lanes, width 16, 8 Gaussians, about a third of the
    lanes valid, and one coincident pair (d = 0 under a True mask)."""
    rng = np.random.RandomState(11)
    n, k, width = 16, 128, 16
    tcfg, jcfg = configs(width=width, num_gaussians=8, cutoff=4.0,
                         gaussian_width=4.0 / 7)
    mask = rng.rand(n, k) < 0.3
    dist = np.where(mask, rng.uniform(0.5, 3.9, (n, k)), 0.0).astype(
        np.float32)
    idx = np.where(mask, rng.randint(0, n, (n, k)), n).astype(np.int32)
    mask[3, 5], dist[3, 5], idx[3, 5] = True, 0.0, 7      # coincident pair
    x = rng.randn(n, width).astype(np.float32)
    g = rng.randn(n, width).astype(np.float32)
    jparams = j_init(jax.random.PRNGKey(4), jcfg)
    jparams = jparams._replace(
        b1=jnp.asarray(0.1 * rng.randn(width).astype(np.float32)),
        b2=jnp.asarray(0.1 * rng.randn(width).astype(np.float32)))
    return tcfg, jcfg, jparams, dist, mask, idx, x, g


def test_bwd_plain_matches_pallas_kernel_interpret():
    """``cfconv_bwd_plain`` against the Pallas kernel in interpret mode and
    against JAX's default XLA backward, with one coincident pair: the port
    takes validity from the mask, as the XLA backward does (agreement at
    1e-5 of scale); the Pallas kernel takes it from d > 0, so it agrees
    with the port only once that lane is masked out, and differs on that
    row with it."""
    tcfg, jcfg, jparams, dist, mask, idx, x, g = tiny_backward_inputs()
    tparams = tuple(t(a) for a in jparams)
    got = cuda_cfconv.cfconv_bwd_plain(tparams, t(dist), t(mask), t(idx),
                                       t(x), t(g), tcfg)
    flat = lambda r: [*r[0], r[1], r[2]]      # noqa: E731
    # JAX's XLA backward: the VJP of cfconv_masked.
    _, vjp = jax.vjp(lambda prm, d, inp: j_masked(
        prm, d, jnp.asarray(mask), jnp.asarray(idx), inp, jcfg),
        jparams, jnp.asarray(dist), jnp.asarray(x))
    dprm, ddist, dx = vjp(jnp.asarray(g))
    for a, b in zip(flat(got), [*dprm, ddist, dx]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    # The Pallas kernel, fed the gathered rows the JAX package feeds it.
    kfn = make_cfconv_bwd_kernel(jcfg, 128, interpret=True)
    x_pad = np.concatenate([x, np.zeros((1, 16), np.float32)])
    g_pad = np.concatenate([g, np.zeros((1, 16), np.float32)])
    dd, dxp, dw1, db1, dw2, db2 = kfn(jnp.asarray(dist),
                                      jnp.asarray(x_pad[idx]),
                                      jnp.asarray(g_pad[idx]),
                                      jnp.asarray(g), jparams)
    pallas = [dw1, db1, dw2, db2, dd, dxp]
    live = mask & (dist > 0)
    ref = cuda_cfconv.cfconv_bwd_plain(
        tparams, t(dist), t(live), t(np.where(live, idx, 16)), t(x), t(g),
        tcfg)
    for a, b in zip(flat(ref), pallas):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    row = got[2][3].numpy()
    assert np.abs(row - np.asarray(dxp)[3]).max() > 1e-3 * np.abs(row).max()


def test_cpu_backward_launches_no_kernel():
    tcfg, _, jparams, dist, mask, idx, x, g = tiny_backward_inputs()
    before = dict(_kernels.LAUNCHES)
    w1, b1, w2, b2 = (t(a).requires_grad_(True) for a in jparams)
    xx = t(x).requires_grad_(True)
    out = tcf.cfconv_masked(tcf.CFConvParams(w1, b1, w2, b2), t(dist),
                            t(mask), t(idx), xx, tcfg)
    torch.autograd.grad(torch.sum(out * t(g)), (w1, xx))
    assert dict(_kernels.LAUNCHES) == before
    with pytest.raises(ValueError, match='width'):
        cuda_cfconv.check_kernel_config(tcfg)


def test_cpu_payload_conv_takes_plain_forward():
    """On CPU tensors ``PayloadConv`` runs ``conv_fwd_plain`` and
    ``cfconv_bwd_plain`` (bitwise their values and gradients, kernel or
    plain flag alike, no launch); the forward kernel's wrapper rejects the
    widths and Gaussian counts the kernels do not take."""
    tcfg, _, jparams, dist, mask, idx, x, g = tiny_backward_inputs()
    args = (t(dist), t(mask), t(idx))
    before = dict(_kernels.LAUNCHES)
    want = cuda_cfconv.conv_fwd_plain(tuple(t(a) for a in jparams), *args,
                                      t(x), tcfg, 4)
    (dw1, db1, dw2, db2), d_dist, d_x = cuda_cfconv.cfconv_bwd_plain(
        tuple(t(a) for a in jparams), *args, t(x), t(g), tcfg, 4)
    assert torch.equal(cuda_cfconv.cfconv_fwd(
        tuple(t(a) for a in jparams), *args, t(x), tcfg, 4), want)
    for plain in (False, True):
        prm = tuple(t(a).requires_grad_(True) for a in jparams)
        dd = t(dist).requires_grad_(True)
        xx = t(x).requires_grad_(True)
        out = cuda_cfconv.payload_conv(prm, dd, *args[1:], xx, tcfg, 4,
                                       plain=plain)
        assert torch.equal(out, want)
        got = torch.autograd.grad(out, (*prm, dd, xx), t(g))
        for a, b in zip(got, (dw1, db1, dw2, db2, d_dist, d_x)):
            assert torch.equal(a, b)
    assert dict(_kernels.LAUNCHES) == before
    for bad in (dict(width=48, num_gaussians=8),
                dict(width=16, num_gaussians=8),
                dict(width=128, num_gaussians=65)):
        cfg = CFConvConfig(cutoff=4.0, gaussian_width=0.5, **bad)
        w, ng = bad['width'], bad['num_gaussians']
        prm = (torch.zeros(ng, w), torch.zeros(w), torch.zeros(w, w),
               torch.zeros(w))
        with pytest.raises(ValueError, match='width'):
            cuda_cfconv.cfconv_fwd_cuda(prm, *args, torch.zeros(16, w), cfg)


@pytest.mark.parametrize('plain', [False, True])
def test_payload_conv_without_weight_grads(plain):
    """Weights that need no gradient (MD: only the positions do): the
    backward is asked for none and returns none (the card's forces-only
    kernel), and its distance and input cotangents equal those of a run
    whose weights need gradients, bitwise. ``weight_grads=False`` on
    ``cfconv_bwd_plain`` gives ``(None, d_dist, d_x)``, bitwise the full
    call's."""
    tcfg, _, jparams, dist, mask, idx, x, g = tiny_backward_inputs()
    args = (tuple(t(a) for a in jparams), t(dist), t(mask), t(idx), t(x),
            t(g), tcfg, 4)
    full = cuda_cfconv.cfconv_bwd_plain(*args)
    dw, d_dist, d_x = cuda_cfconv.cfconv_bwd_plain(*args, weight_grads=False)
    assert dw is None
    assert torch.equal(d_dist, full[1]) and torch.equal(d_x, full[2])

    def grads(weights_need_grad):
        prm = tuple(t(a).requires_grad_(weights_need_grad) for a in jparams)
        dd = t(dist).requires_grad_(True)
        xx = t(x).requires_grad_(True)
        calls = []
        bwd = 'cfconv_bwd_plain' if plain else 'cfconv_bwd'
        with recording(cuda_cfconv, bwd, calls):
            out = cuda_cfconv.payload_conv(prm, dd, t(mask), t(idx), xx,
                                           tcfg, 4, plain=plain)
            got = torch.autograd.grad(out, (dd, xx), t(g))
        (_, kwargs), = calls
        assert kwargs['weight_grads'] is weights_need_grad
        return got

    before = dict(_kernels.LAUNCHES)
    forces, trained = grads(False), grads(True)
    assert dict(_kernels.LAUNCHES) == before
    for a, b, c in zip(forces, trained, (d_dist, d_x)):
        assert torch.equal(a, b) and torch.equal(a, c)


def normwise(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def test_bwd_split3_products_hold_the_card_gates():
    """The kernel's arithmetic (``csrc/cfconv_bwd.cu``): every product in
    three bf16 passes (``cuda_cfconv.SPLIT3``), emulated by the plain
    backward, against JAX's f32 XLA backward of ``cfconv_masked`` at the
    cfconv-26k layer's widths (width 128, 50 Gaussians, 640 lanes, 65 % of
    them valid): within 2e-5 normwise on every output. One bf16 pass
    misses the card's 1e-4 gate on d_dist, which is why the kernel takes
    three."""
    rng = np.random.RandomState(5)
    n, k, width = 48, 640, 128
    tcfg, jcfg = configs(width=width, num_gaussians=50, cutoff=10.0,
                         gaussian_width=10.0 / 49)
    mask = rng.rand(n, k) < 0.65
    dist = np.where(mask, rng.uniform(0.5, 9.9, (n, k)), 0.0).astype(
        np.float32)
    idx = np.where(mask, rng.randint(0, n, (n, k)), n).astype(np.int32)
    x = rng.randn(n, width).astype(np.float32)
    g = rng.randn(n, width).astype(np.float32)
    jparams = j_init(jax.random.PRNGKey(6), jcfg)._replace(
        b1=jnp.asarray(0.1 * rng.randn(width).astype(np.float32)),
        b2=jnp.asarray(0.1 * rng.randn(width).astype(np.float32)))
    _, vjp = jax.vjp(jax.jit(lambda prm, d, inp: j_masked(
        prm, d, jnp.asarray(mask), jnp.asarray(idx), inp, jcfg)),
        jparams, jnp.asarray(dist), jnp.asarray(x))
    dprm, ddist, dx = jax.jit(vjp)(jnp.asarray(g))
    want = [*dprm, ddist, dx]
    args = (tuple(t(a) for a in jparams), t(dist), t(mask), t(idx), t(x),
            t(g), tcfg)
    flat = lambda r: [a.numpy() for a in (*r[0], r[1], r[2])]  # noqa: E731
    split = flat(cuda_cfconv.cfconv_bwd_plain(*args,
                                              dtype=cuda_cfconv.SPLIT3))
    errs = [normwise(a, b) for a, b in zip(split, want)]
    assert max(errs) <= 2e-5, errs
    one = flat(cuda_cfconv.cfconv_bwd_plain(*args, dtype=torch.bfloat16))
    assert normwise(one[4], want[4]) > 1e-4
