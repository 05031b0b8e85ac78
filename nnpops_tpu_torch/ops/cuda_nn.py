"""The fused species-ensemble kernels (``csrc/fused_nn.cu``), their wrappers,
the autograd Function and the plain PyTorch versions.

Port of ``nnpops_tpu/ops/pallas_nn.py`` (``make_fused_species_net``,
``species_energies_fused``, ``ensemble_energy_grouped_rows_fused``). Per
species: every model's MLP with bf16 matmul operands and f32 accumulation,
f32 biases and CELU(0.1) in f32 (activations are rounded to bf16 only as
matmul operands), the out=1 last layer as an f32 product with the
bf16-valued last weights, and the model mean. This is not
``batched_nn.apply_species_net``'s bf16 path, which rounds activations
before the CELU; the plain versions here follow the kernels.

The ensemble runs in three stages, each one launch for every species of
the call (the species table of :func:`pack_ensemble` and the call's row
counts say which rows and weights a block takes):

1. ``layer1``: ``H1 = CELU(bf16(X) W1cat^T + b1cat)`` with the first layers
   of all M models stacked (``W1cat [M d1, in]``), and for the gradient the
   CELU derivative ``D1`` (f32);
2. ``hidden``: per (row block, model) the layers 2..L-1, the energy
   ``h . w_last`` and, for the gradient, the backward down to
   ``G1_m = (c2 W2_m) o D1_m`` (bf16); the energies are summed over the
   models in model order;
3. ``dx`` (gradient only): ``dx = (1/M) G1cat W1cat``, one product with
   K = M d1, so the model sum is part of the accumulation.

Each stage has a plain version (``layer1_plain``, ``hidden_plain``,
``dx_plain``) on the packed buffers, the reference of its kernel. Their
composition equals :func:`fused_species_net_plain`, the per-species oracle
on the raw nets, up to the order of f32 sums.

Scope as in the reference BatchedNN: inference and input gradients. Under
autograd the forward runs the energy+gradient stages and saves
``dx1 = de/dx`` at unit cotangent; the backward is ``g * dx1``. Weights and
biases get no gradient.

Dispatch: a CUDA tensor launches the kernels or raises; a CPU tensor runs
the oracle species by species (:func:`ensemble_oracle`), which is also the
plain reference of the whole on any device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.weak

from .. import _kernels
from .batched_nn import CELU_ALPHA, EnsembleParams, SpeciesNet

_BF16 = torch.bfloat16
ROW_BLOCK = 64            # rows of a hidden-stage block (fused_nn.cu kHRows)
MAX_SPECIES = 8           # fused_nn.cu kMaxSpecies
MAX_LAYERS = 8            # fused_nn.cu kMaxLayers
MAX_WIDTH = 256           # fused_nn.cu kMaxW
_META_HEAD, _META_STRIDE = 8, 16


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """f32 tensor holding ``t`` rounded to bf16: a matmul of such operands in
    f32 is a bf16 matmul with f32 accumulation (the products are exact)."""
    return t.to(_BF16).float()


def _celu_and_derivative(z: torch.Tensor):
    e_z = torch.exp(z / CELU_ALPHA)
    return (torch.where(z > 0, z, CELU_ALPHA * (e_z - 1.0)),
            torch.where(z > 0, 1.0, e_z))


def fused_species_net_plain(x: torch.Tensor, net: SpeciesNet,
                            with_grad: bool = False,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The per-species oracle: ``x [n, in] -> (e [n, 1], dx [n, in] or
    None)``, model-mean energies and, with ``with_grad``, their input
    gradient at unit cotangent, in the kernels' working types, one model
    after another as the Pallas kernel runs them."""
    n_layers = len(net.weights)
    num_models = net.weights[0].shape[0]
    x16 = _bf16_values(x.float())
    acc = 0.0
    bias_sum = 0.0
    dx = None
    for mi in range(num_models):
        h = x16
        derivs = []
        for l in range(n_layers - 1):
            w = _bf16_values(net.weights[l][mi])                 # [out, in]
            z = _bf16_values(h) @ w.T + net.biases[l][mi].float()
            h, deriv = _celu_and_derivative(z)
            derivs.append(deriv)
        w_last = _bf16_values(net.weights[n_layers - 1][mi])   # [1, d]
        acc = acc + h * w_last
        bias_sum = bias_sum + net.biases[n_layers - 1][mi].float()
        if with_grad:
            d = w_last.expand_as(h)
            for l in range(n_layers - 2, -1, -1):
                d = d * derivs[l]
                d = _bf16_values(d) @ _bf16_values(net.weights[l][mi])
            dx = d if dx is None else dx + d
    e = (torch.sum(acc, 1, keepdim=True) + bias_sum) * (1.0 / num_models)
    if with_grad:
        dx = dx * (1.0 / num_models)
    return e, dx


# ---------------------------------------------------------------------------
# Packing.
# ---------------------------------------------------------------------------

def _pad(d: int, m: int) -> int:
    return -(-d // m) * m


def _first_width_step(num_models: int) -> int:
    """Hidden widths are padded to a multiple of 32 (the hidden stage's
    wgmma chunk), the first also so that ``M d1`` is a multiple of 64 (the
    layer-1 and dx stages' k-tile)."""
    step = 32
    while (num_models * step) % 64:
        step *= 2
    return step


class PackedNet(NamedTuple):
    """One species' ensemble in the kernels' layout (see fused_nn.cu).
    Every width is zero-padded (the first hidden width to a multiple of
    :func:`_first_width_step`, the others to 32, the input to 8): padded
    units have z = 0, so they contribute exact zeros forward and
    backward."""
    w1: torch.Tensor          # bf16 [M d1, in_pad]; row m d1 + j is W_0[m, j]
    wbuf: torch.Tensor        # bf16: for l = 1..L-2, W_l [M, d[l+1], d[l]]
                              # then W_l^T [M, d[l], d[l+1]]
    fbuf: torch.Tensor        # f32: b1cat [M d1], b_l [M, d[l+1]] for l =
                              # 1..L-2, w_last [M, d[L-1]] (bf16 values),
                              # b_last [M], zeros to a multiple of 4 floats
    dims: Tuple[int, ...]     # padded widths, dims[0] = in_pad, last = 1
    in_actual: int
    num_models: int

    def hidden(self) -> Tuple[torch.Tensor, ...]:
        """Views of W_1 .. W_{L-2}, each ``[M, d[l+1], d[l]]``."""
        m, d = self.num_models, self.dims
        sizes = [m * d[l + 1] * d[l] for l in range(1, len(d) - 2)
                 for _ in range(2)]
        parts = torch.split(self.wbuf, sizes)
        return tuple(parts[2 * l].view(m, d[l + 2], d[l + 1])
                     for l in range(len(d) - 3))

    def vectors(self):
        """Views ``(b1cat [M d1], (b_l [M, d[l+1]], ...), w_last [M, d[L-1]],
        b_last [M])`` of ``fbuf``."""
        m, d = self.num_models, self.dims
        L = len(d) - 1
        sizes = ([m * d[1]] + [m * d[l + 1] for l in range(1, L - 1)]
                 + [m * d[L - 1], m])
        sizes.append(self.fbuf.numel() - sum(sizes))
        parts = torch.split(self.fbuf, sizes)
        biases = tuple(p.view(m, d[l + 2]) for l, p in
                       enumerate(parts[1:L - 1]))
        return parts[0], biases, parts[L - 1].view(m, d[L - 1]), parts[L]


class PackedEnsemble(NamedTuple):
    """Every species' :class:`PackedNet` concatenated, and the species
    table the kernels take (``meta``; layout in fused_nn.cu
    ``read_table``)."""
    nets: Tuple[PackedNet, ...]
    w1cat: torch.Tensor       # bf16 [ksum, in_pad]: the species' w1 stacked
    w1cat_t: torch.Tensor     # bf16 [in_pad, ksum]: K-major copy for dx
    wbuf: torch.Tensor
    fbuf: torch.Tensor
    meta: Tuple[int, ...]
    meta_c: object            # ``meta`` as a ctypes int array
    kmax: int                 # widest M d1: the row stride of H1, D1, G1
    in_pad: int
    in_actual: int
    num_models: int


# Packed ensembles keyed weakly by their first weight tensor, so an entry
# lives only as long as the weights do.
_PACKED_ENSEMBLE = torch.utils.weak.WeakIdKeyDictionary()


@torch.no_grad()
def pack_species_net(net: SpeciesNet) -> PackedNet:
    """One species' weights in the kernels' layout."""
    ws, bs = net.weights, net.biases
    n_layers = len(ws)
    m = ws[0].shape[0]
    dims = [ws[0].shape[2]] + [w.shape[1] for w in ws]
    if dims[-1] != 1:
        raise ValueError('the last layer must have one output')
    if n_layers < 3:
        raise ValueError('the staged ensemble needs at least two hidden '
                         f'layers, got {n_layers - 1}')
    pd = ([_pad(dims[0], 8), _pad(dims[1], _first_width_step(m))]
          + [_pad(d, 32) for d in dims[2:-1]] + [1])
    dev = ws[0].device
    w1 = torch.zeros(m, pd[1], pd[0], dtype=_BF16, device=dev)
    w1[:, :dims[1], :dims[0]] = ws[0].to(_BF16)
    b1 = torch.zeros(m, pd[1], dtype=torch.float32, device=dev)
    b1[:, :dims[1]] = bs[0].float()
    wparts, fparts = [], [b1.reshape(-1)]
    for l in range(1, n_layers - 1):
        w = torch.zeros(m, pd[l + 1], pd[l], dtype=_BF16, device=dev)
        w[:, :dims[l + 1], :dims[l]] = ws[l].to(_BF16)
        wparts += [w.reshape(-1), w.transpose(1, 2).reshape(-1)]
        b = torch.zeros(m, pd[l + 1], dtype=torch.float32, device=dev)
        b[:, :dims[l + 1]] = bs[l].float()
        fparts.append(b.reshape(-1))
    w_last = torch.zeros(m, pd[n_layers - 1], dtype=torch.float32, device=dev)
    w_last[:, :dims[n_layers - 1]] = _bf16_values(ws[n_layers - 1][:, 0, :])
    fparts += [w_last.reshape(-1), bs[n_layers - 1][:, 0].float()]
    # b_last has M entries: pad so that the next species' vectors start on a
    # 16-byte boundary (the kernels load them as float2 and float4).
    tail = -sum(f.numel() for f in fparts) % 4
    fparts.append(torch.zeros(tail, dtype=torch.float32, device=dev))
    return PackedNet(w1.reshape(m * pd[1], pd[0]).contiguous(),
                     torch.cat(wparts).contiguous(),
                     torch.cat(fparts).contiguous(), tuple(pd),
                     int(dims[0]), int(m))


def pack_ensemble(params: EnsembleParams) -> PackedEnsemble:
    """Every species' net packed and concatenated, with the species table.
    Cached while every weight and bias is the same tensor at the same
    version: an in-place update (``copy_``, ``load_state_dict``) packs
    anew."""
    nets = params.networks
    stamp = tuple((id(t), t._version) for net in nets
                  for t in net.weights + net.biases)
    hit = _PACKED_ENSEMBLE.get(nets[0].weights[0])
    if hit is not None and hit[0] == stamp:
        return hit[1]
    packed = _pack_ensemble(nets)
    _PACKED_ENSEMBLE[nets[0].weights[0]] = (stamp, packed)
    return packed


@torch.no_grad()
def _pack_ensemble(networks: Sequence[SpeciesNet]) -> PackedEnsemble:
    nets = tuple(pack_species_net(n) for n in networks)
    if not 1 <= len(nets) <= MAX_SPECIES:
        raise ValueError(f'1 to {MAX_SPECIES} species, got {len(nets)}')
    first = nets[0]
    for p in nets:
        if (p.num_models, len(p.dims), p.in_actual) != (
                first.num_models, len(first.dims), first.in_actual):
            raise ValueError('every species needs the same number of models '
                             'and layers and the same input width')
        if len(p.dims) - 1 > MAX_LAYERS or max(p.dims[1:-1]) > MAX_WIDTH:
            raise ValueError(f'at most {MAX_LAYERS} layers of width '
                             f'{MAX_WIDTH}, got {p.dims}')
    m, L = first.num_models, len(first.dims) - 1
    meta = [len(nets), m, L, first.in_actual, first.dims[0], 0, 0, 0]
    w1row = woff = foff = 0
    for p in nets:
        row = list(p.dims) + [0] * (9 - len(p.dims)) + [w1row, woff, foff]
        meta += row + [0] * (_META_STRIDE - len(row))
        w1row += p.w1.shape[0]
        woff += p.wbuf.numel()
        foff += p.fbuf.numel()
    meta[5] = max(p.w1.shape[0] for p in nets)                   # kmax
    meta[6] = w1row                                              # ksum
    meta[7] = max(max(p.dims[1:-1]) for p in nets)               # maxw
    w1cat = torch.cat([p.w1 for p in nets]).contiguous()
    return PackedEnsemble(
        nets, w1cat, w1cat.t().contiguous(),
        torch.cat([p.wbuf for p in nets]).contiguous(),
        torch.cat([p.fbuf for p in nets]).contiguous(), tuple(meta),
        (ctypes.c_int * len(meta))(*meta), meta[5], first.dims[0],
        first.in_actual, m)


# ---------------------------------------------------------------------------
# The stages' plain versions.
# ---------------------------------------------------------------------------

def species_ranges(counts: Sequence[int]):
    """``(s, first row, end row)`` of every species with rows."""
    out, start = [], 0
    for s, c in enumerate(counts):
        if c:
            out.append((s, start, start + c))
        start += c
    return out


def species_rows(pe: PackedEnsemble, counts: Sequence[int]):
    """``(s, first row, end row, M d1)`` of every species with rows."""
    return [(s, r0, r1, pe.nets[s].w1.shape[0])
            for s, r0, r1 in species_ranges(counts)]


def to_bf16_input(x: torch.Tensor, pe: PackedEnsemble) -> torch.Tensor:
    """``x`` rounded to bf16, zero-padded to the packed input width."""
    if x.shape[1] == pe.in_pad:
        return x.to(_BF16)
    x16 = torch.zeros(x.shape[0], pe.in_pad, dtype=_BF16, device=x.device)
    x16[:, :x.shape[1]] = x
    return x16


def layer1_plain(x16: torch.Tensor, pe: PackedEnsemble,
                 counts: Sequence[int], with_grad: bool):
    """Stage 1: ``(H1 [n, kmax] bf16, D1 [n, kmax] f32 or None)``; columns
    past a species' ``M d1`` are 0."""
    n = x16.shape[0]
    h1 = torch.zeros(n, pe.kmax, dtype=_BF16, device=x16.device)
    d1 = (torch.zeros(n, pe.kmax, dtype=torch.float32, device=x16.device)
          if with_grad else None)
    for s, r0, r1, ksp in species_rows(pe, counts):
        net = pe.nets[s]
        z = x16[r0:r1].float() @ net.w1.float().T + net.vectors()[0]
        h, deriv = _celu_and_derivative(z)
        h1[r0:r1, :ksp] = h.to(_BF16)
        if with_grad:
            d1[r0:r1, :ksp] = deriv
    return h1, d1


def hidden_plain(h1: torch.Tensor, d1: Optional[torch.Tensor],
                 pe: PackedEnsemble, counts: Sequence[int], with_grad: bool):
    """Stage 2: ``(e [n, 1], G1 [n, kmax] bf16 or None)``: per model the
    layers 2..L-1, the row energy ``h . w_last`` and, with ``with_grad``,
    ``G1_m = (c2 W2_m) o D1_m``; energies summed over the models in order,
    plus the last biases, over M."""
    n, m_models = h1.shape[0], pe.num_models
    e = torch.zeros(n, 1, dtype=torch.float32, device=h1.device)
    g1 = (torch.zeros(n, pe.kmax, dtype=_BF16, device=h1.device)
          if with_grad else None)
    for s, r0, r1, _ in species_rows(pe, counts):
        net = pe.nets[s]
        d = net.dims
        hidden = net.hidden()
        _, biases, w_last, b_last = net.vectors()
        esum = 0.0
        for m in range(m_models):
            cols = slice(m * d[1], (m + 1) * d[1])
            h = h1[r0:r1, cols].float()
            derivs = []
            for l, w in enumerate(hidden):
                h, deriv = _celu_and_derivative(h.to(_BF16).float()
                                                @ w[m].float().T + biases[l][m])
                derivs.append(deriv)
            esum = esum + torch.sum(h * w_last[m], 1, keepdim=True)
            if with_grad:
                c = w_last[m] * derivs[-1]
                for l in range(len(hidden) - 1, -1, -1):
                    c = c.to(_BF16).float() @ hidden[l][m].float()
                    c = c * (derivs[l - 1] if l else d1[r0:r1, cols])
                g1[r0:r1, cols] = c.to(_BF16)
        e[r0:r1] = (esum + torch.sum(b_last)) / m_models
    return e, g1


def dx_plain(g1: torch.Tensor, pe: PackedEnsemble,
             counts: Sequence[int]) -> torch.Tensor:
    """Stage 3: ``dx [n, in] = (1/M) G1cat W1cat`` per species."""
    dx = torch.zeros(g1.shape[0], pe.in_actual, dtype=torch.float32,
                     device=g1.device)
    for s, r0, r1, ksp in species_rows(pe, counts):
        w1 = pe.nets[s].w1.float()[:, :pe.in_actual]
        dx[r0:r1] = (g1[r0:r1, :ksp].float() @ w1) * (1.0 / pe.num_models)
    return dx


def ensemble_plain(x: torch.Tensor, pe: PackedEnsemble, counts: Sequence[int],
                   with_grad: bool):
    """The three stages' plain versions composed: ``(e [n, 1], dx or
    None)``, what :func:`ensemble_cuda` computes."""
    h1, d1 = layer1_plain(to_bf16_input(x, pe), pe, counts, with_grad)
    e, g1 = hidden_plain(h1, d1, pe, counts, with_grad)
    return e, (dx_plain(g1, pe, counts) if with_grad else None)


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------

class Workspace(NamedTuple):
    """Byte offsets of the stages' intermediates in one scratch buffer."""
    nbytes: int
    h1: int        # bf16 [n, kmax]
    d1: int        # f32 [n, kmax] (gradient only)
    g1: int        # bf16 [n, kmax] (gradient only)
    epart: int     # f32 [M, n]: per-model row energies
    cnt: int       # int32 [row blocks]: models done per 64-row block
    ncnt: int


def workspace(pe: PackedEnsemble, counts: Sequence[int],
              with_grad: bool) -> Workspace:
    n = sum(counts)
    ncnt = sum(-(-c // ROW_BLOCK) for c in counts)
    sizes = (n * pe.kmax * 2, n * pe.kmax * 4 * with_grad,
             n * pe.kmax * 2 * with_grad, pe.num_models * n * 4, ncnt * 4)
    offs, o = [], 0
    for size in sizes:
        offs.append(o)
        o += _pad(size, 256)
    return Workspace(max(o, 256), *offs, ncnt)


_COUNTS_C = {}


def _counts_c(counts: Tuple[int, ...]):
    hit = _COUNTS_C.get(counts)
    if hit is None:
        if len(_COUNTS_C) > 64:
            _COUNTS_C.clear()
        hit = _COUNTS_C[counts] = (ctypes.c_int * len(counts))(*counts)
    return hit


def _check(pe: PackedEnsemble, counts: Tuple[int, ...], *tensors) -> None:
    if len(counts) != len(pe.nets):
        raise ValueError(f'{len(counts)} counts for {len(pe.nets)} species')
    _kernels.require_cuda(pe.w1cat, pe.w1cat_t, pe.wbuf, pe.fbuf, *tensors)


# The three launches, on raw device pointers (``None`` for an absent
# gradient buffer): the tensor wrappers below and ensemble_cuda share them.
def _launch_layer1(pe, x16, h1, d1, cnt, ncnt, cc, stream) -> None:
    _kernels.launch(
        'fused_nn_fwdgrad_layer1' if d1 is not None else 'fused_nn_fwd_layer1',
        x16, pe.w1cat.data_ptr(), pe.fbuf.data_ptr(), h1, d1, cnt, ncnt,
        pe.meta_c, cc, stream)


def _launch_hidden(pe, h1, d1, g1, epart, cnt, e, cc, stream) -> None:
    _kernels.launch(
        'fused_nn_fwdgrad_hidden' if g1 is not None else 'fused_nn_fwd_hidden',
        h1, d1, pe.wbuf.data_ptr(), pe.fbuf.data_ptr(), g1, epart, cnt, e,
        pe.meta_c, cc, stream)


def _launch_dx(pe, g1, dx, cc, stream) -> None:
    _kernels.launch('fused_nn_fwdgrad_dx', g1, pe.w1cat_t.data_ptr(), dx,
                    pe.meta_c, cc, stream)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def layer1_cuda(x16, pe, counts, h1, d1, cnt) -> None:
    """Stage 1 kernel into ``h1`` (and ``d1`` when given); zeroes ``cnt``."""
    counts = tuple(counts)
    _check(pe, counts, x16, h1, cnt, *([d1] if d1 is not None else []))
    _launch_layer1(pe, x16.data_ptr(), h1.data_ptr(), _ptr(d1), cnt.data_ptr(),
                   cnt.numel(), _counts_c(counts),
                   _kernels.stream_handle(x16.device))


def hidden_cuda(h1, d1, pe, counts, g1, epart, cnt, e) -> None:
    """Stage 2 kernel: ``e`` (and ``g1`` when given) from ``h1`` (and
    ``d1``); ``cnt`` must be zero (stage 1 zeroes it, and the kernel leaves
    it zero)."""
    counts = tuple(counts)
    grad = g1 is not None
    _check(pe, counts, h1, epart, cnt, e, *([d1, g1] if grad else []))
    _launch_hidden(pe, h1.data_ptr(), _ptr(d1) if grad else None, _ptr(g1),
                   epart.data_ptr(), cnt.data_ptr(), e.data_ptr(),
                   _counts_c(counts), _kernels.stream_handle(h1.device))


def dx_cuda(g1, pe, counts, dx) -> None:
    """Stage 3 kernel into ``dx``."""
    counts = tuple(counts)
    _check(pe, counts, g1, dx)
    _launch_dx(pe, g1.data_ptr(), dx.data_ptr(), _counts_c(counts),
               _kernels.stream_handle(g1.device))


def workspace_views(buf: torch.Tensor, ws: Workspace, pe: PackedEnsemble,
                    n: int):
    """``(h1, d1, g1, epart, cnt)`` views of a scratch buffer (``d1`` and
    ``g1`` empty when the workspace has no gradient part)."""
    def view(off, count, dtype, shape):
        size = count * torch.tensor([], dtype=dtype).element_size()
        return buf[off:off + size].view(dtype).view(shape)
    k = pe.kmax
    grad = ws.g1 > ws.d1
    return (view(ws.h1, n * k, _BF16, (n, k)),
            view(ws.d1, n * k * grad, torch.float32, (n * grad, k)),
            view(ws.g1, n * k * grad, _BF16, (n * grad, k)),
            view(ws.epart, pe.num_models * n, torch.float32,
                 (pe.num_models, n)),
            view(ws.cnt, ws.ncnt, torch.int32, (ws.ncnt,)))


def ensemble_cuda(x: torch.Tensor, pe: PackedEnsemble, counts: Sequence[int],
                  with_grad: bool):
    """The stage kernels on ``x [n, in]`` (contiguous f32 on the card):
    ``(e [n, 1], dx [n, in] or None)``. Two or three launches for every
    species, one scratch buffer, no host work per species."""
    counts = tuple(counts)
    n = x.shape[0]
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != pe.in_actual:
        raise ValueError(f'x must be float32 [n, {pe.in_actual}], got '
                         f'{x.dtype} {tuple(x.shape)}')
    if sum(counts) != n:
        raise ValueError(f'counts {counts} do not sum to {n} rows')
    _check(pe, counts, x)
    e = torch.empty(n, 1, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if with_grad else None
    if n == 0:
        return e, dx
    x16 = to_bf16_input(x, pe)
    ws = workspace(pe, counts, with_grad)
    buf = torch.empty(ws.nbytes, dtype=torch.uint8, device=x.device)
    base = buf.data_ptr()
    cc, stream = _counts_c(counts), _kernels.stream_handle(x.device)
    d1 = base + ws.d1 if with_grad else None
    g1 = base + ws.g1 if with_grad else None
    _launch_layer1(pe, x16.data_ptr(), base + ws.h1, d1, base + ws.cnt,
                   ws.ncnt, cc, stream)
    _launch_hidden(pe, base + ws.h1, d1, g1, base + ws.epart, base + ws.cnt,
                   e.data_ptr(), cc, stream)
    if with_grad:
        _launch_dx(pe, g1, dx.data_ptr(), cc, stream)
    return e, dx


def ensemble_oracle(params: EnsembleParams, x: torch.Tensor,
                    counts: Sequence[int], with_grad: bool):
    """:func:`fused_species_net_plain` species by species on the raw nets,
    over species-grouped rows: ``(e [n, 1], dx [n, in] or None)``."""
    parts = [fused_species_net_plain(x[r0:r1], params.networks[s], with_grad)
             for s, r0, r1 in species_ranges(counts)]
    if not parts:
        return (x.new_zeros(0, 1),
                x.new_zeros(0, x.shape[1]) if with_grad else None)
    e = torch.cat([p[0] for p in parts])
    return e, (torch.cat([p[1] for p in parts]) if with_grad else None)


class FusedEnsembleFunction(torch.autograd.Function):
    """Energies and gradient in one pass, ``(x, run) -> e [n, 1]`` with
    ``run(x, True) = (e, dx1)`` saving ``dx1``; the backward is
    ``g * dx1``."""

    @staticmethod
    def forward(ctx, x, run):
        e, dx1 = run(x, True)
        ctx.save_for_backward(dx1)
        return e

    @staticmethod
    def backward(ctx, g):
        (dx1,) = ctx.saved_tensors
        return g * dx1, None


def _energies(x: torch.Tensor, run) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return FusedEnsembleFunction.apply(x, run)
    return run(x, False)[0]


def ensemble_energies(params: EnsembleParams, x: torch.Tensor,
                      counts: Sequence[int], plain: bool = False,
                      ) -> torch.Tensor:
    """Per-row model-mean energies ``[n, 1]`` of species-grouped rows
    (``counts[s]`` contiguous rows per species, ascending species),
    differentiable in ``x`` only: on a CUDA tensor one set of stage launches
    for every species (under autograd the gradient stages), on a CPU tensor
    or with ``plain`` :func:`ensemble_oracle`."""
    counts = tuple(int(c) for c in counts)

    def run(xx, with_grad):
        if plain or xx.device.type == 'cpu':
            return ensemble_oracle(params, xx, counts, with_grad)
        if xx.device.type != 'cuda':
            raise ValueError(f'no fused-NN kernel for device {xx.device}')
        return ensemble_cuda(xx.contiguous(), pack_ensemble(params), counts,
                             with_grad)
    return _energies(x, run)


def _grouped(params: EnsembleParams, aev: torch.Tensor,
             counts: Sequence[int], plain: bool) -> torch.Tensor:
    counts = tuple(int(c) for c in counts)
    n = sum(counts)
    if n == 0:
        return aev.new_zeros(())
    return torch.sum(ensemble_energies(params, aev[:n], counts, plain))


def ensemble_energy_grouped_rows_fused(params: EnsembleParams,
                                       aev: torch.Tensor,
                                       counts: Sequence[int]) -> torch.Tensor:
    """Total NN energy from species-grouped AEV rows (``counts[s]``
    contiguous rows per species, ascending species) through the fused
    stages: one set of launches for every species (see
    :func:`ensemble_energies`)."""
    return _grouped(params, aev, counts, False)


def ensemble_energy_grouped_rows_fused_plain(params: EnsembleParams,
                                             aev: torch.Tensor,
                                             counts: Sequence[int],
                                             ) -> torch.Tensor:
    """:func:`ensemble_energy_grouped_rows_fused` through
    :func:`ensemble_oracle` on any device, with the same gradient: the
    reference the kernels are held against on the card. It reads the raw
    nets, so it shares no packing with the kernels."""
    return _grouped(params, aev, counts, True)
