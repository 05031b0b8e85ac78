"""Particle Mesh Ewald electrostatics (port of ``nnpops_tpu.ops.pme``).

The algorithm of the reference PME op (``src/pytorch/pme/``):

* direct space: erfc-damped Coulomb over a neighbor pair list with exclusion
  skipping, minus the erf-damped compensation for the excluded pairs that
  reciprocal space includes (pmeCPU.cpp:105-157);
* reciprocal space: cardinal B-spline charge spreading onto a 3D grid
  (pmeCPU.cpp:202-224), a real FFT, the Ewald k-space convolution and energy
  (pmeCPU.cpp:235-266), plus the analytic self-energy (pme.py:194);
* the B-spline Fourier moduli, precomputed on the host in float64
  (pme.py:94-129).

Port notes:

* Spreading is one ``index_add`` of the ``[N, order^3]`` stencil, the
  reference NNPOps's atomics design. The JAX package's scatter-free chunked
  spread (``spread_charges_chunked``) avoids a scatter the TPU serialises;
  it drops atoms past a per-chunk capacity, and below that capacity it
  equals the scatter. ``spread_capacity`` and ``spread_overflow`` are kept
  exactly, so the combined model's ``pme_spread_chunk`` count and check are
  the JAX package's. On CUDA, ``index_add`` sums with atomics in an order
  that changes from run to run.
* The FFT is ``torch.fft.rfftn`` (XLA's ``rfftn`` in the JAX package).
* Gradients come from autograd through the spline recursion, the
  ``index_add`` (whose adjoint is the force-interpolation gather,
  pmeCPU.cpp:324-343) and the FFT, so the pair path and the reciprocal term
  have derivatives of any order in positions and charges. The window
  direct path (``ops.cuda_pme``) is first-order, as the Pallas VJP is.
* ``compute_direct(cell_list=...)`` needs ``CellList.build_payload``
  (ROADMAP A.6, not ported) and raises.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import PMEConfig
from ..geometry import box_transform, invert_box, validate_box
from ..neighbors.pairs import MaskedPairs, neighbor_pairs_masked
from .aev_blocked import device_constant
from .batched_nn import resolve_device
from .cuda_pme import plan_pme_window, pme_direct_window, pme_window_overflow

Tensor = torch.Tensor

_CHUNK = 8   # grid points per chunk axis of the JAX package's chunked spread


# ---------------------------------------------------------------------------
# B-spline machinery.

def bspline_weights(dr: Tensor, order: int) -> Tensor:
    """Cardinal B-spline weights of ``order`` for fractional offsets ``dr``:
    ``[..., order]``, slot k the weight of grid point ``base + k`` (Cox-de
    Boor recursion on uniform knots, pmeCPU.cpp:49-69)."""
    w = torch.stack([1.0 - dr, dr], -1)
    for j in range(3, order + 1):
        div = 1.0 / (j - 1)
        prev = torch.nn.functional.pad(w, (0, 1))        # w_{j-1}[k]
        shifted = torch.nn.functional.pad(w, (1, 0))     # w_{j-1}[k-1]
        k = torch.arange(j, dtype=dr.dtype, device=dr.device)
        w = div * ((dr[..., None] + (j - 1 - k)) * shifted
                   + (k + 1.0 - dr[..., None]) * prev)
    return w


def bspline_moduli(grid_sizes: Sequence[int], order: int) -> Tuple[np.ndarray, ...]:
    """Squared DFT magnitudes of the B-spline for each grid axis, host
    float64 (Essmann et al. 1995; reference pme.py:94-129): the order-n
    spline at the integer knots, |DFT|^2, near-zero entries patched with
    the mean of their neighbors. Cast to the working type at use."""
    data = np.zeros(order, dtype=np.float64)
    data[0] = 1.0
    for j in range(3, order + 1):
        div = 1.0 / (j - 1)
        new = np.zeros(order, dtype=np.float64)
        for k in range(j):
            left = data[k - 1] if k >= 1 else 0.0
            new[k] = div * ((j - 1 - k) * left + (k + 1.0) * data[k])
        data = new
    knots = np.zeros(max(grid_sizes), dtype=np.float64)
    knots[1:order + 1] = data[:order]

    moduli = []
    for ndata in grid_sizes:
        i = np.arange(ndata)
        arg = 2.0 * np.pi * np.outer(i, i) / ndata
        sc = (knots[:ndata] * np.cos(arg)).sum(axis=1)
        ss = (knots[:ndata] * np.sin(arg)).sum(axis=1)
        m = sc * sc + ss * ss
        small = m < 1e-7
        patched = 0.5 * (np.roll(m, 1) + np.roll(m, -1))
        moduli.append(np.where(small, patched, m))
    return tuple(moduli)


# ---------------------------------------------------------------------------
# Direct space.

def pme_direct_energy(positions: Tensor, charges: Tensor, pairs: MaskedPairs,
                      exclusions: Tensor, alpha: float,
                      coulomb: float) -> Tensor:
    """Direct-space Ewald energy over a masked pair list: pairs listed in
    ``exclusions`` ([N, E] int, padded with -1) are skipped, then every
    exclusion's erf-damped primary-copy energy is subtracted
    (pme.py:25-33, pmeCPU.cpp:134-157). ``torch.erfc``, as the JAX pair
    path takes ``jax.scipy.special.erfc``."""
    q1 = charges[pairs.atom1]
    q2 = charges[pairs.atom2]
    excl_rows = exclusions[pairs.atom1]                       # [P, E]
    excluded = torch.any(excl_rows == pairs.atom2[:, None], -1)
    include = pairs.mask & ~excluded
    r = torch.where(include, pairs.distances, 1.0)
    e_pair = coulomb * q1 * q2 * torch.erfc(alpha * r) / r
    energy = torch.sum(torch.where(include, e_pair, 0.0))
    return energy - pme_exclusion_compensation(positions, charges, exclusions,
                                               alpha, coulomb)


def pme_exclusion_compensation(positions: Tensor, charges: Tensor,
                               exclusions: Tensor, alpha: float,
                               coulomb: float) -> Tensor:
    """The erf-damped energy of the excluded pairs (deduped to j > i) from
    the UNWRAPPED displacement, which reciprocal space added and direct
    space subtracts (pme.py:25-33, pmeCPU.cpp:134-157)."""
    n, e = exclusions.shape
    if e == 0:
        return positions.new_zeros(())
    i_idx = torch.arange(n, device=positions.device)[:, None].expand(n, e)
    j_idx = exclusions.long()
    valid = j_idx > i_idx                                # also rejects -1
    j_safe = torch.where(valid, j_idx, 0)
    # index_select, not advanced indexing: its adjoint is an index_add,
    # where advanced indexing's sorts the (mostly duplicate) indices.
    dr = (positions.index_select(0, i_idx.reshape(-1))
          - positions.index_select(0, j_safe.reshape(-1)))
    d2 = torch.sum(dr * dr, -1).reshape(n, e)
    rr = torch.sqrt(torch.where(valid, d2, 1.0))
    erf_term = 1.0 - torch.erfc(alpha * rr)
    e_excl = coulomb * charges[i_idx] * charges[j_safe] * erf_term / rr
    return torch.sum(torch.where(valid, e_excl, 0.0))


# ---------------------------------------------------------------------------
# Reciprocal space.

def _fractional_grid(positions: Tensor, box: Tensor, config: PMEConfig):
    """(base grid point [N, 3] int64, offset dr [N, 3]) of every atom:
    fractional coordinates from the closed-form box inverse, wrapped into
    [0, 1) and scaled to the grid (the JAX package's f32 floor and cast
    order, so the grid points equal its)."""
    g3 = config.grid_shape
    t = box_transform(positions, invert_box(box))
    t = (t - torch.floor(t)) * device_constant(g3, positions.dtype,
                                              positions.device)
    ti = torch.floor(t)
    base = ti.to(torch.int32).long() % device_constant(g3, torch.int64,
                                                      positions.device)
    return base, t - ti


def _atom_chunk_data(positions: Tensor, charges: Tensor, box: Tensor,
                     config: PMEConfig):
    """Per-atom spline weights, local base in its 8^3 chunk and chunk id
    (the JAX package's chunked-spread binning, kept for its overflow
    count)."""
    base, dr = _fractional_grid(positions, box, config)
    w = bspline_weights(dr, config.order)                     # [N, 3, order]
    chunk3 = base // _CHUNK
    lbase = base - chunk3 * _CHUNK
    _, gy, gz = config.grid_shape
    ncy, ncz = gy // _CHUNK, gz // _CHUNK
    cid = (chunk3[:, 0] * ncy + chunk3[:, 1]) * ncz + chunk3[:, 2]
    return w, lbase, cid


def spread_capacity(num_atoms: int, config: PMEConfig) -> int:
    """The JAX chunked spread's static per-chunk atom capacity: 4x the mean
    occupancy + 8."""
    nchunks = int(np.prod([g // _CHUNK for g in config.grid_shape]))
    return int(np.ceil(4.0 * num_atoms / nchunks)) + 8


def spread_overflow(positions: Tensor, charges: Tensor, box: Tensor,
                    config: PMEConfig) -> Tensor:
    """TRUE max atoms per 8^3 chunk (int32 scalar on the positions'
    device): the JAX package's ``pme_spread_chunk`` count, held against
    ``spread_capacity``. The port's spread has no such capacity; the count
    is kept so the soft-failure contract stays the JAX package's."""
    with torch.no_grad():
        _, _, cid = _atom_chunk_data(positions, charges, box, config)
        nchunks = int(np.prod([g // _CHUNK for g in config.grid_shape]))
        # index_add, not bincount: bincount on a CUDA tensor synchronises.
        counts = torch.zeros(max(nchunks, 1), dtype=torch.int32,
                             device=positions.device)
        counts.index_add_(0, cid, torch.ones_like(cid, dtype=torch.int32))
        return torch.max(counts)


def spread_charges(positions: Tensor, charges: Tensor, box: Tensor,
                   config: PMEConfig) -> Tensor:
    """Spread charges onto the PME grid with order-n B-splines: one
    ``index_add`` of the [N, order^3] stencil (pmeCPU.cpp:202-224), scaled
    by sqrt(coulomb). Differentiating through it gives the
    force-interpolation gather."""
    gx, gy, gz = config.grid_shape
    order = config.order
    dev = positions.device
    base, dr = _fractional_grid(positions, box, config)
    w = bspline_weights(dr, order)                            # [N, 3, order]
    offsets = torch.arange(order, device=dev)
    idx = (base[:, :, None] + offsets) % device_constant(
        (gx, gy, gz), torch.int64, dev)[None, :, None]
    amp = charges * float(np.sqrt(config.coulomb))
    stencil = (amp[:, None, None, None] * w[:, 0, :, None, None]
               * w[:, 1, None, :, None] * w[:, 2, None, None, :])
    flat_idx = ((idx[:, 0, :, None, None] * gy + idx[:, 1, None, :, None]) * gz
                + idx[:, 2, None, None, :])
    grid = positions.new_zeros(gx * gy * gz)
    grid = grid.index_add(0, flat_idx.reshape(-1), stencil.reshape(-1))
    return grid.reshape(gx, gy, gz)


@functools.lru_cache(maxsize=16)
def _eterm_tables(config: PMEConfig, moduli_key, dtype, device):
    """Device constants of the k-space factor, made once: the wrapped
    frequencies per axis and the moduli product over the half-spectrum."""
    gx, gy, gz = config.grid_shape
    zsize = gz // 2 + 1

    def wrapped(g, size):
        k = np.arange(size)
        return np.where(k < (g + 1) // 2, k, k - g)

    mods = [torch.as_tensor(m, device=device).to(dtype) for m in moduli_key]
    mod = (mods[0][:, None, None] * mods[1][None, :, None]
           * mods[2][None, None, :zsize])
    kz = np.arange(zsize)
    scale = np.where((kz > 0) & (kz <= (gz - 1) // 2), 2.0, 1.0)
    k0 = np.ones((gx, gy, zsize), bool)
    k0[0, 0, 0] = False
    return (torch.as_tensor(wrapped(gx, gx), dtype=dtype, device=device),
            torch.as_tensor(wrapped(gy, gy), dtype=dtype, device=device),
            torch.as_tensor(wrapped(gz, zsize), dtype=dtype, device=device),
            mod, torch.as_tensor(scale, dtype=dtype, device=device),
            torch.as_tensor(k0, device=device))


class _Moduli(tuple):
    """The moduli tuple, hashable by identity for the table cache."""
    __hash__ = object.__hash__
    __eq__ = object.__eq__


def reciprocal_eterm(box: Tensor, config: PMEConfig, moduli) -> Tensor:
    """The k-space convolution factor over the rfftn half-spectrum
    (pmeCPU.cpp:243-260), zero at k = 0. ``moduli``: the host float64
    tuple of :func:`bspline_moduli`, cast to the box's type."""
    if not isinstance(moduli, _Moduli):
        moduli = _Moduli(moduli)
    mx, my, mz, mod, _, k0 = _eterm_tables(config, moduli, box.dtype,
                                           box.device)
    recip = invert_box(box)
    mx, my, mz = mx[:, None, None], my[None, :, None], mz[None, None, :]
    mhx = mx * recip[0, 0]
    mhy = mx * recip[1, 0] + my * recip[1, 1]
    mhz = mx * recip[2, 0] + my * recip[2, 1] + mz * recip[2, 2]
    m2 = mhx * mhx + mhy * mhy + mhz * mhz
    scale_factor = np.pi * box[0, 0] * box[1, 1] * box[2, 2]
    denom = m2 * scale_factor * mod
    exp_factor = (np.pi * np.pi) / (config.alpha * config.alpha)
    safe_m2 = torch.where(m2 > 0, m2, 1.0)
    safe_denom = torch.where(denom != 0, denom, 1.0)
    eterm = torch.exp(-exp_factor * safe_m2) / safe_denom
    return torch.where(k0, eterm, 0.0)


def pme_reciprocal_energy(positions: Tensor, charges: Tensor, box: Tensor,
                          config: PMEConfig, moduli) -> Tensor:
    """Reciprocal-space Ewald energy, NOT including the self-energy term."""
    grid = spread_charges(positions, charges, box, config)
    gk = torch.fft.rfftn(grid)
    if not isinstance(moduli, _Moduli):
        moduli = _Moduli(moduli)
    eterm = reciprocal_eterm(box, config, moduli)
    scale = _eterm_tables(config, moduli, box.dtype, box.device)[4]
    power = gk.real * gk.real + gk.imag * gk.imag
    return 0.5 * torch.sum(scale * eterm * power)


def pme_self_energy(charges: Tensor, alpha: float, coulomb: float) -> Tensor:
    """The analytic Ewald self-energy ``-sum(q^2) * k * alpha / sqrt(pi)``
    (pme.py:194)."""
    return -torch.sum(charges * charges) * (coulomb * alpha / np.sqrt(np.pi))


# ---------------------------------------------------------------------------
# User-facing class (API parity with NNPOps.pme.PME).

class PME:
    """Particle Mesh Ewald, mirroring the reference class
    (pme/pme.py:52-196): stateless after construction. ``exclusions`` go
    to ``device`` (the tensors' device of later calls; the CUDA card
    unless the caller says otherwise)."""

    def __init__(self, gridx: int, gridy: int, gridz: int, order: int,
                 alpha: float, coulomb: float, exclusions, device=None):
        self.config = PMEConfig(gridx, gridy, gridz, order, alpha, coulomb)
        exclusions = np.asarray(exclusions, dtype=np.int32)
        if exclusions.ndim != 2:
            raise ValueError('exclusions must be 2D')
        self.exclusions = torch.as_tensor(exclusions,
                                          device=resolve_device(device))
        self.moduli = _Moduli(bspline_moduli(self.config.grid_shape, order))

    def _check(self, positions, charges):
        if positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError('positions must have shape (atoms, 3)')
        if charges.ndim != 1:
            raise ValueError('charges must be 1D')
        if (positions.shape[0] != self.exclusions.shape[0]
                or charges.shape[0] != self.exclusions.shape[0]):
            raise ValueError('positions, charges, and exclusions must all '
                             'have the same length')

    def compute_direct(self, positions: Tensor, charges: Tensor,
                       cutoff: float, box_vectors: Tensor,
                       max_num_pairs: int = -1, cell_list=None) -> Tensor:
        """Direct-space energy over the O(N^2) pair list (pme.py:131-165).
        ``cell_list`` (the JAX package's O(N) payload route) needs
        ``CellList.build_payload``, ROADMAP A.6, and raises."""
        self._check(positions, charges)
        if cutoff <= 0:
            raise ValueError('cutoff must be positive')
        if cell_list is not None:
            raise NotImplementedError(
                'compute_direct(cell_list=...) needs CellList.build_payload '
                '(ROADMAP A.6, not ported); use the pair list or the window '
                'path (plan_direct_window / compute_direct_window)')
        pairs = neighbor_pairs_masked(positions, cutoff, max_num_pairs,
                                      box_vectors)
        return pme_direct_energy(positions, charges, pairs, self.exclusions,
                                 self.config.alpha, self.config.coulomb)

    def plan_direct_window(self, box_vectors, cutoff: float, positions,
                           margin: float = 1.25, bucket: bool = False):
        """Host-side plan (cell grid, capacity[, small_cap, num_big]) of the
        window direct path from the true cell occupancy of ``positions``
        times ``margin`` (``ops.cuda_pme.plan_pme_window``). The box is
        validated here, on the host, once: the per-step call does not copy
        a CUDA box back to check it."""
        box = _host_array(box_vectors)
        validate_box(box, cutoff)
        return plan_pme_window(box, cutoff, _host_array(positions),
                               margin=margin, bucket=bucket)

    def compute_direct_window(self, positions: Tensor, charges: Tensor,
                              cutoff: float, box_vectors: Tensor,
                              window_plan, plain: bool = False) -> Tensor:
        """Direct-space energy through the window kernel (``ops.cuda_pme``,
        B.5), minus the exclusion compensation. ``window_plan`` from
        :meth:`plan_direct_window`; overflow of its capacity is observable
        through :meth:`direct_window_overflow`. A box on the host is
        validated; a CUDA box was validated at plan time. ``plain`` runs the
        kernel's plain PyTorch version on any device."""
        self._check(positions, charges)
        if cutoff <= 0:
            raise ValueError('cutoff must be positive')
        if box_vectors.device.type == 'cpu':
            validate_box(box_vectors, cutoff)
        energy = pme_direct_window(
            positions, charges, box_vectors, self.exclusions, cutoff,
            self.config.alpha, self.config.coulomb, *window_plan[:2],
            plain=plain)
        return energy - pme_exclusion_compensation(
            positions, charges, self.exclusions, self.config.alpha,
            self.config.coulomb)

    def direct_window_overflow(self, positions: Tensor, box_vectors: Tensor,
                               window_plan) -> Tensor:
        """TRUE max per-cell occupancy of the window direct path (a device
        scalar); for a bucketed 4-tuple plan the big-cell-count overflow is
        folded in as a value above the capacity."""
        return pme_window_overflow(positions, box_vectors, window_plan)

    def compute_reciprocal(self, positions: Tensor, charges: Tensor,
                           box_vectors: Tensor) -> Tensor:
        """Reciprocal-space energy including the self-energy term
        (pme.py:167-196)."""
        self._check(positions, charges)
        return (pme_self_energy(charges, self.config.alpha,
                                self.config.coulomb)
                + pme_reciprocal_energy(positions, charges, box_vectors,
                                        self.config, self.moduli))


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
