"""MACE's two operations of a layer (Batatia et al., NeurIPS 2022,
arXiv:2206.07697; ACEsuit/mace ``blocks.py``, ``symmetric_contraction.py``)
as autograd Functions with hand-written, scatter-free adjoints.

**The equivariant message** (:func:`mace_message`). For every lane (i, l)
of the symmetric full neighbor list, j = ``indices[i, l]``, with the
lane's harmonics Y [16] (``so3.spherical_harmonics`` of its unit vector)
and radial basis e [R] (zero on a padded lane and past the cutoff), the
radial network R = MLP(e) [P, F] (SiLU, no biases: exactly zero where e
is) weights each path p = (l1, l2 -> l3) of ``message_paths``:

    m_i^p[k, m3] = sum_l R_p,k sum_{m1 m2} C^{l1 l2 l3}_{m1 m2 m3}
                   h_j[k, l1 m1] Y_l2 m2

* **Forward**: in row chunks of ``chunk_rows`` rows, so that each [rows,
  K, w F] lane temporary stays at or under ``CHUNK_BYTES`` (1 GiB; w the
  plan's ``lane_width``). The lanes are reduced before the Clebsch-Gordan
  product: X = R_p h_j [rows, K, sum_p (2 l1 + 1) F] over all paths (one
  broadcast product an l1), then Z = Y^T X, one batched product [rows, 16,
  K] x [rows, K, ...], then m^p = C Z per atom on Z's l2 rows. No [lanes,
  paths x F x (2 l3 + 1)] message tensor is built.
* **Saved**: the per-atom h and the payload (Y, e and the indices); the
  lane tensors are computed again in the backward.
* **Backward**: each row on its own. With dZ = C g on each path's l2
  rows (zero elsewhere), its lanes give the cotangents of their Y (X
  dZ^T) and e (the radial network's adjoint by autograd inside the
  chunk, of dR = sum_m1 (Y dZ) h_j); its own atom's dh comes from the
  cotangents g of the atoms in its row: the list is symmetric, the
  mirrored lane has the same length, so the same R, and Y_l2(-r) =
  (-1)^l2 Y_l2(r), so

      dh_j[k, m1] = sum_l sum_p R_p,k(l) sum_m3 g_i(l)^p[k, m3] G_p[m1, m3]
      G_p[m1, m3] = (-1)^l2 sum_m2 C_m1m2m3 Y_m2(l),

  one batched product a chunk of (R g_i) [rows, F, K x sum_p (2 l3 + 1)]
  by G [rows, ..., 2 l1 + 1] (G = Y @ a constant table). No
  ``index_add``, no scatter, no atomics.
* **Lanes**: padded lanes and the lanes of a Verlet skin give exactly
  zero, forward and backward (e and so R are exactly zero there; e's own
  ``where`` stops its cotangent).

**The symmetric contraction** (:func:`symmetric_contraction`): per atom,
of its A [F, 16] (0e + 1o + 2e + 3o),

    B[k, LM] = sum_nu sum_eta W_nu,L[z, eta, k]
               sum_{m1 .. m_nu} U^{nu,L}_eta[m1 .. m_nu, M] prod_xi A[k, m_xi]

with U from ``so3.symmetric_basis``. The atoms are grouped by species and
T_nu = U^nu W_nu[z] is folded once a species; each group runs in chunks
of ``contraction_rows`` atoms, nested as mace nests it:
o = T_3 A + T_2, o2 = o A + T_1, B = o2 A (never a [16, 16, 16, F] tensor
an atom). T_nu is symmetric in its slots, so the backward is the same
nesting with T_3, T_2, T_1 scaled by 3, 2, 1: dA = g . (3 T_3 A A + 2 T_2
A + T_1). Only A is saved; the grouping is a gather there and back (the
inverse permutation), never a scatter.

**Weights**: neither Function computes weight gradients. The MD path
needs none; a weight that requires one raises, rather than being dropped.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import COUNTERS
from . import so3
from .cuda_cfconv import _pad_row, _row_chunks

Tensor = torch.Tensor

# Bytes a lane temporary of the message, or a per-atom temporary of the
# contraction, may take.
CHUNK_BYTES = 1 << 30


def _silu_norm() -> float:
    """1 / sqrt(E[silu(z)^2]) for z ~ N(0, 1) (e3nn's ``normalize2mom`` of
    SiLU, here by 200-point Gauss-Hermite quadrature): 1.6790..."""
    x, w = np.polynomial.hermite_e.hermegauss(200)
    second = np.sum(w * (x / (1.0 + np.exp(-x))) ** 2) / math.sqrt(2 * math.pi)
    return float(1.0 / math.sqrt(second))


SILU_NORM = _silu_norm()


def silu_n(x: Tensor) -> Tensor:
    """SiLU rescaled to a unit second moment under a unit normal input."""
    return SILU_NORM * torch.nn.functional.silu(x)


class Path(NamedTuple):
    l1: int     # of the node features
    l2: int     # of the harmonics
    l3: int     # of the message


def message_paths(l_in: Sequence[int], lmax: int = so3.LMAX
                  ) -> Tuple[Path, ...]:
    """The tensor product's paths in e3nn's order (l1, then l2, then l3
    ascending): every l3 <= ``lmax`` that the triangle rule and parity
    ((-1)^(l1 + l2) = (-1)^l3) allow. 4 from (0,), 10 from (0, 1)."""
    return tuple(Path(l1, l2, l3) for l1 in l_in for l2 in range(lmax + 1)
                 for l3 in range(abs(l1 - l2), min(l1 + l2, lmax) + 1)
                 if (l1 + l2 + l3) % 2 == 0)


class Plan(NamedTuple):
    """The message's layout for one set of paths (path ids q index
    ``paths``; every width is in units of F)."""
    paths: Tuple[Path, ...]
    width_in: int                   # sum over l1 of 2 l1 + 1 (h's components)
    l1_ranges: Tuple[Tuple[int, int, int], ...]   # (l1, first q, last q + 1)
    x_off: Tuple[int, ...]          # each path's first column of X
    x_width: int                    # sum over paths of 2 l1 + 1
    by_l3: Tuple[Tuple[int, ...], ...]      # path ids, for each l3
    g_off: Tuple[int, ...]          # each path's first row of the packed g
    g_width: int                    # sum over paths of 2 l3 + 1
    lane_width: int                 # the widest lane temporary


@functools.lru_cache(maxsize=None)
def plan(paths: Tuple[Path, ...]) -> Plan:
    l_in = sorted({p.l1 for p in paths})
    if l_in != list(range(len(l_in))) or [p.l1 for p in paths] != sorted(
            p.l1 for p in paths):
        raise ValueError(f'node features must hold l = 0 .. n, the paths '
                         f'ordered by l1: {paths}')
    ranges = tuple((l1, min(q for q, p in enumerate(paths) if p.l1 == l1),
                    max(q for q, p in enumerate(paths) if p.l1 == l1) + 1)
                   for l1 in l_in)
    x_off = tuple(int(np.sum([2 * p.l1 + 1 for p in paths[:q]], dtype=int))
                  for q in range(len(paths)))
    by_l3 = tuple(tuple(q for q, p in enumerate(paths) if p.l3 == l)
                  for l in range(so3.LMAX + 1))
    g_off, row = [0] * len(paths), 0
    for group in by_l3:
        for q in group:
            g_off[q] = row
            row += 2 * paths[q].l3 + 1
    x_width = sum(2 * p.l1 + 1 for p in paths)
    return Plan(paths, sum(2 * l + 1 for l in l_in), ranges, x_off, x_width,
                by_l3, tuple(g_off), row, max(len(paths), x_width, row))


def chunk_rows(k: int, width: int, lane_width: int, itemsize: int = 4) -> int:
    """Atom rows a chunk of the message takes: the most whose [rows, K,
    lane_width x F] lane temporaries stay at or under ``CHUNK_BYTES`` (at
    least one). 655 at K 80, F 128 and the 10 paths of layer 2 (lane width
    40: the packed cotangents of the mirrored messages), float32."""
    return max(1, CHUNK_BYTES // (k * lane_width * width * itemsize))


@functools.lru_cache(maxsize=None)
def _cg(path: Path, dtype, device) -> Tensor:
    return torch.as_tensor(so3.clebsch_gordan(*path), dtype=dtype,
                           device=device)


@functools.lru_cache(maxsize=None)
def _mirror_table(pl: Plan, dtype, device) -> Tensor:
    """[16, g_width x width_in]: the lane's G[(p, m3), m1] = (-1)^l2
    sum_m2 C^p_{m1 m2 m3} Y_m2 as Y @ this table."""
    t = np.zeros((so3.DIM, pl.g_width, pl.width_in))
    for q, p in enumerate(pl.paths):
        c = so3.clebsch_gordan(*p) * (-1.0) ** p.l2
        t[so3.block(p.l2), pl.g_off[q]:pl.g_off[q] + 2 * p.l3 + 1,
          so3.block(p.l1)] = np.transpose(c, (1, 2, 0))
    return torch.as_tensor(t.reshape(so3.DIM, -1), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _by_l3_order(pl: Plan, device) -> Tensor:
    return torch.as_tensor([q for g in pl.by_l3 for q in g], device=device)


def _mlp(e: Tensor, weights: Sequence[Tensor]) -> Tensor:
    """e3nn's ``FullyConnectedNet`` on pre-scaled weights: SiLU (rescaled)
    between the layers, none after the last, no biases."""
    x = e
    for w in weights[:-1]:
        x = silu_n(x @ w)
    return x @ weights[-1]


def _gather(table: Tensor, idx: Tensor) -> Tensor:
    r, k = idx.shape
    return table.index_select(0, idx.reshape(-1)).view(r, k,
                                                       *table.shape[1:])


def _x_lanes(pl: Plan, r: Tensor, hj: Tensor) -> Tensor:
    """X [rows, K, x_width x F]: each path's R_p h_j[l1], (m1, F) in its
    columns, one broadcast product an l1."""
    rows, k, _, f = r.shape
    parts = [(r[:, :, q0:q1, None, :], hj[:, :, None, so3.block(l1)])
             for l1, q0, q1 in pl.l1_ranges]
    if torch.is_grad_enabled() and (r.requires_grad or hj.requires_grad):
        # The oracle's path: differentiable, one copy more.
        return torch.cat([(a * b).reshape(rows, k, -1) for a, b in parts], -1)
    x = r.new_empty(rows, k, pl.x_width * f)
    col = 0
    for a, b in parts:
        n = a.shape[2] * b.shape[3] * f
        torch.mul(a, b, out=x[..., col:col + n].view(rows, k, a.shape[2],
                                                     b.shape[3], f))
        col += n
    return x


def _rows_forward(pl: Plan, h_pad: Tensor, y: Tensor, e: Tensor,
                  idx: Tensor, weights) -> list:
    """The messages m^p [rows, F, 2 l3 + 1] of a block of rows, one a
    path; ``h_pad`` [N + 1, width_in, F] ends in a zero row."""
    rows, k = idx.shape
    f = h_pad.shape[2]
    r = _mlp(e, weights).view(rows, k, len(pl.paths), f)
    z = torch.bmm(y.transpose(1, 2), _x_lanes(pl, r, _gather(h_pad, idx)))
    out = []
    for q, p in enumerate(pl.paths):
        a, b = 2 * p.l1 + 1, 2 * p.l2 + 1
        zp = z[:, so3.block(p.l2), pl.x_off[q] * f:(pl.x_off[q] + a) * f]
        out.append(torch.einsum('rbak,abc->rkc', zp.view(rows, b, a, f),
                                _cg(p, zp.dtype, zp.device)))
    return out


def _rows_backward(pl: Plan, h_pad, g_pad, g_rows, y, e, idx, weights):
    """(dy [rows, K, 16], de [rows, K, R], dh [rows, F, width_in]) of a
    block of rows: their lanes' Y and e cotangents, and their own atoms' h
    cotangents from the mirrored lanes, read through their own lanes.
    ``g_pad`` [N + 1, g_width, F] packs every atom's message cotangents,
    ``g_rows`` the rows' own, per path [rows, F, 2 l3 + 1]."""
    rows, k = idx.shape
    f = h_pad.shape[2]
    dtype, dev = h_pad.dtype, h_pad.device
    hj = _gather(h_pad, idx)
    with torch.enable_grad():
        e_leaf = e.detach().requires_grad_(True)
        r_graph = _mlp(e_leaf, weights)
    r = r_graph.detach().view(rows, k, len(pl.paths), f)
    # dZ [rows, 16, x_width F]: each path's (C g_p) in its l2 rows.
    dz = h_pad.new_zeros(rows, so3.DIM, pl.x_width * f)
    for q, p in enumerate(pl.paths):
        a, b = 2 * p.l1 + 1, 2 * p.l2 + 1
        dz[:, so3.block(p.l2), pl.x_off[q] * f:(pl.x_off[q] + a) * f] = \
            torch.einsum('abc,rkc->rbak', _cg(p, dtype, dev),
                         g_rows[q]).reshape(rows, b, a * f)
    dy = torch.bmm(_x_lanes(pl, r, hj), dz.transpose(1, 2))
    dx = torch.bmm(y, dz)
    dr = torch.empty_like(r)
    for l1, q0, q1 in pl.l1_ranges:
        a = 2 * l1 + 1
        dxl = dx[..., pl.x_off[q0] * f:pl.x_off[q1 - 1] * f + a * f]
        dr[:, :, q0:q1] = torch.sum(
            dxl.view(rows, k, q1 - q0, a, f) * hj[:, :, None, so3.block(l1)],
            3)
    (de,) = torch.autograd.grad(r_graph, e_leaf, dr.view(rows, k, -1))
    # The mirrored lanes: Q = R_p g_i^p over (p, m3) against G(Y).
    gj = _gather(g_pad, idx)                      # [rows, K, g_width, F]
    r_l3 = r.index_select(2, _by_l3_order(pl, dev))
    row = first = 0
    for group in pl.by_l3:
        if group:
            c3 = 2 * pl.paths[group[0]].l3 + 1
            gj[:, :, row:row + len(group) * c3].view(
                rows, k, len(group), c3, f).mul_(
                    r_l3[:, :, first:first + len(group), None, :])
            row += len(group) * c3
            first += len(group)
    g_lane = (y.reshape(rows * k, so3.DIM) @ _mirror_table(pl, dtype, dev)
              ).view(rows, k * pl.g_width, pl.width_in)
    dh = torch.bmm(gj.view(rows, k * pl.g_width, f).transpose(1, 2), g_lane)
    return dy, de, dh


def _per_path(pl: Plan, grads) -> list:
    """Each path's [N, F, 2 l3 + 1] of the per-l3 tensors ``grads``."""
    out = [None] * len(pl.paths)
    for l3, group in enumerate(pl.by_l3):
        for slot, q in enumerate(group):
            out[q] = grads[l3][:, slot]
    return out


class MACEMessage(torch.autograd.Function):
    """The messages of one layer, one tensor an l3; see the module
    docstring."""

    @staticmethod
    def forward(ctx, h, y, e, idx, weights, pl, rows_per_chunk):
        n, f = h.shape[0], h.shape[1]
        idx = idx.long()
        h_pad = _pad_row(h.transpose(1, 2))              # [N + 1, width_in, F]
        outs = [h.new_empty(n, len(g), f, 2 * l3 + 1)
                for l3, g in enumerate(pl.by_l3)]
        for s in _row_chunks(n, rows_per_chunk):
            ms = _rows_forward(pl, h_pad, y[s], e[s], idx[s], weights)
            for l3, group in enumerate(pl.by_l3):
                for slot, q in enumerate(group):
                    outs[l3][s, slot] = ms[q]
        ctx.save_for_backward(h_pad, y, e, idx)
        ctx.weights, ctx.pl, ctx.rows_per_chunk = weights, pl, rows_per_chunk
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        h_pad, y, e, idx = ctx.saved_tensors
        pl = ctx.pl
        n = idx.shape[0]
        grads = [torch.zeros_like(out) if g is None else g
                 for g, out in zip(grads, (
                     h_pad.new_empty(n, len(gr), h_pad.shape[2], 2 * l3 + 1)
                     for l3, gr in enumerate(pl.by_l3)))]
        per_path = _per_path(pl, grads)
        g_pad = _pad_row(torch.cat([per_path[q].transpose(1, 2)
                                    for group in pl.by_l3 for q in group], 1))
        dy, de = torch.empty_like(y), torch.empty_like(e)
        dh = h_pad.new_empty(n, h_pad.shape[2], h_pad.shape[1])
        for s in _row_chunks(n, ctx.rows_per_chunk):
            dy[s], de[s], dh[s] = _rows_backward(
                pl, h_pad, g_pad, [g[s] for g in per_path], y[s], e[s],
                idx[s], ctx.weights)
        return dh, dy, de, None, None, None, None


def mace_message(h: Tensor, y: Tensor, e: Tensor, indices: Tensor,
                 weights: Sequence[Tensor], paths: Tuple[Path, ...],
                 rows_per_chunk: Optional[int] = None) -> Tuple[Tensor, ...]:
    """One layer's messages: for each l3 = 0 .. 3, [N, paths of l3, F, 2 l3
    + 1], from the node features ``h`` [N, F, sum (2 l1 + 1)] over the
    lanes (harmonics ``y`` [N, K, 16], radial basis ``e`` [N, K, R],
    ``indices`` padded with N) of a symmetric full neighbor list, with the
    radial network's pre-scaled ``weights`` (the last [H, P x F]).
    ``rows_per_chunk`` defaults to ``chunk_rows``. The lanes go into
    ``COUNTERS['mace_lanes']``."""
    if any(w.requires_grad for w in weights):
        raise RuntimeError(
            'mace_message computes no weight gradients (the MD path needs '
            'none); its radial weights must not require grad')
    pl = plan(tuple(paths))
    if h.shape[2] != pl.width_in or weights[-1].shape[1] != len(
            pl.paths) * h.shape[1]:
        raise ValueError(f'h {tuple(h.shape)} and the radial output '
                         f'{tuple(weights[-1].shape)} do not fit the paths '
                         f'{pl.paths}')
    COUNTERS['mace_lanes'] += indices.numel()
    if rows_per_chunk is None:
        rows_per_chunk = chunk_rows(indices.shape[1], h.shape[1],
                                    pl.lane_width, h.element_size())
    return MACEMessage.apply(h, y, e, indices, tuple(weights), pl,
                             rows_per_chunk)


def message_plain(h, y, e, indices, weights, paths) -> Tuple[Tensor, ...]:
    """:func:`mace_message` by autograd through its forward, unchunked: the
    adjoint tests' oracle."""
    pl = plan(tuple(paths))
    ms = _rows_forward(pl, _pad_row(h.transpose(1, 2)), y, e,
                       indices.long(), weights)
    return tuple(torch.stack([ms[q] for q in g], 1) for g in pl.by_l3)


# ---- The symmetric contraction.


def contraction_rows(width: int, outputs: int, itemsize: int = 4) -> int:
    """Atoms a chunk of the contraction takes: the most whose [F, atoms,
    outputs x 256] temporary stays at or under ``CHUNK_BYTES``. 2,048 at F
    128 and outputs 4 (0e + 1o) in float32."""
    return max(1, CHUNK_BYTES // (width * outputs * so3.DIM ** 2 * itemsize))


@functools.lru_cache(maxsize=None)
def _basis(nu: int, big_l: int, dtype, device) -> Tensor:
    return torch.as_tensor(so3.symmetric_basis(nu, big_l), dtype=dtype,
                           device=device)


def fold(outputs: Sequence[int], weights, species: int, dtype, device
         ) -> Tuple[Tensor, Tensor, Tensor]:
    """(T1 [F, M, 16], T2 [F, M, 16, 16], T3 [F, 16, M x 256]) of one
    species: T_nu = sum_eta U^{nu,L}_eta W_nu,L[species, eta], the
    ``outputs`` L concatenated along M; ``weights[i][nu - 1]`` [E, n, F]
    are those of ``outputs[i]``."""
    t = {1: [], 2: [], 3: []}
    for big_l, w_l in zip(outputs, weights):
        if len(w_l) != 3:
            raise ValueError('the contraction is built for correlation 3')
        for nu, w in enumerate(w_l, start=1):
            t[nu].append(torch.einsum('...Mn,nc->c...M',
                                      _basis(nu, big_l, dtype, device),
                                      w[species]))
    t1 = torch.cat(t[1], -1).permute(0, 2, 1)              # [F, M, 16]
    t2 = torch.cat(t[2], -1).permute(0, 3, 1, 2)           # [F, M, a, b]
    t3 = torch.cat(t[3], -1)                               # [F, a, b, d, M]
    f, m = t3.shape[0], t3.shape[-1]
    # [F, d, (M, a, b)]: the first product contracts the last slot.
    t3 = t3.permute(0, 3, 4, 1, 2).reshape(f, so3.DIM, m * so3.DIM ** 2)
    return t1.contiguous(), t2.contiguous(), t3.contiguous()


def _nest(x: Tensor, t1: Tensor, t2: Tensor, t3: Tensor) -> Tensor:
    """o2 [F, n, M, 16] = (T3 x + T2) x + T1 for x [F, n, 16]."""
    f, n = x.shape[:2]
    m = t1.shape[1]
    o = torch.bmm(x, t3).view(f, n, m * so3.DIM, so3.DIM)
    o = o + t2.view(f, 1, m * so3.DIM, so3.DIM)
    o2 = torch.matmul(o, x[..., None]).view(f, n, m, so3.DIM)
    return o2 + t1[:, None]


class SymmetricContraction(torch.autograd.Function):
    """B [N, F, M] from A [N, F, 16]; see the module docstring."""

    @staticmethod
    def forward(ctx, a, tables, groups, inverse, rows):
        parts = []
        for (t1, t2, t3), idx in zip(tables, groups):
            x = a.index_select(0, idx).transpose(0, 1).contiguous()
            for s in _row_chunks(x.shape[1], rows):
                o2 = _nest(x[:, s], t1, t2, t3)
                parts.append(torch.matmul(o2, x[:, s, :, None])[..., 0]
                             .transpose(0, 1))
        ctx.save_for_backward(a)
        ctx.tables, ctx.groups, ctx.inverse, ctx.rows = (tables, groups,
                                                         inverse, rows)
        return torch.cat(parts).index_select(0, inverse)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        parts = []
        for (t1, t2, t3), idx in zip(ctx.tables, ctx.groups):
            x = a.index_select(0, idx).transpose(0, 1).contiguous()
            gx = g.index_select(0, idx).transpose(0, 1)
            for s in _row_chunks(x.shape[1], ctx.rows):
                o2 = _nest(x[:, s], t1, 2.0 * t2, 3.0 * t3)
                parts.append(torch.matmul(gx[:, s, None, :], o2)[:, :, 0]
                             .transpose(0, 1))
        return (torch.cat(parts).index_select(0, ctx.inverse), None, None,
                None, None)


def symmetric_contraction(a: Tensor, outputs: Sequence[int], weights,
                          groups: Sequence[Tuple[int, Tensor]],
                          inverse: Tensor) -> Tensor:
    """B [N, F, M] of A [N, F, 16]: the ``outputs`` L concatenated (M = sum
    2L + 1), with ``weights[i][nu - 1]`` [E, n, F] the weights of
    U^{nu,L} (``so3.symmetric_basis``) for L = ``outputs[i]``. ``groups``: (species, its atoms' indices) of each
    species present, in the order that ``inverse`` (each atom's place in
    the concatenated groups) undoes. The atom-channel pairs go into
    ``COUNTERS['mace_contractions']``."""
    if any(w.requires_grad for w_l in weights for w in w_l):
        raise RuntimeError(
            'symmetric_contraction computes no weight gradients (the MD '
            'path needs none); its weights must not require grad')
    n, f = a.shape[0], a.shape[1]
    COUNTERS['mace_contractions'] += n * f
    tables = tuple(fold(outputs, weights, s, a.dtype, a.device)
                   for s, _ in groups)
    m = tables[0][0].shape[1]
    return SymmetricContraction.apply(
        a, tables, tuple(idx for _, idx in groups), inverse,
        contraction_rows(f, m, a.element_size()))
