"""Real spherical harmonics, real Clebsch-Gordan coefficients and the bases
of MACE's symmetric contraction, for irreps of natural parity (0e, 1o, 2e,
3o: parity (-1)^l) up to ``LMAX`` = 3, the couplings' intermediates up to
l = 4.

* **Harmonics.** The real spherical harmonics Y_lm, m = -l .. l, of a unit
  vector (x, y, z), component-normalised (sum_m Y_lm^2 = 2l + 1):

      Y_lm = sqrt((2l + 1) (2 - delta_m0) (l - |m|)! / (l + |m|)!)
             * (d^|m| P_l / dz^|m|)(z) * {Re (x + iy)^m    m >= 0
                                          Im (x + iy)^|m|  m < 0}

  (no Condon-Shortley phase: Y_1 = sqrt(3) (y, z, x)). :func:`real_sph_harm`
  evaluates them in float64 numpy for any l (the tables' own use);
  :func:`spherical_harmonics` gives the 16 of l <= 3 on torch lanes as one
  product of the degree-l monomials of (x, y, z) with a coefficient table
  fitted once from :func:`real_sph_harm` (each r^l Y_lm is a homogeneous
  polynomial of degree l), differentiable by autograd.
* **Wigner D.** :func:`wigner_d`: the real D_l(R) with Y_l(R r) = D_l(R)
  Y_l(r), fitted by least squares from :func:`real_sph_harm` on fixed
  sample points.
* **Clebsch-Gordan.** :func:`wigner_3j`: the real Wigner 3j symbol, the
  unit-norm tensor of V_l1 (x) V_l2 (x) V_l3 invariant under D_l1 (x) D_l2
  (x) D_l3: the null vector of the constraints of three fixed rotations,
  its sign fixed so that its first entry (in (m1, m2, m3) order) of
  magnitude over 1e-6 is positive. :func:`clebsch_gordan` is it times
  sqrt(2 l3 + 1), e3nn's ``component`` normalisation of a tensor-product
  path: C^{l1 l2 l3}_{m1 m2 m3}.
* **Symmetric contraction bases.** :func:`symmetric_basis` (nu, L): an
  orthonormal basis U^{nu,L}_eta of the tensors of (R^16)^{(x) nu} -> V_L
  (16 = the components of 0e + 1o + 2e + 3o) that are equivariant, have
  output parity (-1)^L and are symmetric in the nu slots. Built from the
  coupling trees through C, in this order:

      nu = 1:  (l1) -> L                      l1 = L
      nu = 2:  (l1 (x) l2) -> L               l1, l2 = 0 .. 3
      nu = 3:  ((l1 (x) l2)_l12 (x) l3) -> L   l1, l2, l3 = 0 .. 3 (l3
               innermost of the three), l12 = |l1 - l2| .. l1 + l2
               (innermost of all)

  keeping the trees with l1 + .. + l_nu = L mod 2 that the triangle rule
  allows; each is symmetrised over the nu! slot permutations, then
  Gram-Schmidt in that order drops a residual of norm under 1e-9 and
  normalises the rest. The span is that of mace's ``U_matrix_real``; the
  basis differs from it by an orthogonal change of the weights' basis.

Every table is float64 numpy, built once and cached.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

LMAX = 3
DIM = (LMAX + 1) ** 2          # 16 components of 0e + 1o + 2e + 3o
DROP = 1e-9                    # Gram-Schmidt residual norm dropped


def block(l: int) -> slice:
    """The components of irrep ``l`` among the 16."""
    return slice(l * l, (l + 1) * (l + 1))


def _legendre_derivative(l: int, m: int) -> np.ndarray:
    """Coefficients, ascending powers of z, of d^m P_l / dz^m."""
    c = np.polynomial.legendre.leg2poly(np.eye(l + 1)[l])
    return np.polynomial.polynomial.polyder(c, m) if m else c


def real_sph_harm(l: int, xyz: np.ndarray) -> np.ndarray:
    """[..., 2l + 1] component-normalised real harmonics of unit vectors
    ``xyz`` [..., 3], float64."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    w = x + 1j * y
    out = []
    for m in range(-l, l + 1):
        a = abs(m)
        norm = math.sqrt((2 * l + 1) * (2 if a else 1) * math.factorial(l - a)
                         / math.factorial(l + a))
        q = np.polynomial.polynomial.polyval(z, _legendre_derivative(l, a))
        p = w ** a
        out.append(norm * q * (p.real if m >= 0 else p.imag))
    return np.stack(out, -1)


def _monomials(degree: int):
    """Exponents (a, b, c) of x^a y^b z^c with a + b + c = ``degree``."""
    return [(a, b, degree - a - b) for a in range(degree, -1, -1)
            for b in range(degree - a, -1, -1)]


def _sample_points(n: int = 64, seed: int = 7) -> np.ndarray:
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _harmonic_table() -> Tuple[Tuple[Tuple[int, int, int], ...], np.ndarray]:
    """(the monomials of degree 0 .. LMAX, coefficients [20, 16]): Y =
    monomials @ coefficients on the unit sphere, block-diagonal by
    degree."""
    pts = _sample_points(200, 11)
    monos = [e for l in range(LMAX + 1) for e in _monomials(l)]
    out = np.zeros((len(monos), DIM))
    row = 0
    for l in range(LMAX + 1):
        exps = _monomials(l)
        a = np.stack([pts[:, 0] ** i * pts[:, 1] ** j * pts[:, 2] ** k
                      for i, j, k in exps], 1)
        y = real_sph_harm(l, pts)
        coef, *_ = np.linalg.lstsq(a, y, rcond=None)
        if np.abs(a @ coef - y).max() > 1e-12:
            raise ArithmeticError(f'Y_{l} is no polynomial of degree {l}')
        out[row:row + len(exps), block(l)] = coef
        row += len(exps)
    return tuple(monos), out


@functools.lru_cache(maxsize=None)
def _harmonic_coefficients(dtype, device) -> Tensor:
    return torch.as_tensor(_harmonic_table()[1], dtype=dtype, device=device)


def spherical_harmonics(u: Tensor) -> Tensor:
    """[..., 16] the harmonics l = 0 .. 3 of unit vectors ``u`` [..., 3]
    (zero vectors give Y_00 = 1 and zeros), differentiable."""
    x, y, z = u.unbind(-1)
    powers = {(0, 0, 0): torch.ones_like(x)}
    for a, b, c in _harmonic_table()[0]:
        if (a, b, c) in powers:
            continue
        # Each monomial of degree l is one of degree l - 1 times x, y or z.
        if a:
            powers[a, b, c] = powers[a - 1, b, c] * x
        elif b:
            powers[a, b, c] = powers[a, b - 1, c] * y
        else:
            powers[a, b, c] = powers[a, b, c - 1] * z
    mono = torch.stack([powers[e] for e in _harmonic_table()[0]], -1)
    return mono @ _harmonic_coefficients(u.dtype, u.device)


def rotation(seed: int) -> np.ndarray:
    """A random proper rotation [3, 3] from ``seed``."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def wigner_d(l: int, rot: np.ndarray) -> np.ndarray:
    """[2l + 1, 2l + 1] the real D_l of the rotation ``rot``: Y_l(rot r) =
    D_l Y_l(r)."""
    pts = _sample_points()
    dt, *_ = np.linalg.lstsq(real_sph_harm(l, pts),
                             real_sph_harm(l, pts @ np.asarray(rot).T),
                             rcond=None)
    return dt.T


def _fix_sign(c: np.ndarray) -> np.ndarray:
    first = c.reshape(-1)[np.flatnonzero(np.abs(c.reshape(-1)) > 1e-6)[0]]
    return c if first > 0 else -c


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """[2l1 + 1, 2l2 + 1, 2l3 + 1] the real Wigner 3j symbol (unit
    Frobenius norm; zeros off the triangle rule)."""
    shape = (2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return np.zeros(shape)
    size = int(np.prod(shape))
    rows = []
    for seed in (1, 2, 3):
        rot = rotation(seed)
        k = np.kron(np.kron(wigner_d(l1, rot), wigner_d(l2, rot)),
                    wigner_d(l3, rot))
        rows.append(k - np.eye(size))
    _, s, vt = np.linalg.svd(np.concatenate(rows))
    if not (s[-1] < 1e-10 and (size == 1 or s[-2] > 1e-3)):
        raise ArithmeticError(f'no unique invariant of {l1} {l2} {l3}: '
                              f'singular values {s[-2:]}')
    c = vt[-1].reshape(shape)
    return _fix_sign(c / np.linalg.norm(c))


def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """C^{l1 l2 l3} = the real 3j times sqrt(2 l3 + 1)."""
    return wigner_3j(l1, l2, l3) * math.sqrt(2 * l3 + 1)


def _trees(nu: int, big_l: int):
    """The coupling trees (lists of 'l's, tensor [16]*nu + [2L + 1]) of
    ``symmetric_basis``, in its order."""
    ls = range(LMAX + 1)
    if nu == 1:
        if big_l <= LMAX:
            t = np.zeros((DIM, 2 * big_l + 1))
            t[block(big_l)] = np.eye(2 * big_l + 1)
            yield t
        return
    if nu == 2:
        for l1, l2 in itertools.product(ls, ls):
            if (l1 + l2 - big_l) % 2 or not abs(l1 - l2) <= big_l <= l1 + l2:
                continue
            t = np.zeros((DIM, DIM, 2 * big_l + 1))
            t[block(l1), block(l2)] = clebsch_gordan(l1, l2, big_l)
            yield t
        return
    if nu != 3:
        raise ValueError(f'correlation order {nu} is not built (1 .. 3)')
    for l1, l2, l3 in itertools.product(ls, ls, ls):
        if (l1 + l2 + l3 - big_l) % 2:
            continue
        for l12 in range(abs(l1 - l2), l1 + l2 + 1):
            if not abs(l12 - l3) <= big_l <= l12 + l3:
                continue
            t = np.zeros((DIM, DIM, DIM, 2 * big_l + 1))
            t[block(l1), block(l2), block(l3)] = np.einsum(
                'abk,kcm->abcm', clebsch_gordan(l1, l2, l12),
                clebsch_gordan(l12, l3, big_l))
            yield t


@functools.lru_cache(maxsize=None)
def symmetric_basis(nu: int, big_l: int) -> np.ndarray:
    """[16]*nu + [2L + 1, n] U^{nu,L}: the orthonormal, slot-symmetric,
    equivariant basis (see the module docstring), float64."""
    basis = []
    perms = list(itertools.permutations(range(nu)))
    for t in _trees(nu, big_l):
        sym = sum(np.transpose(t, p + (nu,)) for p in perms) / len(perms)
        v = sym.reshape(-1)
        for _ in range(2):
            for b in basis:
                v = v - (b @ v) * b
        norm = float(np.linalg.norm(v))
        if norm >= DROP:
            basis.append(v / norm)
    shape = (DIM,) * nu + (2 * big_l + 1,)
    if not basis:
        return np.zeros(shape + (0,))
    return np.stack(basis, -1).reshape(shape + (len(basis),))
