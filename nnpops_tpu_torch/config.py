"""Frozen configuration dataclasses (the port's copy of what it needs from
``nnpops_tpu.config``).

The port keeps its own copy so that it imports nothing of the JAX package.
``tests/test_torch_config.py`` holds the copies equal to the JAX package's,
field by field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ANIBasis:
    """The ANI symmetry-function basis: per-function (eta, rs) radial and
    (eta, rs, zeta, theta) angular parameters, the two cutoffs and the
    ``torchani`` flag (radial functions / 4, angle dot product * 0.95)."""
    num_species: int
    radial_cutoff: float
    angular_cutoff: float
    radial_eta: Tuple[float, ...]
    radial_rs: Tuple[float, ...]
    angular_eta: Tuple[float, ...]
    angular_rs: Tuple[float, ...]
    angular_zeta: Tuple[float, ...]
    angular_thetas: Tuple[float, ...]
    torchani: bool = True
    # The factor grids of a single-eta/zeta product grid rs x thetas (set by
    # from_grids); the angular kernel evaluates the two factors separately.
    angular_rs_grid: Optional[Tuple[float, ...]] = None
    angular_thetas_grid: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        n = len(self.radial_eta)
        if not (len(self.radial_rs) == n):
            raise ValueError('radial parameter lists must have equal length')
        m = len(self.angular_eta)
        if not (len(self.angular_rs) == m == len(self.angular_zeta)
                == len(self.angular_thetas)):
            raise ValueError('angular parameter lists must have equal length')

    @property
    def num_radial(self) -> int:
        return len(self.radial_eta)

    @property
    def num_angular(self) -> int:
        return len(self.angular_eta)

    @property
    def num_species_pairs(self) -> int:
        s = self.num_species
        return s * (s + 1) // 2

    @property
    def radial_length(self) -> int:
        return self.num_species * self.num_radial

    @property
    def angular_length(self) -> int:
        return self.num_species_pairs * self.num_angular

    @property
    def aev_length(self) -> int:
        return self.radial_length + self.angular_length

    @classmethod
    def from_grids(cls, num_species: int, Rcr: float, Rca: float,
                   EtaR, ShfR, EtaA, Zeta, ShfA, ShfZ,
                   torchani: bool = True) -> 'ANIBasis':
        """Expand TorchANI-style parameter grids into flat function lists:
        radial = EtaR x ShfR, angular = EtaA x Zeta x ShfA x ShfZ (this
        order defines the AEV layout)."""
        r_eta, r_rs = [], []
        for eta in EtaR:
            for rs in ShfR:
                r_eta.append(float(eta))
                r_rs.append(float(rs))
        a_eta, a_rs, a_zeta, a_ts = [], [], [], []
        for eta in EtaA:
            for zeta in Zeta:
                for rs in ShfA:
                    for ts in ShfZ:
                        a_eta.append(float(eta))
                        a_rs.append(float(rs))
                        a_zeta.append(float(zeta))
                        a_ts.append(float(ts))
        grid_kwargs = {}
        if len(EtaA) == 1 and len(Zeta) == 1:
            grid_kwargs = dict(
                angular_rs_grid=tuple(float(x) for x in ShfA),
                angular_thetas_grid=tuple(float(x) for x in ShfZ))
        return cls(num_species=num_species, radial_cutoff=float(Rcr),
                   angular_cutoff=float(Rca),
                   radial_eta=tuple(r_eta), radial_rs=tuple(r_rs),
                   angular_eta=tuple(a_eta), angular_rs=tuple(a_rs),
                   angular_zeta=tuple(a_zeta), angular_thetas=tuple(a_ts),
                   torchani=torchani, **grid_kwargs)

    @classmethod
    def ani2x(cls, torchani: bool = True) -> 'ANIBasis':
        """The ANI-2x basis: 7 species, 16 radial x 32 angular functions,
        Rcr = 5.1 A, Rca = 3.5 A."""
        ShfR = np.linspace(0.8, 5.1, 17)[:16]
        ShfA = np.linspace(0.8, 3.5, 9)[:8]
        ShfZ = (np.arange(4) + 0.5) * (math.pi / 4.0)
        return cls.from_grids(7, 5.1, 3.5, EtaR=[19.7], ShfR=ShfR,
                              EtaA=[12.5], Zeta=[14.1], ShfA=ShfA, ShfZ=ShfZ,
                              torchani=torchani)


# ANI-2x supported elements in species order (H, C, N, O, S, F, Cl).
ANI2X_ELEMENTS: Tuple[int, ...] = (1, 6, 7, 8, 16, 9, 17)

# Hidden-layer widths of the ANI-2x atomic networks per species, in the order
# of ANI2X_ELEMENTS: aev -> h1 -> h2 -> h3 -> 1 with CELU(0.1) between.
ANI2X_LAYER_DIMS: Tuple[Tuple[int, ...], ...] = (
    (256, 192, 160),   # H
    (224, 192, 160),   # C
    (192, 160, 128),   # N
    (192, 160, 128),   # O
    (160, 128, 96),    # S
    (160, 128, 96),    # F
    (160, 128, 96),    # Cl
)


@dataclasses.dataclass(frozen=True)
class CFConvConfig:
    """SchNet continuous-filter convolution configuration
    (schnet/CFConv.h:125-137)."""
    width: int
    num_gaussians: int
    cutoff: float
    gaussian_width: float
    activation: str = 'ssp'   # 'ssp' (shifted softplus) or 'tanh'

    def __post_init__(self):
        if self.activation not in ('ssp', 'tanh'):
            raise ValueError("activation must be 'ssp' or 'tanh'")

    @property
    def gaussian_positions(self) -> np.ndarray:
        """Gaussian centers uniformly spaced on [0, cutoff]
        (CpuCFConv.cpp:121-122), float32."""
        g = self.num_gaussians
        return np.arange(g, dtype=np.float32) * (self.cutoff / (g - 1))


@dataclasses.dataclass(frozen=True)
class PaiNNConfig:
    """PaiNN's widths (Schütt, Unke and Gastegger, ICML 2021; SchNetPack's
    ``PaiNN``): ``width`` features F of the scalar and vector states,
    ``num_radial`` radial functions sin(n pi d / rc) / d, n = 1 ..
    num_radial, and the cosine ``cutoff`` rc. The port has no JAX twin of
    it."""
    width: int = 128
    num_radial: int = 20
    cutoff: float = 5.0

    def __post_init__(self):
        if self.width < 1 or self.num_radial < 1:
            raise ValueError('width and num_radial must be positive')
        if self.cutoff <= 0:
            raise ValueError('cutoff must be positive')


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    """MACE's widths (Batatia et al., NeurIPS 2022; ACEsuit/mace ``MACE``),
    by default MACE-OFF23 medium's (Kovacs et al., arXiv:2312.15211):
    ``channels`` F of every irrep, harmonics to ``l_max`` (3: the port's
    tables), hidden node features to ``hidden_l`` (1: 128x0e + 128x1o),
    the symmetric contraction's ``correlation`` order (3: body order 4),
    ``num_radial`` Bessel functions under the polynomial cutoff of power
    ``cutoff_p`` at ``cutoff`` rc, the radial networks' hidden widths
    ``radial_mlp``, the last readout's hidden width ``readout_hidden``, and
    the messages' divisor ``avg_num_neighbors``. The port has no JAX twin
    of it."""
    channels: int = 128
    l_max: int = 3
    hidden_l: int = 1
    correlation: int = 3
    num_radial: int = 8
    cutoff_p: int = 5
    cutoff: float = 5.0
    radial_mlp: Tuple[int, ...] = (64, 64, 64)
    readout_hidden: int = 16
    avg_num_neighbors: float = 1.0

    def __post_init__(self):
        if self.channels < 1 or self.num_radial < 1 or self.readout_hidden < 1:
            raise ValueError('channels, num_radial and readout_hidden must '
                             'be positive')
        if self.l_max != 3 or self.correlation != 3 or \
                self.hidden_l not in (0, 1):
            raise ValueError('the port builds l_max 3, correlation 3 and '
                             'hidden_l 0 or 1')
        if self.cutoff <= 0 or self.cutoff_p < 1 or \
                self.avg_num_neighbors <= 0:
            raise ValueError('cutoff, cutoff_p and avg_num_neighbors must be '
                             'positive')
        object.__setattr__(self, 'radial_mlp', tuple(self.radial_mlp))


@dataclasses.dataclass(frozen=True)
class PMEConfig:
    """Particle Mesh Ewald configuration (pme/pme.py:52-92)."""
    gridx: int
    gridy: int
    gridz: int
    order: int
    alpha: float
    coulomb: float

    def __post_init__(self):
        if min(self.gridx, self.gridy, self.gridz) < 1:
            raise ValueError('The grid dimensions must be positive')
        if self.order < 1:
            raise ValueError('order must be positive')
        if self.alpha <= 0:
            raise ValueError('alpha must be positive')
        if self.coulomb <= 0:
            raise ValueError('coulomb must be positive')

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.gridx, self.gridy, self.gridz)
