"""Host utilities (port of ``nnpops_tpu.utils``): water-box builders
(``water``), molecule file loaders (``io``), TorchANI npz import and export
(``torchani_io``) and step timing, tracing and MD drift monitoring
(``profiling``). All are the port's own copies; none imports the JAX
package."""
from .io import Molecule, load_mol2, load_pdb
from .water import (TIP3P_CHARGES, WaterBox, make_triclinic_water_box,
                    make_water_box)

__all__ = ['Molecule', 'TIP3P_CHARGES', 'WaterBox', 'load_mol2', 'load_pdb',
           'make_triclinic_water_box', 'make_water_box']
