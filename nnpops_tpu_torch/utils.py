"""System builders (the counterpart of ``nnpops_tpu.utils``).

The water boxes are host numpy and are shared with the JAX package rather
than copied: ``nnpops_tpu.utils.water`` imports no JAX.
"""
from nnpops_tpu.utils.water import (WaterBox, make_triclinic_water_box,
                                    make_water_box)

__all__ = ['WaterBox', 'make_triclinic_water_box', 'make_water_box']
