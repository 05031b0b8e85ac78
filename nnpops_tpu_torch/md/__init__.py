from .integrators import (MDState, initialize, langevin_baoab, velocity_verlet,  # noqa: F401
                          run_md, run_md_sticky, run_md_sticky_counts,
                          kinetic_energy, OverflowStats)
from .checkpoint import (save_checkpoint, load_checkpoint,  # noqa: F401
                         save_checkpoint_distributed,
                         load_checkpoint_distributed)
