from .ani import ANIModel, ANIParams, init_ani_params, species_from_atomic_numbers
