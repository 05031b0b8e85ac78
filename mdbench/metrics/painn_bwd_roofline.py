"""``painn_bwd_roofline``: the least time of one force evaluation's PaiNN
message-backward work over the device seconds a force evaluation of the
kernel that does it (``csrc/painn_bwd.cu``).

The work is what any forces-only backward of the message must do for every
directed pair inside rc, in every block, as FP32 FLOP (an FMA two; the
configuration is true float32): the lane's and its mirrored entry's
elementwise work, ``PAIR_BWD_PER_F`` F + ``PAIR_BWD_PER_R`` R
(``mdbench/reference/painn_cell_list.py``), and the filter product's
input-side adjoint, R x 3F FMA (6 R F), at the FP32 peak. Computing the
filter W again is left out, since a design may load it instead. The device
seconds are the operations whose names hold ``painn_bwd`` in the trace's
breakdown of the profiled stretch's device operations (its ten costliest),
over the stretch's force spans. None where the cell counts no PaiNN pairs
or the kernel is not among those ten (a program without it)."""
from mdbench.reference.painn_cell_list import PAIR_BWD_PER_F, PAIR_BWD_PER_R
from mdbench.work import PEAKS

KERNEL = 'painn_bwd'


def least_seconds(counts: dict) -> float:
    f, r = counts['width'], counts['radial']
    flop = counts['interactions'] * counts['painn_pairs'] * (
        PAIR_BWD_PER_F * f + PAIR_BWD_PER_R * r + 6 * r * f)
    return flop / PEAKS['fp32_flops']


def read(ctx):
    if 'painn_pairs' not in ctx.counts:
        return None
    ops = (ctx.trace.get('breakdown') or {}).get('device_ops', ())
    device_s = sum(s for name, s in ops if KERNEL in name)
    _, forces = ctx.trace.get('span_device', {}).get('force', (0, 0))
    if not device_s or not forces:
        return None
    return 100.0 * least_seconds(ctx.counts) / (device_s / forces)
