"""``cfconv_bwd_roofline``: the least time of the B.6 kernel's
(``csrc/cfconv_bwd.cu``) essential work in one force evaluation over its
device seconds a force evaluation.

The work is what a force needs of the conv's backward: for every directed
pair inside the cutoff, in every interaction, the input and distance
cotangents' four filter products (the filter's rbf W1 and act W2 computed
again, d_act = d_y1 W2^T, d_rbf = d_h W1^T), each counted once at the
bf16 tensor peak: 4 (G W + W^2) FLOP a pair, the weight gradients (which
MD never uses) left out. The device seconds are the kernels whose names
hold ``cfconv_bwd`` in the trace's breakdown of the profiled stretch's
device operations, over the stretch's force spans. That breakdown holds
only the ten costliest operations, so the kernel's partial-sum reduction
(``cfconv_bwd_reduce``, well below the tenth) is not counted and the
reading is that much high; and the metric reads None, as where B.6 did
not run or the cell counts no CFConv pairs, once B.6 itself falls out of
those ten."""
from mdbench.work import PEAKS

KERNEL = 'cfconv_bwd'


def least_seconds(counts: dict) -> float:
    w, g = counts['width'], counts['gaussians']
    flop = counts['interactions'] * counts['cfconv_pairs'] * 4 * (g * w
                                                                  + w * w)
    return flop / PEAKS['bf16_tensor_flops']


def read(ctx):
    if 'cfconv_pairs' not in ctx.counts:
        return None
    ops = (ctx.trace.get('breakdown') or {}).get('device_ops', ())
    device_s = sum(s for name, s in ops if KERNEL in name)
    _, forces = ctx.trace.get('span_device', {}).get('force', (0, 0))
    if not device_s or not forces:
        return None
    return 100.0 * least_seconds(ctx.counts) / (device_s / forces)
