"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 mdbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the workload of ``BENCHMARK.json`` (a configuration and a
traffic mix); everything else is found by name under ``mdbench/``. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with the
reference beside its limit (also the last lines of standard error). With
no CUDA card, too few cards, or JAX loaded once the window has closed, it
prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Kernel and build caches at fixed paths inside the checkout.
for _var, _sub in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('CUDA_CACHE_PATH', 'cuda')):
    os.environ[_var] = str(ROOT / '.mdbench_cache' / _sub)
os.environ['USE_FLAX'] = '0'
sys.path[0] = str(ROOT)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nnpops_tpu')


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line(torch) -> dict:
    """The card's name and power limit (nvidia-smi), printed with every
    run."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        limit = f'nvidia-smi failed: {exc}'
    return {'kind': name, 'nvidia_smi': limit}


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if args.workload not in cells:
        log(f'no workload {args.workload!r} in BENCHMARK.json')
        return 2
    cell = cells[args.workload]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        log(f'this cell needs {cell["chips"]} CUDA card(s); found '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
            ': no result')
        return 3
    card = card_line(torch)
    log(f'card: {card["kind"]}; nvidia-smi name, power.limit: '
        f'{card["nvidia_smi"]}')

    from mdbench import harness
    cfg = harness.load_json('configs', cell['config'])
    traffic = harness.load_json('traffic', cell['traffic'])

    per_layer, end_to_end = bench['per_layer'], bench['end_to_end']
    out = harness.run_cell(cfg, traffic, args.seed, args.seconds,
                           bool(args.trace), 'cuda', T_START,
                           per_layer=[m['name'] for m in per_layer], log=log)

    correct, checks = harness.verdict(cfg, out)
    if out['failures']:
        log(f'failed blocks (first {len(out["failures"])}): '
            f'{out["failures"]}')
    if args.trace:
        metrics = {m['name']: {'value': out['per_layer'][m['name']],
                               'unit': m['unit']}
                   for m in per_layer if m['name'] in out['per_layer']}
    else:
        metrics = {m['name']: {'value': out[m['name']], 'unit': m['unit']}
                   for m in end_to_end}
    device = {'platform': 'gpu', 'kind': card['kind'],
              'count': cell['chips'],
              'memory_peak_bytes': out['memory_peak_bytes']}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': device}
    if args.trace:
        device['busy_s'] = out['busy_s']
        device['window_s'] = out['window_s']
        result['breakdown'] = out['breakdown']
        log(f'breakdown: {json.dumps(out["breakdown"])}')
    found = forbidden_modules()
    if found:
        log(f'loaded in this process, which the benchmark forbids: {found}; '
            'no result')
        return 4
    result['checks'] = checks
    for name, c in checks.items():
        log(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
