"""Start SPMD ranks: one process per device, one default process group.

:func:`process_group` initialises the group of one process through a
``file://`` rendezvous in a temporary directory (no port to collide with
another run) and destroys it on exit; :func:`run_spmd` starts
``world_size`` such processes with ``torch.multiprocessing`` (spawn),
runs ``fn(*args)`` on each and returns their results in rank order.

Spawned ranks import ``fn`` by its module, so it must be a module-level
function of an importable module that pulls in no more than the rank
needs (the rank functions of ``nnpops_tpu_torch.dryrun``). Each rank runs
torch on one thread. The group carries a timeout and so does the wait for
the ranks: a rank that hangs in a collective fails the call instead of
hanging it, and the other ranks are terminated.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 300.0


@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world_size: int = 1,
                  init_file: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """The default process group for the enclosed block: ``backend``
    'nccl' on the card, 'gloo' on the CPU; ``init_file`` the rendezvous
    file every rank names (a fresh temporary one for a group of one)."""
    with contextlib.ExitStack() as stack:
        if init_file is None:
            if world_size != 1:
                raise ValueError('a group of several ranks needs the '
                                 'init_file they share')
            init_file = os.path.join(
                stack.enter_context(tempfile.TemporaryDirectory()),
                'rendezvous')
        dist.init_process_group(
            backend, init_method='file://' + init_file, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank: int, world_size: int, backend: str, init_file: str,
               timeout_s: float, fn: Callable, args, results) -> None:
    torch.set_num_threads(1)
    if backend == 'nccl':
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        with process_group(backend, rank, world_size, init_file, timeout_s):
            out = fn(*args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))


def run_spmd(fn: Callable, world_size: int, backend: str = 'gloo', *args,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one process
    group; returns each rank's result (picklable) in rank order. Raises
    RuntimeError with the failing ranks' tracebacks, or TimeoutError when
    the ranks have not all finished within ``timeout_s``; either way no
    rank is left running."""
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    outs, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, 'rendezvous')
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, backend, init_file,
                                   timeout_s, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(outs) + len(errors) < world_size and not errors:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f'ranks {sorted(set(range(world_size)) - set(outs))}'
                            f' did not finish within {timeout_s} s')
                    if not any(p.is_alive() for p in procs):
                        # Every rank has exited: take what they left.
                        try:
                            rank, ok, out = results.get(timeout=5.0)
                        except queue.Empty:
                            break
                    else:
                        continue
                (outs if ok else errors)[rank] = out
        finally:
            # Ranks that reported exit on their own; the others (a failure
            # elsewhere, a timeout) are terminated at once.
            for p in procs:
                p.join(timeout=10.0 if len(outs) == world_size else 0.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError('\n'.join(f'rank {r} failed:\n{tb}'
                                     for r, tb in sorted(errors.items())))
    missing = sorted(set(range(world_size)) - set(outs))
    if missing:
        raise RuntimeError(f'ranks {missing} exited without a result '
                           f'(exit codes {[p.exitcode for p in procs]})')
    return [outs[r] for r in range(world_size)]
