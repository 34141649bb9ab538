"""One process per rank: spawn a world of ranks and join it.

``spawn(fn, world, args)`` starts ``world`` fresh interpreters
(``torch.multiprocessing``, the spawn method), joins each to one
``torch.distributed`` world through a ``FileStore`` in a temporary
directory, and runs ``fn(rank, world, *args)`` in each: the same host
program on every rank (SPMD). The backend is chosen by topology
(``communicator_pool.world_backend``). Every rank starts with one
``PYTHONHASHSEED``, since prompts and request seeds come from Python's
salted ``hash`` of the request id. The join has a deadline: a rank that
misses a collective hangs its group, so a run that outlives ``timeout``
is killed and raises ``TimeoutError`` instead of hanging its caller.
Each rank runs in a process group of its own, so a terminal's Ctrl-C
reaches the launcher alone: with ``forward_signals`` its SIGINT or
SIGTERM goes on to rank 0 (a server's graceful stop) and the ranks get
``STOP_GRACE_S`` to exit; otherwise it stops the launcher, which kills
the ranks.
"""
from __future__ import annotations

import os
import shutil
import signal
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.communicator_pool import world_backend

STOP_GRACE_S = 120.0    # the ranks' time to drain after a stop signal


def _entry(rank: int, fn: Callable, world: int, init_method: str,
           device_type: str, threads: Optional[int], args: tuple) -> None:
    """A rank's process: join the world (on the card, as ``cuda:(rank %
    device_count)``), run ``fn``, leave."""
    os.setpgrp()
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(world_backend(device, world),
                            init_method=init_method, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), *,
          device_type: str, timeout: Optional[float] = 600.0,
          hash_seed: str = "0", threads: Optional[int] = None,
          on_start: Optional[Callable] = None,
          forward_signals: bool = False) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks and wait
    for all of them. ``fn`` must be importable by the children (a
    module-level function). ``device_type`` ("cuda" or "cpu") has no
    default: the caller names where the ranks run. Raises if a rank
    raises or dies, and ``TimeoutError`` (after killing every rank) past
    ``timeout`` seconds (None: no deadline). ``on_start`` gets the
    ranks' pids. ``forward_signals`` (from the main thread) passes a
    SIGINT or SIGTERM on to rank 0 as SIGINT and then allows the ranks
    ``STOP_GRACE_S`` to exit; a second signal stops the wait."""
    tmp = tempfile.mkdtemp(prefix="ranks-")
    init = "file://" + os.path.join(tmp, "store")
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = hash_seed
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, world, init, device_type, threads,
                          tuple(args)),
            nprocs=world, join=False, start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = saved
    if on_start is not None:
        on_start([p.pid for p in ctx.processes])
    deadline = None if timeout is None else time.monotonic() + timeout
    stop_by = None
    saved = {}

    def forward(signum, frame):
        nonlocal stop_by
        if stop_by is not None:
            raise KeyboardInterrupt
        stop_by = time.monotonic() + STOP_GRACE_S
        os.kill(ctx.processes[0].pid, signal.SIGINT)

    if forward_signals:
        saved = {s: signal.signal(s, forward)
                 for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        while True:
            ends = [d for d in (deadline, stop_by) if d is not None]
            wait = None if not ends else \
                max(min(ends) - time.monotonic(), 0.0)
            if forward_signals:
                # a signal's handler cannot shorten a wait in progress
                wait = 1.0 if wait is None else min(wait, 1.0)
            if ctx.join(timeout=wait):
                break
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                raise TimeoutError(
                    f"{world} ranks still running after {timeout:.0f} s "
                    f"(a missed collective?)")
            if stop_by is not None and now >= stop_by:
                raise TimeoutError(
                    f"{world} ranks still running {STOP_GRACE_S:.0f} s after "
                    f"the stop signal")
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
