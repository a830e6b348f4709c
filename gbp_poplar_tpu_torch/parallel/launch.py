"""Start the ranks of a sharded run: the counterpart of the JAX package's
``make_mesh``.

``run(fn, n, args, device_type)`` runs ``fn(rank, *args)`` on ``n`` ranks
of one ``torch.distributed`` process group: rank 0 in this process (so
what it prints goes where this process prints, and a caller that captures
its output captures rank 0's), ranks 1 .. n-1 in processes started with
the ``spawn`` method (never ``fork``: this process may hold a CUDA
context). Rank r runs on ``cuda:(r % cards)``, or on the CPU for
``device_type="cpu"``; by default on the device the drivers take (the CPU
under ``GBP_PLATFORM=cpu``, else the cards; an error when there is none).
The backend is NCCL when every rank has a card of its own and gloo
otherwise (the CPU, or ranks sharing a card).

Every collective has a deadline (``timeout``): a rank that waits longer
raises instead of hanging. A rank's exception ends the run: ``run``
raises, with the failing ranks' tracebacks, and stops every process it
started.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue as queue_lib
import sys
import time
import traceback

import torch
import torch.distributed as dist

HOST = "127.0.0.1"
# seconds a rank waits for a collective (and for the others to start)
TIMEOUT = 120.0


@dataclasses.dataclass(frozen=True)
class Rank:
    """What ``fn`` is given: its rank, the rank count, its device and the
    process group (pass ``group`` to the sharded solvers)."""

    rank: int
    world: int
    device: torch.device
    group: object


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(n: int, device_type: str) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if device_type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _join(rank, world, store, backend, device, timeout, fn, args):
    """Set up rank ``rank``'s process group, run ``fn``, tear it down."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        return fn(Rank(rank, world, device, dist.group.WORLD), *args)
    finally:
        dist.destroy_process_group()


def _child(rank, world, port, backend, device_type, timeout, threads, fn,
           args, results):
    """The body of a spawned rank: its result or traceback goes to the
    parent through ``results``."""
    try:
        torch.set_num_threads(threads)
        store = dist.TCPStore(HOST, port, world, False,
                              timeout=datetime.timedelta(seconds=timeout))
        out = _join(rank, world, store, backend,
                    rank_device(rank, device_type), timeout, fn, args)
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise SystemExit(1)


def run(fn, n: int, args=(), device_type: str | None = None,
        timeout: float = TIMEOUT) -> list:
    """Run ``fn(Rank, *args)`` on ``n`` ranks (see the module docstring);
    returns their results in rank order. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function). ``device_type``: "cuda", "cpu", or
    None for ``drivers.common.select_device``'s choice. CPU ranks share
    this process's threads evenly."""
    if device_type is None:
        from ..drivers.common import select_device
        device_type = select_device().type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("parallel.run: no CUDA device")
    backend = backend_for(n, device_type)
    devices = [rank_device(r, device_type) for r in range(n)]
    print(f"launch: {n} ranks on {', '.join(str(d) for d in devices)}, "
          f"backend {backend}", file=sys.stderr)
    if device_type == "cuda":
        from ..ops import _cuda
        _cuda.library()            # built once, before the ranks load it
    store = dist.TCPStore(HOST, 0, n, True,
                          timeout=datetime.timedelta(seconds=timeout),
                          wait_for_workers=False)
    threads = torch.get_num_threads()
    share = max(1, threads // n)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True, args=(
        r, n, store.port, backend, device_type, timeout, share, fn, args,
        results)) for r in range(1, n)]
    for p in procs:
        p.start()
    out = [None] * n
    failures = {}
    failed0 = None
    torch.set_num_threads(share)
    try:
        out[0] = _join(0, n, store, backend, devices[0], timeout, fn, args)
    except BaseException as e:           # reported with the others' below
        failed0 = e
    finally:
        torch.set_num_threads(threads)
    # drain before joining; after a failure here, wait only briefly
    deadline = time.monotonic() + (10.0 if failed0 else timeout)
    for _ in procs:
        try:
            r, tb, res = results.get(
                timeout=max(0.1, deadline - time.monotonic()))
        except queue_lib.Empty:
            break
        if tb is None:
            out[r] = res
        else:
            failures[r] = tb
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    missing = [r for r, p in enumerate(procs, 1)
               if r not in failures and p.exitcode != 0]
    if isinstance(failed0, (KeyboardInterrupt, SystemExit)):
        raise failed0
    if failed0 is not None or failures or missing:
        lines = [f"rank {r} failed:\n{tb}" for r, tb in sorted(failures.items())]
        lines += [f"rank {r} ended without a result" for r in missing]
        if failed0 is not None:
            lines.insert(0, f"rank 0 failed: {failed0!r}")
        raise RuntimeError("sharded run failed\n" + "\n".join(lines)) \
            from failed0
    return out
