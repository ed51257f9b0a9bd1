"""Start one process a device on this machine, as ``torchrun`` would.

``launch(fn, n, *args)`` runs ``fn(*args)`` in ``n`` fresh interpreters
(the ``spawn`` start method), each with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and a ``file://`` rendezvous in a temporary directory
(``GCPNET_INIT_METHOD``: no TCP port, so that several launches can run at
once on one machine) and the loopback interface for gloo's and NCCL's
sockets unless set (all ranks are on this machine, which may have no
network to resolve its own name on), and returns rank 0's result.  A process that raises
ends the run: the others are stopped (they would wait in a collective for
ever) and its traceback is raised here.  ``fn`` and ``args`` must pickle.
Runs over several machines take an external launcher, which sets the same
variables.
"""

from __future__ import annotations

import faulthandler
import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

from gcpnet_torch.parallel.group import INIT_METHOD_ENV


def _child(fn: Callable, args: tuple, rank: int, world: int, workdir: str, timeout: Optional[float]) -> None:
    os.environ.update(
        RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
        **{INIT_METHOD_ENV: "file://" + os.path.join(workdir, "store")},
    )
    for name in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(name, "lo")
    if timeout is not None:  # a process still running near the end prints where it is
        faulthandler.dump_traceback_later(0.9 * timeout)
    import torch
    import torch.distributed as dist

    # the machine's CPU threads, shared among the processes
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        result = ("ok", fn(*args))
    except Exception:  # reported to the launcher, which raises it
        result = ("error", traceback.format_exc())
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result if rank == 0 or result[0] == "error" else ("ok", None), f)
    if result[0] == "error":
        # at once: tearing the group down could wait for ever on a peer
        # blocked in a collective
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


def _status(workdir: str, rank: int):
    """What rank ``rank`` wrote before it exited: ``("ok", result)`` or
    ``("error", traceback)``; ``None`` if it wrote nothing."""
    path = os.path.join(workdir, f"rank{rank}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def launch(fn: Callable, nprocs: int, *args, timeout: Optional[float] = None) -> Any:
    """``fn(*args)`` on ranks ``0 .. nprocs - 1`` of this machine; rank 0's
    result.  ``timeout`` seconds (none by default) bound the whole run.

    A process's end is read from its sentinel and its outcome from the file
    it wrote, not from its exit code, which another part of the program
    may have reaped first (``is_alive`` then never turns false)."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gcpnet_launch_") as workdir:
        procs = [ctx.Process(target=_child, args=(fn, args, rank, nprocs, workdir, timeout)) for rank in range(nprocs)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        running = {p.sentinel: rank for rank, p in enumerate(procs)}
        failed = None
        try:
            while running and failed is None:
                left = None if deadline is None else max(0.0, deadline - time.monotonic())
                ended = multiprocessing.connection.wait(list(running), timeout=left)
                if not ended:
                    raise TimeoutError(f"launch: {nprocs} processes ran over {timeout} s "
                                       f"(ranks still running: {sorted(running.values())})")
                for sentinel in ended:
                    rank = running.pop(sentinel)
                    status = _status(workdir, rank)
                    if status is None or status[0] != "ok":
                        failed = rank
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        if failed is not None:
            errors = [f"rank {r}:\n{st[1]}" for r in range(nprocs) if (st := _status(workdir, r)) and st[0] == "error"]
            raise RuntimeError(
                f"rank {failed} of {nprocs} failed (exit code {procs[failed].exitcode}):\n" + "\n".join(errors)
            )
        return _status(workdir, 0)[1]
