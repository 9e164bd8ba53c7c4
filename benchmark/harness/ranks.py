"""The ranks of a cell that spans cards: rank 0 is the run's own process
(the one run.py measures, traces and checks for JAX), ranks 1..n-1 are
workers it spawns, one process a card.

Every rank joins one process group through the program's
``parallel/multihost.initialize`` at a ``file://`` store in a fresh
temporary directory, so no port is fixed.  Rank 0 tells the workers what
to do over pipes, never by a collective on the cards: the trace of rank 0
holds the program's collectives alone.  A worker runs the driver's
``Worker`` (the driver loaded by path, as run.py loads it): each message
but the last is one call of ``Worker.handle``; at ``stop`` the worker
sends back ``Worker.stop()``, leaves the group with the others (a barrier,
then ``destroy_process_group``) and exits 0.

A watchdog thread in rank 0 ends the process with :data:`WATCHDOG_EXIT`
and no result where a worker exits before it is told to, or where a
phase that waits on the other ranks (joining the group, a call, leaving
it) outlasts its deadline: a dead rank or an NCCL call that never returns
cannot leave the command waiting.  A worker exits where rank 0's process
is gone (:data:`ORPHAN_EXIT`), or after a failure with a code of its own:
1 for an exception, 4 where it loaded JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import importlib.util
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback

WATCHDOG_EXIT = 5
ORPHAN_EXIT = 3
FORBIDDEN_EXIT = 4
JOIN_S = 180.0  # the workers start Python, torch and the program, then join
CALL_S = 50.0  # one call of every rank, or leaving the group
POLL_S = 0.25  # the watchdog's look at the workers and the deadline


class Ranks:
    """Rank 0's side: spawns ``n - 1`` workers running ``driver_path``'s
    ``Worker(rank, n, args)``, joins the group with them, and watches them
    until :meth:`close`."""

    def __init__(self, n: int, driver_path: str, args: dict):
        from simglucose_tpu_torch.parallel import multihost

        self.tmp = tempfile.mkdtemp(prefix="ranks-")
        self.conns, self.procs = [], []
        self._deadline = time.monotonic() + JOIN_S
        self._leaving = False  # the workers were told to stop: their exits are due
        self._closed = False
        self._joined = False
        ctx = mp.get_context("spawn")
        store = os.path.join(self.tmp, "store")
        try:
            for r in range(1, n):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_worker, args=(driver_path, r, n, store, theirs, args),
                                name=f"rank{r}", daemon=True)
                p.start()
                theirs.close()
                self.conns.append(mine)
                self.procs.append(p)
            threading.Thread(target=self._watch, name="ranks-watchdog", daemon=True).start()
            multihost.initialize(f"file://{store}", world_size=n, rank=0)
            self._joined = True
        except BaseException:
            self.close()
            raise
        self._deadline = None

    @contextlib.contextmanager
    def waiting(self):
        """A phase that waits on the other ranks: the watchdog ends the
        process if it lasts more than :data:`CALL_S`."""
        self._deadline = time.monotonic() + CALL_S
        try:
            yield
        finally:
            self._deadline = None

    def tell(self, msg) -> None:
        """Send ``msg`` to every worker."""
        for c in self.conns:
            c.send(msg)

    def stop(self) -> list:
        """Each worker's ``Worker.stop()``, in rank order; then every rank
        leaves the group and the workers are joined.  The ranks are closed
        afterwards, whatever happened."""
        import torch.distributed as dist

        if self._closed:
            raise RuntimeError("the ranks were closed already")
        try:
            with self.waiting():
                self.tell(("stop",))
                out = [c.recv() for c in self.conns]
                self._leaving = True
                dist.barrier()
                dist.destroy_process_group()
                self._joined = False
                for p in self.procs:
                    p.join(CALL_S)
            bad = [(p.name, p.exitcode) for p in self.procs if p.exitcode != 0]
        finally:
            self.close()
        if bad:
            raise RuntimeError(f"workers exited badly: {bad}")
        return out

    def close(self) -> None:
        """Kill what is left of the workers, leave the group, stop the
        watchdog and remove the store: safe to call again, and after a
        failure."""
        if self._closed:
            return
        self._leaving = True
        self._closed = True
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        for c in self.conns:
            c.close()
        if self._joined:
            import torch.distributed as dist

            self._joined = False
            if dist.is_initialized():
                dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _watch(self):
        while not self._closed:
            if self._leaving:
                time.sleep(POLL_S)
            else:
                mp.connection.wait([p.sentinel for p in self.procs], POLL_S)
                dead = [(p.name, p.exitcode) for p in self.procs if p.exitcode is not None]
                if dead and not self._leaving and not self._closed:
                    self._abort(f"a worker exited during the run: {dead}")
            deadline = self._deadline
            if deadline is not None and time.monotonic() > deadline and not self._closed:
                self._abort("a phase that waits on every rank outlasted its deadline "
                            "(a rank is blocked in a collective)")

    def _abort(self, why: str):
        print(f"benchmark: {why}; ending every rank", file=sys.stderr, flush=True)
        for p in self.procs:
            if p.is_alive():
                p.kill()
        os._exit(WATCHDOG_EXIT)


def _load(path: str):
    spec = importlib.util.spec_from_file_location("benchmark.drivers._rank", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _orphan_watch():
    """Exit once rank 0's process is gone, wherever this one is waiting."""
    mp.parent_process().join()
    os._exit(ORPHAN_EXIT)


def _worker(driver_path: str, rank: int, n: int, store: str, conn, args: dict):
    """A worker's whole life: join, serve rank 0's messages, leave."""
    import torch

    torch.set_num_threads(1)
    threading.Thread(target=_orphan_watch, daemon=True).start()
    try:
        import torch.distributed as dist

        from benchmark.run import forbidden_loaded
        from simglucose_tpu_torch.parallel import multihost

        multihost.initialize(f"file://{store}", world_size=n, rank=rank)
        worker = _load(driver_path).Worker(rank, n, args)
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            worker.handle(msg)
        if forbidden_loaded():
            print(f"rank {rank}: loaded {forbidden_loaded()}", file=sys.stderr, flush=True)
            os._exit(FORBIDDEN_EXIT)
        conn.send(worker.stop())
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
