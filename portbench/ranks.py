"""A cell over several ranks, one process and one card a rank: the
launcher and the ranks' agreement.  ``run.py``'s docstring gives the
contract; ``harness.run_cell`` takes a :class:`Team` for its part of it.
"""
from __future__ import annotations

import datetime
import gc
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import socket
import sys
import time
import traceback

GROUP_TIMEOUT_S = 600          # the longest any collective may wait
DEADLINE_S = 600               # a run's ranks end this long past --seconds
GRACE_S = 10                   # from SIGTERM to SIGKILL


class Team:
    """This rank's place among the run's ranks, and the harness's gloo
    group over which they agree (the program's collectives go over the
    program's own group).  The default, a team of one, is a run in one
    process: each agreement is with itself.  ``note`` tells the launcher
    which phase the rank is in, so that its report names where a rank
    sat when a run failed or passed its deadline."""

    def __init__(self, rank: int = 0, size: int = 1, group=None,
                 conn=None):
        self.rank, self.size, self.group = rank, size, group
        self._conn = conn

    def note(self, phase: str) -> None:
        if self._conn is not None:
            self._conn.send(("phase", phase))

    def bcast(self, obj):
        """Rank 0's ``obj``, on every rank."""
        if self.size == 1:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj`` in rank order, on every rank."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.size == 1:
            return
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def first(self, fn):
        """``fn()`` on rank 0, then on the others: what rank 0 builds
        (the kernel library on a fresh checkout) the others find built."""
        out = fn() if self.rank == 0 else None
        self.barrier()
        return fn() if self.rank else out


def control(cell):
    """The control of ``cell`` (the plain reference in the precision below
    the configuration's) as a program: a factory a rank can unpickle."""
    from . import spec
    ref = spec.load_module(cell.reference, "reference")
    return ref.control(cell.sizes, cell.traffic)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, size: int, port: int, job: dict, conn) -> None:
    """One rank: join the program's group and the harness's, make each run
    of ``job``, send the launcher rank 0's result of each (None from the
    others) with the JAX modules this rank has loaded, and exit once the
    launcher says every rank is done.  It ends without the interpreter's
    clean-up, which can wait on the groups' teardown: by then every
    collective has completed on every rank."""
    code = 0
    try:
        conn.send(("phase", "imports"))
        import torch
        import torch.distributed as dist
        from torch.distributed import distributed_c10d as c10d

        from cfftpack_tpu_torch.parallel import init_distributed

        from . import harness, spec
        cuda = job["device"] == "cuda"
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cuda and have < size:
            print(f"portbench: {job['cell'].name} needs {size} CUDA card(s), "
                  f"found {have}; not measuring", file=sys.stderr)
            code = 2
            return
        conn.send(("phase", "join"))
        init_distributed(f"localhost:{port}", size, rank,
                         device=job["device"])
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        if hasattr(c10d, "_set_pg_timeout"):     # the program's group
            c10d._set_pg_timeout(timeout)
        group = dist.new_group(backend="gloo", timeout=timeout)
        team = Team(rank, size, group, conn)
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        for i, (seed, factory) in enumerate(job["runs"]):
            team.note(f"set-up of run {i}")
            program = factory(job["cell"]) if factory is not None else None
            r = harness.run_cell(job["cell"], seed, job["seconds"],
                                 job["trace"], device, job["t0"],
                                 program=program, team=team)
            conn.send(("run", i, r, spec.forbidden_modules(sys.modules)))
            del r, program
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        conn.send(("done",))
        conn.recv()                              # every rank is done
    except Exception:
        traceback.print_exc()
        code = 1
    finally:
        # no clean-up: an exit that ran it could wait on a collective in
        # flight, or on the teardown of the groups
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _end(procs) -> None:
    """End every rank still running, and wait for each."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(GRACE_S)
        if p.is_alive():
            p.kill()
            p.join()


def launch(cell, runs, seconds: float, trace: bool, t0: float,
           device: str = "cuda", deadline_s: float | None = None,
           on_result=None) -> int:
    """Make ``runs`` ([(seed, program factory or None)]) of ``cell`` over
    ``cell.chips`` rank processes.  ``on_result(index, result, found)``
    gets rank 0's result of each run once every rank has reported it,
    with the JAX modules any rank had loaded.  Returns 0 once every rank
    has made every run, 2 where a rank found too few cards, else 1
    (a rank failed, or the deadline passed); every rank is ended and
    waited for either way."""
    ctx = mp.get_context("spawn")
    job = {"cell": cell, "runs": list(runs), "seconds": seconds,
           "trace": trace, "t0": t0, "device": device}
    port = _free_port()
    deadline = time.monotonic() + (seconds + DEADLINE_S if deadline_s is None
                                   else deadline_s)
    procs, conns, reports, done = [], {}, {}, 0
    phase = ["start"] * cell.chips
    finished = set()

    def fail(why: str) -> int:
        print(f"portbench: {cell.name}: {why}; ending every rank (phases: "
              + ", ".join(f"rank {r} {p}" for r, p in enumerate(phase))
              + ")", file=sys.stderr)
        return 1

    try:
        for r in range(cell.chips):
            mine, theirs = ctx.Pipe()
            p = ctx.Process(target=_rank, name=f"portbench-rank{r}",
                            args=(r, cell.chips, port, job, theirs))
            p.start()
            theirs.close()
            procs.append(p)
            conns[mine] = r
        while len(finished) < cell.chips:
            left = deadline - time.monotonic()
            if left <= 0:
                return fail("past its deadline")
            for ready in mpc.wait(list(conns) + [p.sentinel for p in procs],
                                  timeout=left):
                if ready not in conns:
                    continue
                r = conns[ready]
                try:
                    msg = ready.recv()
                except EOFError:
                    del conns[ready]
                    continue
                if msg[0] == "phase":
                    phase[r] = msg[1]
                elif msg[0] == "done":
                    phase[r] = "done"
                    finished.add(r)
                else:
                    _, i, result, found = msg
                    got = reports.setdefault(i, {})
                    got[r] = (result, found)
                    if len(got) == cell.chips:
                        done += 1
                        if on_result is not None:
                            on_result(i, got[0][0], sorted(
                                set().union(*(f for _, f in got.values()))))
            codes = [p.exitcode for p in procs]
            if 2 in codes:
                return 2
            bad = [(r, c) for r, c in enumerate(codes)
                   if c is not None and r not in finished]
            if bad:
                return fail(f"rank {bad[0][0]} exited {bad[0][1]}")
        for c in conns:
            try:
                c.send("exit")
            except OSError:                      # that rank has gone
                pass
        for p in procs:
            p.join(GRACE_S)
    finally:
        _end(procs)
        for c in conns:
            c.close()
    return 0 if done == len(job["runs"]) else 1
