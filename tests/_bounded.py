"""Time limits for tests that wait on another process or a thread.

A test that waits without a limit cannot fail by itself when what it waits
on hangs: it holds its pytest worker until the suite's own clock cuts the
whole run. ``subprocess.run(..., timeout=...)`` is not enough either, since
it kills only the child it started; a child's own children (the worker
interpreters of a multi-process dryrun) outlive it and keep the cores busy.

* :func:`run_bounded` runs a command in a session of its own and, at the
  limit, kills its whole process group.
* :func:`bounded_call` runs a blocking call on a daemon thread and raises
  if it has not returned by the limit.
* :func:`kill_workers` kills a process pool's workers, so that a pool
  whose result never came can be shut down without waiting on them.

Rank processes go through ``_torch_ranks.Ranks.join``, which has a limit
of its own.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading


def run_bounded(args, limit: float, **kw) -> subprocess.CompletedProcess:
    """``subprocess.run(args, capture_output=True, text=True, **kw)``, with
    the child in a new session. Past ``limit`` seconds the child's process
    group (the child and every process it started that kept the group) is
    killed and ``TimeoutError`` raised with the tail of its output."""
    with subprocess.Popen(args, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True, **kw) as proc:
        try:
            out, err = proc.communicate(timeout=limit)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            raise TimeoutError(
                f"{args!r} still running after {limit} s; its process group "
                f"was killed\nstdout:\n{out[-4000:]}\nstderr:\n{err[-4000:]}"
            ) from None
        except BaseException:
            # in its own session the child misses the terminal's ^C, and
            # leaving the ``with`` waits for it
            os.killpg(proc.pid, signal.SIGKILL)
            raise
    return subprocess.CompletedProcess(args, proc.returncode, out, err)


def bounded_call(fn, limit: float):
    """``fn()`` on a daemon thread: its return value, or its
    exception re-raised; ``TimeoutError`` if it has not returned after
    ``limit`` seconds (the thread is left behind, blocked)."""
    done = {}

    def target():
        try:
            done["value"] = fn()
        except BaseException as e:   # handed to the caller below
            done["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(limit)
    if t.is_alive():
        raise TimeoutError(
            f"{getattr(fn, '__name__', fn)!r} has not returned after "
            f"{limit} s")
    if "error" in done:
        raise done["error"]
    return done["value"]


def kill_workers(pool) -> None:
    """Kill the worker processes of a ``ProcessPoolExecutor``, so that its
    ``shutdown`` does not wait on a task that never ends. (The executor
    has no public call for it before Python 3.14's ``kill_workers``.)"""
    for p in list((pool._processes or {}).values()):
        p.kill()
