"""The limits of ``tests/_bounded.py``: a child that outlives its limit is
killed with every process it started, a child that ends in time returns
its output, and a call on a thread that never returns fails the test
instead of holding it."""

import re
import subprocess
import sys
import threading
import time

import pytest

from _bounded import bounded_call, run_bounded

# starts a sleeping grandchild, says its pid, then sleeps itself
PARENT = """
import subprocess, sys, time
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
print(child.pid, flush=True)
time.sleep(120)
"""


def _running(pid: int) -> bool:
    """False once ``pid`` has ended: gone, or a zombie left for its parent
    (here init) to reap."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return False
    return state != "Z"


def test_run_bounded_kills_the_whole_tree():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="after 2 s") as err:
        run_bounded([sys.executable, "-c", PARENT], 2)
    assert time.monotonic() - t0 < 12
    found = re.search(r"stdout:\n(\d+)", str(err.value))
    assert found, f"the child printed no pid:\n{err.value}"
    grandchild = int(found.group(1))
    deadline = time.monotonic() + 10
    while _running(grandchild) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _running(grandchild)


def test_run_bounded_returns_the_output_of_a_child_in_time():
    proc = run_bounded([sys.executable, "-c", "print('in time')"], 60)
    assert isinstance(proc, subprocess.CompletedProcess)
    assert (proc.returncode, proc.stdout, proc.stderr) == (0, "in time\n", "")


def test_bounded_call_returns_raises_or_times_out():
    assert bounded_call(lambda: 7, 10) == 7
    with pytest.raises(KeyError, match="inner"):
        bounded_call(lambda: {}["inner"], 10)
    never = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="after 1 s"):
        bounded_call(never.wait, 1)
    assert time.monotonic() - t0 < 10
    never.set()
