"""Test-run set-up shared by every test: each xdist worker's share of the
CPU threads, and a time limit on every test.  pytest loads this file
before ``tests/conftest.py``.

Thread budget: under ``pytest -n N`` every worker would otherwise start
torch, MKL and OpenMP with one thread per core, N times over, and the
threads spin against each other (a test ran 8-15x its time alone).  Each
worker gets ``cpu_count // N`` threads instead, set before anything
imports torch; ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` pass the same
share on to the worker's subprocesses.  A run without xdist keeps the
libraries' defaults.

Time limit: a test not marked slow fails once one of its phases (set-up,
call, tear-down) passes ``TEST_TIME_LIMIT_S``: SIGALRM raises in the
test's own frame, so a hang fails that test and the run goes on.
A phase stuck where no signal handler can run (inside C code) gets its
threads' stacks dumped ``_HARD_GRACE_S`` later and its process ended.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _threads = max(1, (os.cpu_count() or 1) // int(_workers))
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = \
        str(_threads)
    import torch

    torch.set_num_threads(_threads)
    torch.set_num_interop_threads(_threads)

import contextlib  # noqa: E402
import faulthandler  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

TEST_TIME_LIMIT_S = 300.0
_HARD_GRACE_S = 60.0


@contextlib.contextmanager
def _time_limit(item, phase):
    if item.get_closest_marker("slow") is not None:
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{phase} of {item.nodeid} passed its "
                    f"{TEST_TIME_LIMIT_S:.0f} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT_S)
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT_S + _HARD_GRACE_S,
                                      exit=True, file=sys.__stderr__)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "set-up"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "tear-down"):
        yield
