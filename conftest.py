"""Bounds for every test under the repo root.

- Runs ``async def`` tests (pytest-asyncio is not available in this
  environment) on a fresh event loop, and settles what a test leaves behind
  within a bound (``_settle``). Its ``pytest_pyfunc_call`` is ``tryfirst``, so
  it answers for coroutines before the one in ``tests/conftest.py``, which
  ends a test with ``asyncio.run`` and so waits without a bound.
- Gives every test's call phase a time limit (``TEST_TIME_LIMIT_S``).

Imports no JAX and no torch: ``tests/conftest.py`` sets JAX's platform before
anything imports it.
"""

import asyncio
import contextlib
import faulthandler
import inspect
import signal
import sys
import threading
import time

import pytest

# What an async test leaves behind is given _SETTLE_S to finish by itself,
# then _CANCEL_S to honour its cancellation; the loop's async generators and
# default executor get _CANCEL_S each to shut down. asyncio.run would wait
# for all of it without a bound, and on Python 3.12 a task cancelled while
# create_subprocess_exec connects the child's pipes never settles.
_SETTLE_S = 3.0
_CANCEL_S = 2.0
# A call phase that runs longer fails (pytest_runtest_call below), so a stuck
# call costs its test and not the files queued behind it on its worker. The
# figure is the tier-1 run's 1470 s timeout less that run's 994 s (6 xdist
# workers on an 8-core CPU host). It bounds one call, not the run: a call
# that sticks late in the run still outlasts the timeout. The slowest passing
# call, test_torch_spec_serving.py::test_sampled_distribution_matches_plain_engine,
# took 374-450 s in such runs.
TEST_TIME_LIMIT_S = 475


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    """Run ``async def`` tests on a fresh event loop, driving async-generator
    fixtures (which plugin-less pytest passes through unresolved) in the same
    loop as the test, then settle the tasks the test left behind. A task that
    is still pending after its cancellation fails the test, by name."""
    fn = pyfuncitem.obj
    if not inspect.iscoroutinefunction(fn):
        return None

    async def run():
        kwargs = {}
        cleanups = []
        for name in pyfuncitem._fixtureinfo.argnames:
            value = pyfuncitem.funcargs[name]
            if inspect.isasyncgen(value):
                kwargs[name] = await value.__anext__()
                cleanups.append(value)
            elif inspect.iscoroutine(value):
                kwargs[name] = await value
            else:
                kwargs[name] = value
        try:
            await fn(**kwargs)
        finally:
            for gen in reversed(cleanups):
                with contextlib.suppress(StopAsyncIteration):
                    await gen.__anext__()

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    try:
        loop.run_until_complete(run())
    finally:
        try:
            stuck = _settle(loop)
        finally:
            asyncio.set_event_loop(None)
            loop.close()
    if stuck:
        pytest.fail(
            f"{len(stuck)} task(s) the test left behind were still pending "
            f"{_CANCEL_S} s after their cancellation: "
            + "; ".join(repr(task) for task in stuck),
            pytrace=False,
        )
    return True


def _settle(loop):
    """Wait for the loop's leftover tasks, cancel those still pending, shut
    its async generators and default executor down, each within its bound;
    return the tasks that are still pending."""

    def drain(seconds, cancel):
        deadline = time.monotonic() + seconds
        while pending := asyncio.all_tasks(loop):
            left = deadline - time.monotonic()
            if left <= 0:
                return pending
            if cancel:
                for task in pending:
                    if not task.cancelling():
                        task.cancel()
            loop.run_until_complete(asyncio.wait(pending, timeout=left))
        return set()

    drain(_SETTLE_S, cancel=False)
    stuck = drain(_CANCEL_S, cancel=True)
    shutdown = loop.create_task(loop.shutdown_asyncgens())
    loop.run_until_complete(asyncio.wait({shutdown}, timeout=_CANCEL_S))
    loop.run_until_complete(loop.shutdown_default_executor(_CANCEL_S))
    return stuck


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Fail a test whose call phase runs past TEST_TIME_LIMIT_S, after dumping
    every thread's stack to stderr, so that one stuck test costs that test
    and not the run. SIGALRM is delivered to the main thread, where pytest
    and xdist's workers run tests; on any other thread the limit is off."""
    if threading.current_thread() is not threading.main_thread():
        return (yield)

    def expire(signum, frame):
        faulthandler.dump_traceback(sys.__stderr__)
        pytest.fail(f"the call phase ran past its {TEST_TIME_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
