"""The harness in the repo root's conftest.py must end every test in bounded
time.

Each case lays out a copy of both real conftest files, the root's and
tests/conftest.py (whose own runner the root's must answer before), with a
one-test module under tests/, and runs it in a child pytest, so that a runner
that hangs costs this test its subprocess timeout, not the suite its worker.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
ROOT_CONFTEST = TESTS.parent / "conftest.py"
TESTS_CONFTEST = TESTS / "conftest.py"

# An un-awaited task left inside create_subprocess_exec with pipes: on
# Python 3.12 its cancellation never completes, so a runner that cancels
# before waiting hangs here.
LEFT_SUBPROCESS = """
import asyncio

async def test_leaves_a_subprocess_task():
    async def spawn():
        proc = await asyncio.create_subprocess_exec(
            "sleep", "0.2",
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        await proc.communicate()

    asyncio.get_running_loop().create_task(spawn())
    await asyncio.sleep(0)
"""

# The fixtures below shorten the root conftest's constants for their module.
RUNNER = """
import pytest

@pytest.fixture
def runner(request):
    (plugin,) = [p for p in request.config.pluginmanager.get_plugins()
                 if hasattr(p, "TEST_TIME_LIMIT_S")]
    return plugin
"""

IGNORES_CANCELLATION = RUNNER + """
import asyncio

@pytest.fixture(autouse=True)
def short_waits(runner, monkeypatch):
    monkeypatch.setattr(runner, "_SETTLE_S", 0.2)
    monkeypatch.setattr(runner, "_CANCEL_S", 0.2)

async def test_leaves_a_task_that_ignores_cancellation():
    async def stubborn():
        while True:
            try:
                await asyncio.sleep(3600)
            except asyncio.CancelledError:
                pass

    asyncio.get_running_loop().create_task(stubborn(), name="stubborn-task")
    await asyncio.sleep(0)
"""

OVERRUNS_LIMIT = RUNNER + """
import time

@pytest.fixture(autouse=True)
def one_second_limit(runner, monkeypatch):
    monkeypatch.setattr(runner, "TEST_TIME_LIMIT_S", 1)

def test_sleeps_past_the_limit():
    time.sleep(60)
"""

CASES = {
    "left_subprocess_task": (LEFT_SUBPROCESS, 0, ["1 passed"]),
    "ignores_cancellation": (
        IGNORES_CANCELLATION,
        1,
        ["1 failed", "still pending", "stubborn-task", "stubborn()"],
    ),
    "overruns_time_limit": (
        OVERRUNS_LIMIT,
        1,
        ["1 failed", "ran past its 1 s limit", "test_sleeps_past_the_limit"],
    ),
}

# The runner's waits add at most 9 s to a call at the committed constants
# (3 s for leftovers to finish, then 2 s each to cancel them and to shut
# down the loop's async generators and its executor). The subprocess task
# finishes in its first 0.2 s, the ignores-cancellation case cuts the waits
# to 0.8 s, and the time-limit case ends after 1 s.
CALL_BOUND_S = 10


@pytest.mark.parametrize("case", list(CASES))
def test_runner_ends_in_bounded_time(case, tmp_path):
    source, want_rc, want_text = CASES[case]
    shutil.copy(ROOT_CONFTEST, tmp_path / "conftest.py")
    (tmp_path / "tests").mkdir()
    shutil.copy(TESTS_CONFTEST, tmp_path / "tests" / "conftest.py")
    (tmp_path / "tests" / "test_case.py").write_text(source)
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-q", "-rf", "--durations=1",
         "--durations-min=0", "--rootdir", str(tmp_path),
         "tests/test_case.py"],
        cwd=tmp_path,
        stdin=subprocess.DEVNULL,
        capture_output=True,
        text=True,
        timeout=60,
    )
    out = run.stdout + run.stderr
    assert run.returncode == want_rc, out
    for text in want_text:
        assert text in out, out
    call = re.search(r"([0-9.]+)s call +tests/test_case\.py::", out)
    assert call is not None and float(call.group(1)) < CALL_BOUND_S, out
