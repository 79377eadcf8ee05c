"""Nothing the benchmark loads is JAX or the JAX package: a fresh process
imports run.py and runs every cell at the tiny size, then lists the
top-level module names it holds. Names are compared whole: the port's
package name begins with the JAX package's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from tiny import BENCH

from pb_core import guard  # noqa: E402


def test_guard_compares_whole_top_level_names():
    found = guard.forbidden_loaded(["bee_code_interpreter_fs_tpu_torch.models",
                                    "bee_code_interpreter_fs_tpu_torchx", "jaxtyping",
                                    "numpy", "flaxen"])
    assert found == []
    assert guard.forbidden_loaded(["jax._src.core", "bee_code_interpreter_fs_tpu.ops",
                                   "flax", "jaxlib.xla_client"]) == [
        "bee_code_interpreter_fs_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax_module():
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH / 'tests')!r}]
import tiny
import run
for cell in tiny.CELLS:
    tiny.run_tiny(cell, 5, seconds=0.3, trace=True)
tops = sorted({{m.split('.', 1)[0] for m in sys.modules}})
print(json.dumps(tops))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(BENCH.parent), env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bee_code_interpreter_fs_tpu_torch" in tops and "torch" in tops
    assert not tops & guard.FORBIDDEN, tops & guard.FORBIDDEN


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mistral-7b.score-long",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(BENCH.parent), env=env, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
