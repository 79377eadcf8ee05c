"""The PyTorch port's flash attention (bee_code_interpreter_fs_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernel, which runs
here in interpret mode as its own tests run it.

Inputs are made with numpy from a seed and handed to both frameworks. The
CUDA kernel itself runs only on a card: tests/test_torch_cuda_kernels.py.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu_torch.ops import _build  # noqa: E402

# Module objects (the JAX package's ops/__init__ re-exports the function
# under the module's name).
jax_fa = importlib.import_module("bee_code_interpreter_fs_tpu.ops.flash_attention")
port_fa = importlib.import_module("bee_code_interpreter_fs_tpu_torch.ops.flash_attention")

REPO_ROOT = Path(__file__).resolve().parent.parent

# f32: both sides run the same recurrence in f32; only the order of the
# sums differs. bf16: P and the output are rounded to bf16 after sums taken
# in another order, so a value may land one bf16 step away (2^-7 relative),
# and outputs here stay below ~2 in magnitude.
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize(
    "t,block_q,block_k,d,window,sinks,dtype",
    [
        (64, 16, 32, 16, 0, 0, "float32"),
        (100, 32, 16, 64, 0, 0, "float32"),  # padding tail
        (100, 16, 32, 16, 24, 0, "float32"),
        (100, 32, 16, 64, 24, 4, "float32"),
        (64, 32, 16, 64, 0, 0, "bfloat16"),
        (100, 16, 32, 16, 24, 4, "bfloat16"),
    ],
)
def test_reference_matches_jax_kernel(t, block_q, block_k, d, window, sinks, dtype):
    arrays = _qkv(t + d + window + sinks, 2, t, 2, d)
    want = jax_fa.flash_attention(
        *_jax(arrays, dtype), block_q=block_q, block_k=block_k,
        window=window, sinks=sinks, interpret=True,
    )
    got = port_fa.flash_attention(
        *_torch(arrays, dtype), block_q=block_q, block_k=block_k,
        window=window, sinks=sinks,
    )
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= TOLERANCE[dtype], err


@pytest.mark.parametrize(
    "t,block_q,block_k",
    [(1, 512, 1024), (32, 512, 1024), (100, 16, 32), (900, 512, 1024),
     (2048, 512, 1024), (1000, 64, 48)],
)
def test_effective_blocks_follow_jax_rule(t, block_q, block_k):
    assert port_fa.effective_blocks(t, block_q, block_k) == jax_fa.effective_blocks(
        t, block_q, block_k
    )


def test_shape_mismatch_raises():
    q, k, v = _torch(_qkv(0, 1, 8, 2, 16), "float32")
    with pytest.raises(ValueError, match="shapes differ"):
        port_fa.flash_attention(q, k[:, :4], v)
    with pytest.raises(ValueError, match="shapes differ"):
        port_fa.flash_attention_reference(q, k, v[..., :8])


def test_cpu_tensors_take_the_reference_without_launching():
    q, k, v = _torch(_qkv(1, 2, 40, 2, 16), "float32")
    before = port_fa.flash_attention.launches
    got = port_fa.flash_attention(q, k, v, window=8, sinks=2)
    want = port_fa.flash_attention_reference(q, k, v, window=8, sinks=2)
    assert port_fa.flash_attention.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "dtype,d,message",
    [(torch.float16, 64, "bfloat16 or float32"), (torch.float32, 32, "d in")],
)
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(dtype, d, message):
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    with pytest.raises(ValueError, match=message):
        port_fa._launch_kernel(q, q, q, 1.0, 0, 0)


def test_kernel_wrapper_refuses_strided_head_dim():
    q = torch.zeros((1, 8, 2, 128))[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        port_fa._launch_kernel(q, q, q, 1.0, 0, 0)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "case,message",
    [
        ("head_stride_not_16_bytes", "16-byte aligned"),
        ("base_not_16_bytes", "16-byte aligned"),
        ("stride_past_tma_limit", "2\\*\\*40"),
        ("float16", "bfloat16 or float32"),
        ("d_96", "d in"),
    ],
)
def test_kernel_input_check_refuses_what_tma_cannot_take(case, message):
    if case == "head_stride_not_16_bytes":  # 68 bf16 = 136 bytes per head
        q = _bf16((1, 8, 2, 68))[..., :64]
    elif case == "base_not_16_bytes":  # 4 bf16 = 8 bytes past the start
        q = _bf16(8 * 2 * 64 + 4)[4:].view(1, 8, 2, 64)
    elif case == "stride_past_tma_limit":
        q = _bf16((1, 8, 2, 64)).as_strided((1, 8, 2, 64), (2**39, 128, 64, 1))
    elif case == "float16":
        q = torch.zeros((1, 8, 2, 64), dtype=torch.float16)
    else:
        q = _bf16((1, 8, 2, 96))
    with pytest.raises(ValueError, match=message):
        port_fa._check_kernel_inputs(q, q, q)
    port_fa._check_kernel_inputs(*(_bf16((1, 8, 2, 64)),) * 3)  # a good one passes


def test_library_path_hashes_every_header(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC_DIR.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    (csrc / "tile_loop.cuh").write_bytes(b"// a header\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.library_path("flash_attention")
    assert before == _build.library_path("flash_attention")  # stable
    (csrc / "tile_loop.cuh").write_bytes(b"// an edited header\n")
    after = _build.library_path("flash_attention")
    assert after != before and after.parent == before.parent
    (csrc / "notes.txt").write_bytes(b"not a source")
    assert _build.library_path("flash_attention") == after


def test_module_imports_without_nvcc_or_triton():
    code = (
        "import sys, shutil\n"
        "import bee_code_interpreter_fs_tpu_torch.ops.flash_attention as m\n"
        "import bee_code_interpreter_fs_tpu_torch.parallel.mesh\n"
        "import bee_code_interpreter_fs_tpu_torch.parallel.collectives\n"
        "import bee_code_interpreter_fs_tpu_torch.parallel.ring_attention\n"
        "import bee_code_interpreter_fs_tpu_torch.parallel.ulysses\n"
        "import bee_code_interpreter_fs_tpu_torch.models.llama\n"
        "assert shutil.which('nvcc') is None\n"
        "assert 'triton' not in sys.modules\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'bee_code_interpreter_fs_tpu')]\n"
        "assert not bad, bad\n"
        "assert m.flash_attention.launches == 0\n"
        "assert m.flash_attention_partial.launches == 0\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, check=True)


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
