"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here carries the `cuda` marker and skips without a CUDA device.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, without the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

fa = importlib.import_module("bee_code_interpreter_fs_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "t,d,dtype,window,sinks",
    [(2048, 128, "bfloat16", 0, 0), (1000, 128, "bfloat16", 0, 0),
     (1000, 64, "float32", 256, 4), (300, 64, "bfloat16", 100, 4),
     (77, 128, "float32", 0, 0)],
)
def test_flash_kernel_matches_reference(cuda, t, d, dtype, window, sinks):
    rng = np.random.default_rng(t + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, 4, d)).astype(np.float32))
               .to(device=cuda, dtype=getattr(torch, dtype)) for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=window, sinks=sinks)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_reference(q, k, v, window=window, sinks=sinks)
    # The kernel tiles by its own sizes: f32 differs from the reference in
    # summation order only; bf16 may round P or the output one step apart.
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert got.dtype == q.dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_flash_kernel_refuses_mixed_dtypes(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q is"):
        fa.flash_attention(q, q.float(), q)


def test_forward_launches_the_kernel_once_per_layer(cuda):
    from bee_code_interpreter_fs_tpu_torch.models import LlamaConfig, forward, init_params

    cfg = LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, hidden_dim=512,
                           attn_impl="flash", dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda)
    with torch.inference_mode():
        fa.flash_attention.launches = 0
        flash = forward(params, tokens, cfg)
        assert fa.flash_attention.launches == cfg.n_layers
        plain = forward(params, tokens, dataclasses.replace(cfg, attn_impl="plain"))
    assert (flash - plain).abs().max().item() <= 1e-4
