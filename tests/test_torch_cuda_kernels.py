"""The port's CUDA kernels (full flash attention and the ring step) on the
card, against their plain PyTorch versions.

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
     (77, 128, "float32", 0, 0),
     # the bf16 kernel's 128-row tiles: shorter than one, one row past one
     (40, 64, "bfloat16", 0, 0), (40, 128, "bfloat16", 0, 0),
     (129, 64, "bfloat16", 0, 0), (129, 128, "bfloat16", 0, 0)],
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


@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_reads_a_head_slice_view(cuda, d):
    rng = np.random.default_rng(d)
    full = [torch.from_numpy(rng.standard_normal((2, 300, 24, d)).astype(np.float32))
            .to(device=cuda, dtype=torch.bfloat16) for _ in range(3)]
    q, k, v = (x[:, :, 8:16] for x in full)  # strided views, no copy
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_reference(*(x.contiguous() for x in (q, k, v)))
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


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


# name: (tq, tk, q_offset, k_offset, causal, fold an earlier chunk first)
PARTIAL_CASES = {
    "diagonal": (256, 256, 256, 256, True, False),
    "past_chunk": (256, 256, 512, 0, True, False),
    "non_causal": (256, 256, 0, 256, False, False),
    "klen_tail_tk1000": (256, 1000, 900, 0, True, False),
    "q_padding_tq77": (77, 256, 200, 0, True, False),
    "folded_carry": (256, 256, 256, 256, True, True),
    "all_future_chunk": (256, 256, 0, 256, True, True),
    "tq77_tk200": (77, 200, 1000, 0, True, False),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PARTIAL_CASES))
def test_partial_kernel_matches_reference(cuda, case, dtype, d):
    tq, tk, q_off, k_off, causal, fold_first = PARTIAL_CASES[case]
    b, h = 1, 4
    rng = np.random.default_rng(tq + tk + d)

    def draw(t):
        x = rng.standard_normal((b, t, h, d)).astype(np.float32)
        return torch.from_numpy(x).to(device=cuda, dtype=getattr(torch, dtype))

    q, k, v, k_prev, v_prev = draw(tq), draw(tk), draw(tk), draw(256), draw(256)
    carry = fa.new_carry(b, h, tq, d, cuda)
    if fold_first:  # a chunk at global position 0, folded by the plain version
        carry = fa.flash_attention_partial_reference(
            q, k_prev, v_prev, *carry, q_offset=q_off, k_offset=0)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal)
    got = [c.clone() for c in carry]
    before = fa.flash_attention_partial.launches
    out = fa.flash_attention_partial(q, k, v, *got, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_partial.launches == before + 1
    assert all(o is g for o, g in zip(out, got))  # the caller's carry, in place
    want = fa.flash_attention_partial_reference(q, k, v, *carry, **kw)
    if case == "all_future_chunk":
        assert all(torch.equal(g, c) for g, c in zip(got, carry))
        return
    # The kernel tiles by its own sizes: f32 differs in summation order;
    # bf16 may round P one step apart.
    tol = 1e-4 if dtype == "float32" else 2e-2
    out_got = got[0] / got[2].clamp(min=1e-30)[..., None]
    out_want = want[0] / want[2].clamp(min=1e-30)[..., None]
    assert (out_got - out_want).abs().max().item() <= tol
    assert (got[1] - want[1]).abs().max().item() <= tol


def test_ring_forward_launches_the_partial_kernel_per_live_step(cuda):
    from bee_code_interpreter_fs_tpu_torch.models import LlamaConfig, forward, init_params
    from bee_code_interpreter_fs_tpu_torch.parallel import MeshSpec, make_mesh

    sp = 4
    cfg = LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, hidden_dim=512,
                           attn_impl="flash", dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda)
    mesh = make_mesh(MeshSpec((1, sp, 1, 1)), cuda)
    with torch.inference_mode():
        want = forward(params, tokens, cfg)
        fa.flash_attention.launches = fa.flash_attention_partial.launches = 0
        got = forward(params, tokens, cfg, mesh=mesh)
        torch.cuda.synchronize()
        assert fa.flash_attention_partial.launches == cfg.n_layers * sp * (sp + 1) // 2
        assert fa.flash_attention.launches == 0
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [64, 128])
def test_partial_kernel_on_sp_chunk_views(cuda, d):
    """Ring chunks are views into the full tensors: the kernel must read
    each chunk's own rows only (its tensor maps end at the chunk's end)."""
    from bee_code_interpreter_fs_tpu_torch.parallel.mesh import sp_chunks

    b, t, h, n = 1, 4 * 200, 4, 4
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               .to(device=cuda, dtype=torch.bfloat16) for _ in range(3))
    qs, ks, vs = (sp_chunks(x, n) for x in (q, k, v))
    c = t // n
    for q_rank, k_rank in ((2, 2), (2, 1), (3, 0), (0, 1)):
        kw = dict(q_offset=q_rank * c, k_offset=k_rank * c)
        got = fa.new_carry(b, h, c, d, cuda)
        fa.flash_attention_partial(qs[q_rank], ks[k_rank], vs[k_rank], *got, **kw)
        want = fa.flash_attention_partial_reference(
            qs[q_rank].contiguous(), ks[k_rank].contiguous(), vs[k_rank].contiguous(),
            *fa.new_carry(b, h, c, d, cuda), **kw)
        if k_rank > q_rank:  # all in the future: the carry stays fresh (the
            # plain version's q-tile, padded to 256 rows, reaches the chunk)
            assert all(torch.equal(g, f) for g, f in zip(got, fa.new_carry(b, h, c, d, cuda)))
            continue
        out_got = got[0] / got[2].clamp(min=1e-30)[..., None]
        out_want = want[0] / want[2].clamp(min=1e-30)[..., None]
        assert (out_got - out_want).abs().max().item() <= 2e-2


def _tiny_bf16(cuda):
    from bee_code_interpreter_fs_tpu_torch.models import LlamaConfig, init_params

    cfg = LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1, hidden_dim=512,
                           max_seq_len=256, attn_impl="flash", dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator(device=cuda).manual_seed(1),
                           device=cuda)
    return cfg, params, tokens


# bf16 rounds P and the activations at other places in the two forwards; the
# CPU bf16 tests hold the port to the reference with the same logit tolerance.
BF16_LOGIT_TOL = 0.05


def test_bf16_forward_flash_matches_plain(cuda):
    from bee_code_interpreter_fs_tpu_torch.models import forward

    cfg, params, tokens = _tiny_bf16(cuda)
    with torch.inference_mode():
        fa.flash_attention.launches = 0
        flash = forward(params, tokens, cfg)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == cfg.n_layers
        plain = forward(params, tokens, dataclasses.replace(cfg, attn_impl="plain"))
    assert bool(torch.isfinite(flash).all())
    assert (flash - plain).abs().max().item() <= BF16_LOGIT_TOL


def test_bf16_ring_forward_matches_the_no_mesh_flash_forward(cuda):
    from bee_code_interpreter_fs_tpu_torch.models import forward
    from bee_code_interpreter_fs_tpu_torch.parallel import MeshSpec, make_mesh

    sp = 4
    cfg, params, tokens = _tiny_bf16(cuda)
    mesh = make_mesh(MeshSpec((1, sp, 1, 1)), cuda)
    with torch.inference_mode():
        want = forward(params, tokens, cfg)
        fa.flash_attention.launches = fa.flash_attention_partial.launches = 0
        got = forward(params, tokens, cfg, mesh=mesh)
        torch.cuda.synchronize()
        assert fa.flash_attention_partial.launches == cfg.n_layers * sp * (sp + 1) // 2
        assert fa.flash_attention.launches == 0
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= BF16_LOGIT_TOL
