"""The PyTorch port's Llama (bee_code_interpreter_fs_tpu_torch/models/) against
the JAX package's models/llama.py at the tiny config, on the same weights.

JAX initialises the weights; params_from_jax converts them. Token inputs
come from numpy. The JAX flash path runs its Pallas kernel in interpret
mode on the CPU by itself. Tolerances: f32 1e-4 (the same arithmetic in
another summation order); bf16 0.05 in logits, the reference's own spread
between its plain and flash paths at this config.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.hf_convert import from_hf_state_dict  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    to_torch,
)
from bee_code_interpreter_fs_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec,
    make_mesh,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {
    "mha": {},
    "gqa": {"n_kv_heads": 2},
    "window": {"sliding_window": 16, "attention_sinks": 2},
}
F32_TOL = 1e-4
BF16_LOGIT_TOL = 0.05


def _configs(variant, dtype="float32", **extra):
    overrides = {**VARIANTS[variant], "dtype": dtype, **extra}
    return jl.LlamaConfig.tiny(**overrides), LlamaConfig.tiny(**overrides)


@functools.lru_cache(maxsize=None)
def _models(variant, dtype="float32"):
    """(jax params, port module) on the same weights."""
    jcfg, tcfg = _configs(variant, dtype)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_jax(tree, tcfg, device="cpu")


def _tokens(seed, b=2, t=24):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------- config


@pytest.mark.parametrize(
    "preset", ["tiny", "llama2_7b", "llama2_13b", "llama3_8b", "mixtral_8x7b"]
)
def test_config_presets_equal_jax(preset):
    want = dataclasses.asdict(getattr(jl.LlamaConfig, preset)())
    got = dataclasses.asdict(getattr(LlamaConfig, preset)())
    assert got == want
    assert getattr(LlamaConfig, preset)().head_dim == getattr(jl.LlamaConfig, preset)().head_dim


def test_config_fields_and_defaults_equal_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(LlamaConfig) == fields(jl.LlamaConfig)
    assert LlamaConfig.__dataclass_params__.frozen


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 5, "per_row"])
def test_rope_matches_jax(dtype, offset):
    x = np.random.default_rng(3).standard_normal((2, 6, 3, 16)).astype(np.float32)
    off = np.array([3, 11], np.int32) if offset == "per_row" else offset
    want = jl._rope(jnp.asarray(x, getattr(jnp, dtype)), 10000.0, offset=off)
    t_off = torch.from_numpy(off) if offset == "per_row" else off
    got = tl._rope(torch.from_numpy(x).to(getattr(torch, dtype)), 10000.0, offset=t_off)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)  # f32, like the model's
    want = jl._rms_norm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w), 1e-5)
    got = tl._rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same roundings, but rsqrt may differ by an f32 ulp, which can
    # move a value across one bf16 rounding boundary (2^-7 relative).
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-6, rtol=rtol)


def test_expand_gqa_maps_head_i_to_kv_head_i_div_rep():
    k = torch.arange(2 * 3 * 2 * 1, dtype=torch.float32).reshape(2, 3, 2, 1)
    ek, ev = tl._expand_gqa(k, k, 4)
    want = np.repeat(k.numpy(), 2, axis=2)
    assert np.array_equal(ek.numpy(), want) and np.array_equal(ev.numpy(), want)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_f32_matches_jax(variant, impl):
    jparams, model = _models(variant)
    jcfg, tcfg = _configs(variant, attn_impl=impl)
    toks = _tokens(11)
    want = jl.forward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = tl.forward(model, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_forward_bf16_matches_jax(impl):
    jparams, model = _models("mha", "bfloat16")
    jcfg, tcfg = _configs("mha", "bfloat16", attn_impl=impl)
    toks = _tokens(12)
    want = jl.forward(jparams, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = tl.forward(model, torch.from_numpy(toks), tcfg)
    assert np.abs(got.numpy() - _np(want)).max() <= BF16_LOGIT_TOL


# ---------------------------------------------------------------- decoding


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_chunk_match_jax(variant):
    jparams, model = _models(variant)
    jcfg, tcfg = _configs(variant)
    toks = _tokens(13, t=20)
    prompt, chunk = toks[:, :16], toks[:, 16:]
    j_logits, j_cache = jl.prefill(jparams, jnp.asarray(prompt), jl.init_cache(jcfg, 2, 24), jcfg)
    j_chunk, j_cache = jl.decode_chunk(jparams, jnp.asarray(chunk), j_cache, 16, jcfg)
    with torch.no_grad():
        cache = tl.init_cache(tcfg, 2, 24, device="cpu")
        t_logits, cache = tl.prefill(model, torch.from_numpy(prompt), cache, tcfg)
        t_chunk, cache = tl.decode_chunk(model, torch.from_numpy(chunk), cache, 16, tcfg)
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(t_chunk.numpy(), _np(j_chunk), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(cache["k"].numpy(), _np(j_cache["k"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cache["v"].numpy(), _np(j_cache["v"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_eos", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_tokens_equal_jax(variant, use_eos):
    jparams, model = _models(variant)
    jcfg, tcfg = _configs(variant)
    prompt = _tokens(14, t=8)
    plain = np.asarray(jl.greedy_generate(jparams, jnp.asarray(prompt), jcfg, max_new_tokens=8))
    # An eos that row 0 emits mid-generation, so pinning is exercised.
    eos = int(plain[0, 8 + 2]) if use_eos else None
    want = (np.asarray(jl.greedy_generate(jparams, jnp.asarray(prompt), jcfg,
                                          max_new_tokens=8, eos_id=eos))
            if use_eos else plain)
    got = tl.greedy_generate(model, torch.from_numpy(prompt), tcfg,
                             max_new_tokens=8, eos_id=eos)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if use_eos:
        row = got[0, 8:].numpy()
        first = int(np.argmax(row == eos))
        assert (row[first:] == eos).all()


def test_generate_equals_greedy_generate():
    _, model = _models("mha")
    _, tcfg = _configs("mha")
    prompt = torch.from_numpy(_tokens(15, t=5))
    assert torch.equal(
        tl.generate(model, prompt, tcfg, max_new_tokens=4),
        tl.greedy_generate(model, prompt, tcfg, max_new_tokens=4),
    )


def test_cache_too_small_is_refused():
    with pytest.raises(ValueError, match="cache too small"):
        tl.resolve_cache_len(12, 8)
    assert tl.resolve_cache_len(12, None) == 12
    _, model = _models("mha")
    _, tcfg = _configs("mha")
    with pytest.raises(ValueError, match="cache too small"):
        tl.greedy_generate(model, torch.zeros((1, 6), dtype=torch.int32), tcfg,
                           max_new_tokens=4, max_len=8)
    # A write past the cache's end raises instead of being clamped.
    cache = tl.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        tl.decode_chunk(model, torch.zeros((1, 3), dtype=torch.int32), cache, 6, tcfg)


# ---------------------------------------------------------------- params


def test_init_params_shapes_dtypes_and_scale():
    cfg = LlamaConfig.tiny(n_kv_heads=2)
    model = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny(n_kv_heads=2)))
    assert tuple(model.embed.shape) == jparams["embed"].shape
    assert tuple(model.lm_head.shape) == jparams["lm_head"].shape
    for name, leaf in jparams["layers"].items():
        for blk in model.layers:
            param = getattr(blk, name)
            assert tuple(param.shape) == leaf.shape[1:], name
            assert str(param.dtype).split(".")[-1] == str(leaf.dtype), name
    assert model.embed.dtype == torch.bfloat16 and model.final_norm.dtype == torch.float32
    assert torch.equal(model.layers[0].attn_norm, torch.ones(cfg.dim))
    std = model.layers[0].w_down.float().std().item()
    assert abs(std - cfg.hidden_dim ** -0.5) < 0.1 * cfg.hidden_dim ** -0.5
    again = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.layers[1].wq, model.layers[1].wq)


def test_bf16_conversion_round_trips_bit_for_bit():
    import ml_dtypes

    bits = np.random.default_rng(5).integers(0, 2**16, 4096, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0  # drop NaN/inf patterns
    array = bits.view(ml_dtypes.bfloat16).reshape(64, 64)
    tensor = to_torch(array)
    assert tensor.dtype == torch.bfloat16
    assert np.array_equal(tensor.view(torch.int16).numpy().view(np.uint16), bits.reshape(64, 64))
    _, model = _models("mha", "bfloat16")
    jparams, _ = _models("mha", "bfloat16")
    want = np.asarray(jparams["layers"]["wq"][1]).view(np.uint16)
    assert np.array_equal(model.layers[1].wq.view(torch.int16).numpy().view(np.uint16), want)


def test_later_slice_paths_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.Llama(LlamaConfig.tiny(n_experts=4), device="cpu")
    _, model = _models("mha")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="remat"):
        tl.forward(model, toks, LlamaConfig.tiny(remat=True, dtype="float32"))
    with pytest.raises(NotImplementedError, match="parallel slice"):
        tl.forward(model, toks, LlamaConfig.tiny(dtype="float32"),
                   mesh=make_mesh(MeshSpec((1, 1, 1, 2)), device="cpu"))
    with pytest.raises(NotImplementedError, match="MoE"):
        from_hf_state_dict({"model.layers.0.block_sparse_moe.gate.weight":
                            np.zeros((4, 64), np.float32)},
                           LlamaConfig.tiny(dtype="float32"), device="cpu")


# ---------------------------------------------------------------- hygiene


def test_port_imports_nothing_of_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import bee_code_interpreter_fs_tpu_torch as pkg\n"
        "import chip_smoke\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'bee_code_interpreter_fs_tpu'\n"
        "       or m.startswith('bee_code_interpreter_fs_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                   env=dict(os.environ), check=True)


def test_entry_points_without_device_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from bee_code_interpreter_fs_tpu_torch.entry import entry

    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_cache(cfg, 1, 8)


def test_entry_on_the_cpu_gives_tiny_logits():
    from bee_code_interpreter_fs_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    with torch.no_grad():
        logits = fn(*args)
    assert tuple(logits.shape) == (2, 32, 256) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
