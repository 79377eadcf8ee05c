"""The port's rolling (ring-buffer) KV cache (models/rolling.py) against the
JAX package's.

Config: tests/unit/test_rolling_cache.py's tiny f32 model with a window of
5, sinks 0 and 2, and sequences several windows long; JAX's seed-0 weights
converted to the port. Logits within rtol/atol 2e-4 of JAX's
rolling_decode_logits and of the port's windowed forward (the JAX test's
tolerance); greedy tokens equal to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.models import rolling as jrolling  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.rolling import (  # noqa: E402
    init_rolling_cache,
    rolling_decode_logits,
    rolling_greedy_generate,
)

TOL = 2e-4


def _model(sinks):
    fields = dict(dtype="float32", sliding_window=5, attention_sinks=sinks)
    jcfg = jl.LlamaConfig.tiny(**fields)
    tcfg = LlamaConfig.tiny(**fields)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("sinks", [0, 2])
def test_rolling_logits_equal_jax_and_windowed_forward(sinks):
    jp, jcfg, tp, tcfg = _model(sinks)
    tokens = np.random.default_rng(15).integers(0, tcfg.vocab_size, (2, 23))
    got = rolling_decode_logits(tp, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 23, tcfg.vocab_size)
    want = np.asarray(jrolling.rolling_decode_logits(jp, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    windowed = tl.forward(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), windowed.numpy(), rtol=TOL, atol=TOL)


def test_cache_size_independent_of_length():
    cfg = LlamaConfig.tiny(dtype="float32", sliding_window=6, attention_sinks=2)
    cache = init_rolling_cache(cfg, 3, device="cpu")
    assert cache["k"].shape == (2, 3, 6, 4, 16) and cache["sink_k"].shape[2] == 2
    gqa = LlamaConfig.tiny(dtype="float32", n_heads=4, n_kv_heads=2, sliding_window=4)
    assert init_rolling_cache(gqa, 1, device="cpu")["k"].shape[3] == 2
    assert set(init_rolling_cache(gqa, 1, device="cpu")) == {"k", "v"}
    with pytest.raises(ValueError, match="sliding window"):
        init_rolling_cache(LlamaConfig.tiny(), 1, device="cpu")


def test_rolling_greedy_tokens_equal_jax():
    jp, jcfg, tp, tcfg = _model(2)
    prompt = np.random.default_rng(16).integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jrolling.rolling_greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                                       max_new_tokens=9))
    got = rolling_greedy_generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=9)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tl.greedy_generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=9)
    assert torch.equal(got, plain)
