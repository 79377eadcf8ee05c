"""The port's LoRA path (bee_code_interpreter_fs_tpu_torch/models/lora.py, the
LoRA branches of llama._w/_mm, ServingEngine(adapters=)) against the JAX
package's.

Fixture: the JAX multi-LoRA tests' tiny config (2 layers, dim 64, 4 q / 2
kv heads, vocab 79, f32), JAX's seed-0 weights converted to the port, and
two rank-4 adapters whose ``b`` is NOT zero (init_lora's zero ``b`` would
test nothing): JAX's init_lora plus seeded numpy noise, converted with
lora_from_jax. Logits within 1e-5 of JAX's; engine tokens equal to JAX's
greedy_generate over the wrapped tree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.models import lora as jlora  # noqa: E402
from bee_code_interpreter_fs_tpu.models.quant import (  # noqa: E402
    quantize4_params as jquantize4,
    quantize_params as jquantize,
)
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import lora  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import (  # noqa: E402
    lora_from_jax,
    params_from_jax,
)
from bee_code_interpreter_fs_tpu_torch.models.paged import PagedServingEngine  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.quant import (  # noqa: E402
    quantize4_params,
    quantize_params,
)
from bee_code_interpreter_fs_tpu_torch.models.serving import ServingEngine  # noqa: E402

FIXTURE = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
               vocab_size=79, max_seq_len=96, dtype="float32")
TOL = 1e-5
CASES = [([5, 9, 2], 8, None), ([5, 9, 2], 8, "a"), ([5, 9, 2], 8, "b"),
         ([44, 3], 6, "a"), ([7] * 12, 5, "b")]


def _nonzero_adapter(key, cfg, seed, targets=jlora.DEFAULT_TARGETS):
    rng = np.random.default_rng(seed)
    tree = jlora.init_lora(key, cfg, rank=4, targets=targets)
    return jax.tree.map(
        lambda x: x + 0.02 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32),
        tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny(**FIXTURE)
    tcfg = LlamaConfig.tiny(**FIXTURE)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    ja, jb = _nonzero_adapter(k1, jcfg, 1), _nonzero_adapter(k2, jcfg, 2)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    ta, tb = (lora_from_jax(jax.tree.map(np.asarray, x)) for x in (ja, jb))
    return jparams, jcfg, ja, jb, model, tcfg, ta, tb


def _tokens(b=3, t=10, seed=3):
    return np.random.default_rng(seed).integers(0, 79, (b, t))


def _jax_greedy(params, cfg, prompt, new):
    out = jl.greedy_generate(params, jnp.asarray([prompt], jnp.int32), cfg,
                             max_new_tokens=new)
    return np.asarray(out)[0, len(prompt):]


def test_lora_wrap_forward_equals_jax(tiny):
    jparams, jcfg, ja, _, model, tcfg, ta, _ = tiny
    toks = _tokens()
    want = np.asarray(jl.forward(jlora.lora_wrap(jparams, ja, alpha=8.0),
                                 jnp.asarray(toks), jcfg))
    got = tl.forward(lora.lora_wrap(model, ta, alpha=8.0), torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # The wrapped reference tree converts too (composite leaves).
    conv = params_from_jax(jax.tree.map(np.asarray, jlora.lora_wrap(jparams, ja, alpha=8.0)),
                           tcfg, device="cpu")
    assert lora.is_lora_leaf(conv.layers[1].wq)
    np.testing.assert_allclose(tl.forward(conv, torch.from_numpy(toks), tcfg).numpy(),
                               want, atol=TOL, rtol=0)
    # The base model is untouched by the wrap (no tensor copied or moved).
    assert isinstance(model.layers[0].wq, torch.nn.Parameter)


def test_merge_lora_equals_jax_and_the_wrap(tiny):
    jparams, jcfg, ja, _, model, tcfg, ta, _ = tiny
    merged = lora.merge_lora(model, ta)
    want = np.asarray(jlora.merge_lora(jparams, ja)["layers"]["wq"][1])
    np.testing.assert_allclose(merged.layers[1].wq.detach().numpy(), want, atol=1e-6, rtol=0)
    toks = torch.from_numpy(_tokens(seed=7))
    np.testing.assert_allclose(tl.forward(merged, toks, tcfg).numpy(),
                               tl.forward(lora.lora_wrap(model, ta), toks, tcfg).numpy(),
                               atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="quantized"):
        lora.merge_lora(quantize_params(model), ta)


def test_multi_lora_rows_equal_single_wraps(tiny):
    jparams, jcfg, ja, jb, model, tcfg, ta, tb = tiny
    toks = _tokens()
    stacked = lora.stack_loras([lora.zero_lora(tcfg, rank=4, device="cpu"), ta, tb])
    ids = torch.tensor([0, 1, 2])
    multi = tl.forward(lora.multi_lora_wrap(model, stacked, ids),
                       torch.from_numpy(toks), tcfg)
    jmulti = jl.forward(jlora.multi_lora_wrap(
        jparams, jlora.stack_loras([jlora.zero_lora(jcfg, rank=4), ja, jb]),
        jnp.asarray([0, 1, 2])), jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(multi.numpy(), np.asarray(jmulti), atol=TOL, rtol=0)
    singles = [model, lora.lora_wrap(model, ta), lora.lora_wrap(model, tb)]
    for row, single in enumerate(singles):
        want = tl.forward(single, torch.from_numpy(toks[row:row + 1]), tcfg)[0]
        np.testing.assert_allclose(multi[row].numpy(), want.numpy(), atol=TOL, rtol=0)
    # The selection is read at each use: writing the ids moves the rows.
    ids.copy_(torch.tensor([2, 2, 0]))
    again = tl.forward(lora.multi_lora_wrap(model, stacked, ids), torch.from_numpy(toks), tcfg)
    want = tl.forward(singles[2], torch.from_numpy(toks[:1]), tcfg)[0]
    np.testing.assert_allclose(again[0].numpy(), want.numpy(), atol=TOL, rtol=0)
    with pytest.raises(TypeError, match="per batch row"):
        tl._w(lora.multi_lora_wrap(model, stacked, ids).layers[0].wq, torch.float32)


def test_rank_mismatch_and_bad_targets_raise(tiny):
    _, _, _, _, _, tcfg, ta, _ = tiny
    other = lora.init_lora(torch.Generator().manual_seed(9), tcfg, rank=8, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        lora.stack_loras([ta, other])
    with pytest.raises(ValueError, match="at least one"):
        lora.stack_loras([])
    with pytest.raises(ValueError, match="rank must be"):
        lora.init_lora(torch.Generator(), tcfg, rank=0, device="cpu")
    with pytest.raises(ValueError, match="unknown LoRA target"):
        lora.init_lora(torch.Generator(), tcfg, targets=("w_router",), device="cpu")
    with pytest.raises(ValueError, match="MoE expert"):
        lora._target_dims(LlamaConfig.tiny(n_experts=4), "w_up")


def test_init_lora_is_the_identity(tiny):
    _, _, _, _, model, tcfg, _, _ = tiny
    fresh = lora.init_lora(torch.Generator().manual_seed(1), tcfg, rank=4,
                           targets=("wq", "w_gate", "w_down"), device="cpu")
    assert float(fresh["layers"]["wq"]["a"].abs().max()) > 0
    toks = torch.from_numpy(_tokens())
    assert torch.equal(tl.forward(lora.lora_wrap(model, fresh), toks, tcfg),
                       tl.forward(model, toks, tcfg))


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_serves_mixed_adapters_equal_to_jax(tiny, kind):
    jparams, jcfg, ja, jb, model, tcfg, ta, tb = tiny
    kw = dict(n_slots=3, max_len=64, steps_per_sync=4, adapters={"a": ta, "b": tb},
              device="cpu")
    eng = (PagedServingEngine(model, tcfg, block_size=8, **kw) if kind == "paged"
           else ServingEngine(model, tcfg, **kw))
    rids = [eng.submit(p, m, adapter=ad) for p, m, ad in CASES]
    res = eng.run()
    wraps = {None: jparams, "a": jlora.lora_wrap(jparams, ja),
             "b": jlora.lora_wrap(jparams, jb)}
    for rid, (p, m, ad) in zip(rids, CASES):
        np.testing.assert_array_equal(res[rid], _jax_greedy(wraps[ad], jcfg, p, m))
    if kind == "paged":
        assert eng.free_blocks == eng.stats()["total_blocks"]


def test_adapter_prefix_binding(tiny):
    jparams, jcfg, ja, _, model, tcfg, ta, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=2, max_len=64, adapters={"a": ta},
                        device="cpu")
    pid_a = eng.register_prefix([9, 4, 27, 3], adapter="a")
    with pytest.raises(ValueError, match="adapter-specific"):
        eng.submit([1], 4, prefix_id=pid_a)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit([1], 4, adapter="nope")
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.register_prefix([1, 2], adapter="nope")
    rid = eng.submit([1, 2], 6, prefix_id=pid_a, adapter="a")
    r_only = eng.submit([], 5, prefix_id=pid_a, adapter="a")
    res = eng.run()
    wrapped = jlora.lora_wrap(jparams, ja)
    np.testing.assert_array_equal(res[rid], _jax_greedy(wrapped, jcfg, [9, 4, 27, 3, 1, 2], 6))
    np.testing.assert_array_equal(res[r_only], _jax_greedy(wrapped, jcfg, [9, 4, 27, 3], 5))
    with pytest.raises(ValueError, match="share one target set"):
        ServingEngine(model, tcfg, n_slots=1, max_len=32, device="cpu", adapters={
            "a": ta, "q": lora.init_lora(torch.Generator(), tcfg, rank=4, targets=("wq",), device="cpu")})


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_qlora_over_quantized_base(tiny, precision):
    """LoRA composes over int8 and int4 bases: the wrapped forward equals
    JAX's, and the engine's adapter tokens equal JAX's over the same
    quantized base."""
    jparams, jcfg, ja, jb, model, tcfg, ta, tb = tiny
    if precision == "int8":
        jq, tq = jquantize(jparams), quantize_params(model)
    else:
        jq, tq = jquantize4(jparams, 32), quantize4_params(model, 32)
    toks = _tokens()
    want = np.asarray(jl.forward(jlora.lora_wrap(jq, ja), jnp.asarray(toks), jcfg))
    got = tl.forward(lora.lora_wrap(tq, ta), torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    eng = ServingEngine(tq, tcfg, n_slots=2, max_len=64, adapters={"a": ta, "b": tb},
                        device="cpu")
    r1 = eng.submit([3, 14], 6, adapter="a")
    r2 = eng.submit([3, 14], 6)
    res = eng.run()
    np.testing.assert_array_equal(res[r1], _jax_greedy(jlora.lora_wrap(jq, ja), jcfg, [3, 14], 6))
    np.testing.assert_array_equal(res[r2], _jax_greedy(jq, jcfg, [3, 14], 6))
