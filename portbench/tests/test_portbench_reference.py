"""The plain reference (reference/llama_ref.py) held to the port on the
CPU at tiny sizes, with the same seeded weights: Mistral's sliding window
(the port's plain attention and K1's plain version) and Mixtral's top-2
routing. Logits are compared, in float32."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from tiny import conf_overrides  # noqa: F401  (puts the benchmark on sys.path)

from pb_core import program, spec  # noqa: E402
from reference.llama_ref import Reference  # noqa: E402

SEED = 2**31 + 977


def _conf(config: str, **extra) -> dict:
    bench = spec.load_benchmark()
    conf = dict(spec.config(bench, config))
    conf.update(hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
    conf.update(extra)
    return conf


def _port_logits(conf, tokens, attn_impl):
    cfg = program.llama_config(conf, dtype="float32", attn_impl=attn_impl)
    params = program.build_params(conf, SEED, "cpu", cfg)
    from bee_code_interpreter_fs_tpu_torch.models import forward

    with torch.no_grad():
        return forward(params, tokens[None], cfg)[0]


def _ref_logits(conf, tokens):
    ref = Reference(conf, SEED, "cpu", weight_dtype=torch.float32)
    h = ref.final_hidden([tokens])[0]
    return ref.logits_rows(h, torch.arange(tokens.numel()))


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
def test_mistral_window_matches_port(attn_impl):
    conf = _conf("mistral-7b", sliding_window=8)
    tokens = torch.randint(0, conf["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(1))
    got = _port_logits(conf, tokens, attn_impl)
    want = _ref_logits(conf, tokens)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()
    # The window matters at this length: without it the logits differ.
    unwindowed = _ref_logits(dict(conf, sliding_window=None), tokens)
    assert (unwindowed[20:] - want[20:]).abs().max() > 1e-2


def test_mixtral_top2_matches_port():
    conf = _conf("mixtral-8x7b")
    tokens = torch.randint(0, conf["vocab_size"], (33,),
                           generator=torch.Generator().manual_seed(2))
    got = _port_logits(conf, tokens, "plain")
    want = _ref_logits(conf, tokens)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


def test_mixtral_routing_is_top2_renormalized():
    """One expert's output alone differs: routing and its weights matter."""
    conf = _conf("mixtral-8x7b")
    ref = Reference(conf, SEED, "cpu", weight_dtype=torch.float32)
    w = ref.layer_weights(0)
    h = torch.randn(16, conf["hidden_size"], generator=torch.Generator().manual_seed(3))
    out = ref._mlp(h, w)
    probs = torch.softmax(h @ w["router"], dim=-1)
    top_p, top_i = probs.topk(2, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(h)
    for t in range(h.shape[0]):
        for slot in range(2):
            e = int(top_i[t, slot])
            y = (torch.nn.functional.silu(h[t] @ w["w_gate"][e]) * (h[t] @ w["w_up"][e])) @ w["w_down"][e]
            want[t] += top_p[t, slot] * y
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-6)


def test_weights_are_the_seeds_and_shared():
    """The program's module holds exactly the reference's tensors, and
    another seed gives other weights."""
    conf = _conf("mixtral-8x7b")
    cfg = program.llama_config(conf, dtype="float32")
    params = program.build_params(conf, SEED, "cpu", cfg)
    ref = Reference(conf, SEED, "cpu", weight_dtype=torch.float32)
    for i, blk in enumerate(params.layers):
        w = ref.layer_weights(i)
        for name in ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down"):
            assert torch.equal(getattr(blk, name), w[name]), (i, name)
    assert torch.equal(params.lm_head, ref.head())
    other = Reference(conf, SEED + 1, "cpu", weight_dtype=torch.float32)
    assert not torch.equal(other.layer_weights(0)["wq"], ref.layer_weights(0)["wq"])
    assert dataclasses.asdict(cfg)["n_experts"] == 8

