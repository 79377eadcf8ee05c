"""Model FLOPs the work needs, from a configuration file's published keys:
2 FLOPs per matmul parameter a token passes through, plus attention's
4 x head_dim x heads x layers per visible (query, key) pair. A mixture of
experts counts the router and only the top-k experts a token needs, not
what a dispatch computes; the head counts only where the logits are
used. The arithmetic of ``chip_smoke.py``'s train phase ((6N + attention)
x tokens), forward only.
"""

from __future__ import annotations

from roofline.flash_attention_k1 import causal_pairs


def _dims(conf: dict):
    d = conf["hidden_size"]
    nh, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    return d, nh, nkv, d // nh


def body_params(conf: dict) -> int:
    """Matmul parameters one token passes through below the head."""
    d, nh, nkv, hd = _dims(conf)
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    experts = int(conf.get("num_local_experts") or 0)
    mlp = 3 * d * conf["intermediate_size"]
    if experts:
        mlp = mlp * int(conf["num_experts_per_tok"]) + d * experts
    return conf["num_hidden_layers"] * (attn + mlp)


def head_params(conf: dict) -> int:
    return conf["hidden_size"] * conf["vocab_size"]


def attention_flops(conf: dict, pairs: int) -> float:
    _, nh, _, hd = _dims(conf)
    return 4.0 * hd * nh * conf["num_hidden_layers"] * pairs


def _window(conf: dict) -> int:
    return int(conf.get("sliding_window") or 0)


def score_flops(conf: dict, t: int) -> float:
    """A t-token document scored: every position through the body, the
    head at the t - 1 positions whose next token is scored."""
    return (2.0 * (t * body_params(conf) + (t - 1) * head_params(conf))
            + attention_flops(conf, causal_pairs(t, _window(conf))))


def prefill_flops(conf: dict, n: int) -> float:
    """An n-token prompt prefilled; the head at its last position only."""
    return (2.0 * (n * body_params(conf) + head_params(conf))
            + attention_flops(conf, causal_pairs(n, _window(conf))))


def decode_flops(conf: dict, context: int) -> float:
    """One decoded token whose query sees `context` keys (itself
    included), capped by the window."""
    w = _window(conf)
    keys = min(context, w) if w else context
    return (2.0 * (body_params(conf) + head_params(conf))
            + attention_flops(conf, keys))
