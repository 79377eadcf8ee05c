"""Rolling (ring-buffer) KV cache for sliding-window models: the counterpart
of bee_code_interpreter_fs_tpu/models/rolling.py.

A model with cfg.sliding_window = W only ever reads the last W keys (plus
cfg.attention_sinks = S sink keys), so its decode cache can be a ring of W
slots and a write-once buffer of S sink slots: O(W + S) per layer however
long the stream runs.

- Slot ``pos % W`` is overwritten each step; the position ring slot j
  holds is ``pos - ((pos - j) % W)``, negative (never written) early on.
- A ring key is visible when that position is >= S: sink positions attend
  from the sink buffer (written once, visible when s <= pos), so their
  early ring copies are masked rather than counted twice.
- Keys are stored after RoPE at their absolute positions, as in the
  standard cache; softmax does not care about the ring's order, so the
  logits equal the full-cache windowed path's up to summation order.

`rolling_decode_logits` (teacher-forced, the equivalence oracle) and
`rolling_greedy_generate` both step from position 0: the prompt is fed one
token a step, as the reference's scan does. The cache is updated in place.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_fs_tpu_torch.device import resolve_device
from bee_code_interpreter_fs_tpu_torch.models.config import (
    LlamaConfig,
    check_supported,
)
from bee_code_interpreter_fs_tpu_torch.models.llama import (
    Llama,
    _cached_gqa_attention,
    _embed,
    _logits,
    model_dtype,
    transformer_block,
)

__all__ = ["init_rolling_cache", "rolling_decode_logits",
           "rolling_decode_step", "rolling_greedy_generate"]


def init_rolling_cache(cfg: LlamaConfig, batch_size: int, device=None):
    """A ring of cfg.sliding_window K/V slots, plus cfg.attention_sinks
    write-once slots ("sink_k"/"sink_v") when sinks > 0, per layer, zeros
    [L, b, n, n_kv, hd] in the model dtype. Sizes come from cfg only: the
    decode step reads its visibility rule from the cache's shapes."""
    W, S = cfg.sliding_window, cfg.attention_sinks
    if W <= 0:
        raise ValueError("rolling cache needs a sliding window (W > 0)")
    dev = resolve_device(device)
    dt = model_dtype(cfg)

    def zeros(n):
        return torch.zeros((cfg.n_layers, batch_size, n, cfg.n_kv_heads,
                            cfg.head_dim), dtype=dt, device=dev)

    cache = {"k": zeros(W), "v": zeros(W)}
    if S > 0:
        cache["sink_k"], cache["sink_v"] = zeros(S), zeros(S)
    return cache


def _visible(pos: int, W: int, S: int, device):
    """Which of the [S sinks, W ring] keys a query at `pos` attends."""
    j = torch.arange(W, device=device)
    ring = (pos - ((pos - j) % W)) >= S
    if S == 0:
        return ring
    return torch.cat([torch.arange(S, device=device) <= pos, ring])


def rolling_decode_step(params: Llama, tokens, cache, pos: int, cfg: LlamaConfig):
    """One decode step against the ring (written in place): tokens [b, 1] at
    position `pos`. Returns (logits [b, vocab] f32, cache)."""
    if cfg.sliding_window <= 0:
        raise ValueError("rolling_decode_step requires cfg.sliding_window > 0")
    check_supported(cfg)
    scale = cfg.head_dim ** -0.5
    W = cache["k"].shape[2]
    S = cache["sink_k"].shape[2] if "sink_k" in cache else 0
    pos = int(pos)
    valid = _visible(pos, W, S, cache["k"].device)[None, None, None, None, :]
    slot = pos % W
    x = _embed(params, tokens, model_dtype(cfg))
    for i, lp in enumerate(params.layers):
        def attn_fn(q, k, v, i=i):
            cache["k"][i, :, slot] = k[:, 0]
            cache["v"][i, :, slot] = v[:, 0]
            if S == 0:
                return _cached_gqa_attention(q, cache["k"][i], cache["v"][i],
                                             valid, scale)
            if pos < S:  # write-once: only positions < S land in the sinks
                cache["sink_k"][i, :, pos] = k[:, 0]
                cache["sink_v"][i, :, pos] = v[:, 0]
            keys = torch.cat([cache["sink_k"][i], cache["k"][i]], dim=1)
            values = torch.cat([cache["sink_v"][i], cache["v"][i]], dim=1)
            return _cached_gqa_attention(q, keys, values, valid, scale)

        x = transformer_block(x, lp, cfg, attn_fn, rope_offset=pos)
    return _logits(params, x[:, 0], cfg), cache


@torch.inference_mode()
def rolling_decode_logits(params: Llama, tokens, cfg: LlamaConfig):
    """Teacher-forced logits [b, t, vocab] f32 through the ring: the
    equivalence oracle against forward() with the same window and sinks,
    at O(W + S) cache residency."""
    tokens = torch.as_tensor(tokens, device=params.device)
    b, t = tokens.shape
    cache = init_rolling_cache(cfg, b, device=params.device)
    out = []
    for pos in range(t):
        logits, cache = rolling_decode_step(params, tokens[:, pos:pos + 1],
                                            cache, pos, cfg)
        out.append(logits)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def rolling_greedy_generate(params: Llama, prompt_tokens, cfg: LlamaConfig, *,
                            max_new_tokens: int):
    """Greedy decode over the ring: the prompt fed one token a step, then
    each argmax fed back. Returns int32 [b, prompt + max_new_tokens], the
    sequence greedy_generate returns; the cache's bytes depend on the
    window and sinks, never on the length."""
    prompt = torch.as_tensor(prompt_tokens, device=params.device).to(torch.int32)
    b, p = prompt.shape
    cache = init_rolling_cache(cfg, b, device=params.device)
    fed = []
    logits = None
    for pos in range(p + max_new_tokens):
        tok = (prompt[:, pos] if pos < p
               else torch.argmax(logits, dim=-1).to(torch.int32))
        fed.append(tok)
        if pos + 1 < p + max_new_tokens:  # the last token's logits are unused
            logits, cache = rolling_decode_step(params, tok[:, None], cache,
                                                pos, cfg)
    return torch.stack(fed, dim=1)
