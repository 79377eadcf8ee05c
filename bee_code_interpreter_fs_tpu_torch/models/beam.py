"""Beam search: the counterpart of bee_code_interpreter_fs_tpu/models/beam.py.

- Beams fold into the batch axis ([b * k] rows, row i's beams at i*k ..
  i*k + k - 1): every model call is one batched decode step.
- Reordering beams is a gather over the cache's batch axis, written back
  into the same cache tensors.
- A finished beam is frozen: once it emits `eos_id`, its only continuation
  is eos at log-prob 0, so its score stays fixed and it competes unchanged
  in every later top-k.
- GNMT length normalization, score / ((5 + len) / 6) ** alpha, picks the
  best of each row's k beams at the end.
- Top-k breaks ties by the lower index, as the reference's lax.top_k does
  (a stable descending sort); torch.topk promises no order among ties.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import (
    Llama,
    decode_step,
    init_cache,
    prefill,
    resolve_cache_len,
)

__all__ = ["beam_generate"]

_NEG_INF = -1e30


def _top_k(x, k: int):
    """(values, indices) of the k largest entries along the last axis, the
    lower index first among equal values."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def beam_generate(params: Llama, prompt_tokens, cfg: LlamaConfig, *,
                  max_new_tokens: int, beam_size: int,
                  length_penalty: float = 1.0, eos_id=None,
                  max_len: int | None = None):
    """The highest-scoring continuation per prompt under beam search.

    prompt_tokens: [b, prompt_len]. Returns int32 [b, prompt_len +
    max_new_tokens] on the params' device: the best beam per row after
    length normalization; a beam that finished early is padded with
    `eos_id`. `beam_size=1` is greedy search and equals greedy_generate."""
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    dev = params.device
    prompt = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    b, prompt_len = prompt.shape
    k = beam_size
    vocab = cfg.vocab_size
    max_len = resolve_cache_len(prompt_len + max_new_tokens, max_len)
    if max_new_tokens == 0:
        return prompt

    # Prefill once per prompt, then tile the cache across the beams.
    cache = init_cache(cfg, b, max_len, device=dev)
    logits, cache = prefill(params, prompt, cache, cfg)
    cache = {name: c.repeat_interleave(k, dim=1) for name, c in cache.items()}

    logp0 = torch.log_softmax(logits.float(), dim=-1)  # [b, V]
    # Step 0 seeds the beams from the prompt's top-k tokens; k > vocab pads
    # dead beams at -inf, which revive once live beams fan out past them.
    top_scores, top_tok = _top_k(logp0, min(k, vocab))
    scores = torch.full((b, k), _NEG_INF, dtype=torch.float32, device=dev)
    first_tok = torch.zeros((b, k), dtype=torch.int64, device=dev)
    scores[:, :top_scores.shape[1]] = top_scores
    first_tok[:, :top_tok.shape[1]] = top_tok
    tok = first_tok.reshape(b * k)
    done = (tok == eos_id) if eos_id is not None else torch.zeros(
        b * k, dtype=torch.bool, device=dev)
    gen_len = torch.ones(b * k, dtype=torch.int64, device=dev)
    # Token history is carried and reordered with the beams: a beam's row
    # at step t is not its ancestor's row at step t + 1.
    seqs = torch.zeros((b * k, max_new_tokens), dtype=torch.int64, device=dev)
    seqs[:, 0] = tok
    if eos_id is not None:
        frozen = torch.full((vocab,), _NEG_INF, dtype=torch.float32, device=dev)
        frozen[eos_id] = 0.0
    row_base = (torch.arange(b, device=dev) * k)[:, None]

    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(params, tok[:, None], cache,
                                    prompt_len + i, cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if eos_id is not None:
            logp = torch.where(done[:, None], frozen[None, :], logp)
        cand = (scores.reshape(b * k)[:, None] + logp).reshape(b, k * vocab)
        scores, flat_idx = _top_k(cand, k)  # [b, k]
        tok = (flat_idx % vocab).reshape(b * k)
        src = (row_base + flat_idx // vocab).reshape(b * k)
        for c in cache.values():
            c.copy_(c[:, src])  # reorder the beams' cache rows in place
        done = done[src]
        gen_len = gen_len[src] + (~done).long()
        seqs = seqs[src]
        seqs[:, i + 1] = tok
        if eos_id is not None:
            done = done | (tok == eos_id)

    tokens = seqs.reshape(b, k, max_new_tokens)
    lp = ((5.0 + gen_len.reshape(b, k).float()) / 6.0) ** length_penalty
    best = torch.argmax(scores / lp, dim=1)  # the first maximum, as JAX's
    best_tokens = tokens[torch.arange(b, device=dev), best]
    return torch.cat([prompt, best_tokens.to(torch.int32)], dim=1)
