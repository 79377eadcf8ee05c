"""Continuous-batching serving engine: the counterpart of
bee_code_interpreter_fs_tpu/models/serving.py.

One resident model serves many requests by iteration-level batching over a
fixed bank of `n_slots` cache slots: requests join and leave the running
batch at token boundaries.

- **Bucketed prefill.** Admission pads a prompt to one of a few bucket
  lengths and prefills it into a bucket-sized scratch cache, then copies
  the scratch into the slot's cache row. Torch does not compile per shape,
  but the buckets still decide which prompts are admissible and how
  chunked prefill splits a long one. K/V written for padded positions are
  never read: a decode step at position p writes p before it reads it, and
  reads only positions <= p. The same holds for a row's stale tail past
  the bucket.
- **Decode bursts without a host sync.** Between scheduler syncs the
  engine runs `steps_per_sync` decode steps in a Python loop over device
  tensors (position, last token, remaining budget, active flag,
  temperature, top_p, stream keys): no `.item()`, no `.tolist()`, no
  Python branch on a device value. Every slot sits at its own position
  (per-slot RoPE, masks and cache writes at each slot's frontier). EOS and
  budgets deactivate slots on the device; after the burst one copy brings
  the emitted tokens, their flags and log-probs (and the active flags) to
  the host.
- **Sampling** uses the port's counter-based stream (models/llama.py): a
  request's key is stream_key(seed), or stream_key(engine seed, rid), and
  the token at position p draws with (key, p), at admission and in the
  burst alike. A request's stream therefore depends only on its seed and
  positions, never on what else shares the batch. It is not jax.random's
  stream: sampled tokens are not the reference's tokens; greedy tokens
  are.
- **int8 KV** (`kv_quant=True`): prompts prefill at full precision and
  quantize as they install; decode quantizes each new K/V vector as it
  writes and dequantizes the whole row as attention reads it.

- **Multi-LoRA** (`adapters=`): many fine-tunes of one resident base
  model share every burst. The adapters stack into one bank with the zero
  adapter at index 0 (so un-adapted rows compute the exact base model);
  each slot's adapter index sits in a device tensor that admission writes
  in place, and every adapted matmul gathers its rows' adapters
  (models/lora.py). A prefix registered under an adapter serves only that
  adapter's requests: its K/V depend on the adapter.

The cache is mutated in place. Everything runs on the params' device,
which is the card unless the engine is built with `device="cpu"`.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from bee_code_interpreter_fs_tpu_torch.device import resolve_device
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import (
    _cached_gqa_attention,
    _embed,
    _logits,
    decode_chunk,
    decode_valid_mask,
    gumbel_noise,
    init_cache,
    model_dtype,
    nucleus_mask,
    prefill,
    stream_key,
    transformer_block,
)
from bee_code_interpreter_fs_tpu_torch.models.lora import (
    multi_lora_wrap,
    stack_loras,
    zero_lora,
)
from bee_code_interpreter_fs_tpu_torch.models.quant import (
    dequantize_kv,
    quantize_kv,
)

__all__ = ["ServingEngine", "Request"]


@dataclass
class Request:
    """One queued generation request (host-side bookkeeping)."""

    rid: int
    prompt: np.ndarray  # [prompt_len] int32 (the suffix when prefix_id set)
    max_new_tokens: int
    prefix_id: int | None = None
    temperature: float = 0.0  # 0 = greedy
    seed: int | None = None
    on_token: object = None  # callable(list[int]) | None: streaming sink
    want_logprobs: bool = False
    top_p: float = 1.0  # nucleus truncation (1.0 = off)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    adapter: str | None = None  # multi-LoRA adapter name (None = base)
    generated: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)


def _kv_write_read(quant: bool, write_at, read_tf, dt):
    """The per-layer KV strategy shared by the dense and paged decode steps:
    (cache_keys, write_read). `write_at(leaf, value)` writes the new
    token's K/V in place (row scatter or block scatter) and `read_tf(leaf)`
    gives the attention-readable view (the row, or the block-table gather).
    With `quant`, values quantize at the write and dequantize at the read:
    the one int8-KV recipe of both engines."""
    if quant:
        keys = ("kq", "ks", "vq", "vs")

        def write_read(cs, k, v):
            ckq, cks, cvq, cvs = cs
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            for leaf, value in ((ckq, kq), (cks, ks), (cvq, vq), (cvs, vs)):
                write_at(leaf, value)
            return (dequantize_kv(read_tf(ckq), read_tf(cks), dt),
                    dequantize_kv(read_tf(cvq), read_tf(cvs), dt))
    else:
        keys = ("k", "v")

        def write_read(cs, k, v):
            write_at(cs[0], k)
            write_at(cs[1], v)
            return read_tf(cs[0]), read_tf(cs[1])

    return keys, write_read


def _decode_layers(params, tokens, store, pos, cfg: LlamaConfig, cache_keys,
                   write_read, valid):
    """The layer loop of a per-slot decode chunk: tokens [b, s], slot i's
    token j at position pos[i] + j; layer i's K/V [b, s, ...] go through
    write_read on store[key][i]. Returns logits [b, s, vocab] f32."""
    scale = cfg.head_dim ** -0.5
    x = _embed(params, tokens, model_dtype(cfg))
    for i, lp in enumerate(params.layers):
        cs = tuple(store[key][i] for key in cache_keys)

        def attn_fn(q, k, v, cs=cs):
            keys, vals = write_read(cs, k, v)
            return _cached_gqa_attention(q, keys, vals, valid, scale)

        x = transformer_block(x, lp, cfg, attn_fn, rope_offset=pos)
    return _logits(params, x, cfg)


def _chunk_valid(qpos, max_len: int, cfg: LlamaConfig):
    """Visibility of a per-slot chunk, qpos [b, s]: bool [b, 1, 1, s,
    max_len] for _cached_gqa_attention's [b, g, r, s, k] scores."""
    b, s = qpos.shape
    valid = decode_valid_mask(qpos.reshape(-1), max_len, cfg)
    return valid.reshape(b, s, max_len)[:, None, None]


def _perslot_decode_chunk(params, tokens, cache, pos, cfg: LlamaConfig,
                          max_len: int | None = None):
    """A decode chunk where every slot starts at its own position: tokens
    [b, s], slot i's token j at position pos[i] + j (pos [b] int64 on the
    device). Writes each slot's K/V in place; slot i's query j reads cache
    positions <= pos[i] + j. Returns logits [b, s, vocab] f32.

    `max_len` (default: the cache's length) is the slot's logical length.
    A cache allocated one column longer keeps that last column as a
    scratch column: a write at a position >= max_len lands there and is
    never read (attention reads columns < max_len). The speculative
    engines' chunks and draft steps reach up to gamma positions past a
    slot's end, whose writes the reference drops; without the scratch
    column such a write raises."""
    quant = "kq" in cache
    width = (cache["kq"] if quant else cache["k"]).shape[2]
    max_len = width if max_len is None else max_len
    b, s = tokens.shape
    qpos = pos[:, None] + torch.arange(s, device=pos.device)[None, :]
    valid = _chunk_valid(qpos, max_len, cfg)
    bidx = torch.arange(b, device=pos.device)[:, None]
    cols = torch.clamp(qpos, max=max_len) if width > max_len else qpos

    def write_at(leaf, value):
        leaf[bidx, cols] = value

    def read(leaf):
        return leaf[:, :max_len] if width > max_len else leaf

    cache_keys, write_read = _kv_write_read(quant, write_at, read,
                                            model_dtype(cfg))
    return _decode_layers(params, tokens, cache, pos, cfg, cache_keys,
                          write_read, valid)


def _perslot_decode_step(params, tokens, cache, pos, cfg: LlamaConfig,
                         max_len: int | None = None):
    """One decode step where every slot sits at its own position: tokens
    [b, 1], pos [b]. Returns logits [b, vocab] f32."""
    return _perslot_decode_chunk(params, tokens, cache, pos, cfg, max_len)[:, 0]


def _sample_next(logits, temp, keys, positions, top_p=None):
    """Next token per row: greedy where temp == 0, else a Gumbel-max draw
    from the row's stream at the sampled token's position (`positions`).
    The one definition of the engines' sampling; `top_p` ([b] or None)
    truncates to the nucleus first."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.where(temp > 0, temp, 1.0)[:, None]
    if top_p is not None:
        scaled = nucleus_mask(scaled, top_p[:, None])
    noise = gumbel_noise(keys, positions, logits.shape[-1])
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temp > 0, sampled, greedy)


def _burst(step_fn, pos, tok, remaining, active, temp, keys, steps: int,
           eos_id, with_logprobs: bool, top_p=None, penalties=None):
    """The one burst loop both engines run: `step_fn(tokens, pos, active)`
    gives logits (and writes the KV store in place); sampling, emit
    bookkeeping and budget/EOS masking live here.

    `penalties` (None = off): (presence [b], frequency [b], counts [b,
    vocab] int32, updated in place): OpenAI-style repetition control, which
    shapes token choice (greedy included) while reported log-probs stay
    raw-model. Returns (pos, tok, remaining, active, toks [steps, b],
    emitted [steps, b], lps [steps, b])."""
    toks, emitted_all, lps = [], [], []
    for _ in range(steps):
        logits = step_fn(tok[:, None], pos, active)
        if penalties is None:
            choice_logits = logits
        else:
            presence, frequency, counts = penalties
            choice_logits = (logits - presence[:, None] * (counts > 0)
                             - frequency[:, None] * counts)
        nxt = _sample_next(choice_logits, temp, keys, pos + 1, top_p)
        if with_logprobs:
            lp = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
        else:
            lp = torch.zeros(logits.shape[0], dtype=torch.float32,
                             device=logits.device)
        tok = torch.where(active, nxt, tok)
        emitted = active
        pos = pos + active
        remaining = remaining - active.long()
        active = active & (remaining > 0)
        if eos_id is not None:
            active = active & (tok != eos_id)
        if penalties is not None:
            counts.scatter_add_(1, tok[:, None], emitted[:, None].to(counts.dtype))
        toks.append(tok)
        emitted_all.append(emitted)
        lps.append(lp)
    return (pos, tok, remaining, active, torch.stack(toks),
            torch.stack(emitted_all), torch.stack(lps))


# ---------------------------------------------------------------- admission

def _prefill_scratch(params, tokens, true_len: int, cfg: LlamaConfig,
                     pad_to: int):
    """Prefill a bucketed prompt [1, bucket] into a contiguous scratch of
    pad_to >= bucket positions; returns (last_logits [vocab], scratch)."""
    scratch = init_cache(cfg, 1, pad_to, device=tokens.device)
    logits_all, scratch = decode_chunk(params, tokens, scratch, 0, cfg)
    return logits_all[0, true_len - 1], scratch


def _prefill_scratch_prefixed(params, pk, pv, tokens, true_len: int,
                              cfg: LlamaConfig, pad_to: int):
    """The prefix-cached variant: the prefix's K/V at positions 0..plen-1,
    then the suffix chunk-prefilled at rope offset plen, in one scratch of
    pad_to >= plen + bucket positions."""
    plen = pk.shape[2]
    scratch = init_cache(cfg, 1, pad_to, device=tokens.device)
    scratch["k"][:, :, :plen] = pk
    scratch["v"][:, :, :plen] = pv
    logits_all, scratch = decode_chunk(params, tokens, scratch, plen, cfg)
    return logits_all[0, true_len - 1], scratch


def _chunked_scratch_prefill(params, tokens, true_len: int, cfg: LlamaConfig,
                             chunk: int):
    """Prefill a chunk-aligned bucketed prompt `chunk` tokens at a time
    against the growing scratch, so scores peak at chunk x bucket instead
    of bucket². Returns (last_logits [vocab] at true_len - 1, scratch)."""
    bucket = tokens.shape[1]
    if bucket % chunk:
        raise ValueError(
            f"bucket {bucket} is not a multiple of prefill chunk {chunk}: "
            "the tail would silently never prefill"
        )
    scratch = init_cache(cfg, 1, bucket, device=tokens.device)
    last = None
    for start in range(0, bucket, chunk):
        logits, scratch = decode_chunk(params, tokens[:, start:start + chunk],
                                       scratch, start, cfg)
        if start <= true_len - 1 < start + chunk:
            last = logits[0, true_len - 1 - start]
    return last, scratch


def _install_row(cache, scratch, slot: int):
    """Copy a contiguous scratch ([L, 1, T, ...], T <= max_len) into cache
    row `slot`, positions 0..T-1; int8 caches quantize it on the way (the
    prompt prefilled exactly, only the stored cache is quantized). The
    row's tail past T keeps stale K/V that is never read."""
    T = scratch["k"].shape[2]
    for name, value in _stored(cache, scratch):
        cache[name][:, slot, :T] = value[:, 0]


def _stored(store, kv):
    """(leaf name, value) pairs of dense K/V `kv` in `store`'s format: as
    they are, or int8-quantized for an int8 store."""
    if "kq" in store:
        return zip(("kq", "ks", "vq", "vs"),
                   (*quantize_kv(kv["k"]), *quantize_kv(kv["v"])))
    return ((name, kv[name]) for name in ("k", "v"))


class ServingEngine:
    """Continuous-batching serving over a fixed slot bank.

    >>> eng = ServingEngine(params, cfg, n_slots=4, max_len=512)
    >>> rid = eng.submit([1, 5, 9], max_new_tokens=32)
    >>> results = eng.run()          # {rid: np.ndarray of generated tokens}

    Results are the generated continuation only. With `eos_id` set, a
    request stops at (and includes) its first eos: greedy_generate's
    pinning, truncated at the first eos.
    """

    def __init__(self, params, cfg: LlamaConfig, *, n_slots: int = 4,
                 max_len: int | None = None, steps_per_sync: int = 8,
                 prefill_buckets: tuple = (), eos_id: int | None = None,
                 seed: int = 0, adapters: dict | None = None,
                 lora_alpha: float = 16.0, prefill_chunk: int | None = None,
                 kv_quant: bool = False, device=None):
        """`device`: where the engine runs, the card unless "cpu" is given;
        `params` must live there. `adapters`: {name: adapter tree
        (models/lora.py's init_lora shape)}, served side by side; a
        request picks one by name, or none for the base model."""
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        self.steps_per_sync = int(steps_per_sync)
        self.eos_id = eos_id
        self.kv_quant = bool(kv_quant)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and not (
            1 <= self.prefill_chunk < self.max_len
        ):
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be in "
                f"[1, max_len={self.max_len}) — a chunk that can never "
                "fire is a misconfiguration"
            )
        if prefill_buckets:
            self.buckets = tuple(sorted(int(b) for b in prefill_buckets))
            if self.buckets[0] < 1 or self.buckets[-1] > self.max_len:
                raise ValueError(
                    f"prefill_buckets must lie in [1, max_len={self.max_len}]"
                    f", got {self.buckets}"
                )
        else:
            # Powers of two, topped by the largest admissible prompt length
            # (max_len - 1: at least one generated token must fit).
            pows = [b for b in (2 ** i for i in range(4, 32))
                    if b < self.max_len - 1]
            self.buckets = tuple(pows + [self.max_len - 1])
        if self.prefill_chunk is not None:
            # Chunk-aligned variants for chunked admission; the original
            # top bucket stays, so capacity never shrinks.
            c = self.prefill_chunk
            aligned = {
                min(-(-b // c) * c, (self.max_len // c) * c)
                for b in self.buckets
            }
            aligned = {b for b in aligned if b > 0}
            self.buckets = tuple(sorted(aligned | {max(self.buckets)}))
        self._init_device_state()
        n, dev = self.n_slots, self.device
        self.pos = torch.zeros(n, dtype=torch.int64, device=dev)
        self.last_tok = torch.zeros(n, dtype=torch.int64, device=dev)
        self.remaining = torch.zeros(n, dtype=torch.int64, device=dev)
        self.active = torch.zeros(n, dtype=torch.bool, device=dev)
        self.temp = torch.zeros(n, dtype=torch.float32, device=dev)
        self.top_p = torch.ones(n, dtype=torch.float32, device=dev)
        self.presence = torch.zeros(n, dtype=torch.float32, device=dev)
        self.frequency = torch.zeros(n, dtype=torch.float32, device=dev)
        self.keys = torch.zeros(n, dtype=torch.int64, device=dev)
        # [n_slots, vocab] int32, allocated at the first penalized admission.
        self.counts = None
        # The host's copy of `active`, refreshed by every burst's one copy.
        self._active_host = np.zeros(n, dtype=bool)
        self._slot_req: list[Request | None] = [None] * n
        self._queue: deque[Request] = deque()
        self._results: dict[int, np.ndarray] = {}
        self._logprob_results: dict[int, np.ndarray] = {}
        self._rid = itertools.count()
        self._prefixes: dict[int, dict] = {}
        self._prefix_id = itertools.count()
        self._base_seed = int(seed)
        self._init_adapters(adapters or {}, float(lora_alpha))

    def _init_adapters(self, adapters: dict, alpha: float):
        """Stack the adapters (the zero adapter at index 0) and wrap the
        base twice, once per batch shape the engine runs: the slot bank
        (bursts) and one row (admission). Each wrap reads its own id tensor,
        written in place; neither is ever rebuilt."""
        self._adapter_idx: dict = {None: 0}
        self._burst_params = self._one_params = self.params
        if not adapters:
            return
        names = list(adapters)
        for n in names:
            if not (isinstance(adapters[n], dict) and adapters[n].get("layers")):
                raise ValueError(
                    f"adapter {n!r} is not an adapter tree {{'layers': "
                    "{target: {'a', 'b'}}} (models/lora.py)"
                )
        targets = tuple(adapters[names[0]]["layers"])
        for n in names[1:]:
            if tuple(adapters[n]["layers"]) != targets:
                raise ValueError(
                    f"adapters must share one target set: {names[0]!r} has "
                    f"{targets}, {n!r} has {tuple(adapters[n]['layers'])}"
                )
        first = adapters[names[0]]["layers"][targets[0]]["a"]
        zero = zero_lora(self.cfg, rank=first.shape[-1], targets=targets,
                         device=self.device)
        bank = stack_loras(
            [zero] + [{"layers": {t: {k: v.to(self.device) for k, v in ab.items()}
                                  for t, ab in adapters[n]["layers"].items()}}
                      for n in names],
            targets=targets, alpha=alpha)
        self._adapter_idx.update({n: i + 1 for i, n in enumerate(names)})
        self._slot_ids = torch.zeros(self.n_slots, dtype=torch.int64,
                                     device=self.device)
        self._one_id = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._burst_params = multi_lora_wrap(self.params, bank, self._slot_ids)
        self._one_params = multi_lora_wrap(self.params, bank, self._one_id)

    def _params_for(self, adapter):
        """The one-row model for `adapter` (admission and prefixes): the
        base model, or the wrapped one with its id set to the adapter."""
        if self._one_params is not self.params:
            self._one_id.fill_(self._adapter_idx[adapter])
        return self._one_params

    def _req_params(self, req: Request):
        return self._params_for(req.adapter)

    def _init_device_state(self):
        """The KV state: one [n_slots, max_len] cache, int8 per head_dim
        vector with kv_quant. PagedServingEngine overrides it."""
        cfg = self.cfg
        if self.kv_quant:
            shape = (cfg.n_layers, self.n_slots, self.max_len,
                     cfg.n_kv_heads, cfg.head_dim)
            self.cache = _int8_kv_store(shape, self.device)
        else:
            self.cache = init_cache(cfg, self.n_slots, self.max_len,
                                    device=self.device)

    # ------------------------------------------------------------- intake

    def _check_adapter(self, adapter) -> None:
        if adapter not in self._adapter_idx:
            raise ValueError(f"unknown adapter {adapter!r}")

    @torch.inference_mode()
    def register_prefix(self, tokens, adapter: str | None = None) -> int:
        """Prefill a shared prompt prefix once and keep its K/V; requests
        submitted with the returned id skip the prefix's prefill. Costs one
        [L, 1, plen] K/V buffer on the device per prefix."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("empty prefix")
        if tokens.size >= self.max_len:
            raise ValueError(
                f"prefix ({tokens.size}) leaves no room in max_len "
                f"{self.max_len}"
            )
        self._check_adapter(adapter)
        k, v, row_logits = self._prefix_kv(self._params_for(adapter),
                                           self.cfg, tokens)
        pid = next(self._prefix_id)
        self._prefixes[pid] = {"k": k, "v": v, "last_logits": row_logits,
                               "len": int(tokens.size), "adapter": adapter}
        return pid

    def _prefix_kv(self, params, cfg: LlamaConfig, tokens: np.ndarray):
        """A prefix's K/V [L, 1, plen, ...] and last-position logits,
        chunked above prefill_chunk."""
        plen = int(tokens.size)
        if self.prefill_chunk is not None and plen > self.prefill_chunk:
            c = self.prefill_chunk
            padded = self._padded_prompt(tokens, -(-plen // c) * c)
            row_logits, scratch = _chunked_scratch_prefill(
                params, padded, plen, cfg, c)
            return scratch["k"][:, :, :plen], scratch["v"][:, :, :plen], row_logits
        scratch = init_cache(cfg, 1, plen, device=self.device)
        batch_logits, scratch = prefill(
            params, torch.from_numpy(tokens[None, :]).to(self.device),
            scratch, cfg)
        return scratch["k"], scratch["v"], batch_logits[0]

    def unregister_prefix(self, prefix_id: int) -> None:
        """Release a registered prefix's K/V. Requests already admitted
        with it are unaffected; raises while queued requests reference it."""
        if prefix_id not in self._prefixes:
            raise ValueError(f"unknown prefix_id {prefix_id}")
        users = [r.rid for r in self._queue if r.prefix_id == prefix_id]
        if users:
            raise ValueError(
                f"prefix {prefix_id} is referenced by queued request(s) "
                f"{users}; drain or cancel them first"
            )
        del self._prefixes[prefix_id]

    def submit(self, prompt, max_new_tokens: int,
               prefix_id: int | None = None, *, temperature: float = 0.0,
               seed: int | None = None, adapter: str | None = None,
               on_token=None, logprobs: bool = False,
               top_p: float = 1.0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0) -> int:
        """Queue a prompt (a sequence of token ids); returns its request id.
        With `prefix_id`, `prompt` is the suffix after that prefix (it may
        be empty).

        `on_token(list[int])` streams the request's new tokens at every
        scheduler sync, in order, concatenating to the final result. A
        callback's exception propagates out of step()/run() only after
        every slot's tokens are recorded and every other sink is delivered
        (call run() again to resume). `temperature` > 0 samples from the
        request's stream (see the module docstring): with a `seed`, the
        output does not depend on other traffic or on how bursts are cut.
        Presence/frequency penalties count generated tokens only, shape
        token choice (greedy included) and leave log-probs raw-model."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self._check_adapter(adapter)
        plen = 0
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            pf = self._prefixes[prefix_id]
            if pf["adapter"] != adapter:
                raise ValueError(
                    f"prefix {prefix_id} was registered under adapter "
                    f"{pf['adapter']!r}; request uses {adapter!r}: prefix K/V "
                    "is adapter-specific"
                )
            plen = pf["len"]
        elif prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen + prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix ({plen}) + prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds cache max_len {self.max_len}"
            )
        if (prefix_id is None and prompt.size > 0
                and prompt.size > max(self.buckets)):
            # Prefixed suffixes skip this gate: _suffix_bucket's exact-
            # remainder fallback holds any suffix the total check admitted.
            raise ValueError(
                f"prompt length {prompt.size} exceeds largest prefill "
                f"bucket {max(self.buckets)}"
            )
        rid = next(self._rid)
        self._queue.append(
            Request(rid, prompt, int(max_new_tokens), prefix_id,
                    float(temperature), seed, on_token, bool(logprobs),
                    float(top_p), float(presence_penalty),
                    float(frequency_penalty), adapter)
        )
        return rid

    def _suffix_bucket(self, plen: int, n: int) -> int:
        """Smallest bucket holding an n-token suffix beside a plen-token
        prefix within max_len; else the exact remainder max_len - plen,
        which holds n by submit's total-length check."""
        return next(
            (b for b in self.buckets if b >= n and plen + b <= self.max_len),
            self.max_len - plen,
        )

    def _padded_prompt(self, prompt: np.ndarray, bl: int) -> torch.Tensor:
        padded = np.zeros((1, bl), np.int32)
        padded[0, : prompt.size] = prompt
        return torch.from_numpy(padded).to(self.device)

    def _bucket_len(self, n: int) -> int:
        plain = next((b for b in self.buckets if n <= b), None)
        if plain is None:
            raise ValueError(f"no bucket holds prompt of length {n}")
        c = self.prefill_chunk
        if c is not None and plain > c and plain % c:
            # Above the chunk size, prefer the smallest chunk-aligned bucket
            # that holds the prompt (chunked admission); keep the unaligned
            # one only when no aligned bucket can.
            aligned = next(
                (b for b in self.buckets
                 if n <= b and b > c and b % c == 0),
                None,
            )
            if aligned is not None:
                return aligned
        return plain

    def _req_key(self, req: Request) -> int:
        if req.seed is not None:
            return stream_key(req.seed)
        return stream_key(self._base_seed, req.rid)

    def _pick_first(self, req: Request, last_logits, prompt_end: int) -> int:
        """The first generated token from the admission logits, greedy or
        drawn at position prompt_end from the stream the burst continues
        (unpenalized: nothing has been generated yet). Records its model
        log-prob when the request asked for log-probs."""
        if req.temperature <= 0:
            tok = int(torch.argmax(last_logits))
        else:
            dev = last_logits.device
            top_p = (torch.tensor([req.top_p], device=dev)
                     if req.top_p < 1.0 else None)
            tok = int(_sample_next(
                last_logits[None].float(),
                torch.tensor([req.temperature], device=dev),
                torch.tensor([self._req_key(req)], device=dev),
                torch.tensor([prompt_end], device=dev), top_p)[0])
        if req.want_logprobs:
            req.logprobs.append(
                float(torch.log_softmax(last_logits.float(), dim=-1)[tok]))
        return tok

    # ---------------------------------------------------------- scheduling

    def _retire(self):
        for i in range(self.n_slots):
            req = self._slot_req[i]
            if req is not None and not self._active_host[i]:
                self._record_result(req)
                self._slot_req[i] = None
                self._on_retire(i)

    def _install(self, req: Request, i: int):
        """Prefill `req`'s prompt into slot `i`'s KV storage. Returns
        (first_token, prompt_end), or None when the engine cannot place it
        now (the paged engine out of blocks): the caller requeues it."""
        last_logits, prompt_end = self._admit_row(
            self.cache, self._req_params(req), self.cfg, req, i, "k", "v")
        return self._pick_first(req, last_logits, prompt_end), prompt_end

    def _admit_row(self, cache, params, cfg: LlamaConfig, req: Request,
                   i: int, pk: str, pv: str):
        """Prefill `req`'s prompt with `params` into row `i` of the dense
        `cache` (a registered prefix's K/V under names pk, pv). Returns
        (last logits, prompt_end)."""
        n = req.prompt.size
        if req.prefix_id is not None:
            pf = self._prefixes[req.prefix_id]
            plen = pf["len"]
            if n == 0:
                _install_row(cache, {"k": pf[pk], "v": pf[pv]}, i)
                return pf["last_logits"], plen
            bl = self._suffix_bucket(plen, n)
            last_logits, scratch = _prefill_scratch_prefixed(
                params, pf[pk], pf[pv], self._padded_prompt(req.prompt, bl),
                n, cfg, plen + bl)
            _install_row(cache, scratch, i)
            return last_logits, plen + n
        bl = self._bucket_len(n)
        padded = self._padded_prompt(req.prompt, bl)
        if (self.prefill_chunk is not None and bl > self.prefill_chunk
                and bl % self.prefill_chunk == 0):
            last_logits, scratch = _chunked_scratch_prefill(
                params, padded, n, cfg, self.prefill_chunk)
        else:
            last_logits, scratch = _prefill_scratch(params, padded, n, cfg, bl)
        _install_row(cache, scratch, i)
        return last_logits, n

    def _record_result(self, req: Request) -> None:
        """The one place a finished or cancelled request's channels land."""
        self._results[req.rid] = np.asarray(req.generated, np.int32)
        if req.want_logprobs:
            self._logprob_results[req.rid] = np.asarray(
                req.logprobs, np.float32
            )

    def _on_retire(self, i: int) -> None:
        """Hook: slot i's request just finished (the paged engine frees its
        blocks here)."""

    def _admit_waiting(self) -> list:
        """Admit queued requests into free slots. Returns the admission-time
        deliveries [(callback, [token]), ...] for step() to fire after all
        bookkeeping."""
        fired: list = []
        for i in range(self.n_slots):
            if self._slot_req[i] is not None:
                continue
            # A request done at admission (budget 1, or eos first) never
            # occupies the slot: keep feeding the slot from the queue.
            while self._queue:
                req = self._queue.popleft()
                placed = self._install(req, i)
                if placed is None:
                    self._queue.appendleft(req)
                    return fired
                first, prompt_end = placed
                req.generated.append(first)
                if req.on_token is not None:
                    fired.append((req.on_token, [first]))
                if req.max_new_tokens <= 1 or (
                    self.eos_id is not None and first == self.eos_id
                ):
                    self._record_result(req)
                    self._on_retire(i)  # release a paged reservation
                    continue
                self._occupy(i, req, first, prompt_end)
                break
        return fired

    def _occupy(self, i: int, req: Request, first: int, prompt_end: int):
        """Set slot i's device state for an admitted request."""
        self._slot_req[i] = req
        self.pos[i] = prompt_end
        self.temp[i] = req.temperature
        self.top_p[i] = req.top_p
        self.presence[i] = req.presence_penalty
        self.frequency[i] = req.frequency_penalty
        if req.presence_penalty or req.frequency_penalty:
            # Generated-only histogram: the admission token alone.
            if self.counts is None:
                self.counts = torch.zeros(
                    (self.n_slots, self.cfg.vocab_size), dtype=torch.int32,
                    device=self.device)
            self.counts[i] = 0
            self.counts[i, first] = 1
        self.keys[i] = self._req_key(req)
        if self._burst_params is not self.params:
            self._slot_ids[i] = self._adapter_idx[req.adapter]
        self.last_tok[i] = first
        self.remaining[i] = req.max_new_tokens - 1
        self.active[i] = True
        self._active_host[i] = True

    @torch.inference_mode()
    def step(self):
        """One scheduler iteration: retire, admit, one decode burst."""
        self._retire()
        fired = self._admit_waiting()
        if not self._active_host.any():
            self._deliver(fired)
            return
        reqs = [r for r in self._slot_req if r is not None]
        want_lp = any(r.want_logprobs for r in reqs)
        want_tp = any(r.top_p < 1.0 and r.temperature > 0 for r in reqs)
        want_pen = any(r.presence_penalty or r.frequency_penalty for r in reqs)
        toks, emitted, lps = self._run_burst(want_lp, want_tp, want_pen)
        # Record every slot's tokens, then fire every callback: a raising
        # sink never costs any request its tokens or another sink its
        # delivery.
        for i in range(self.n_slots):
            req = self._slot_req[i]
            if req is None:
                continue
            new = toks[emitted[:, i], i].tolist()
            req.generated.extend(new)
            if req.want_logprobs:
                req.logprobs.extend(lps[emitted[:, i], i].tolist())
            if req.on_token is not None and new:
                fired.append((req.on_token, new))
        self._deliver(fired)

    @staticmethod
    def _deliver(fired: list) -> None:
        """Fire streaming sinks; every sink gets its delivery before the
        first exception (if any) propagates."""
        first_exc = None
        for cb, new in fired:
            try:
                cb(new)
            except Exception as e:  # noqa: BLE001 — deliver to all sinks
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc

    def _step_fn(self):
        """(tokens, pos, active) -> logits for one decode step over the
        engine's KV store."""
        def step(tokens, pos, active):
            del active  # a dense slot's idle frontier rewrite is harmless
            return _perslot_decode_step(self._burst_params, tokens,
                                        self.cache, pos, self.cfg)
        return step

    def _run_burst(self, with_logprobs: bool = False, with_top_p: bool = False,
                   with_penalties: bool = False):
        """`steps_per_sync` decode steps with no host sync, then one copy to
        the host. Returns numpy (toks [steps, b], emitted [steps, b] bool,
        lps [steps, b] f32)."""
        (self.pos, self.last_tok, self.remaining, self.active, toks, emitted,
         lps) = _burst(
            self._step_fn(), self.pos, self.last_tok, self.remaining,
            self.active, self.temp, self.keys, self.steps_per_sync,
            self.eos_id, with_logprobs, self.top_p if with_top_p else None,
            (self.presence, self.frequency, self.counts) if with_penalties
            else None)
        # One device-to-host copy: tokens, flags and the f32 log-probs'
        # bits as int32, and the active flags.
        packed = torch.cat([
            toks.to(torch.int32).reshape(-1),
            emitted.to(torch.int32).reshape(-1),
            lps.view(torch.int32).reshape(-1),
            self.active.to(torch.int32),
        ]).cpu().numpy()
        s, b = toks.shape
        toks_h, emitted_h, lps_h = packed[:3 * s * b].reshape(3, s, b)
        self._active_host = packed[3 * s * b:].astype(bool)
        return toks_h, emitted_h.astype(bool), lps_h.view(np.float32)

    def take_logprobs(self, rid: int):
        """Pop the finished request's per-token model log-probs (aligned 1:1
        with its result tokens). None unless it was submitted with
        logprobs=True and has finished."""
        return self._logprob_results.pop(rid, None)

    @torch.inference_mode()
    def cancel(self, rid: int) -> bool:
        """Cancel a request: a queued one is dropped, an active one stops at
        the sync boundary; either way its tokens so far become its result.
        False when the rid is unknown or already finished."""
        for idx, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[idx]
                self._record_result(req)
                return True
        for i in range(self.n_slots):
            req = self._slot_req[i]
            if req is not None and req.rid == rid:
                # A slot may hold a request that finished in the last burst
                # and was not swept yet: a completion, not a cancellation.
                was_active = bool(self._active_host[i])
                self.active[i] = False
                self._active_host[i] = False
                self._retire()
                return was_active
        return False

    def stats(self) -> dict:
        """Scheduler snapshot: queue depth, slot occupancy, finished-but-
        uncollected results (the paged engine adds pool use)."""
        return {
            "queued": len(self._queue),
            "active_slots": int(self._active_host.sum()),
            "occupied_slots": sum(r is not None for r in self._slot_req),
            "n_slots": self.n_slots,
            "results_pending": len(self._results),
        }

    def run(self) -> dict[int, np.ndarray]:
        """Drain the queue and all active slots; returns {rid: generated}."""
        while self._queue or any(r is not None for r in self._slot_req):
            self.step()
        self._retire()
        out, self._results = self._results, {}
        # Keep only this drain's unclaimed log-probs.
        self._logprob_results = {
            r: v for r, v in self._logprob_results.items() if r in out
        }
        return out


def _int8_kv_store(shape, device) -> dict:
    """Zeroed int8 K/V with one f32 scale per head_dim vector."""
    sshape = shape[:-1] + (1,)
    return {
        "kq": torch.zeros(shape, dtype=torch.int8, device=device),
        "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
        "vq": torch.zeros(shape, dtype=torch.int8, device=device),
        "vs": torch.zeros(sshape, dtype=torch.float32, device=device),
    }
