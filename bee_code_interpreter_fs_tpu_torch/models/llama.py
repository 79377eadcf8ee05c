"""Dense Llama in PyTorch: the counterpart of
bee_code_interpreter_fs_tpu/models/llama.py for the paths this package runs.

Weights keep the reference's [in, out] layout (``h @ W``), bf16 (or the
config's dtype) on the matmul path and f32 norm weights; a matmul weight
may be an int8 or int4 leaf (models/quant.py), dequantized at each use, or a LoRA leaf
(models/lora.py) applied activation-side. The reference's
stacked [n_layers, ...] leaves become one ``Block`` per layer in a
``ModuleList``, and its layer scan a loop over them. Forward attention is
"plain" (dense scores, rounded in the model dtype as the reference does)
or "flash" (ops/flash_attention.py: the CUDA kernel on the card); a mesh
with sp > 1 runs it sequence-parallel (ring or Ulysses, parallel/). The
cached decode path (prefill / decode_chunk / decode_step) uses plain
attention, as the reference does.

Sampling (``sample_generate``, and the serving engines) draws from the
port's own counter-based stream, not jax.random's (see "sampling" below).

The KV cache is updated IN PLACE: prefill and decode_chunk write their K/V
into the cache tensors they are given and return that same dict (JAX
donates the cache instead). A write past the cache's end raises; it is
never clamped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bee_code_interpreter_fs_tpu_torch.device import resolve_device
from bee_code_interpreter_fs_tpu_torch.models.config import (
    LlamaConfig,
    check_supported,
)
from bee_code_interpreter_fs_tpu_torch.models.lora import (
    MultiLoraWeight,
    is_lora_leaf,
)
from bee_code_interpreter_fs_tpu_torch.models.quant import (
    dequantize,
    dequantize4,
    is_quantized,
    is_quantized4,
)
from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import flash_attention
from bee_code_interpreter_fs_tpu_torch.parallel.mesh import Mesh
from bee_code_interpreter_fs_tpu_torch.parallel.ring_attention import ring_attention
from bee_code_interpreter_fs_tpu_torch.parallel.ulysses import ulysses_attention

MASK_VALUE = -1e30
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_dtype(cfg: LlamaConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}") from None


def _weight(*shape, dtype, device):
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


def _dense_weight(n_in, n_out, dtype, device):
    return _weight(n_in, n_out, dtype=dtype, device=device)


class Block(nn.Module):
    """One decoder layer's weights (the reference's `layers` leaves at one
    layer index). A matmul weight is a dense Parameter or a quantized leaf
    (models/quant.py); `matmul_weight(n_in, n_out, dtype, device)` makes
    each one."""

    def __init__(self, cfg: LlamaConfig, dtype, device,
                 matmul_weight=_dense_weight):
        super().__init__()
        dim, hd = cfg.dim, cfg.head_dim
        nh, nkv, hidden = cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim
        self.attn_norm = _weight(dim, dtype=torch.float32, device=device)
        self.wq = matmul_weight(dim, nh * hd, dtype, device)
        self.wk = matmul_weight(dim, nkv * hd, dtype, device)
        self.wv = matmul_weight(dim, nkv * hd, dtype, device)
        self.wo = matmul_weight(nh * hd, dim, dtype, device)
        self.mlp_norm = _weight(dim, dtype=torch.float32, device=device)
        self.w_gate = matmul_weight(dim, hidden, dtype, device)
        self.w_up = matmul_weight(dim, hidden, dtype, device)
        self.w_down = matmul_weight(hidden, dim, dtype, device)


class Llama(nn.Module):
    """The model's parameters: embed, per-layer blocks, final norm, head
    (run them with ``forward``)."""

    def __init__(self, cfg: LlamaConfig, device=None, *,
                 matmul_weight=_dense_weight):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        dtype = model_dtype(cfg)
        self.embed = _weight(cfg.vocab_size, cfg.dim, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device, matmul_weight) for _ in range(cfg.n_layers)
        )
        self.final_norm = _weight(cfg.dim, dtype=torch.float32, device=device)
        self.lm_head = matmul_weight(cfg.dim, cfg.vocab_size, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------- params

def init_params(cfg: LlamaConfig, generator: torch.Generator, device=None) -> Llama:
    """Random weights (counterpart of the reference's init_params): normal
    draws scaled by fan_in**-0.5, made in f32 and cast to the model dtype;
    norm weights are f32 ones. `generator` must live on `device`. Torch and
    JAX give different numbers from one seed; parity tests convert JAX's
    weights instead (models/convert.py)."""
    model = Llama(cfg, device)
    dev = model.device

    def dense(param, fan_in):
        draw = torch.randn(param.shape, generator=generator,
                           dtype=torch.float32, device=dev)
        param.copy_(draw * fan_in ** -0.5)

    with torch.no_grad():
        dense(model.embed, 1.0)
        for blk in model.layers:
            blk.attn_norm.fill_(1.0)
            dense(blk.wq, cfg.dim)
            dense(blk.wk, cfg.dim)
            dense(blk.wv, cfg.dim)
            dense(blk.wo, cfg.n_heads * cfg.head_dim)
            blk.mlp_norm.fill_(1.0)
            dense(blk.w_gate, cfg.dim)
            dense(blk.w_up, cfg.dim)
            dense(blk.w_down, cfg.hidden_dim)
        model.final_norm.fill_(1.0)
        dense(model.lm_head, cfg.dim)
    return model


# ---------------------------------------------------------------- forward

def _rms_norm(x, w, eps):
    """f32 statistics, cast back to x's dtype, THEN scaled by w in x's dtype
    (the norm weights are f32 while activations may be bf16)."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w.to(x.dtype)


def _rope(x, theta, offset=0):
    """Rotary embedding over [b, t, h, d] on INTERLEAVED lane pairs
    (x[..., 0::2], x[..., 1::2]). `offset` shifts positions: an int, or a
    [b] tensor (each row at its own position). cos and sin are cast to x's
    dtype before the multiply."""
    b, t, h, d = x.shape
    freqs = theta ** (
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    )
    if isinstance(offset, torch.Tensor):
        off = offset.to(device=x.device, dtype=torch.float32).reshape(-1)
    else:  # filled on the device: no host-to-device copy per call
        off = torch.full((1,), float(offset), dtype=torch.float32, device=x.device)
    positions = (
        torch.arange(t, dtype=torch.float32, device=x.device)[None, :]
        + off[:, None]
    )
    angles = positions[..., None] * freqs[None, None, :]  # [b|1, t, d/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, t, h, d)


def _plain_causal_attention(q, k, v, scale, window: int = 0, sinks: int = 0):
    """Dense causal attention. The score product runs in the input dtype
    (so bf16 scores are rounded) and only then goes to f32, as the
    reference does; the flash path scores in f32 and so differs by design
    in bf16."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    t = q.shape[1]
    ones = torch.ones((t, t), dtype=torch.bool, device=q.device)
    mask = torch.tril(ones)
    if window > 0:
        visible = torch.tril(ones, -window).logical_not()
        if sinks > 0:
            visible = visible | (torch.arange(t, device=q.device) < sinks)[None, :]
        mask = mask & visible
    s = torch.where(mask[None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _expand_gqa(k, v, n_heads):
    """Repeat kv heads up to n_heads: head i reads kv head i // rep."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _w(leaf, dt):
    """Matmul-weight accessor: a dense tensor casts to dt (a no-op at the
    model dtype); int8 and int4 leaves (models/quant.py) dequantize here, at
    the use site, into a dt copy of the weight. A LoRA leaf resolves to
    ``base + a @ b`` (a fallback that builds the [in, out] delta: every
    model matmul goes through _mm, which never does)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(dt)
    if is_quantized(leaf):
        return dequantize(leaf, dt)
    if is_quantized4(leaf):
        return dequantize4(leaf, dt)
    if isinstance(leaf, MultiLoraWeight):
        raise TypeError(
            "multi-adapter LoRA leaves select weights per batch row and "
            "have no single-matrix form; _mm applies them activation-side"
        )
    if is_lora_leaf(leaf):
        return _w(leaf.base, dt) + leaf.lora_a.to(dt) @ leaf.lora_b.to(dt)
    raise TypeError(f"unknown weight leaf {type(leaf).__name__}")


def _mm(h, leaf, dt):
    """``h @ W`` for any weight-leaf kind the port runs. LoRA leaves apply
    activation-side, ``h @ base + (h @ a) @ b``: two skinny matmuls, the
    dense delta never built; a multi-adapter leaf gathers each row's
    selected adapter (before the cast, so only the b selected ones
    convert) and runs the two products batched over rows."""
    if isinstance(leaf, MultiLoraWeight):
        ids = leaf.lora_ids
        a_sel = leaf.lora_a_stack[ids].to(dt)  # [b, in, r]
        b_sel = leaf.lora_b_stack[ids].to(dt)  # [b, r, out]
        delta = torch.einsum("btr,bro->bto",
                             torch.einsum("btd,bdr->btr", h, a_sel), b_sel)
        return _mm(h, leaf.base, dt) + delta
    if is_lora_leaf(leaf):
        return (_mm(h, leaf.base, dt)
                + (h @ leaf.lora_a.to(dt)) @ leaf.lora_b.to(dt))
    return h @ _w(leaf, dt)


def transformer_block(x, lp: Block, cfg: LlamaConfig, attn_fn, *, rope_offset=0):
    """One pre-norm decoder block. `attn_fn(q, k, v)` receives UNexpanded kv
    heads ([b, t, n_kv_heads, hd])."""
    b, t, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    h = _rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = _mm(h, lp.wq, dt).reshape(b, t, nh, hd)
    k = _mm(h, lp.wk, dt).reshape(b, t, nkv, hd)
    v = _mm(h, lp.wv, dt).reshape(b, t, nkv, hd)
    q = _rope(q, cfg.rope_theta, offset=rope_offset)
    k = _rope(k, cfg.rope_theta, offset=rope_offset)
    attn = attn_fn(q, k, v)
    x = x + _mm(attn.reshape(b, t, nh * hd), lp.wo, dt)

    h = _rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    gate = F.silu(_mm(h, lp.w_gate, dt))
    return x + _mm(gate * _mm(h, lp.w_up, dt), lp.w_down, dt)


def _logits(params: Llama, x, cfg: LlamaConfig):
    x = _rms_norm(x, params.final_norm, cfg.norm_eps)
    return _mm(x, params.lm_head, x.dtype).float()


def _embed(params: Llama, tokens, dt):
    tokens = torch.as_tensor(tokens, device=params.device)
    return params.embed.to(dt)[tokens.long()]


def forward(params: Llama, tokens, cfg: LlamaConfig, *, mesh: Mesh | None = None):
    """Token ids [b, t] -> logits [b, t, vocab] (float32), on the params'
    device. `attn_impl="flash"` runs ops/flash_attention.py (the CUDA kernel
    on the card, once per layer).

    If `mesh` (parallel.mesh.Mesh) has an "sp" axis of size > 1, attention
    runs sequence-parallel with the strategy cfg.sp_impl selects: "ring"
    (K/V chunks around the ring; with flash, the ring-step kernel once per
    live (rank, step)) or "ulysses" (head/sequence regroup, full-sequence
    attention per rank; with flash, the flash kernel once per rank). A mesh
    with sp = 1 is the single-device forward."""
    check_supported(cfg)
    dt = model_dtype(cfg)
    nh = cfg.n_heads
    scale = cfg.head_dim ** -0.5
    use_sp = mesh is not None and mesh.sp > 1
    if use_sp and cfg.sliding_window > 0:
        raise ValueError(
            "sliding_window is not composed with sequence parallelism "
            "(windowing across ring/ulysses shards is unimplemented); "
            "use a mesh without an sp axis"
        )
    if use_sp:
        use_flash = cfg.attn_impl == "flash"
        if mesh.device.type != params.device.type:
            raise ValueError(f"mesh is on {mesh.device}, params on {params.device}")
        if cfg.sp_impl == "ulysses":
            # Ulysses takes UNexpanded kv: when the kv head count divides
            # sp they regroup at 1/rep the bytes and expand after.
            def attn_fn(q, k, v):
                return ulysses_attention(q, k, v, mesh, scale=scale,
                                         use_flash=use_flash)
        elif cfg.sp_impl == "ring":
            def attn_fn(q, k, v):
                return ring_attention(q, *_expand_gqa(k, v, nh), mesh,
                                      scale=scale, use_flash=use_flash)
        else:
            raise ValueError(
                f"sp_impl must be 'ring' or 'ulysses', got {cfg.sp_impl!r}"
            )
    elif cfg.attn_impl == "flash":
        def attn_fn(q, k, v):
            return flash_attention(
                q, *_expand_gqa(k, v, nh), scale=scale,
                window=cfg.sliding_window, sinks=cfg.attention_sinks,
            )
    else:
        def attn_fn(q, k, v):
            return _plain_causal_attention(
                q, *_expand_gqa(k, v, nh), scale,
                window=cfg.sliding_window, sinks=cfg.attention_sinks,
            )

    x = _embed(params, tokens, dt)
    for lp in params.layers:
        x = transformer_block(x, lp, cfg, attn_fn)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------- decoding

def init_cache(cfg: LlamaConfig, batch_size: int, max_len: int | None = None,
               device=None):
    """Stacked per-layer KV cache with unexpanded GQA heads:
    {"k"|"v": [L, b, max_len, n_kv, head_dim]} zeros in the model dtype."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    dt = model_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def resolve_cache_len(needed: int, max_len: int | None, *,
                      what: str = "prompt+new") -> int:
    """Default max_len to exactly what the generation needs; refuse an
    explicit max_len that cannot hold it."""
    max_len = max_len or needed
    if max_len < needed:
        raise ValueError(
            f"max_len={max_len} < {what}={needed}: cache too small"
        )
    return max_len


def decode_valid_mask(q_pos, max_len, cfg: LlamaConfig):
    """Which cache positions queries at positions `q_pos` [n] may attend:
    the causal prefix, minus what a sliding window retires, plus sinks.
    Returns bool [n, max_len]."""
    q_pos = torch.as_tensor(q_pos)
    cols = torch.arange(max_len, device=q_pos.device)[None, :]
    valid = cols <= q_pos[:, None]
    if cfg.sliding_window > 0:
        visible = cols > q_pos[:, None] - cfg.sliding_window
        if cfg.attention_sinks > 0:
            visible = visible | (cols < cfg.attention_sinks)
        valid = valid & visible
    return valid


def _cached_gqa_attention(q, keys, values, valid, scale):
    """Attention of q [b, t, nh, hd] against an UNexpanded cache
    [b, max, nkv, hd] through a grouped contraction (query head i reads kv
    head i // rep), with no copy of the cache."""
    b, t, nh, hd = q.shape
    nkv = keys.shape[2]
    rep = nh // nkv
    qg = q.reshape(b, t, nkv, rep, hd)
    s = torch.einsum("btgrd,bkgd->bgrtk", qg, keys).float() * scale
    s = torch.where(valid, s, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    attn = torch.einsum("bgrtk,bkgd->btgrd", p, values)
    return attn.reshape(b, t, nh, hd)


def _check_write(pos: int, s: int, max_len: int):
    if pos < 0 or pos + s > max_len:
        raise ValueError(
            f"cache write at positions {pos}..{pos + s - 1} is past the "
            f"cache's max_len {max_len}"
        )


def prefill(params: Llama, tokens, cache, cfg: LlamaConfig):
    """The whole prompt in one pass, writing every K/V position into the
    cache (in place). Returns (last-position logits [b, vocab] f32, cache)."""
    check_supported(cfg)
    dt = model_dtype(cfg)
    scale = cfg.head_dim ** -0.5
    t = tokens.shape[1]
    if t > cache["k"].shape[2]:
        raise ValueError(
            f"prompt length {t} exceeds cache max_len {cache['k'].shape[2]}"
        )
    x = _embed(params, tokens, dt)
    for i, lp in enumerate(params.layers):
        def attn_fn(q, k, v, i=i):
            cache["k"][i, :, :t] = k
            cache["v"][i, :, :t] = v
            return _plain_causal_attention(
                q, *_expand_gqa(k, v, cfg.n_heads), scale,
                window=cfg.sliding_window, sinks=cfg.attention_sinks,
            )

        x = transformer_block(x, lp, cfg, attn_fn)
    return _logits(params, x[:, t - 1], cfg), cache


def decode_chunk(params: Llama, tokens, cache, pos: int, cfg: LlamaConfig):
    """`s` tokens at positions pos..pos+s-1 against the cache (written in
    place): each attends to every cache position up to itself. Returns
    (logits [b, s, vocab] f32, cache)."""
    check_supported(cfg)
    dt = model_dtype(cfg)
    scale = cfg.head_dim ** -0.5
    s = tokens.shape[1]
    max_len = cache["k"].shape[2]
    pos = int(pos)
    _check_write(pos, s, max_len)
    q_pos = pos + torch.arange(s, device=cache["k"].device)
    valid = decode_valid_mask(q_pos, max_len, cfg)[None, None, None]
    x = _embed(params, tokens, dt)
    for i, lp in enumerate(params.layers):
        def attn_fn(q, k, v, i=i):
            cache["k"][i, :, pos:pos + s] = k
            cache["v"][i, :, pos:pos + s] = v
            return _cached_gqa_attention(q, cache["k"][i], cache["v"][i],
                                         valid, scale)

        x = transformer_block(x, lp, cfg, attn_fn, rope_offset=pos)
    return _logits(params, x, cfg), cache


def decode_step(params: Llama, tokens, cache, pos: int, cfg: LlamaConfig):
    """One token per row at position `pos`: decode_chunk with s=1.
    Returns (logits [b, vocab] f32, cache)."""
    logits, cache = decode_chunk(params, tokens, cache, pos, cfg)
    return logits[:, 0], cache


@torch.inference_mode()
def greedy_generate(params: Llama, prompt_tokens, cfg: LlamaConfig, *,
                    max_new_tokens: int, max_len: int | None = None,
                    eos_id=None):
    """Greedy decode: one batched prefill, then one decode step per new
    token, each picking the first maximal logit. Returns int32
    [b, prompt + max_new_tokens] on the params' device.

    `eos_id` (None = off): a row that emits it has every later position
    pinned to eos_id (the shape stays fixed, as in the reference)."""
    prompt = torch.as_tensor(prompt_tokens, device=params.device).to(torch.int32)
    b, prompt_len = prompt.shape
    max_len = resolve_cache_len(prompt_len + max_new_tokens, max_len)
    if max_new_tokens == 0:
        return prompt
    cache = init_cache(cfg, b, max_len, device=params.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    done = torch.zeros(b, dtype=torch.bool, device=params.device)
    new_tokens = []
    for i in range(max_new_tokens):
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        if eos_id is not None:
            token = torch.where(done, torch.full_like(token, eos_id), token)
            done = done | (token == eos_id)
        new_tokens.append(token)
        if i + 1 < max_new_tokens:  # the last token's logits are unused
            logits, cache = decode_step(params, token[:, None], cache,
                                        prompt_len + i, cfg)
    return torch.cat([prompt, torch.stack(new_tokens, dim=1)], dim=1)


def generate(params: Llama, prompt_tokens, cfg: LlamaConfig, *,
             max_new_tokens: int, max_len: int | None = None):
    """Greedy autoregressive generation without eos handling. Returns int32
    [b, prompt + max_new_tokens]."""
    return greedy_generate(params, prompt_tokens, cfg,
                           max_new_tokens=max_new_tokens, max_len=max_len)


# ---------------------------------------------------------------- sampling
#
# The sampling stream. jax.random's threefry bits cannot be reproduced
# cheaply in torch, so the port has its own counter-based stream and its
# sampled tokens are NOT the reference's: they are held to nucleus_mask
# parity, to the stream's invariances (a draw depends only on its key and
# the sampled token's position; temperature 0 is greedy) and to the
# softmax by a distribution test. A draw is Gumbel-max: the token at
# position p of a row with key k is argmax(scaled + g), where g[i] is the
# Gumbel transform of a 32-bit hash of (k, p, i), computed in int64 torch
# ops on the logits' device. Keys are 32-bit: `stream_key(seed, ...)` on
# the host, `fold_key` on the host or the device.

NEG_INF_LOGIT = -1e30  # finite mask value for truncated-sampling logits
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(h, c: int):
    """Low 32 bits of h * c, for h in [0, 2**32) (an int or an int64
    tensor), without an intermediate past 2**49."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2**32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold_key(key, data):
    """The key of `key` folded with `data` (each an int in [0, 2**32) or an
    int64 tensor of such, broadcast)."""
    return _fmix32(key ^ _fmix32((data + _GOLDEN) & _M32))


def stream_key(*values: int) -> int:
    """A 32-bit stream key from host ints (a seed, or a seed and an id);
    each int folds in by its low and high 32-bit halves."""
    key = 0
    for v in values:
        v = int(v) % 2 ** 64
        key = fold_key(fold_key(key, v & _M32), v >> 32)
    return key


def uniform_noise(keys, positions, n: int):
    """Uniform (0, 1) draws [b, n] f32 for rows with stream `keys` [b] at
    `positions` [b] (int64 tensors on one device): draw i hashes (key,
    position, i)."""
    rows = fold_key(keys.long(), positions.long())
    cols = torch.arange(n, dtype=torch.int64, device=keys.device)
    bits = _fmix32(rows[:, None] ^ _fmix32((cols + _GOLDEN) & _M32)[None, :])
    # 23 bits -> u in (0, 1) exactly: (k + 0.5) / 2**23.
    return ((bits >> 9).float() + 0.5) * 2.0 ** -23


def gumbel_noise(keys, positions, vocab: int):
    """Gumbel(0, 1) noise [b, vocab] f32 for rows with stream `keys` [b]
    sampling the token at `positions` [b]: the Gumbel transform of
    uniform_noise."""
    return -torch.log(-torch.log(uniform_noise(keys, positions, vocab)))


def nucleus_mask(scaled, top_p):
    """Top-p truncation: keep the smallest logit-sorted prefix whose
    cumulative probability reaches top_p. A token survives when the mass
    strictly before it is < top_p, so the argmax always survives; top_p >=
    1 keeps every token, bit for bit (an f32 cumulative sum can pass 1.0
    before the last token, which the reference's rule would then drop).
    `top_p` broadcasts against the leading dims (a number, or [b, 1])."""
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = (mass_before < top_p) | (torch.as_tensor(top_p) >= 1.0)
    kept = torch.where(keep, sorted_desc, torch.inf)
    cutoff = kept.amin(dim=-1, keepdim=True)
    return torch.where(scaled < cutoff, NEG_INF_LOGIT, scaled)


def _top_k_mask(scaled, top_k: int):
    kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
    return torch.where(scaled < kth, NEG_INF_LOGIT, scaled)


@torch.inference_mode()
def sample_generate(params: Llama, prompt_tokens, seed: int, cfg: LlamaConfig, *,
                    max_new_tokens: int, temperature: float = 1.0,
                    top_k: int = 0, top_p: float | None = None,
                    max_len: int | None = None, eos_id=None):
    """Stochastic generation: temperature scaling, optional top-k then
    top-p truncation, one Gumbel-max draw per row and step from the port's
    stream (row r's key is stream_key(seed, r); the token at position p
    draws with position p). `eos_id` pins a row's positions after its first
    eos. Returns int32 [b, prompt + max_new_tokens] on the params' device."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    prompt = torch.as_tensor(prompt_tokens, device=params.device).to(torch.int32)
    b, prompt_len = prompt.shape
    max_len = resolve_cache_len(prompt_len + max_new_tokens, max_len)
    if max_new_tokens == 0:
        return prompt
    dev = params.device
    keys = torch.tensor([stream_key(seed, r) for r in range(b)],
                        dtype=torch.int64, device=dev)
    cache = init_cache(cfg, b, max_len, device=dev)
    logits, cache = prefill(params, prompt, cache, cfg)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    new_tokens = []
    for i in range(max_new_tokens):
        scaled = logits / max(temperature, 1e-6)
        if top_k > 0:
            scaled = _top_k_mask(scaled, top_k)
        if top_p is not None:
            scaled = nucleus_mask(scaled, top_p)
        positions = torch.full((b,), prompt_len + i, dtype=torch.int64, device=dev)
        noise = gumbel_noise(keys, positions, scaled.shape[-1])
        token = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
        if eos_id is not None:
            token = torch.where(done, torch.full_like(token, eos_id), token)
            done = done | (token == eos_id)
        new_tokens.append(token)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, token[:, None], cache,
                                        prompt_len + i, cfg)
    return torch.cat([prompt, torch.stack(new_tokens, dim=1)], dim=1)


# ---------------------------------------------------------------- speculative
#
# Lockstep speculative decoding. The reference runs the whole generation as
# one device loop with the batch-minimum acceptance as its carry; here the
# loop runs on the host and reads that one int per pass (it is the `pos` of
# the next pass's decode_chunk). Sampled draws come from the port's stream
# at three independent sites per position, keyed fold_key(row key, tag):
# tag 1 the draft's proposal, tag 2 the accept test, tag 3 the boundary
# (residual or bonus) draw; the first token draws from the row key itself,
# as sample_generate's does.

_TAG_DRAFT, _TAG_ACCEPT, _TAG_BOUNDARY = 1, 2, 3


def _spec_setup(draft_params: Llama, target_params: Llama, prompt_tokens,
                cfg_draft: LlamaConfig, cfg_target: LlamaConfig, *,
                max_new_tokens: int, gamma: int, max_len: int | None,
                plain_decoder: str):
    """Shared preamble: validation, cache sizing (slack: a pass writes up to
    gamma positions past the last emitted token, and the output buffer one
    more), both prefills, and the output buffer with the prompt written.
    An explicit max_len that cannot hold p + max_new_tokens + gamma + 1
    raises; it is never enlarged."""
    if cfg_draft.vocab_size != cfg_target.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if gamma < 1:
        raise ValueError(
            "gamma must be >= 1 (0 proposals leaves nothing to verify; "
            f"use {plain_decoder} for plain decoding)"
        )
    dev = target_params.device
    if draft_params.device != dev:
        raise ValueError(f"draft is on {draft_params.device}, target on {dev}")
    prompt = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    b, p = prompt.shape
    total = p + max_new_tokens + gamma + 1
    max_len = resolve_cache_len(total, max_len, what="prompt+new+gamma+1")
    d_cache = init_cache(cfg_draft, b, max_len, device=dev)
    t_cache = init_cache(cfg_target, b, max_len, device=dev)
    t_logits, t_cache = prefill(target_params, prompt, t_cache, cfg_target)
    _, d_cache = prefill(draft_params, prompt, d_cache, cfg_draft)
    buf = torch.zeros((b, total), dtype=torch.int32, device=dev)
    buf[:, :p] = prompt
    return b, p, d_cache, t_cache, t_logits, buf


def _row_accept(ok, gamma: int):
    """Per row, the length of the leading run of True in ok [b, gamma]."""
    return torch.where(ok.all(dim=1), gamma, torch.argmin(ok.int(), dim=1))


@torch.inference_mode()
def speculative_generate(draft_params: Llama, target_params: Llama, prompt_tokens,
                         cfg_draft: LlamaConfig, cfg_target: LlamaConfig, *,
                         max_new_tokens: int, gamma: int = 4,
                         max_len: int | None = None):
    """Greedy speculative decoding: the draft proposes gamma tokens one step
    at a time, the target scores them all in one decode_chunk, and the
    longest agreeing prefix plus the target's own next token are emitted.
    The output is greedy_generate(target)'s: the draft decides how many
    tokens a pass yields, never which. Rows advance in lockstep by the
    batch-minimum acceptance (rows that agreed longer re-derive the same
    tokens next pass). Returns int32 [b, prompt + max_new_tokens].

    Each pass reads the acceptance to the host once: it is the next pass's
    cache position."""
    b, p, d_cache, t_cache, t_logits, buf = _spec_setup(
        draft_params, target_params, prompt_tokens, cfg_draft, cfg_target,
        max_new_tokens=max_new_tokens, gamma=gamma, max_len=max_len,
        plain_decoder="greedy_generate",
    )
    buf[:, p] = torch.argmax(t_logits, dim=-1).to(torch.int32)
    # Invariant at the top of a pass: n_done tokens emitted; both caches
    # hold positions 0..L-1, L = p + n_done - 1; buf[:, L] is the newest
    # emitted token, fed to neither model yet.
    n_done = 1
    while n_done < max_new_tokens:
        L = p + n_done - 1
        pending = buf[:, L]
        # gamma + 1 draft steps: the last feeds d_gamma so the draft cache
        # covers L + gamma when every proposal is accepted.
        tok, props = pending, []
        for j in range(gamma + 1):
            logits, d_cache = decode_step(draft_params, tok[:, None], d_cache,
                                          L + j, cfg_draft)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            props.append(tok)
        drafts = torch.stack(props[:gamma], dim=1)  # [b, gamma]
        chunk = torch.cat([pending[:, None], drafts], dim=1)
        v_logits, t_cache = decode_chunk(target_params, chunk, t_cache, L,
                                         cfg_target)
        t_preds = torch.argmax(v_logits, dim=-1).to(torch.int32)  # [b, gamma+1]
        accept = int(_row_accept(drafts == t_preds[:, :gamma], gamma).min())
        # The whole prediction row: positions past the acceptance point
        # are rewritten by the next pass before they can be emitted.
        buf[:, L + 1:L + 2 + gamma] = t_preds
        n_done += accept + 1
    return buf[:, :p + max_new_tokens]


@torch.inference_mode()
def speculative_sample_generate(draft_params: Llama, target_params: Llama,
                                prompt_tokens, seed: int, cfg_draft: LlamaConfig,
                                cfg_target: LlamaConfig, *, max_new_tokens: int,
                                gamma: int = 4, temperature: float = 1.0,
                                max_len: int | None = None):
    """Sampled speculative decoding (accept/resample): the draft samples
    gamma proposals at `temperature`, the target scores them in one
    decode_chunk, proposal d_j is accepted when u < p_j(d_j) / q_j(d_j)
    (strict: u never accepts a token of target probability 0), the first
    rejection draws from norm(max(0, p_j - q_j)), and a fully accepted
    pass draws a bonus token from p_{gamma+1}. The emitted sequence is
    distributed as target-only sampling at the same temperature.

    Rows advance in lockstep by the batch-minimum acceptance: the boundary
    token is per-row right (a row still accepting there keeps its draft
    token, a row rejecting there takes its residual draw) and later
    positions are rewritten by the next pass. Row r's stream key is
    stream_key(seed, r); draws come from the port's stream (see
    "sampling"), not jax.random's. One host read per pass, as in
    speculative_generate. Returns int32 [b, prompt + max_new_tokens]."""
    temp = max(float(temperature), 1e-6)
    b, p, d_cache, t_cache, t_logits, buf = _spec_setup(
        draft_params, target_params, prompt_tokens, cfg_draft, cfg_target,
        max_new_tokens=max_new_tokens, gamma=gamma, max_len=max_len,
        plain_decoder="sample_generate",
    )
    dev = buf.device
    vocab = cfg_target.vocab_size
    keys = torch.tensor([stream_key(seed, r) for r in range(b)],
                        dtype=torch.int64, device=dev)
    k_draft, k_accept, k_boundary = (fold_key(keys, tag) for tag in
                                     (_TAG_DRAFT, _TAG_ACCEPT, _TAG_BOUNDARY))

    def draw(row_keys, scores, position: int):
        at = torch.full((b,), position, dtype=torch.int64, device=dev)
        noise = gumbel_noise(row_keys, at, vocab)
        return torch.argmax(scores + noise, dim=-1).to(torch.int32)

    buf[:, p] = draw(keys, t_logits / temp, p)
    n_done = 1
    while n_done < max_new_tokens:
        L = p + n_done - 1
        pending = buf[:, L]
        tok, props, q_logits = pending, [], []
        for j in range(gamma + 1):
            logits, d_cache = decode_step(draft_params, tok[:, None], d_cache,
                                          L + j, cfg_draft)
            tok = draw(k_draft, logits / temp, L + j + 1)
            props.append(tok)
            q_logits.append(logits)
        drafts = torch.stack(props[:gamma], dim=1)  # [b, gamma]
        q_probs = torch.softmax(torch.stack(q_logits[:gamma], dim=1) / temp,
                                dim=-1)  # [b, gamma, V]
        chunk = torch.cat([pending[:, None], drafts], dim=1)
        v_logits, t_cache = decode_chunk(target_params, chunk, t_cache, L,
                                         cfg_target)
        p_probs = torch.softmax(v_logits / temp, dim=-1)  # [b, gamma+1, V]
        at_draft = drafts.long()[..., None]
        p_d = p_probs[:, :gamma].gather(-1, at_draft)[..., 0]
        q_d = q_probs.gather(-1, at_draft)[..., 0]
        ratio = p_d / torch.clamp(q_d, min=1e-30)
        u = uniform_noise(k_accept, torch.full((b,), L, dtype=torch.int64,
                                               device=dev), gamma)
        row_accept = _row_accept(u < ratio, gamma)
        accept = int(row_accept.min())
        idx = min(accept, gamma - 1)
        # The boundary draw: the residual at the rejection point; with every
        # proposal accepted, q := 0 and the residual is p_{gamma+1} itself.
        p_at = p_probs[:, accept]
        q_at = q_probs[:, idx] if accept < gamma else torch.zeros_like(p_at)
        residual = torch.clamp(p_at - q_at, min=0.0)
        boundary = draw(k_boundary, torch.log(residual + 1e-30), L + 1 + accept)
        final = torch.where(row_accept > accept, drafts[:, idx], boundary)
        row = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        row[:, accept] = final
        buf[:, L + 1:L + 2 + gamma] = row
        n_done += accept + 1
    return buf[:, :p + max_new_tokens]
