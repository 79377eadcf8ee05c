"""Weight-only int8/int4 and KV-cache int8 quantization: the counterpart of
bee_code_interpreter_fs_tpu/models/quant.py.

Same recipes, bit for bit: scale math in f32, round half to even
(``torch.round``, as ``jnp.round``), clip, cast.

- int8, symmetric per output channel: for ``w [*, in, out]``,
  ``s = max(|w|, dim=-2) / 127``, ``q = clip(round(w / s), -127, 127)``.
- int4, symmetric per (group of ``group`` inputs, output channel):
  ``s4 [*, in/group, 1, out]``, values in [-7, 7], two nibbles per int8
  along the input axis (even rows low nibble, odd rows high).
- KV cache, per head_dim vector: ``quantize_kv`` / ``dequantize_kv``.

A quantized weight is a small module holding its tensors as buffers
(``Int8Weight`` with ``q``/``s``, ``Int4Weight`` with ``q4``/``s4``); it
takes the place of the dense Parameter on a ``Block`` (or the model's
``lm_head``), and ``models/llama.py::_w`` dequantizes it at the use site.
PyTorch does not fuse that dequantize into the matmul as XLA does: each
use materializes a copy of the weight in the compute dtype.

Quantized: the seven per-layer matmul weights and lm_head. Left as they
are: the embedding (a gather), the norms. The tp sharding specs
(``quantized_param_specs``) come with the dp/tp slice of the port.
"""

from __future__ import annotations

import copy
import itertools

import torch
from torch import nn

# Per-layer matmul weights that quantize (the Block attributes).
QUANTIZED_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Int8Weight(nn.Module):
    """An int8 weight leaf: ``w ≈ q * s`` (q int8 [*, in, out], s f32
    [*, 1, out])."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


class Int4Weight(nn.Module):
    """A packed int4 weight leaf: q4 int8 [*, in/2, out] (two nibbles a
    byte), s4 f32 [*, in/group, 1, out]."""

    def __init__(self, q4: torch.Tensor, s4: torch.Tensor):
        super().__init__()
        self.register_buffer("q4", q4)
        self.register_buffer("s4", s4)


def _sym_int8(x: torch.Tensor, dim: int):
    """The one symmetric-int8 recipe, in f32. Returns (q int8, s f32)."""
    x32 = x.float()
    s = x32.abs().amax(dim=dim, keepdim=True) / 127.0
    s = s.clamp_min(1e-12)  # an all-zero vector must not divide by zero
    q = torch.round(x32 / s).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_int8(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8 over the contraction dim (-2)."""
    return Int8Weight(*_sym_int8(w, dim=-2))


def is_quantized(leaf) -> bool:
    return isinstance(leaf, Int8Weight)


def dequantize(leaf: Int8Weight, dtype) -> torch.Tensor:
    return leaf.q.to(dtype) * leaf.s.to(dtype)


def quantize_int4(w: torch.Tensor, group: int = 128) -> Int4Weight:
    """Symmetric group-wise int4, packed two values a byte (see the module
    docstring). `group` clamps to the input dim, which it must divide."""
    w32 = w.float()
    *lead, n_in, n_out = w32.shape
    group = min(group, n_in)
    if n_in % group or group % 2:
        raise ValueError(f"in dim {n_in} must divide by even group {group}")
    g = w32.reshape(*lead, n_in // group, group, n_out)
    s = (g.abs().amax(dim=-2, keepdim=True) / 7.0).clamp_min(1e-12)
    q = torch.round(g / s).clamp(-7, 7).to(torch.int8).reshape(*lead, n_in, n_out)
    lo = q[..., 0::2, :] & 0x0F
    hi = q[..., 1::2, :] & 0x0F
    return Int4Weight((lo | (hi << 4)).to(torch.int8), s)


def is_quantized4(leaf) -> bool:
    return isinstance(leaf, Int4Weight)


def dequantize4(leaf: Int4Weight, dtype) -> torch.Tensor:
    packed, s = leaf.q4, leaf.s4
    *lead, half_in, n_out = packed.shape
    n_in = 2 * half_in
    group = n_in // s.shape[-3]
    # Sign-extend each nibble: int8 << wraps into the sign bit, >> is
    # arithmetic (as in XLA).
    lo = (packed << 4) >> 4
    hi = packed >> 4
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, n_in, n_out)
    g = q.reshape(*lead, n_in // group, group, n_out)
    return (g.float() * s).reshape(*lead, n_in, n_out).to(dtype)


def set_weight(module: nn.Module, name: str, leaf) -> None:
    """Put a weight leaf (a dense Parameter or a quantized module) on
    `module` under `name`, whatever kind it held before."""
    module._parameters.pop(name, None)
    module._modules.pop(name, None)
    setattr(module, name, leaf)


def _shallow(module: nn.Module) -> nn.Module:
    """A copy of `module` whose parameter, buffer and child tables are new
    dicts holding the same objects: replacing an entry leaves the original
    as it was, and no tensor is copied."""
    out = copy.copy(module)
    out._parameters = dict(module._parameters)
    out._buffers = dict(module._buffers)
    out._modules = dict(module._modules)
    return out


def with_layer_weights(params, names, make):
    """A new model sharing every tensor of `params`, whose layer i weight
    `name` (for each of `names`) becomes make(name, i, weight)."""
    out = _shallow(params)
    layers = nn.ModuleList()
    for i, blk in enumerate(params.layers):
        new = _shallow(blk)
        for name in names:
            set_weight(new, name, make(name, i, getattr(blk, name)))
        layers.append(new)
    out.layers = layers
    return out


def _with_matmul_weights(params, fn):
    """A new model sharing every tensor of `params` except the matmul
    weights, which become fn(weight). No dense weight is copied."""
    out = with_layer_weights(params, QUANTIZED_LAYER_WEIGHTS,
                             lambda name, i, w: fn(w))
    set_weight(out, "lm_head", fn(params.lm_head))
    return out


@torch.no_grad()
def quantize_params(params):
    """int8-quantize a Llama module's matmul weights (weight-only). Returns
    a new module; everything else is shared with `params`."""
    return _with_matmul_weights(params, quantize_int8)


@torch.no_grad()
def quantize4_params(params, group: int = 128):
    """int4-quantize the same weight set as quantize_params."""
    return _with_matmul_weights(params, lambda w: quantize_int4(w, group))


def quantized_nbytes(params) -> int:
    """Bytes of every weight tensor (a quantized leaf counts its q and s)."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(params.parameters(), params.buffers()))


@torch.no_grad()
def random_quantized_params(generator: torch.Generator, cfg,
                            precision: str = "int8", device=None):
    """Random weights at cfg's shapes with the matmul weights already
    quantized: the dense matmul weights never exist, so peak memory stays
    at the quantized footprint. Scales are those of a symmetric-quantized
    fan_in**-0.5 Gaussian; other leaves: norms ones, the embedding normal,
    nothing else. `generator` must live on `device`."""
    from bee_code_interpreter_fs_tpu_torch.models.llama import Llama

    if precision not in ("int8", "int4"):
        raise ValueError(f"precision must be int8 or int4, got {precision!r}")

    def leaf(n_in, n_out, dtype, device):
        if precision == "int4":
            group = min(128, n_in)
            q4 = torch.randint(-128, 128, (n_in // 2, n_out), generator=generator,
                               dtype=torch.int8, device=device)
            s4 = torch.full((n_in // group, 1, n_out), n_in ** -0.5 / 7.0,
                            dtype=torch.float32, device=device)
            return Int4Weight(q4, s4)
        q = torch.randint(-127, 128, (n_in, n_out), generator=generator,
                          dtype=torch.int8, device=device)
        s = torch.full((1, n_out), n_in ** -0.5 / 127.0, dtype=torch.float32,
                       device=device)
        return Int8Weight(q, s)

    model = Llama(cfg, device, matmul_weight=leaf)
    model.embed.copy_(torch.randn(model.embed.shape, generator=generator,
                                  dtype=torch.float32, device=model.device))
    for norm in [model.final_norm] + [w for blk in model.layers
                                      for w in (blk.attn_norm, blk.mlp_norm)]:
        norm.fill_(1.0)
    return model


# ---------------------------------------------------------- KV-cache int8

def quantize_kv(x: torch.Tensor):
    """Symmetric per-vector int8 for K/V cache entries: one f32 scale per
    trailing head_dim vector. Returns (q int8 [...], s f32 [..., 1])."""
    return _sym_int8(x, dim=-1)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """``q * s`` in the compute dtype, at the attention read."""
    return q.to(dtype) * s.to(dtype)
