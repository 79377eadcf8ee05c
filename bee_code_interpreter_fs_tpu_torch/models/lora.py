"""LoRA / QLoRA adapters and multi-adapter stacks: the counterpart of
bee_code_interpreter_fs_tpu/models/lora.py for the paths this package runs.

- An adapter tree is ``{"layers": {target: {"a": [L, in, r], "b": [L, r,
  out]}}}`` of f32 tensors (``init_lora``: fan-in-scaled normal ``a``,
  zero ``b``; ``zero_lora``: all zeros, the identity).
- ``lora_wrap`` returns a new ``Llama`` sharing every tensor of the base,
  whose target weights are ``LoraWeight`` leaves (``base`` plus
  ``lora_a [in, r]`` and ``lora_b [r, out]``, the alpha/rank scale folded
  into ``lora_b``). ``models/llama.py::_mm`` applies the update on the
  activation side, ``h @ base + (h @ a) @ b``, so the [in, out] delta is
  never built; ``base`` may be an int8 or int4 leaf (QLoRA).
- ``merge_lora`` folds adapters into dense base weights (a quantized base
  refuses: merging would dequantize it).
- ``stack_loras`` stacks N adapters into a bank (``a [L, N, in, r]``, ``b
  [L, N, r, out]``, scale folded in once); ``multi_lora_wrap`` makes
  ``MultiLoraWeight`` leaves that apply row i's adapter ``ids[i]``. The
  ids tensor is shared by every leaf and read at each use, so a caller
  changes the selection by writing into it in place (the serving engines
  do), never by rebuilding the model.

Training (``make_lora_train_step``) comes with the training slice, and the
tp sharding specs (``lora_param_specs``) with the dp/tp slice.
"""

from __future__ import annotations

import torch
from torch import nn

from bee_code_interpreter_fs_tpu_torch.device import resolve_device
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.quant import (
    is_quantized,
    is_quantized4,
    set_weight,
    with_layer_weights,
)

__all__ = [
    "DEFAULT_TARGETS",
    "LoraWeight",
    "MultiLoraWeight",
    "init_lora",
    "is_lora_leaf",
    "lora_wrap",
    "merge_lora",
    "multi_lora_wrap",
    "stack_loras",
    "zero_lora",
]

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


class LoraWeight(nn.Module):
    """A composite leaf ``base + lora_a @ lora_b``: ``base`` a dense
    Parameter or a quantized leaf module, ``lora_a [in, r]`` and ``lora_b
    [r, out]`` f32 buffers (scale already folded into ``lora_b``)."""

    def __init__(self, base, lora_a: torch.Tensor, lora_b: torch.Tensor):
        super().__init__()
        if isinstance(base, torch.Tensor) and not isinstance(base, nn.Parameter):
            base = nn.Parameter(base, requires_grad=False)
        set_weight(self, "base", base)
        self.register_buffer("lora_a", lora_a)
        self.register_buffer("lora_b", lora_b)


class MultiLoraWeight(nn.Module):
    """A bank of adapters over one base, selected per batch row: row i
    applies ``lora_a_stack[ids[i]]`` / ``lora_b_stack[ids[i]]`` (stacks
    [N, in, r] / [N, r, out]). ``lora_ids`` ([b] int64) is a plain
    attribute, not a buffer: every leaf of one wrapped model holds the same
    tensor, which a copy of the module would split."""

    def __init__(self, base, lora_a_stack, lora_b_stack, lora_ids):
        super().__init__()
        set_weight(self, "base", base)
        self.register_buffer("lora_a_stack", lora_a_stack)
        self.register_buffer("lora_b_stack", lora_b_stack)
        self.lora_ids = lora_ids


def is_lora_leaf(leaf) -> bool:
    return isinstance(leaf, LoraWeight)


def _target_dims(cfg: LlamaConfig, name: str) -> tuple[int, int]:
    """(in_dim, out_dim) of an adaptable weight."""
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dims = {
        "wq": (cfg.dim, nh * hd),
        "wk": (cfg.dim, nkv * hd),
        "wv": (cfg.dim, nkv * hd),
        "wo": (nh * hd, cfg.dim),
    }
    if cfg.n_experts == 0:
        dims.update({
            "w_gate": (cfg.dim, cfg.hidden_dim),
            "w_up": (cfg.dim, cfg.hidden_dim),
            "w_down": (cfg.hidden_dim, cfg.dim),
        })
    if name not in dims:
        extra = (
            " (MoE expert MLPs are not adaptable: their stacked [E, ...] "
            "weights would need per-expert adapters)"
            if cfg.n_experts > 0 and name in ("w_gate", "w_up", "w_down")
            else ""
        )
        raise ValueError(f"unknown LoRA target {name!r}{extra}")
    return dims[name]


def init_lora(generator: torch.Generator, cfg: LlamaConfig, *, rank: int = 8,
              targets: tuple = DEFAULT_TARGETS, device=None):
    """Adapter tree {"layers": {target: {"a": [L, in, r], "b": [L, r, out]}}},
    f32, on `device` (the card unless "cpu" is given): ``a`` normal draws
    × in**-0.5 from `generator` (which must live there), ``b`` zeros, so
    the wrapped model starts as the base model.
    Torch and JAX give different numbers from one seed; parity tests
    convert JAX's adapters instead (convert.lora_from_jax)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    device = resolve_device(device)
    L = cfg.n_layers
    out = {}
    for name in targets:
        d_in, d_out = _target_dims(cfg, name)
        a = torch.randn((L, d_in, rank), generator=generator,
                        dtype=torch.float32, device=device)
        out[name] = {"a": a * d_in ** -0.5,
                     "b": torch.zeros((L, rank, d_out), dtype=torch.float32,
                                      device=device)}
    return {"layers": out}


def zero_lora(cfg: LlamaConfig, *, rank: int = 8,
              targets: tuple = DEFAULT_TARGETS, device=None):
    """The identity adapter (all-zero a and b) on `device` (the card unless
    "cpu" is given): banks put it at index 0 so un-adapted rows compute the
    exact base model."""
    device = resolve_device(device)
    out = {}
    for name in targets:
        d_in, d_out = _target_dims(cfg, name)
        L = cfg.n_layers
        out[name] = {
            "a": torch.zeros((L, d_in, rank), dtype=torch.float32, device=device),
            "b": torch.zeros((L, rank, d_out), dtype=torch.float32, device=device),
        }
    return {"layers": out}


def lora_wrap(params, lora, *, alpha: float = 16.0):
    """Attach adapters: a new model whose target weights are LoraWeight
    leaves around the same base tensors (dense or quantized: QLoRA); the
    alpha/rank scale is folded into ``lora_b`` here."""
    scaled = {}
    for name, ab in lora["layers"].items():
        rank = ab["a"].shape[-1]
        scaled[name] = (ab["a"], ab["b"] * (alpha / rank))
    return with_layer_weights(
        params, tuple(scaled),
        lambda name, i, base: LoraWeight(base, scaled[name][0][i],
                                         scaled[name][1][i]))


@torch.no_grad()
def merge_lora(params, lora, *, alpha: float = 16.0):
    """Fold adapters into the dense base weights: ``base + a @ b ×
    alpha/rank`` in f32, cast back to the base's dtype. A quantized base
    refuses (merging would dequantize the model); serve lora_wrap's model
    instead."""
    layers = lora["layers"]
    for name in layers:
        for blk in params.layers:
            base = getattr(blk, name)
            if is_quantized(base) or is_quantized4(base):
                raise ValueError(
                    f"cannot merge LoRA into quantized base {name!r}; serve "
                    "the lora_wrap model instead"
                )

    def merged(name, i, base):  # one layer's delta at a time
        a, b = layers[name]["a"][i], layers[name]["b"][i]
        delta = (a.float() @ b.float()) * (alpha / a.shape[-1])
        return nn.Parameter((base.float() + delta.to(base.device)).to(base.dtype),
                            requires_grad=False)

    return with_layer_weights(params, tuple(layers), merged)


def stack_loras(loras, *, targets: tuple = DEFAULT_TARGETS,
                alpha: float = 16.0):
    """Stack N adapter trees (one rank per target) into a bank
    {"layers": {t: {"a": [L, N, in, r], "b": [L, N, r, out]}}}, the
    alpha/rank scale folded into the b stack once."""
    if not loras:
        raise ValueError("need at least one adapter")
    out = {}
    for name in targets:
        abs_ = [lo["layers"][name] for lo in loras]
        ranks = {ab["a"].shape[-1] for ab in abs_}
        if len(ranks) != 1:
            raise ValueError(
                f"adapters disagree on rank for {name!r}: {sorted(ranks)}"
            )
        rank = next(iter(ranks))
        out[name] = {
            "a": torch.stack([ab["a"] for ab in abs_], dim=1),
            "b": torch.stack([ab["b"] for ab in abs_], dim=1) * (alpha / rank),
        }
    return {"layers": out}


def multi_lora_wrap(params, stacked, ids: torch.Tensor):
    """Attach a bank with a per-row selection: target weights become
    MultiLoraWeight leaves over the same base and bank tensors, all
    reading the one `ids` tensor ([b] int64, on the params' device). Write
    into `ids` to change the selection; the model need not be rebuilt."""
    if ids.dtype != torch.int64 or ids.dim() != 1:
        raise ValueError(f"ids must be a [b] int64 tensor, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    bank = stacked["layers"]
    return with_layer_weights(
        params, tuple(bank),
        lambda name, i, base: MultiLoraWeight(base, bank[name]["a"][i],
                                              bank[name]["b"][i], ids))
