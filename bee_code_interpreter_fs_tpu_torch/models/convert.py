"""JAX parameter pytree (as numpy arrays) -> the port's Llama module.

The reference keeps every layer's weights stacked on a leading [n_layers]
axis; here they are split into one Block per layer. JAX's bf16 arrays come
out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects: they cross as their uint16 bits and are viewed back as
``torch.bfloat16``, bit for bit. Quantized leaves ({"q", "s"} int8,
{"q4", "s4"} packed int4) cross as int8 and f32 tensors in the port's
quantized-leaf modules (models/quant.py); LoRA composite leaves ({"base",
"lora_a", "lora_b"}, lora_wrap's) as LoraWeight modules (models/lora.py).
Adapter trees and stacked adapter banks, which are plain dicts of arrays,
cross through ``lora_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import Llama
from bee_code_interpreter_fs_tpu_torch.models.lora import LoraWeight
from bee_code_interpreter_fs_tpu_torch.models.quant import (
    Int4Weight,
    Int8Weight,
    set_weight,
)

_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                 "w_gate", "w_up", "w_down")
_QUANTIZED = {frozenset({"q", "s"}): (Int8Weight, ("q", "s")),
              frozenset({"q4", "s4"}): (Int4Weight, ("q4", "s4"))}


def to_torch(array):
    """A numpy array (bf16 included) as a CPU tensor with the same bits; a
    quantized or LoRA leaf dict as the port's leaf module (still stacked
    over layers, as the reference keeps it)."""
    if isinstance(array, dict):
        if frozenset(array) == {"base", "lora_a", "lora_b"}:
            return LoraWeight(to_torch(array["base"]), to_torch(array["lora_a"]),
                              to_torch(array["lora_b"]))
        kind = _QUANTIZED.get(frozenset(array))
        if kind is None:
            raise ValueError(
                f"unknown weight leaf with keys {sorted(array)} (a multi-"
                "adapter leaf is built by the serving engine from a stacked "
                "bank: convert the bank with lora_from_jax)"
            )
        cls, names = kind
        return cls(*(to_torch(array[name]) for name in names))
    array = np.ascontiguousarray(np.asarray(array))
    if not array.flags.writeable:  # torch tensors may not alias read-only memory
        array = array.copy()
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def lora_from_jax(tree):
    """An adapter tree or stacked bank (nested dicts of arrays, as the
    reference's init_lora / stack_loras make them) as the same dicts of
    CPU tensors."""
    if isinstance(tree, dict):
        return {k: lora_from_jax(v) for k, v in tree.items()}
    return to_torch(tree)


def _layer(leaf, i: int, device):
    """Layer i of a stacked leaf, on `device`."""
    if isinstance(leaf, torch.Tensor):
        return leaf[i]
    if isinstance(leaf, LoraWeight):
        base = _layer(leaf.base, i, device)
        if isinstance(base, torch.Tensor):
            base = base.to(device)
        return LoraWeight(base, leaf.lora_a[i].to(device), leaf.lora_b[i].to(device))
    return type(leaf)(*(t[i].to(device) for t in leaf.buffers()))


def params_from_jax(tree, cfg: LlamaConfig, device=None) -> Llama:
    """The port's module holding the reference's weights. `tree` is the
    reference's parameter pytree with numpy (or array-like) leaves, dense,
    quantized (models/quant.py's quantize_params / quantize4_params) or
    LoRA-wrapped (models/lora.py's lora_wrap)."""
    model = Llama(cfg, device)
    dev = model.device
    layers = tree["layers"]
    with torch.no_grad():
        model.embed.copy_(to_torch(tree["embed"]))
        model.final_norm.copy_(to_torch(tree["final_norm"]))
        head = to_torch(tree["lm_head"])
        if isinstance(head, torch.Tensor):
            model.lm_head.copy_(head)
        else:
            set_weight(model, "lm_head", head.to(dev))
        stacked = {name: to_torch(layers[name]) for name in _LAYER_LEAVES}
        for name, leaf in stacked.items():
            n = (leaf if isinstance(leaf, torch.Tensor)
                 else next(leaf.buffers())).shape[0]
            if n != cfg.n_layers:
                raise ValueError(
                    f"layers/{name} has {n} layers, config {cfg.n_layers}"
                )
        for i, blk in enumerate(model.layers):
            for name, leaf in stacked.items():
                value = _layer(leaf, i, dev)
                if isinstance(value, torch.Tensor):
                    getattr(blk, name).copy_(value)
                else:
                    set_weight(blk, name, value)
    return model
