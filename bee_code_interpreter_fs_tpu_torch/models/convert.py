"""JAX parameter pytree (as numpy arrays) -> the port's Llama module.

The reference keeps every layer's weights stacked on a leading [n_layers]
axis; here they are split into one Block per layer. JAX's bf16 arrays come
out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects: they cross as their uint16 bits and are viewed back as
``torch.bfloat16``, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import Llama

_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                 "w_gate", "w_up", "w_down")


def to_torch(array) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor with the same bits."""
    if isinstance(array, dict):
        raise NotImplementedError(
            "quantized and LoRA weight leaves come with the models/quant.py "
            "slice of the port"
        )
    array = np.ascontiguousarray(np.asarray(array))
    if not array.flags.writeable:  # torch tensors may not alias read-only memory
        array = array.copy()
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def params_from_jax(tree, cfg: LlamaConfig, device=None) -> Llama:
    """The port's module holding the reference's weights. `tree` is the
    reference's parameter pytree with numpy (or array-like) leaves."""
    model = Llama(cfg, device)
    layers = tree["layers"]
    with torch.no_grad():
        model.embed.copy_(to_torch(tree["embed"]))
        model.final_norm.copy_(to_torch(tree["final_norm"]))
        model.lm_head.copy_(to_torch(tree["lm_head"]))
        stacked = {name: to_torch(layers[name]) for name in _LAYER_LEAVES}
        for name, leaf in stacked.items():
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(
                    f"layers/{name} has {leaf.shape[0]} layers, config "
                    f"{cfg.n_layers}"
                )
        for i, blk in enumerate(model.layers):
            for name, leaf in stacked.items():
                getattr(blk, name).copy_(leaf[i])
    return model
