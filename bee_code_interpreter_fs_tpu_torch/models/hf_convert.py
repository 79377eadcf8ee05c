"""HuggingFace Llama state dict -> the port's Llama: the counterpart of
bee_code_interpreter_fs_tpu/models/hf_convert.py.

transformers names a layer's weights ``model.layers.N.self_attn.q_proj
.weight`` and so on, each [out, in]; the port keeps [in, out] (``h @ W``)
in one Block per layer. Each tensor goes to f32, is transposed and cast to
the model dtype, as the reference does, so the two trees are bit-equal.

RoPE: transformers stores the q and k projections' rows in the
rotate-half layout (dimension i pairs with i + head_dim / 2); the port
rotates interleaved pairs (2i, 2i + 1). `_unpermute_rope` reorders each
head's rows once, at conversion.

Tensors may be torch tensors (bf16 included) or anything numpy can read.
Mixtral (mixture-of-experts) checkpoints come with the MoE slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import Llama

__all__ = ["from_hf_state_dict"]


def _np(t, device) -> torch.Tensor:
    """A checkpoint tensor (torch, numpy or array-like) as an f32 tensor on
    `device`. A bf16 tensor widens exactly."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t))
    return t.detach().to(device=device, dtype=torch.float32)


def _unpermute_rope(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Reorder a [n_heads * hd, in] projection's output rows from HF's
    rotate-half layout to the interleaved one: per head, row 2i comes from
    row i and row 2i + 1 from row i + hd / 2."""
    out_dim, in_dim = w.shape
    hd = out_dim // n_heads
    return (w.reshape(n_heads, 2, hd // 2, in_dim).transpose(1, 2)
            .reshape(out_dim, in_dim))


@torch.no_grad()
def from_hf_state_dict(state_dict, cfg: LlamaConfig, dtype=None,
                       device=None) -> Llama:
    """The port's Llama holding a HF Llama state dict's weights, on `device`
    (the card unless "cpu" is given). `dtype` is the matmul weights' dtype
    (default cfg.dtype); norms stay f32. A checkpoint without lm_head.weight
    (tied embeddings) takes the embedding as its head."""
    if cfg.n_experts > 0 or any("block_sparse_moe" in k for k in state_dict):
        raise NotImplementedError(
            "Mixtral (MoE) checkpoints come with the training/MoE slice of "
            "the port"
        )
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.", ""))
    model = Llama(cfg, device)
    dev = model.device

    def get(name):
        return _np(state_dict[name], dev)

    model.embed.copy_(get("model.embed_tokens.weight"))
    model.final_norm.copy_(get("model.norm.weight"))
    head = ("lm_head.weight" if "lm_head.weight" in state_dict
            else "model.embed_tokens.weight")
    model.lm_head.copy_(get(head).T)
    for i, blk in enumerate(model.layers):
        pre = f"model.layers.{i}."
        blk.attn_norm.copy_(get(pre + "input_layernorm.weight"))
        blk.mlp_norm.copy_(get(pre + "post_attention_layernorm.weight"))
        blk.wq.copy_(_unpermute_rope(get(pre + "self_attn.q_proj.weight"),
                                     cfg.n_heads).T)
        blk.wk.copy_(_unpermute_rope(get(pre + "self_attn.k_proj.weight"),
                                     cfg.n_kv_heads).T)
        for name, hf in (("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                         ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                         ("w_down", "mlp.down_proj")):
            getattr(blk, name).copy_(get(pre + hf + ".weight").T)
    return model
