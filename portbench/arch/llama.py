"""The Llama architecture: Mistral-7B and Mixtral-8x7B (a dense or a
top-k MoE MLP, GQA, RoPE, an optional sliding window) as the port's
``models.llama`` runs them. The weight layout and the plain model are
``reference/llama_ref.py``'s; the FLOP counts are ``roofline/model.py``'s,
K1's operations and bytes ``roofline/flash_attention_k1.py``'s.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from reference.llama_ref import (Reference, embed_buffer, head_buffer,  # noqa: F401
                                 layer_buffer, shapes_of)
from roofline.flash_attention_k1 import KERNEL_NAME, launch_work
from roofline.model import decode_flops, prefill_flops, score_flops  # noqa: F401

# The CPU tests' size: a few lanes and two layers.
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
TINY_WINDOW = 16


def port_config(conf: dict, **overrides):
    """The port's LlamaConfig for a configuration file (published keys,
    plus its "run" block), with `overrides` applied last."""
    from bee_code_interpreter_fs_tpu_torch.models import LlamaConfig

    run = dict(conf.get("run", {}))
    kw = dict(
        vocab_size=conf["vocab_size"], dim=conf["hidden_size"],
        n_layers=conf["num_hidden_layers"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        hidden_dim=conf["intermediate_size"],
        max_seq_len=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]),
        dtype=run.pop("dtype", conf.get("torch_dtype", "bfloat16")),
        n_experts=int(conf.get("num_local_experts") or 0),
        n_experts_per_token=int(conf.get("num_experts_per_tok") or 2),
        sliding_window=int(conf.get("sliding_window") or 0),
    )
    kw.update(run)
    cfg = LlamaConfig(**kw)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_params(conf: dict, seed: int, device, cfg=None):
    """The port's Llama for `conf` with the run's seeded weights, loaded
    as views of the per-layer buffers through the module's own
    ``matmul_weight`` hook, so no leaf is allocated twice."""
    from bee_code_interpreter_fs_tpu_torch.models import Llama

    cfg = cfg or port_config(conf)
    shapes = shapes_of(conf)
    dtype = _DTYPES[cfg.dtype]
    names = [n for n, _, _ in shapes.layer() if n != "router"]
    state = {"layer": 0, "leaf": 0, "bufs": []}

    def matmul_weight(n_in, n_out, dt, dev, experts: int = 0):
        layer = state["layer"]
        if layer == cfg.n_layers:  # the head comes after every block
            head = head_buffer(shapes, cfg.vocab_size, cfg.n_layers, seed, dtype, dev)
            return nn.Parameter(head, requires_grad=False)
        if state["leaf"] == 0:
            state["bufs"].append(layer_buffer(shapes, seed, layer, dtype, dev))
        name = names[state["leaf"]]
        leaf = state["bufs"][layer][name]
        want = ((experts,) if experts else ()) + (n_in, n_out)
        if tuple(leaf.shape) != want or leaf.dtype != dt:
            raise ValueError(f"layer {layer} {name}: the port asks for "
                             f"{want} {dt}, the weights are "
                             f"{tuple(leaf.shape)} {leaf.dtype}")
        state["leaf"] += 1
        if state["leaf"] == len(names):
            state["layer"], state["leaf"] = layer + 1, 0
        return nn.Parameter(leaf, requires_grad=False)

    with torch.no_grad():
        model = Llama(cfg, device, matmul_weight=matmul_weight)
        if state["layer"] != cfg.n_layers:
            raise ValueError("the port built fewer blocks than the config has")
        model.embed.data = embed_buffer(shapes, cfg.vocab_size, cfg.n_layers, seed,
                                        dtype, model.device)
        for i, blk in enumerate(model.layers):
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
            if cfg.n_experts:
                # The router lies in the layer's buffer; its own allocation
                # (a few KiB) is dropped.
                blk.router.data = state["bufs"][i]["router"]
        model.final_norm.fill_(1.0)
    return model


def forward(params, tokens, cfg):
    """``models.llama.forward``: K1 does the attention under
    ``attn_impl="flash"``, once per layer."""
    from bee_code_interpreter_fs_tpu_torch.models import llama

    return llama.forward(params, tokens, cfg)


def k1_launches(cfg, t: int) -> list:
    """The shapes (b, t, heads, head_dim, element bytes, window, sinks) of
    the K1 launches one scored t-token document makes: one per layer over
    the whole document."""
    elem = 2 if cfg.dtype == "bfloat16" else 4
    return [(1, t, cfg.n_heads, cfg.head_dim, elem, cfg.sliding_window, cfg.attention_sinks)
            for _ in range(cfg.n_layers)]


def kernels(cfg) -> dict:
    """K1, the port's causal flash attention (``csrc/flash_attention.cu``)."""
    return {"k1": KERNEL_NAME}


def kernel_work(cfg, key: str, slice_rec: dict):
    """(FLOPs, bytes) of each K1 launch of the documents a score slice
    scored, in order. The serving engine's slices are not counted: these
    configurations serve with ``attn_impl="plain"``, which launches no K1."""
    if key != "k1" or "documents" not in slice_rec:
        return None
    return [launch_work(*shape) for t in slice_rec["documents"]
            for shape in k1_launches(cfg, t)]


def tiny(conf: dict) -> dict:
    out = dict(TINY)
    if conf.get("sliding_window"):
        out["sliding_window"] = TINY_WINDOW
    return out
