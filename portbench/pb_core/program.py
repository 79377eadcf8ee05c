"""The system under test: the port's model built from the benchmark's
seeded weights.

This module imports the port (``bee_code_interpreter_fs_tpu_torch``) and
nothing of the JAX package. The weights are made by ``weights.py`` and
loaded into the port's ``Llama`` as views of the per-layer buffers, through
the module's own ``matmul_weight`` hook, so no leaf is allocated twice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pb_core import weights as W


def llama_config(conf: dict, **overrides):
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
    """The port's Llama for `conf` with the run's seeded weights."""
    from bee_code_interpreter_fs_tpu_torch.models import Llama

    cfg = cfg or llama_config(conf)
    shapes = W.shapes_of(conf)
    dtype = _DTYPES[cfg.dtype]
    names = [n for n, _, _ in shapes.layer() if n != "router"]
    state = {"layer": 0, "leaf": 0, "bufs": []}

    def matmul_weight(n_in, n_out, dt, dev, experts: int = 0):
        layer = state["layer"]
        if layer == cfg.n_layers:  # the head comes after every block
            head = W.head_buffer(shapes, cfg.vocab_size, cfg.n_layers, seed,
                                 dtype, dev)
            return nn.Parameter(head, requires_grad=False)
        if state["leaf"] == 0:
            state["bufs"].append(W.layer_buffer(shapes, seed, layer, dtype, dev))
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
        model.embed.data = W.embed_buffer(shapes, cfg.vocab_size, cfg.n_layers,
                                          seed, dtype, model.device)
        for i, blk in enumerate(model.layers):
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
            if cfg.n_experts:
                # The router lies in the layer's buffer; its own allocation
                # (a few KiB) is dropped.
                blk.router.data = state["bufs"][i]["router"]
        model.final_norm.fill_(1.0)
    return model
