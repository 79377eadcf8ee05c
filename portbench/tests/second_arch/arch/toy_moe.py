"""A test-only architecture: a mixture of experts whose configuration
file speaks another dialect than Llama's (``num_experts``,
``moe_intermediate_size``, RoPE under ``rope_parameters``, an explicit
``head_dim``; no ``rope_theta``, no ``num_local_experts``). It runs the
port's Llama underneath, through the benchmark's own llama module, so
what it shows is that the harness reads a configuration only through its
architecture module. It declares a kernel of its own (``kernels``,
``kernel_work``), so that a test can see its pattern reach both drivers'
traced slices."""

from __future__ import annotations

from pb_core import spec
from roofline.flash_attention_k1 import launch_work

_llama = spec.arch({"arch": "llama"})


def as_llama(conf: dict) -> dict:
    """The same model in the llama module's keys."""
    if conf["head_dim"] * conf["num_attention_heads"] != conf["hidden_size"]:
        raise ValueError("the port's Llama takes head_dim = hidden_size / heads")
    out = {k: conf[k] for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                                "num_key_value_heads", "num_experts_per_tok", "vocab_size",
                                "max_position_embeddings", "rms_norm_eps", "torch_dtype")}
    out.update(intermediate_size=conf["moe_intermediate_size"],
               num_local_experts=conf["num_experts"],
               rope_theta=conf["rope_parameters"]["rope_theta"],
               run=conf.get("run", {}))
    return out


def port_config(conf, **overrides):
    return _llama.port_config(as_llama(conf), **overrides)


def build_params(conf, seed, device, cfg=None):
    return _llama.build_params(as_llama(conf), seed, device, cfg)


forward = _llama.forward

# A kernel no card runs: its pattern only has to reach the traced slice.
TOY_KERNEL = r"toy_attention<"


def kernels(cfg):
    return {"toy_attn": TOY_KERNEL}


def kernel_work(cfg, key, slice_rec):
    """One launch per layer over each scored document or admitted prompt,
    counted as K1 counts a causal launch."""
    lengths = slice_rec.get("documents") or slice_rec.get("admits")
    if key != "toy_attn" or not lengths:
        return None
    return [launch_work(1, t, cfg.n_heads, cfg.head_dim, 2)
            for t in lengths for _ in range(cfg.n_layers)]


class Reference(_llama.Reference):
    def __init__(self, conf, seed, device, **kw):
        super().__init__(as_llama(conf), seed, device, **kw)


def score_flops(conf, t):
    return _llama.score_flops(as_llama(conf), t)


def prefill_flops(conf, n):
    return _llama.prefill_flops(as_llama(conf), n)


def decode_flops(conf, context):
    return _llama.decode_flops(as_llama(conf), context)


def tiny(conf):
    return dict(hidden_size=64, head_dim=16, moe_intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
