"""The port's HF conversion (models/hf_convert.py) against the JAX package's
and against transformers' own forward.

- A random HF-named numpy state dict (tiny GQA Llama, seeded) converts to
  tensors bit-equal to JAX's from_hf_state_dict tree, f32 and bf16.
- transformers' LlamaForCausalLM (random init, tiny GQA, f32): the port's
  logits within 1e-4; a bf16 checkpoint with tied embeddings converts.
- A Mixtral state dict raises, naming the MoE slice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bee_code_interpreter_fs_tpu.models import hf_convert as jhf  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.hf_convert import (  # noqa: E402
    _unpermute_rope,
    from_hf_state_dict,
)

CFG = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=128, max_seq_len=64, dtype="float32")


def _hf_state_dict(cfg: LlamaConfig, seed=0, tied=False):
    rng = np.random.default_rng(seed)
    hd = cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, cfg.dim),
          "model.norm.weight": 1 + w(cfg.dim)}
    if not tied:
        sd["lm_head.weight"] = w(cfg.vocab_size, cfg.dim)
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "input_layernorm.weight": 1 + w(cfg.dim),
            pre + "post_attention_layernorm.weight": 1 + w(cfg.dim),
            pre + "self_attn.q_proj.weight": w(cfg.n_heads * hd, cfg.dim),
            pre + "self_attn.k_proj.weight": w(cfg.n_kv_heads * hd, cfg.dim),
            pre + "self_attn.v_proj.weight": w(cfg.n_kv_heads * hd, cfg.dim),
            pre + "self_attn.o_proj.weight": w(cfg.dim, cfg.n_heads * hd),
            pre + "mlp.gate_proj.weight": w(cfg.hidden_dim, cfg.dim),
            pre + "mlp.up_proj.weight": w(cfg.hidden_dim, cfg.dim),
            pre + "mlp.down_proj.weight": w(cfg.dim, cfg.hidden_dim),
        })
    return sd


def _bits(t):
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_is_bit_equal_to_jax(dtype):
    from bee_code_interpreter_fs_tpu.models.llama import LlamaConfig as JaxConfig

    cfg = LlamaConfig(**CFG)
    sd = _hf_state_dict(cfg)
    want = jax.tree.map(np.asarray, jhf.from_hf_state_dict(sd, JaxConfig(**CFG), dtype=dtype))
    got = from_hf_state_dict(sd, cfg, dtype=dtype, device="cpu")

    def same(t, w):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w = w.view(np.int16)
        np.testing.assert_array_equal(_bits(t), w)

    same(got.embed, want["embed"])
    same(got.final_norm, want["final_norm"])
    same(got.lm_head, want["lm_head"])
    for i, blk in enumerate(got.layers):
        for name in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
                     "w_up", "w_down"):
            same(getattr(blk, name), want["layers"][name][i])
    # torch tensors (bf16 included) convert like numpy arrays
    as_torch = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    widened = {k: v.float().numpy() for k, v in as_torch.items()}
    a = from_hf_state_dict(as_torch, cfg, device="cpu")
    b = from_hf_state_dict(widened, cfg, device="cpu")
    assert torch.equal(a.layers[1].wq, b.layers[1].wq)


def test_unpermute_rope_interleaves_each_head():
    w = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(16, 3)
    got = _unpermute_rope(w, 2)
    heads = w.reshape(2, 8, 3)
    assert torch.equal(got.reshape(2, 8, 3)[:, 0::2], heads[:, :4])
    assert torch.equal(got.reshape(2, 8, 3)[:, 1::2], heads[:, 4:])


def test_logits_match_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, attention_bias=False, mlp_bias=False,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).float().eval()
    tokens = np.random.default_rng(1).integers(0, 256, (2, 12))
    with torch.no_grad():
        want = hf_model(torch.from_numpy(tokens)).logits
    cfg = LlamaConfig(**CFG)
    model = from_hf_state_dict(hf_model.state_dict(), cfg, device="cpu")
    got = tl.forward(model, torch.from_numpy(tokens), cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    out = tl.greedy_generate(model, torch.from_numpy(tokens[:, :4]), cfg, max_new_tokens=4)
    assert tuple(out.shape) == (2, 8)


def test_bf16_checkpoint_and_tied_embeddings():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=32,
        tie_word_embeddings=True)
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).to(torch.bfloat16)
    sd = {k: v for k, v in hf_model.state_dict().items() if k != "lm_head.weight"}
    cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2,
                      hidden_dim=64, max_seq_len=32, dtype="float32")
    model = from_hf_state_dict(sd, cfg, dtype="float32", device="cpu")
    assert torch.equal(model.lm_head, model.embed.T)
    logits = tl.forward(model, torch.zeros((1, 6), dtype=torch.int64), cfg)
    assert bool(torch.isfinite(logits).all())


def test_mixtral_raises_naming_the_moe_slice():
    cfg = LlamaConfig(**CFG)
    sd = _hf_state_dict(cfg)
    sd["model.layers.0.block_sparse_moe.gate.weight"] = np.zeros((4, 64), np.float32)
    with pytest.raises(NotImplementedError, match="MoE"):
        from_hf_state_dict(sd, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        from_hf_state_dict(_hf_state_dict(cfg), LlamaConfig(**CFG, n_experts=4),
                           device="cpu")
