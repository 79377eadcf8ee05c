"""The port's checkpoints (utils/checkpoint.py): round trips of dense, int8,
int4 and LoRA-wrapped models and of adapter trees and stacked banks, bit
for bit; `like=` places each leaf on its target's device and dtype; the
file loads with torch.load(weights_only=True)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import lora  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.quant import (  # noqa: E402
    Int4Weight,
    Int8Weight,
    quantize4_params,
    quantize_params,
)
from bee_code_interpreter_fs_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)

CFG = LlamaConfig.tiny(dtype="bfloat16", n_kv_heads=2)


@pytest.fixture(scope="module")
def base():
    return tl.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _adapter(seed):
    tree = lora.init_lora(torch.Generator().manual_seed(seed), CFG, rank=4, device="cpu")
    for ab in tree["layers"].values():
        ab["b"] += 0.05
    return tree


def _same_tree(a, b):
    ta, tb = dict(a.state_dict()), dict(b.state_dict())
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "lora", "qlora"])
def test_model_round_trips_bit_for_bit(tmp_path, base, kind):
    tree = {"dense": lambda: base, "int8": lambda: quantize_params(base),
            "int4": lambda: quantize4_params(base, 32),
            "lora": lambda: lora.lora_wrap(base, _adapter(1)),
            "qlora": lambda: lora.lora_wrap(quantize_params(base), _adapter(1))}[kind]()
    save_checkpoint(tmp_path / "ckpt", tree)
    restored = restore_checkpoint(tmp_path / "ckpt", device="cpu")
    assert type(restored) is tl.Llama
    _same_tree(tree, restored)
    leaf = restored.layers[1].wq
    assert {"dense": torch.nn.Parameter, "int8": Int8Weight, "int4": Int4Weight,
            "lora": lora.LoraWeight, "qlora": lora.LoraWeight}[kind] is type(leaf)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 9)))
    assert torch.equal(tl.forward(restored, toks, CFG), tl.forward(tree, toks, CFG))


def test_adapter_tree_and_bank_round_trip(tmp_path):
    bank = lora.stack_loras([lora.zero_lora(CFG, rank=4, device="cpu"), _adapter(1), _adapter(2)])
    for name, tree in (("adapter", _adapter(1)), ("bank", bank)):
        save_checkpoint(tmp_path / name, tree)
        got = restore_checkpoint(tmp_path / name, device="cpu")
        assert got.keys() == tree.keys() and got["layers"].keys() == tree["layers"].keys()
        for t, ab in tree["layers"].items():
            for k in ("a", "b"):
                assert torch.equal(got["layers"][t][k], ab[k])
    # A lora_wrap model stores each layer's slice, not the [L, ...] stack.
    save_checkpoint(tmp_path / "wrapped", lora.lora_wrap(tl.init_params(
        CFG, torch.Generator().manual_seed(1), device="cpu"), _adapter(1)))
    saved = torch.load(tmp_path / "wrapped" / "checkpoint.pt", weights_only=True)
    assert saved["tensors"]["layers.0.wq.lora_a"].untyped_storage().nbytes() == 64 * 4 * 4


def test_like_places_leaves_and_the_file_is_weights_only(tmp_path, base):
    save_checkpoint(tmp_path / "ckpt", base)
    like = tl.init_params(LlamaConfig.tiny(dtype="float32", n_kv_heads=2),
                          torch.Generator().manual_seed(5), device="cpu")
    got = restore_checkpoint(tmp_path / "ckpt", like=like)
    assert got.layers[0].wq.dtype == got.embed.dtype == torch.float32
    assert got.layers[0].attn_norm.dtype == torch.float32
    assert torch.equal(got.layers[0].wq, base.layers[0].wq.float())
    with pytest.raises(ValueError, match="differ"):
        restore_checkpoint(tmp_path / "ckpt", like=quantize_params(base))
    with pytest.raises(FileExistsError):
        save_checkpoint(tmp_path / "ckpt", base, force=False)
    save_checkpoint(tmp_path / "ckpt", quantize_params(base))  # force replaces
    assert type(restore_checkpoint(tmp_path / "ckpt", device="cpu").layers[0].wq) is Int8Weight
    # The file holds tensors, dicts, lists and strings only.
    torch.load(tmp_path / "ckpt" / "checkpoint.pt", weights_only=True)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(tmp_path / "bad", lora.multi_lora_wrap(
            base, lora.stack_loras([_adapter(1)]), torch.zeros(2, dtype=torch.int64)))
