"""Model checkpoint save/restore over torch files: the counterpart of
bee_code_interpreter_fs_tpu/utils/checkpoint.py.

A checkpoint is a directory holding one ``checkpoint.pt``: a flat
{name: tensor} map and the tree's structure beside it, written with
``torch.save`` and read with ``torch.load(weights_only=True)`` (tensors,
dicts, lists and strings only: loading runs no pickled code). A tree is a
``Llama`` module (dense, int8, int4 or LoRA leaves, as models/quant.py and
models/lora.py make them) or nested dicts and lists of tensors (adapter
trees, stacked adapter banks). A multi-adapter model (lora.multi_lora_wrap)
is not a checkpoint tree: save its base and bank.

The reference writes orbax directories, which this package does not read;
restoring onto a sharded layout waits for the dp/tp slice.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from bee_code_interpreter_fs_tpu_torch.device import resolve_device
from bee_code_interpreter_fs_tpu_torch.models.llama import Block, Llama
from bee_code_interpreter_fs_tpu_torch.models.lora import LoraWeight
from bee_code_interpreter_fs_tpu_torch.models.quant import Int4Weight, Int8Weight

__all__ = ["restore_checkpoint", "save_checkpoint"]

_FILE = "checkpoint.pt"
_FORMAT = "bee_code_interpreter_fs_tpu_torch checkpoint 1"
# The module classes a checkpoint tree may hold, by the name it records.
_MODULES = {cls.__name__: cls for cls in
            (Llama, Block, nn.ModuleList, Int8Weight, Int4Weight, LoraWeight)}


def _owned(t: torch.Tensor) -> torch.Tensor:
    """t on its own storage: torch.save writes a view's whole storage."""
    t = t.detach()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _join(prefix: str, key) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def _children(module: nn.Module):
    return [*module._parameters.items(), *module._buffers.items(),
            *module._modules.items()]


def _flatten(tree, prefix: str, tensors: dict):
    """The structure of `tree` (tensors recorded into `tensors` by their
    dotted path, as state_dict() names them)."""
    if isinstance(tree, torch.Tensor):
        tensors[prefix] = _owned(tree)
        return {"tensor": prefix, "parameter": isinstance(tree, nn.Parameter)}
    if isinstance(tree, nn.Module):
        name = type(tree).__name__
        if _MODULES.get(name) is not type(tree):
            raise TypeError(f"cannot checkpoint a {name} module")
        children = {key: _flatten(value, _join(prefix, key), tensors)
                    for key, value in _children(tree)}
        return {"module": name, "children": children}
    if isinstance(tree, dict):
        return {"dict": {str(k): _flatten(v, _join(prefix, k), tensors)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, _join(prefix, i), tensors)
                         for i, v in enumerate(tree)]}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf")


def save_checkpoint(path: str | Path, tree, *, force: bool = True) -> None:
    """Write `tree` to the directory `path` (created; an existing checkpoint
    there is replaced only with `force`)."""
    path = Path(path).resolve()
    target = path / _FILE
    if target.exists() and not force:
        raise FileExistsError(f"{target} exists; pass force=True to replace it")
    tensors: dict = {}
    structure = _flatten(tree, "", tensors)
    path.mkdir(parents=True, exist_ok=True)
    partial = path / (_FILE + ".partial")
    torch.save({"format": _FORMAT, "structure": structure, "tensors": tensors},
               partial)
    partial.replace(target)


def _like_leaves(like, prefix: str, out: dict) -> dict:
    """{name: tensor} of a tree, named as _flatten names them."""
    if isinstance(like, torch.Tensor):
        out[prefix] = like
    elif isinstance(like, nn.Module):
        for key, value in _children(like):
            _like_leaves(value, _join(prefix, key), out)
    elif isinstance(like, dict):
        for k, v in like.items():
            _like_leaves(v, _join(prefix, k), out)
    elif isinstance(like, (list, tuple)):
        for i, v in enumerate(like):
            _like_leaves(v, _join(prefix, i), out)
    return out


def _build(node, tensors: dict):
    if "tensor" in node:
        t = tensors[node["tensor"]]
        return nn.Parameter(t, requires_grad=False) if node["parameter"] else t
    if "dict" in node:
        return {k: _build(v, tensors) for k, v in node["dict"].items()}
    if "list" in node:
        return [_build(v, tensors) for v in node["list"]]
    cls = _MODULES[node["module"]]
    module = cls.__new__(cls)
    nn.Module.__init__(module)
    for key, child in node["children"].items():
        value = _build(child, tensors)
        if isinstance(value, nn.Parameter):
            module.register_parameter(key, value)
        elif isinstance(value, torch.Tensor):
            module.register_buffer(key, value)
        else:
            module.add_module(key, value)
    return module


def restore_checkpoint(path: str | Path, like=None, device=None):
    """Read a checkpoint written by save_checkpoint.

    Without `like`, every tensor lands on `device` (the card unless "cpu"
    is given) with its saved dtype. With `like` (a tree of the same
    structure, e.g. the live model), each leaf lands on the device and in
    the dtype of the leaf of `like` at the same place; a leaf missing on
    either side raises."""
    target = Path(path).resolve() / _FILE
    want = None
    if like is None:
        where = resolve_device(device)
    else:
        want = _like_leaves(like, "", {})
        devices = {t.device for t in want.values()}
        # One device for the whole tree: load straight onto it.
        where = next(iter(devices)) if len(devices) == 1 else "cpu"
    saved = torch.load(target, map_location=where, weights_only=True)
    if saved.get("format") != _FORMAT:
        raise ValueError(f"{target} is not a checkpoint of this package")
    tensors = saved["tensors"]
    if want is not None:
        if set(want) != set(tensors):
            raise ValueError(
                "checkpoint and like= differ: only in the checkpoint "
                f"{sorted(set(tensors) - set(want))}, only in like= "
                f"{sorted(set(want) - set(tensors))}"
            )
        tensors = {k: t.to(device=want[k].device, dtype=want[k].dtype)
                   for k, t in tensors.items()}
    return _build(saved["structure"], tensors)
