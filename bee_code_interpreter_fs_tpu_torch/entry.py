"""entry(): the port's counterpart of the repo root's __graft_entry__.entry().

Returns ``(fn, args)``: the tiny-config forward and its arguments, random
weights from a seeded generator and [2, 32] zero tokens, on the card unless
`device` names another.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_fs_tpu_torch.device import resolve_device
from bee_code_interpreter_fs_tpu_torch.models import LlamaConfig, forward, init_params


def entry(device=None):
    dev = resolve_device(device)
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)
