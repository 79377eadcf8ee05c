from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import (
    Llama,
    decode_chunk,
    decode_step,
    forward,
    generate,
    greedy_generate,
    init_cache,
    init_params,
    prefill,
    resolve_cache_len,
)

__all__ = [
    "Llama",
    "LlamaConfig",
    "decode_chunk",
    "decode_step",
    "forward",
    "generate",
    "greedy_generate",
    "init_cache",
    "init_params",
    "prefill",
    "resolve_cache_len",
]
