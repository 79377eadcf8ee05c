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
    nucleus_mask,
    prefill,
    resolve_cache_len,
    sample_generate,
)
from bee_code_interpreter_fs_tpu_torch.models.paged import PagedServingEngine
from bee_code_interpreter_fs_tpu_torch.models.quant import (
    quantize4_params,
    quantize_params,
    quantized_nbytes,
    random_quantized_params,
)
from bee_code_interpreter_fs_tpu_torch.models.serving import ServingEngine

__all__ = [
    "Llama",
    "LlamaConfig",
    "PagedServingEngine",
    "ServingEngine",
    "decode_chunk",
    "decode_step",
    "forward",
    "generate",
    "greedy_generate",
    "init_cache",
    "init_params",
    "nucleus_mask",
    "prefill",
    "quantize4_params",
    "quantize_params",
    "quantized_nbytes",
    "random_quantized_params",
    "resolve_cache_len",
    "sample_generate",
]
