from bee_code_interpreter_fs_tpu_torch.models.beam import beam_generate
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.hf_convert import from_hf_state_dict
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
    speculative_generate,
    speculative_sample_generate,
)
from bee_code_interpreter_fs_tpu_torch.models.lora import (
    init_lora,
    lora_wrap,
    merge_lora,
    multi_lora_wrap,
    stack_loras,
    zero_lora,
)
from bee_code_interpreter_fs_tpu_torch.models.paged import PagedServingEngine
from bee_code_interpreter_fs_tpu_torch.models.quant import (
    quantize4_params,
    quantize_params,
    quantized_nbytes,
    random_quantized_params,
)
from bee_code_interpreter_fs_tpu_torch.models.rolling import (
    init_rolling_cache,
    rolling_decode_logits,
    rolling_greedy_generate,
)
from bee_code_interpreter_fs_tpu_torch.models.serving import ServingEngine
from bee_code_interpreter_fs_tpu_torch.models.spec_serving import (
    PagedSpeculativeServingEngine,
    SpeculativeServingEngine,
)

__all__ = [
    "Llama",
    "LlamaConfig",
    "PagedServingEngine",
    "PagedSpeculativeServingEngine",
    "ServingEngine",
    "SpeculativeServingEngine",
    "beam_generate",
    "from_hf_state_dict",
    "init_lora",
    "init_rolling_cache",
    "lora_wrap",
    "merge_lora",
    "multi_lora_wrap",
    "rolling_decode_logits",
    "rolling_greedy_generate",
    "speculative_generate",
    "speculative_sample_generate",
    "stack_loras",
    "zero_lora",
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
