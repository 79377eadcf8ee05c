"""PyTorch/CUDA port of bee_code_interpreter_fs_tpu's model path, for
NVIDIA Hopper (sm_90a).

The JAX package stays the reference; this package imports nothing of it
(nor JAX itself) and keeps its own copy of whatever it needs. Every entry
point that makes state takes a ``device`` argument whose default is the
card; without a card it raises instead of running on the CPU
(``device="cpu"`` asks for the CPU explicitly, as the tests do).

Layout:
- ``models/config.py``  LlamaConfig and its presets.
- ``models/llama.py``   dense single-device Llama: forward (plain or flash
                        attention), KV-cached prefill/decode, greedy,
                        sampled and speculative generation.
- ``models/quant.py``   int8 / packed int4 weights, int8 KV quantizers.
- ``models/serving.py`` ServingEngine: continuous batching over cache slots.
- ``models/paged.py``   PagedServingEngine: the same over a block pool.
- ``models/spec_serving.py`` SpeculativeServingEngine and
                        PagedSpeculativeServingEngine: draft/verify per slot.
- ``models/lora.py``    LoRA / QLoRA leaves, adapter banks for multi-LoRA
                        serving (ServingEngine(adapters=...)).
- ``models/beam.py``    beam search.
- ``models/rolling.py`` the ring-buffer KV cache of sliding-window models.
- ``models/hf_convert.py`` HuggingFace Llama state dict -> the port's module.
- ``models/convert.py`` JAX parameter pytree (as numpy) -> the port's module.
- ``utils/checkpoint.py`` save / restore over torch files.
- ``ops/flash_attention.py`` causal flash attention: the hand-written
                        CUDA kernel (``csrc/flash_attention.cu``) on CUDA
                        tensors, its plain PyTorch tile recurrence on CPU
                        tensors.
- ``entry.py``          entry(): the tiny-config forward and its arguments.
"""

from bee_code_interpreter_fs_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
