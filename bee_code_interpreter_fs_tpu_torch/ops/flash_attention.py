"""Causal flash attention: a hand-written CUDA kernel for Hopper and its plain
PyTorch tile recurrence.

Counterpart of bee_code_interpreter_fs_tpu/ops/flash_attention.py
(`flash_attention`, whose Pallas kernel is `_flash_kernel`). The public
``flash_attention`` dispatches on the device of its inputs:

- a CPU tensor goes to ``flash_attention_reference``, the online-softmax
  tile loop of the JAX kernel written in PyTorch;
- a CUDA tensor goes to the kernel in ``csrc/flash_attention.cu`` (built at
  first use, ops/_build.py), or raises. Nothing falls back.

``flash_attention.launches`` counts kernel launches, so a run can show that
its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_DIMS = (64, 128)


def _pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (>= 8)."""
    return max(8, 1 << (int(n) - 1).bit_length())


def effective_block(n: int, block: int) -> int:
    """One dimension's effective tile for array length n: clamp to n, then
    round up to a power of two (the reference package's rule)."""
    return _pow2_at_least(min(block, max(n, 1)))


def effective_blocks(t: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The (block_q, block_k) the reference tiling runs for length t."""
    return effective_block(t, block_q), effective_block(t, block_k)


def _check_shapes(q, k, v):
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)}"
        )
    if q.dim() != 4:
        raise ValueError(f"expected [b, t, h, d] inputs, got {tuple(q.shape)}")


def flash_attention_reference(q, k, v, *, scale: float | None = None,
                              block_q: int = 512, block_k: int = 1024,
                              window: int = 0, sinks: int = 0):
    """Plain PyTorch flash attention over [b, t, h, d]: the online-softmax
    recurrence of the JAX kernel's `_tile_update`, folded over key tiles of
    `effective_blocks(t, block_q, block_k)[1]` keys.

    Scores and the (acc, m, l) carry are f32; q and k enter the score
    product exactly (bf16 products are exact in f32), P is rounded to v's
    dtype before the P V product, masked scores are -1e30, and the result is
    acc / l in q's dtype. Every query row is folded against every key tile
    up to the last real key: a tile the TPU kernel skips as dead is, for a
    row that already saw a key, an exact no-op (p = 0, correction = 1), and
    for a row that has not yet, wiped exactly by its first visible key
    (correction = 0), so skipping or not gives the same bits. The padding
    tail therefore needs no padded keys at all."""
    _check_shapes(q, k, v)
    b, t, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    _, block_k = effective_blocks(t, block_q, block_k)

    qf = q.permute(0, 2, 1, 3).float()  # [b, h, t, d]
    kf = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    acc = torch.zeros(b, h, t, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(t, device=q.device)
    for k0 in range(0, t, block_k):
        k_pos = torch.arange(k0, min(k0 + block_k, t), device=q.device)
        s = torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
        mask = q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            vis = k_pos[None, :] > q_pos[:, None] - window
            if sinks > 0:
                vis = vis | (k_pos[None, :] < sinks)
            mask = mask & vis
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        pv = torch.matmul(
            p.to(v.dtype).float(), vh[:, :, k0:k0 + block_k].float()
        )
        acc = acc * correction[..., None] + pv
        m = m_new
    out = (acc / l[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def _launch_kernel(q, k, v, scale: float, window: int, sinks: int):
    """Launch csrc/flash_attention.cu on q's device and current stream.
    Raises on anything the kernel does not take, and if the launch reports
    an error."""
    b, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"flash_attention kernel takes bfloat16 or float32, got {q.dtype}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes d in {KERNEL_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"b*h = {b * h} exceeds the kernel grid's 65535")
    align = 16 // q.element_size()  # 16-byte rows for the vector loads
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if any(s % align for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned (strides {x.stride()})"
            )
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out

    from bee_code_interpreter_fs_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *strides, b, t, h, d, int(q.dtype == torch.bfloat16),
            float(scale), int(window), int(sinks), stream,
        )
    if err:
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, scale: float | None = None,
                    block_q: int = 512, block_k: int = 1024, window: int = 0,
                    sinks: int = 0):
    """Causal flash attention over [b, t, h, d] (k and v the same shape as
    q: expand GQA first, models.llama._expand_gqa). Returns [b, t, h, d] in
    q's dtype. `window > 0` is sliding-window attention (each query sees its
    last `window` keys); `sinks > 0` with a window keeps the first `sinks`
    keys visible to every query.

    CPU tensors run `flash_attention_reference` (whose key tiles
    `block_q`/`block_k` set, by the reference package's rule); CUDA
    tensors launch the sm_90a kernel, which tiles by its own fixed sizes
    and agrees with the reference to rounding."""
    _check_shapes(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, scale=scale, block_q=block_q, block_k=block_k,
            window=window, sinks=sinks,
        )
    if q.device.type == "cuda":
        return _launch_kernel(q, k, v, scale, window, sinks)
    raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")


flash_attention.launches = 0
