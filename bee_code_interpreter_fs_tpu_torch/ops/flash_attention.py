"""Flash attention: hand-written CUDA kernels for Hopper and their plain
PyTorch tile recurrences.

Counterpart of bee_code_interpreter_fs_tpu/ops/flash_attention.py:

- ``flash_attention``: full causal attention (the Pallas kernel
  `_flash_kernel`);
- ``flash_attention_partial``: one ring step, a K/V chunk folded into a
  running online-softmax carry (the Pallas kernel `_flash_partial_kernel`).

Each dispatches on the device of its inputs:

- a CPU tensor goes to the plain version (``flash_attention_reference``,
  ``flash_attention_partial_reference``), the online-softmax tile loop of
  the JAX kernel written in PyTorch;
- a CUDA tensor goes to the kernel in ``csrc/flash_attention.cu`` (built at
  first use, ops/_build.py), or raises. Nothing falls back.

``flash_attention.launches`` and ``flash_attention_partial.launches`` count
kernel launches, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from bee_code_interpreter_fs_tpu_torch.ops import _build

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


TMA_MAX_STRIDE_BYTES = 2**40  # a TMA tensor map's limit on each stride


def _check_kernel_inputs(q, k, v):
    """Raise on q/k/v the kernels do not take: another device or dtype, a
    dtype other than bf16/f32, d not 64/128, rows not 16-byte aligned, a
    stride TMA cannot address (the bf16 kernel reads through tensor maps)."""
    d = q.shape[-1]
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
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(
            f"b*h = {q.shape[0] * q.shape[2]} exceeds the kernel grid's 65535"
        )
    align = 16 // q.element_size()  # 16-byte rows for the vector loads
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if any(s % align for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned (strides {x.stride()})"
            )
        if any(s * x.element_size() >= TMA_MAX_STRIDE_BYTES for s in x.stride()[:3]):
            raise ValueError(
                f"{name} strides {x.stride()} reach TMA's 2**40-byte limit"
            )


def _call_kernel(name: str, argtypes, device, *args) -> None:
    """Call the C entry point `name` of csrc/flash_attention.cu (built at
    first use) on `device`'s current stream; raise if the launch reports an
    error."""
    lib = _build.load("flash_attention")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")


def _launch_kernel(q, k, v, scale: float, window: int, sinks: int):
    """Launch csrc/flash_attention.cu's full kernel on q's device and
    current stream. Raises on anything the kernel does not take, and if the
    launch reports an error."""
    b, t, h, d = q.shape
    _check_kernel_inputs(q, k, v)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    _call_kernel(
        "flash_attention_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *strides, b, t, h, d, int(q.dtype == torch.bfloat16),
        float(scale), int(window), int(sinks),
    )
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


# ---------------------------------------------------------------- ring step


def new_carry(b: int, h: int, tq: int, d: int, device=None):
    """A fresh online-softmax carry for `tq` query rows: acc [b, h, tq, d]
    zeros, m [b, h, tq] at -1e30, l [b, h, tq] zeros, all f32."""
    return (torch.zeros((b, h, tq, d), dtype=torch.float32, device=device),
            torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, h, tq), dtype=torch.float32, device=device))


def _check_partial_shapes(q, k, v, acc, m, l):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected [b, t, h, d] q/k/v, got {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    b, tq, h, d = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)}"
        )
    if acc.shape != (b, h, tq, d) or m.shape != (b, h, tq) or l.shape != (b, h, tq):
        raise ValueError(
            f"carry shapes acc {tuple(acc.shape)} m {tuple(m.shape)} l "
            f"{tuple(l.shape)} do not match q {tuple(q.shape)}: want "
            f"[b, h, tq, d] and [b, h, tq]"
        )


def flash_attention_partial_reference(q, k, v, acc, m, l, *, q_offset: int,
                                      k_offset: int, scale: float | None = None,
                                      causal: bool = True, block_q: int = 512,
                                      block_k: int = 1024):
    """Plain PyTorch ring step: the `_tile_update` recurrence folded over key
    tiles of `effective_block(tk, block_k)` keys, starting from the carry
    (acc [b, h, tq, d], m and l [b, h, tq], f32). Returns new (acc, m, l);
    the inputs are not modified.

    Scores are f32 times `scale`; a masked score is -1e30, where the mask is
    `q_pos >= k_pos` on global positions (q_offset + row, k_offset + key)
    when `causal`. P is rounded to v's dtype before the P V product and l
    sums the unrounded P. Only real keys are folded, so the chunk's tail
    needs no mask. A key tile wholly past the causal frontier of a row's
    q-tile (`effective_block(tq, block_q)` rows, as the JAX kernel's grid
    cuts them) leaves that row's carry as it was, so an all-future chunk
    returns the carry bit for bit."""
    _check_partial_shapes(q, k, v, acc, m, l)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    block_q = effective_block(tq, block_q)
    block_k = effective_block(tk, block_k)

    qf = q.permute(0, 2, 1, 3).float()  # [b, h, tq, d]
    kf = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    rows = torch.arange(tq, device=q.device)
    q_pos = q_offset + rows
    tile_last = q_offset + (rows // block_q) * block_q + block_q - 1
    for k0 in range(0, tk, block_k):
        k_pos = k_offset + torch.arange(k0, min(k0 + block_k, tk), device=q.device)
        s = torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
        if causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l_new = l * correction + p.sum(dim=-1)
        pv = torch.matmul(
            p.to(v.dtype).float(), vh[:, :, k0:k0 + block_k].float()
        )
        acc_new = acc * correction[..., None] + pv
        if causal:
            live = tile_last >= k_offset + k0  # [tq]
            acc_new = torch.where(live[:, None], acc_new, acc)
            m_new = torch.where(live, m_new, m)
            l_new = torch.where(live, l_new, l)
        acc, m, l = acc_new, m_new, l_new
    return acc, m, l


def _launch_partial_kernel(q, k, v, acc, m, l, q_offset: int, k_offset: int,
                           scale: float, causal: bool):
    """Launch csrc/flash_attention.cu's ring-step kernel on q's device and
    current stream; it updates the caller's carry tensors in place. Raises
    on anything the kernel does not take (a carry that is not contiguous f32
    on q's device included: the kernel never works on a copy)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_kernel_inputs(q, k, v)
    for name, x in (("acc", acc), ("m", m), ("l", l)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"carry {name} must be float32, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"carry {name} must be contiguous and 16-byte aligned: the "
                "kernel updates it in place"
            )
    for name, off in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not 0 <= int(off) < 2**31 - max(tq, tk):
            raise ValueError(f"{name}={off} is out of the kernel's int range")
    if acc.numel() == 0 or tk == 0:
        return acc, m, l
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    _call_kernel(
        "flash_attention_partial_fwd",
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        *strides, b, tq, tk, h, d, int(q.dtype == torch.bfloat16),
        float(scale), int(q_offset), int(k_offset), int(bool(causal)),
    )
    flash_attention_partial.launches += 1
    return acc, m, l


def flash_attention_partial(q, k, v, acc, m, l, *, q_offset: int, k_offset: int,
                            scale: float | None = None, causal: bool = True,
                            block_q: int = 512, block_k: int = 1024):
    """Fold one K/V chunk into a running online-softmax carry: one step of
    ring attention (parallel/ring_attention.py).

    q: [b, tq, h, d]; k/v: [b, tk, h, d] (bf16 or f32); acc: [b, h, tq, d]
    float32; m/l: [b, h, tq] float32, a fresh carry being zeros, -1e30 and
    zeros. q_offset/k_offset are the chunks' GLOBAL sequence offsets
    (Python ints). The carry is updated IN PLACE and returned as
    (acc, m, l), as the JAX kernel aliases it; finalize with
    acc / max(l, 1e-30)[..., None].

    CPU tensors run `flash_attention_partial_reference` (tiled by
    `block_q`/`block_k`, the reference package's rule) and copy its result
    into the carry; CUDA tensors launch the sm_90a kernel, which tiles by
    its own fixed sizes and agrees with the reference to rounding."""
    _check_partial_shapes(q, k, v, acc, m, l)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        new = flash_attention_partial_reference(
            q, k, v, acc, m, l, q_offset=q_offset, k_offset=k_offset,
            scale=scale, causal=causal, block_q=block_q, block_k=block_k,
        )
        for carry, value in zip((acc, m, l), new):
            carry.copy_(value)
        return acc, m, l
    if q.device.type == "cuda":
        return _launch_partial_kernel(q, k, v, acc, m, l, q_offset, k_offset,
                                      scale, causal)
    raise ValueError(f"flash_attention_partial runs on cpu or cuda, not {q.device}")


flash_attention_partial.launches = 0
