"""Ring attention: exact attention over a sequence split into `sp` chunks.

Counterpart of the JAX package's parallel/ring_attention.py. There each
device holds one sequence chunk and K/V chunks travel the ring with
`ppermute`, folded into a flash-style online-softmax carry. Here the `sp`
ranks live on one card (parallel/mesh.py): the full [b, t, h, d] tensors
are cut into `sp` contiguous chunks (the layout of P("dp", "sp", "tp",
None)), every rank runs the same n-step schedule, and `ring_permute` moves
the K/V chunk list one rank per step. The per-rank, per-step shape is kept
as it is so that a later slice can swap the list for point-to-point sends
between cards without touching the math.

Each step is one of:
- ``use_flash=True``: the ring-step kernel (ops/flash_attention.py,
  `flash_attention_partial`; the CUDA kernel on the card), which updates the
  rank's carry in place;
- ``use_flash=False``: the reference's einsum fold (f32 scores, P rounded
  to v's dtype before P V), the ring's plain version.

A causal step whose K/V chunk lies wholly in the rank's future is skipped
by a Python ``if`` (no device sync): every row has seen its diagonal chunk
at step 0, so the fold it skips is an exact no-op.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention_partial,
    new_carry,
)
from bee_code_interpreter_fs_tpu_torch.parallel.collectives import ring_permute
from bee_code_interpreter_fs_tpu_torch.parallel.mesh import sp_chunks


def _einsum_fold(q, kc, vc, acc, m, l, *, q_offset, k_offset, scale, causal):
    """One ring step of the reference's einsum branch
    (ring_attention.py:93-116). Returns the new (acc, m, l)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(kc.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    acc = acc * corr[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float()
    )
    l = l * corr + p.sum(dim=-1)
    return acc, m_new, l


def ring_attention(q, k, v, mesh, *, causal: bool = True, scale=None,
                   use_flash: bool = False, flash_block: int | None = None):
    """Exact attention with the sequence split over the mesh's `sp` ranks.

    Args:
      q, k, v: the full [batch, t, heads, head_dim] tensors (k and v with
        q's head count: expand GQA first); t must divide by sp.
      mesh: parallel.mesh.Mesh; its `sp` size is the ring's length.
      causal: apply a global causal mask (positions from each chunk's rank).
      scale: softmax scale; defaults to head_dim**-0.5.
      use_flash: fold each step with `flash_attention_partial` (the CUDA
        kernel on the card) instead of the einsum branch. `flash_block`
        overrides both tile sizes of its plain version (tests use small
        tiles on tiny chunks); the kernel tiles by its own sizes.

    Returns [batch, t, heads, head_dim] in q's dtype.
    """
    n = mesh.sp
    b, t, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qs = sp_chunks(q, n)
    kv = list(zip(sp_chunks(k, n), sp_chunks(v, n)))
    c = t // n
    if use_flash:
        fold = flash_attention_partial
        fold_kwargs = ({"block_q": flash_block, "block_k": flash_block}
                       if flash_block is not None else {})
    else:
        fold, fold_kwargs = _einsum_fold, {}

    carries = [new_carry(b, h, c, d, q.device) for _ in range(n)]
    for i in range(n):
        for my in range(n):
            src = (my - i) % n  # rank that the K/V chunk held now came from
            if causal and src > my:
                continue
            kc, vc = kv[my]
            carries[my] = fold(
                qs[my], kc, vc, *carries[my], q_offset=my * c,
                k_offset=src * c, scale=scale, causal=causal, **fold_kwargs,
            )
        kv = ring_permute(kv)  # K/V to the next rank

    outs = []
    for acc, _, l in carries:
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))  # -> [b, c, h, d]
    return torch.cat(outs, dim=1)
