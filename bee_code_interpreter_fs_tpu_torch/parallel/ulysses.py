"""Ulysses-style sequence parallelism: head/sequence repartition.

Counterpart of the JAX package's parallel/ulysses.py. There one all-to-all
turns sequence sharding into head sharding, each device runs ordinary
full-sequence attention for h/n of the heads, and a second all-to-all turns
the result back. Here the `sp` ranks live on one card (parallel/mesh.py):
each rank's [b, t/n, h, d] chunk is a slice of the full tensor, and the two
all-to-alls regroup the list of rank chunks (`_seq_to_heads`,
`_heads_to_seq`), so each rank's attention sees [b, t, h/n, d]. With
``use_flash`` that attention is the flash kernel (ops/flash_attention.py;
the CUDA kernel on the card), n launches per call.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
)
from bee_code_interpreter_fs_tpu_torch.parallel.mesh import sp_chunks


def _seq_to_heads(chunks: list) -> list:
    """all_to_all(split_axis=2, concat_axis=1): rank r trades its head range
    for every rank's sequence range. [b, t/n, h, d] per rank -> [b, t, h/n,
    d] per rank, sequence in rank order."""
    n = len(chunks)
    hn = chunks[0].shape[2] // n
    return [torch.cat([c[:, :, r * hn:(r + 1) * hn] for c in chunks], dim=1)
            for r in range(n)]


def _heads_to_seq(chunks: list) -> list:
    """all_to_all(split_axis=1, concat_axis=2): the inverse regroup,
    [b, t, h/n, d] per rank -> [b, t/n, h, d] per rank."""
    n = len(chunks)
    tn = chunks[0].shape[1] // n
    return [torch.cat([c[:, s * tn:(s + 1) * tn] for c in chunks], dim=2)
            for s in range(n)]


def ulysses_attention(q, k, v, mesh, *, causal: bool = True, scale=None,
                      use_flash: bool = False):
    """Exact attention with the sequence split over the mesh's `sp` ranks.

    Args:
      q: the full [batch, t, heads, head_dim] tensor; t must divide by sp.
      k, v: same, but MAY carry fewer (GQA) heads than q. When the kv head
        count divides sp they regroup unexpanded and expand after the
        regroup (contiguous head slices line up with the repeat-interleave
        pairing of models.llama._expand_gqa); otherwise they expand first.
      mesh: parallel.mesh.Mesh; heads must divide by its `sp` size.
      causal: standard causal mask (positions are global after the regroup).
      use_flash: run each rank's full-sequence attention through the flash
        kernel instead of the dense path.

    Returns [batch, t, heads, head_dim] in q's dtype.
    """
    n = mesh.sp
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    if h % max(h_kv, 1):
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    rep = h // h_kv
    if h % n:
        raise ValueError(
            f"ulysses needs n_heads % axis_size == 0, got {h} % {n}"
        )
    scale = d ** -0.5 if scale is None else scale
    expand_after = rep > 1 and h_kv % n == 0
    if rep > 1 and not expand_after:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if n == 1:
        if expand_after:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return _local_attention(q, k, v, causal=causal, scale=scale,
                                use_flash=use_flash).to(q.dtype)

    qh, kh, vh = (_seq_to_heads(sp_chunks(x, n)) for x in (q, k, v))
    if expand_after:
        kh = [x.repeat_interleave(rep, dim=2) for x in kh]
        vh = [x.repeat_interleave(rep, dim=2) for x in vh]
    outs = [
        _local_attention(qr, kr, vr, causal=causal, scale=scale,
                         use_flash=use_flash).to(q.dtype)
        for qr, kr, vr in zip(qh, kh, vh)
    ]
    return torch.cat(_heads_to_seq(outs), dim=1)


def _local_attention(q, k, v, *, causal, scale, use_flash):
    """Full-sequence attention over a rank's head subset: the flash kernel
    (causal only) or the masked-dense formulation (f32 scores, P rounded to
    v's dtype, an f32 result)."""
    if use_flash and causal:
        return flash_attention(q, k, v, scale=scale)
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
