"""Speculative decoding inside the continuous-batching engines: the
counterpart of bee_code_interpreter_fs_tpu/models/spec_serving.py.

Every burst pass, a draft model proposes gamma tokens per slot (gamma + 1
per-slot decode steps over its own dense cache), then the target scores
all proposals in one per-slot chunked forward (`_perslot_decode_chunk`):
up to gamma + 1 target tokens per slot per pass. Slots accept
independently (the slot bank's position vector carries ragged progress).

- Greedy requests accept by token equality: the emitted stream is the
  plain engine's, token for token.
- Sampled requests (temperature > 0) run accept/resample per slot: the
  draft proposes d_j ~ q_j, position j accepts when u * q_j(d_j) <
  p_j(d_j), the first rejection draws from norm(max(0, p_j - q_j)), and a
  fully accepted pass draws its bonus from p_{gamma+1} (the residual with
  q := 0). The emitted sequence is distributed as target-only sampling;
  it is not the plain engine's stream. Draws come from the port's
  counter-based stream at three sites, keyed fold_key(slot key, tag) and
  then a position: tag 1 the proposal for position P (position P), tag 2
  the pass's accept draws (the pass's start position), tag 3 the boundary
  token (its position). A seeded request's tokens therefore do not depend
  on the other slots.
- A burst runs `steps_per_sync` passes with no host sync; the acceptance
  masks, budgets and eos all stay on the device, and one copy brings the
  pass-major [steps, b, gamma + 1] emission to the host.

Writes past the end. The verify chunk and the draft steps write at
positions pos..pos+gamma, up to gamma past a slot's last position (the
rejected tail when the budget is nearly spent). The reference drops such
writes. Here the dense banks (the dense engine's target cache, and both
engines' draft cache) are one column longer than max_len, and a write at a
position >= max_len lands in that column, which attention never reads;
the paged target pool sends writes past a slot's reservation to its trash
block through a per-slot `limit`. Positions that are read are written
exactly as the reference writes them: the next pass's chunk starts at most
one past the accepted tokens and rewrites every rejected position before
a query can attend it.

The target cache may be int8 (`kv_quant=True`); the draft cache stays
dense. Prefixes prefill through both models. top_p, log-probs, penalties
and adapters are refused (submit / __init__), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import (
    _TAG_ACCEPT,
    _TAG_BOUNDARY,
    _TAG_DRAFT,
    _row_accept,
    fold_key,
    gumbel_noise,
    init_cache,
    uniform_noise,
)
from bee_code_interpreter_fs_tpu_torch.models.paged import (
    PagedServingEngine,
    _perslot_decode_chunk_paged,
)
from bee_code_interpreter_fs_tpu_torch.models.serving import (
    Request,
    ServingEngine,
    _int8_kv_store,
    _perslot_decode_chunk,
    _perslot_decode_step,
)

__all__ = ["PagedSpeculativeServingEngine", "SpeculativeServingEngine"]


def _gumbel_draw(keys, scores, positions):
    """Per row, argmax(scores + Gumbel noise of (key, position))."""
    return torch.argmax(scores + gumbel_noise(keys, positions, scores.shape[-1]),
                        dim=-1)


def _spec_burst(verify_fn, dparams, dcache, dcfg: LlamaConfig, max_len: int,
                pos, last_tok, remaining, active, temp, keys, steps: int,
                gamma: int, eos_id, with_sampling: bool = False):
    """The one speculative burst loop both engines run: `verify_fn(chunk,
    pos, active)` scores a [b, gamma + 1] chunk against the target's store
    (writing it in place) and is the only difference between them.

    `steps` draft/verify passes. At the top of a pass, per slot:
    last_tok[i] is the newest emitted token, unfed, at position pos[i];
    both caches hold K/V for positions < pos[i]. A pass emits 1..gamma+1
    tokens per active slot, cut by budget and eos. Returns (pos, tok,
    remaining, active, toks [steps, b, gamma+1], emitted [steps, b,
    gamma+1]), pass-major, so flattening the last axis gives each slot's
    stream in order. `with_sampling` (host-decided: a sampled request
    holds a slot) adds the accept/resample branch for slots with temp > 0.
    """
    b = pos.shape[0]
    dev = pos.device
    bidx = torch.arange(b, device=dev)
    idx = torch.arange(gamma + 1, device=dev)
    scale = torch.where(temp > 0, temp, 1.0)
    if with_sampling:
        k_draft, k_accept, k_boundary = (fold_key(keys, tag) for tag in
                                         (_TAG_DRAFT, _TAG_ACCEPT, _TAG_BOUNDARY))
    tok = last_tok
    toks, emitted_all = [], []
    for _ in range(steps):
        # Draft rollout: gamma + 1 steps; the last feeds d_gamma so the
        # draft cache covers pos + gamma when every proposal is accepted.
        t, props, qs = tok, [], []
        for j in range(gamma + 1):
            logits = _perslot_decode_step(dparams, t[:, None], dcache, pos + j,
                                          dcfg, max_len)
            t = torch.argmax(logits, dim=-1)
            if with_sampling:
                scaled = logits / scale[:, None]
                qs.append(torch.softmax(scaled, dim=-1))
                t = torch.where(temp > 0,
                                _gumbel_draw(k_draft, scaled, pos + j + 1), t)
            props.append(t)
        drafts = torch.stack(props[:gamma], dim=1)  # [b, gamma]

        # Verify [pending, d_1..d_gamma] at pos..pos+gamma in one chunk;
        # t_preds[:, j] is the target's greedy choice for position pos+j+1.
        chunk = torch.cat([tok[:, None], drafts], dim=1)
        v_logits = verify_fn(chunk, pos, active)
        t_preds = torch.argmax(v_logits, dim=-1)  # [b, gamma+1]
        row_accept = _row_accept(drafts == t_preds[:, :gamma], gamma)
        out = t_preds

        if with_sampling:
            pt = torch.softmax(v_logits / scale[:, None, None], dim=-1)
            q = torch.stack(qs[:gamma], dim=1)  # [b, gamma, vocab]
            p_d = pt[:, :gamma].gather(-1, drafts[..., None])[..., 0]
            q_d = q.gather(-1, drafts[..., None])[..., 0]
            u = uniform_noise(k_accept, pos, gamma)
            s_accept = _row_accept(u * torch.clamp(q_d, min=1e-30) < p_d, gamma)
            # The boundary distribution: the residual at the rejection row;
            # with q_gamma := 0 the all-accepted bonus p_gamma is the same
            # gather.
            q_ext = torch.cat([q, torch.zeros_like(pt[:, :1])], dim=1)
            at = s_accept[:, None, None].expand(-1, 1, pt.shape[-1])
            residual = torch.clamp(pt.gather(1, at)[:, 0] - q_ext.gather(1, at)[:, 0],
                                   min=0.0)
            boundary = _gumbel_draw(k_boundary, torch.log(residual + 1e-30),
                                    pos + s_accept + 1)
            padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            out_s = torch.where(idx[None, :] < s_accept[:, None], padded,
                                boundary[:, None])
            sampled = temp > 0
            row_accept = torch.where(sampled, s_accept, row_accept)
            out = torch.where(sampled[:, None], out_s, out)

        emit_n = torch.minimum(row_accept + 1, remaining)
        if eos_id is not None:
            # Stop at (and include) the first emitted eos.
            is_eos = (out == eos_id) & (idx[None, :] < emit_n[:, None])
            first_eos = torch.where(is_eos.any(dim=1),
                                    torch.argmax(is_eos.int(), dim=1), gamma + 1)
            emit_n = torch.minimum(emit_n, first_eos + 1)
        emit_n = torch.where(active, emit_n, 0)
        emitted = idx[None, :] < emit_n[:, None]  # [b, gamma+1]
        tok = torch.where(active, out[bidx, torch.clamp(emit_n - 1, min=0)], tok)
        pos = pos + emit_n
        remaining = remaining - emit_n
        active = active & (remaining > 0)
        if eos_id is not None:
            active = active & (tok != eos_id)
        toks.append(out)
        emitted_all.append(emitted)
    return (pos, tok, remaining, active, torch.stack(toks),
            torch.stack(emitted_all))


class _SpeculativeMixin:
    """Draft model, validation, admission mirrored into the draft cache and
    prefixes for both models, shared by the dense and paged engines. The
    draft cache is a dense slot bank with a scratch column; only the
    target's storage differs between the engines."""

    def __init__(self, params, cfg: LlamaConfig, *, draft_params,
                 draft_cfg: LlamaConfig, gamma: int = 4, **kwargs):
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if gamma < 1:
            raise ValueError(
                "gamma must be >= 1 (0 proposals leaves nothing to verify; "
                "use ServingEngine for plain decoding)"
            )
        if kwargs.get("adapters"):
            raise ValueError(
                "adapters are not supported by the speculative engine; use "
                "ServingEngine"
            )
        if draft_params.device.type != params.device.type:
            raise ValueError(f"draft is on {draft_params.device}, target on "
                             f"{params.device}")
        self.draft_params = draft_params
        self.dcfg = draft_cfg
        self.gamma = int(gamma)
        super().__init__(params, cfg, **kwargs)
        # + 1: the scratch column the draft's past-the-end writes land in.
        self.dcache = init_cache(self.dcfg, self.n_slots, self.max_len + 1,
                                 device=self.device)

    def submit(self, prompt, max_new_tokens: int, prefix_id=None, **kw):
        if kw.get("top_p", 1.0) < 1.0:
            raise ValueError(
                "top_p is not supported by the speculative engine: nucleus "
                "truncation would have to apply to the draft and target "
                "distributions alike; use ServingEngine"
            )
        for unsupported in ("logprobs", "presence_penalty",
                            "frequency_penalty", "adapter"):
            if kw.get(unsupported):
                raise ValueError(
                    f"{unsupported} is not supported by the speculative "
                    "engine; use ServingEngine"
                )
        return super().submit(prompt, max_new_tokens, prefix_id, **kw)

    @torch.inference_mode()
    def register_prefix(self, tokens, adapter: str | None = None) -> int:
        """Prefix caching for both models: the target's prefix K/V as the
        base engine keeps them, plus the draft's, prefilled once."""
        pid = super().register_prefix(tokens, adapter)
        toks = np.asarray(tokens, np.int32).reshape(-1)
        dk, dv, _ = self._prefix_kv(self.draft_params, self.dcfg, toks)
        self._prefixes[pid].update(dk=dk, dv=dv)
        return pid

    def _install(self, req: Request, i: int):
        placed = super()._install(req, i)
        if placed is None:  # the paged engine is out of blocks: requeued
            return None
        # The same admission into the draft's row i; the target picked the
        # first token, the draft's logits are dropped.
        self._admit_row(self.dcache, self.draft_params, self.dcfg, req, i,
                        "dk", "dv")
        return placed

    def _with_sampling(self) -> bool:
        return any(r is not None and r.temperature > 0 for r in self._slot_req)

    def _run_burst(self, with_logprobs: bool = False, with_top_p: bool = False,
                   with_penalties: bool = False):
        """`steps_per_sync` passes with no host sync, then one copy to the
        host. Returns numpy (toks [steps*(gamma+1), b], emitted, None):
        pass-major then within-pass, each slot's emission order."""
        # submit() refused everything that could set these flags.
        assert not (with_logprobs or with_top_p or with_penalties)
        (self.pos, self.last_tok, self.remaining, self.active, toks,
         emitted) = _spec_burst(
            self._verify_fn(), self.draft_params, self.dcache, self.dcfg,
            self.max_len, self.pos, self.last_tok, self.remaining, self.active,
            self.temp, self.keys, self.steps_per_sync, self.gamma, self.eos_id,
            self._with_sampling())
        s, b, g1 = toks.shape
        packed = torch.cat([
            toks.transpose(1, 2).reshape(-1),
            emitted.transpose(1, 2).reshape(-1).long(),
            self.active.long(),
        ]).cpu().numpy()
        n = s * g1 * b
        self._active_host = packed[2 * n:].astype(bool)
        return (packed[:n].reshape(s * g1, b).astype(np.int32),
                packed[n:2 * n].reshape(s * g1, b).astype(bool), None)


class SpeculativeServingEngine(_SpeculativeMixin, ServingEngine):
    """Continuous batching with per-slot speculative decoding over the dense
    slot bank.

    >>> eng = SpeculativeServingEngine(params, cfg, draft_params=dp,
    ...                                draft_cfg=dcfg, gamma=4, n_slots=4)
    >>> rid = eng.submit([1, 5, 9], max_new_tokens=64)
    >>> eng.run()   # greedy: ServingEngine's tokens on the same traffic

    A sync runs `steps_per_sync` draft/verify passes, so a slot can emit
    up to steps_per_sync * (gamma + 1) tokens per sync."""

    def _init_device_state(self):
        """The target's slot bank, one scratch column past max_len."""
        cfg = self.cfg
        width = self.max_len + 1
        if self.kv_quant:
            shape = (cfg.n_layers, self.n_slots, width, cfg.n_kv_heads,
                     cfg.head_dim)
            self.cache = _int8_kv_store(shape, self.device)
        else:
            self.cache = init_cache(cfg, self.n_slots, width, device=self.device)

    def _verify_fn(self):
        def verify(chunk, pos, active):
            del active  # a dense row is the slot's own: stale writes are harmless
            return _perslot_decode_chunk(self.params, chunk, self.cache, pos,
                                         self.cfg, self.max_len)
        return verify


class PagedSpeculativeServingEngine(_SpeculativeMixin, PagedServingEngine):
    """Per-slot speculative decoding over the paged block pool (prefix block
    sharing and the int8 pool included): SpeculativeServingEngine's
    semantics, only the target's storage differs. A chunk's writes past a
    slot's reservation go to the trash block through the per-slot
    `_slot_limit`, never into a neighbour's blocks."""

    def _init_device_state(self):
        super()._init_device_state()
        # Each slot's reserved token extent, set at admission.
        self._slot_limit = torch.zeros(self.n_slots, dtype=torch.int64,
                                       device=self.device)

    def _install(self, req: Request, i: int):
        placed = super()._install(req, i)
        if placed is None:
            return None
        shared = 0
        if req.prefix_id is not None:
            shared = len(self._prefixes[req.prefix_id].get("pool_blocks", ()))
        self._slot_limit[i] = (shared + len(self._slot_blocks[i])) * self.block_size
        return placed

    def _verify_fn(self):
        def verify(chunk, pos, active):
            return _perslot_decode_chunk_paged(
                self.params, chunk, self.pool, self.tables, pos, active,
                self.cfg, self._slot_limit)
        return verify
