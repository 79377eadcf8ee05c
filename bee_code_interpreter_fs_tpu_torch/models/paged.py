"""Paged KV cache, block-pool serving: the counterpart of
bee_code_interpreter_fs_tpu/models/paged.py.

K/V live in a pool of fixed-size blocks ([L, n_blocks + 1, block_size,
n_kv, hd]) with a per-slot block table mapping logical positions to
physical blocks, so the pool is sized for the traffic's token residency
instead of n_slots x max_len.

- A slot's logical cache is the gather ``pool[tables[slot]]``, made per
  layer per step ([b, max_blocks * block_size, ...]) as in the reference.
- Frontier writes go to (table[pos // bs], pos % bs); no two slots share a
  writable block. Inactive slots write to the trash block instead (the
  last physical block, never allocated): a retired slot's blocks may
  already belong to another request.
- Reservation admission: a request reserves ceil((prompt + max_new) / bs)
  blocks up front or waits for retirements; nothing runs out mid-flight.
- Prefill lands in a block-aligned scratch that one scatter installs.
- A registered prefix's full blocks install once and every request using
  it points at the same physical blocks; the prefix's partial last block,
  the suffix and the generation take private (copy-on-write) blocks.
  Shared blocks stay pinned while the prefix is registered.

Same scheduler, sampling stream and greedy tokens as ServingEngine.
"""

from __future__ import annotations

import torch

from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig
from bee_code_interpreter_fs_tpu_torch.models.llama import model_dtype
from bee_code_interpreter_fs_tpu_torch.models.serving import (
    Request,
    ServingEngine,
    _chunk_valid,
    _chunked_scratch_prefill,
    _decode_layers,
    _int8_kv_store,
    _kv_write_read,
    _prefill_scratch,
    _prefill_scratch_prefixed,
    _stored,
)

__all__ = ["PagedServingEngine"]


def _perslot_decode_chunk_paged(params, tokens, pool, tables, pos, active,
                                cfg: LlamaConfig, limit=None):
    """A decode chunk over the block pool, every slot at its own position:
    tokens [b, s], tables [b, max_blocks], pos [b], active [b]. Writes land
    at (table[(pos+j) // bs], (pos+j) % bs) in place; attention reads the
    gathered logical cache. Returns logits [b, s, vocab].

    Writes of inactive slots go to the trash block (a retired slot's
    blocks may already belong to another request), and so do writes at a
    position >= `limit` [b] (None = no limit): a speculative chunk reaches
    up to gamma positions past a slot's reservation, through table rows
    the slot does not own. Every emitted position lies below the limit, so
    only rejected-tail K/V go to the trash."""
    quant = "kq" in pool
    b, max_blocks = tables.shape
    s = tokens.shape[1]
    ref = pool["kq"] if quant else pool["k"]
    bs = ref.shape[2]
    trash = ref.shape[1] - 1
    logical = max_blocks * bs
    qpos = pos[:, None] + torch.arange(s, device=pos.device)[None, :]
    valid = _chunk_valid(qpos, logical, cfg)
    ok = active[:, None]
    if limit is not None:
        ok = ok & (qpos < limit[:, None])
    blk = tables.gather(1, torch.clamp(qpos, max=logical - 1) // bs)
    blk = torch.where(ok, blk, trash)
    off = qpos % bs

    def write_at(leaf, value):
        leaf[blk, off] = value

    def gathered(leaf):
        return leaf[tables].reshape(b, logical, *leaf.shape[2:])

    pool_keys, write_read = _kv_write_read(quant, write_at, gathered,
                                           model_dtype(cfg))
    return _decode_layers(params, tokens, pool, pos, cfg, pool_keys,
                          write_read, valid)


def _pool_install(pool, kv, blk_ids):
    """Scatter a block-aligned scratch ([L, 1, nb * bs, ...]) into the pool
    at physical blocks `blk_ids` [nb]; an int8 pool quantizes it on the way
    (prefill stays exact, only storage quantizes)."""
    L, _, T = kv["k"].shape[:3]
    bs = next(iter(pool.values())).shape[2]
    nb = T // bs
    for name, value in _stored(pool, kv):
        pool[name][:, blk_ids] = value.reshape(L, nb, bs, *value.shape[3:])


class PagedServingEngine(ServingEngine):
    """Continuous batching over a paged block pool.

    `n_blocks * block_size` is the engine's total token residency; a
    request admits when its worst-case block reservation fits, else it
    waits for retirements. Otherwise the same engine as ServingEngine."""

    def __init__(self, params, cfg: LlamaConfig, *, block_size: int = 16,
                 n_blocks: int | None = None, **kwargs):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        pc = kwargs.get("prefill_chunk")
        if pc and pc % block_size:
            raise ValueError(
                f"prefill_chunk ({pc}) must be a multiple of block_size "
                f"({block_size}) so chunk-aligned scratches stay "
                "block-aligned"
            )
        self.block_size = int(block_size)
        self._requested_blocks = n_blocks
        super().__init__(params, cfg, **kwargs)

    def _init_device_state(self):
        bs = self.block_size
        self.max_blocks = -(-self.max_len // bs)
        n_blocks = (
            int(self._requested_blocks) if self._requested_blocks is not None
            else self.n_slots * self.max_blocks  # dense-equivalent capacity
        )
        if n_blocks < self.max_blocks:
            raise ValueError(
                f"n_blocks={n_blocks} cannot hold even one max-size request "
                f"({self.max_blocks} blocks)"
            )
        cfg = self.cfg
        # +1: the trash block inactive slots write into; never allocated.
        shape = (cfg.n_layers, n_blocks + 1, bs, cfg.n_kv_heads, cfg.head_dim)
        if self.kv_quant:
            self.pool = _int8_kv_store(shape, self.device)
        else:
            dt = model_dtype(cfg)
            self.pool = {name: torch.zeros(shape, dtype=dt, device=self.device)
                         for name in ("k", "v")}
        self.tables = torch.zeros((self.n_slots, self.max_blocks),
                                  dtype=torch.int64, device=self.device)
        self._free: list[int] = list(range(n_blocks))
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.n_slots)]
        # The registered prefix (if any) whose shared blocks each slot's
        # table references: shared blocks stay pinned while in use.
        self._slot_prefix: list[int | None] = [None] * self.n_slots

    # ------------------------------------------------------------ helpers

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def _pad_to_blocks(self, n: int) -> int:
        return self._blocks_for(n) * self.block_size

    def _block_ids(self, blks) -> torch.Tensor:
        return torch.tensor(blks, dtype=torch.int64, device=self.device)

    def _set_table(self, i: int, table: list) -> None:
        self.tables[i, : len(table)] = self._block_ids(table)

    # ---------------------------------------------------------- admission

    def _install(self, req: Request, i: int):
        n = req.prompt.size
        if req.prefix_id is not None:
            return self._install_prefixed(req, i)
        need = self._blocks_for(n + req.max_new_tokens)
        if need > len(self._free):
            return None  # wait for retirements
        blks = [self._free.pop() for _ in range(need)]
        self._slot_blocks[i] = blks
        self._set_table(i, blks)
        bl = self._bucket_len(n)
        pad_to = self._pad_to_blocks(bl)
        if (self.prefill_chunk is not None
                and pad_to > self.prefill_chunk
                and pad_to % self.prefill_chunk == 0):
            last_logits, scratch = _chunked_scratch_prefill(
                self._req_params(req), self._padded_prompt(req.prompt, pad_to), n,
                self.cfg, self.prefill_chunk)
        else:
            last_logits, scratch = _prefill_scratch(
                self._req_params(req), self._padded_prompt(req.prompt, bl), n, self.cfg,
                pad_to)
        self._install_scratch(scratch, blks, pad_to, need)
        return self._pick_first(req, last_logits, n), n

    def _install_prefixed(self, req: Request, i: int):
        """Admission with a registered prefix, sharing its full blocks: the
        prefix's plen // bs full blocks install into the pool once per
        engine and every sharing table points at them; the frontier (the
        prefix's partial last block, the suffix and the generation) takes
        private blocks. Decode writes land at pos >= prompt_end >= the
        shared span, so a shared block is never written."""
        pf = self._prefixes[req.prefix_id]
        plen, n = pf["len"], req.prompt.size
        bs = self.block_size
        shared_nb = plen // bs
        shared_tok = shared_nb * bs
        prompt_end = plen + n
        need_priv = self._blocks_for(prompt_end + req.max_new_tokens) - shared_nb
        alloc_shared = shared_nb if "pool_blocks" not in pf else 0
        if need_priv + alloc_shared > len(self._free):
            return None  # wait for retirements
        if alloc_shared:
            shared = [self._free.pop() for _ in range(shared_nb)]
            _pool_install(self.pool, {k: pf[k][:, :, :shared_tok] for k in ("k", "v")},
                          self._block_ids(shared))
            pf["pool_blocks"] = shared
        blks = [self._free.pop() for _ in range(need_priv)]
        self._slot_blocks[i] = blks  # private only; shared pins via prefix
        self._set_table(i, list(pf.get("pool_blocks", ())) + blks)
        self._slot_prefix[i] = req.prefix_id
        pf["active_users"] = pf.get("active_users", 0) + 1

        if n == 0:
            rem = plen - shared_tok
            if rem:
                # Copy-on-write frontier: the prefix's partial last block,
                # padded to a block once per prefix, becomes this request's
                # first private block.
                if "aligned_rem" not in pf:
                    aligned = {}
                    for k in ("k", "v"):
                        shape = list(pf[k].shape)
                        shape[2] = bs
                        aligned[k] = pf[k].new_zeros(shape)
                        aligned[k][:, :, :rem] = pf[k][:, :, shared_tok:]
                    pf["aligned_rem"] = aligned
                _pool_install(self.pool, pf["aligned_rem"],
                              self._block_ids(blks[:1]))
            return self._pick_first(req, pf["last_logits"], plen), plen
        bl = self._suffix_bucket(plen, n)
        pad_to = self._pad_to_blocks(plen + bl)
        last_logits, scratch = _prefill_scratch_prefixed(
            self._req_params(req), pf["k"], pf["v"], self._padded_prompt(req.prompt, bl),
            n, self.cfg, pad_to)
        # Install only the frontier [shared_tok, ...), trimmed to the
        # private reservation (bucket padding can overshoot it).
        t_inst = min(pad_to - shared_tok, need_priv * bs)
        frontier = {k: scratch[k][:, :, shared_tok:shared_tok + t_inst]
                    for k in ("k", "v")}
        _pool_install(self.pool, frontier, self._block_ids(blks[: t_inst // bs]))
        return self._pick_first(req, last_logits, prompt_end), prompt_end

    def _install_scratch(self, scratch, blks, pad_to: int, need: int):
        """Scatter the prompt scratch into the reserved blocks, trimmed to
        the reservation: the bucket padding can overshoot it, the prompt
        itself never does (need covers prompt + max_new tokens)."""
        t_inst = min(pad_to, need * self.block_size)
        scratch = {k: scratch[k][:, :, :t_inst] for k in ("k", "v")}
        _pool_install(self.pool, scratch,
                      self._block_ids(blks[: t_inst // self.block_size]))

    def _on_retire(self, i: int) -> None:
        self._free.extend(self._slot_blocks[i])
        self._slot_blocks[i] = []
        pid = self._slot_prefix[i]
        if pid is not None:
            self._slot_prefix[i] = None
            pf = self._prefixes.get(pid)
            if pf is not None:
                pf["active_users"] -= 1

    def unregister_prefix(self, prefix_id: int) -> None:
        pf = self._prefixes.get(prefix_id)
        if pf is not None and pf.get("active_users", 0) > 0:
            raise ValueError(
                f"prefix {prefix_id} is referenced by {pf['active_users']} "
                "active slot(s); drain or cancel them first"
            )
        super().unregister_prefix(prefix_id)  # raises for unknown/queued
        if pf is not None and "pool_blocks" in pf:
            self._free.extend(pf["pool_blocks"])

    def stats(self) -> dict:
        out = super().stats()
        shared = sum(len(pf.get("pool_blocks", ()))
                     for pf in self._prefixes.values())
        total = (len(self._free) + shared
                 + sum(len(b) for b in self._slot_blocks))
        out.update({
            "free_blocks": len(self._free),
            "shared_prefix_blocks": shared,
            "total_blocks": total,
            "block_size": self.block_size,
        })
        return out

    # -------------------------------------------------------------- burst

    def _step_fn(self):
        """Decode steps against the block pool; the tables stay constant
        for a burst (reservation admission pre-allocates every block)."""
        def step(tokens, pos, active):
            return _perslot_decode_chunk_paged(
                self._burst_params, tokens, self.pool, self.tables, pos,
                active, self.cfg)[:, 0]
        return step
