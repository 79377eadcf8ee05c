"""The comparisons that decide ``correct``: what the timed path produced,
held to the plain reference (the architecture module's ``Reference``)
once the window has closed and the program's state is freed.

- Scoring: each sampled document's per-token log-probs against the
  reference's; the number compared is the mean squared gap, the widest
  and the mean absolute gap are reported beside it.
- Serving: the reference runs over each sampled greedy request's prompt
  with its served tokens. A token's gap is how far its reference logit
  lies below the reference's best at that position. The number is the
  mean gap over the tokens whose routing is decided (ROUTER_TIE); the
  widest gaps are reported beside it.
"""

from __future__ import annotations

import numpy as np
import torch

# Rows of logits the reference computes at once.
ROW_BLOCK = 2048

# A token whose reference routing comes within this of a tie (between
# the k-th and the next router logit) in some layer is left out of the
# greedy comparison: a bf16 router rounds its logits by up to half an ulp
# (0.008 below 4) and may pick the other expert, which moves the token's
# logits by a whole expert's share. Dense models have no router: every
# token counts.
ROUTER_TIE = 0.02


def sample(items: list, k: int, seed: int, size) -> list:
    """Indices of `k` items drawn from the seed, the largest by `size`
    always among them."""
    if not items:
        return []
    longest = max(range(len(items)), key=lambda i: size(items[i]))
    rest = [i for i in range(len(items)) if i != longest]
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x5A3])
    pick = rng.permutation(len(rest))[: max(0, k - 1)]
    return [longest] + sorted(rest[i] for i in pick)


def _ref_logprobs(ref, docs: list, hidden: list, head) -> list:
    """Each document's next-token log-probs under `ref`, on the device."""
    out = []
    for doc, h in zip(docs, hidden):
        nxt = torch.as_tensor(doc[1:], device=ref.device)
        rows = torch.arange(nxt.numel(), device=ref.device)
        out.append(torch.cat([
            torch.log_softmax(ref.logits_rows(h, rows[r:r + ROW_BLOCK], head), dim=-1)
            .gather(1, nxt[r:r + ROW_BLOCK][:, None])[:, 0]
            for r in range(0, nxt.numel(), ROW_BLOCK)]))
    return out


def _lp_numbers(want: list, got: list) -> dict:
    gap = torch.cat([(torch.as_tensor(np.asarray(g, np.float32), device=w.device) - w).abs()
                     for g, w in zip(got, want)])
    return {"logprob_sq_mean": float((gap * gap).mean()), "logprob_gap_max": float(gap.max()),
            "logprob_gap_mean": float(gap.mean()), "tokens_compared": gap.numel()}


def score_gaps(ref, docs: list, logprobs: list, control=None) -> dict:
    """docs: token arrays; logprobs: the program's log-probs of each
    document's next tokens (len - 1 each). With `control` (the reference
    computing its matmuls in fp8), its log-probs give
    `control_logprob_sq_mean` the same way."""
    seqs = [torch.as_tensor(d, device=ref.device) for d in docs]
    head = ref.head()
    want = _ref_logprobs(ref, docs, ref.final_hidden(seqs), head)
    out = _lp_numbers(want, logprobs)
    if control is not None:
        ctrl = _ref_logprobs(control, docs, control.final_hidden(seqs), head)
        out["control_logprob_sq_mean"] = _lp_numbers(want, [c.cpu().numpy() for c in ctrl])[
            "logprob_sq_mean"]
    return out


def served_gaps(ref, served: list, control=None) -> dict:
    """served: dicts of a finished greedy request's prompt and served
    tokens. Each token's gap is how far its reference logit lies below the
    reference's best at that position. The number is the mean gap over the
    tokens whose reference routing is decided (ROUTER_TIE; every token of
    a dense model), the widest gaps reported beside it. With `control`
    (the reference computing its matmuls in fp8), the mean is read again
    for the token the control puts first at each position:
    `control_served_gap_mean`."""
    dev = ref.device
    seqs = [torch.as_tensor(np.concatenate([r["prompt"], r["tokens"][:-1]]).astype(np.int64),
                            device=dev) for r in served]
    margins = []
    hidden = ref.final_hidden(seqs, router_margins=margins)
    hidden_c = control.final_hidden(seqs) if control is not None else None
    head = ref.head()
    greedy, at_margin, controlled = [], [], []
    for i, (r, h) in enumerate(zip(served, hidden)):
        n = r["prompt"].size
        toks = torch.as_tensor(r["tokens"].astype(np.int64), device=dev)
        for j in range(0, toks.numel(), ROW_BLOCK):
            rows = torch.arange(n - 1 + j, n - 1 + min(j + ROW_BLOCK, toks.numel()), device=dev)
            logits = ref.logits_rows(h, rows, head)
            tok = toks[j:j + rows.numel()]
            best = logits.max(dim=-1).values
            greedy.append(best - logits.gather(1, tok[:, None])[:, 0])
            if hidden_c is not None:
                first = control.logits_rows(hidden_c[i], rows, head).argmax(dim=-1)
                controlled.append(best - logits.gather(1, first[:, None])[:, 0])
            if margins:
                at_margin.append(margins[i][rows])
    if not greedy:
        return {}
    gap = torch.cat(greedy)
    decided = torch.cat(at_margin) > ROUTER_TIE if at_margin else torch.ones_like(gap, dtype=torch.bool)
    kept = gap[decided]
    out = dict(served_gap_mean=float(kept.mean()) if kept.numel() else None,
               served_gap_max=float(gap.max()),
               served_gap_max_decided=float(kept.max()) if kept.numel() else None,
               served_gap_mean_all=float(gap.mean()),
               served_not_argmax_share=float((gap > 0).float().mean()),
               greedy_tokens_compared=int(kept.numel()),
               greedy_tokens_served=gap.numel())
    if controlled:
        out["control_served_gap_mean"] = float(torch.cat(controlled)[decided].mean())
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}})."""
    shown, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": spec["limit"]}
        if value is None or not value <= spec["limit"]:
            ok = False
    return ok, shown
