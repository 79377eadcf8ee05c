"""The check that decides `correct`, driven through whole runs of each
cell at the tiny size on the CPU (the look for a card skipped), with the
timed path broken underneath: each fault the cell can have must come out
as not correct, and the sound run as correct. The cells run on one card,
so no exchange between cards can be left out.

The precision controls are read on the card at the cell's own size
(``readings.py``) and held there (``cuda``) to be refused: the reference
computing its matmuls in fp8, and the program's own int8-weights path."""

from __future__ import annotations

import pytest
import torch

from tiny import CELLS, run_tiny

from pb_core import spec  # noqa: E402

SEED = 2**31 + 4242
SERVE = tuple(c["name"] for c in spec.load_benchmark()["workloads"]
              if spec.mix(c["traffic"])["driver"] == "closed_loop_serve")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, _, _, _ = run_tiny(cell, SEED)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_score_answer_altered_is_refused(monkeypatch):
    from bee_code_interpreter_fs_tpu_torch.models import llama

    forward = llama.forward

    def altered(params, tokens, cfg, **kw):
        # The second half of every document's answer comes out wrong: its
        # logits reversed over the vocabulary.
        logits = forward(params, tokens, cfg, **kw)
        half = tokens.shape[1] // 2
        logits[:, half:] = logits[:, half:].flip(-1)
        return logits

    monkeypatch.setattr(llama, "forward", altered)
    result, _, _, _ = run_tiny("mistral-7b.score-long", SEED)
    assert not result["correct"], result["checks"]


def _patch_decode(monkeypatch, broken):
    from bee_code_interpreter_fs_tpu_torch.models import serving

    monkeypatch.setattr(serving, "_perslot_decode_step",
                        broken(serving._perslot_decode_step))


def _token_altered(step):
    def fn(params, tokens, cache, pos, cfg, max_len=None):
        logits = step(params, tokens, cache, pos, cfg, max_len)
        return logits.roll(1, dims=-1)  # every slot's choice moves one id
    return fn


def _state_unchanged(step):
    def fn(params, tokens, cache, pos, cfg, max_len=None):
        # The step writes its K/V into a copy: the cache stays as it was.
        return step(params, tokens, {k: v.clone() for k, v in cache.items()}, pos,
                    cfg, max_len)
    return fn


def _half_batch(step):
    def fn(params, tokens, cache, pos, cfg, max_len=None):
        logits = step(params, tokens, cache, pos, cfg, max_len)
        # Every other slot is left out: it gets the mean of the others'
        # logits.
        logits[1::2] = logits[0::2].mean(dim=0, keepdim=True)
        return logits
    return fn


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch],
                         ids=["token-altered", "state-unchanged", "half-batch"])
def test_serve_fault_is_refused(monkeypatch, cell, fault):
    _patch_decode(monkeypatch, fault)
    result, _, _, _ = run_tiny(cell, SEED)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_refused_on_the_card(cell):
    """At the cell's own size: the reference computing its matmuls in fp8,
    put in the program's place over the same prompts and tokens, reads
    every compared number above its limit. Run on the card (about two
    minutes a cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    import run

    limits = spec.limits(cell)
    _, _, _, rec = run.run_cell(spec.load_benchmark(), cell, SEED, 6.0, False,
                                fp8_control=True, torch=torch)
    for name, lim in limits.items():
        assert rec["numbers"][f"control_{name}"] > lim["limit"], (name, rec["numbers"])


@pytest.mark.cuda
def test_int8_weights_are_refused_on_the_card():
    """At the score cell's own size: the program with its int8 weights
    (dequantized to bf16 before each product) fails the check's verdict.
    Run on the card (about a minute)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 path runs at the cell's own size")
    import run
    from pb_core import check

    cell = "mistral-7b.score-long"
    _, _, _, rec = run.run_cell(spec.load_benchmark(), cell, SEED, 6.0, False,
                                variant="int8", torch=torch)
    ok, shown = check.verdict(rec["numbers"], spec.limits(cell))
    assert not ok, shown
