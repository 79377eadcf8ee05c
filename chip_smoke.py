#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bee_code_interpreter_fs_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases env,build,parity

Phases, one line each; any failure exits non-zero:
  env     torch/CUDA versions, the card's name and power limit, TF32 off.
  build   nvcc of every kernel source under the package's csrc/ (parallel);
          ptxas' registers and spills per kernel and, where the toolkit has
          cuobjdump, the HGMMA (wgmma), UTMALDG (TMA load) and SYNCS
          (mbarrier) instructions in each bf16 kernel's SASS.
  parity  each kernel against its plain PyTorch version on the card: the
          flash kernel (K1: also t=40 and t=129 around the 128-row tile, and
          a head-slice view) and the ring-step kernel (K2: diagonal, past,
          non-causal, klen tail, q padding, folded carry, all-future chunk
          whose carry must come back bit for bit, tq=77 against tk=200, and
          sp_chunks views of a longer tensor).
  path_a  Llama-2-7B forward (bf16, b=2, t=2048, random seeded weights)
          through the flash kernel: 32 launches, finite logits, argmax
          agreement with plain attention; a torch.profiler table of device
          time by kernel; then full width, 4 layers, f32: flash vs plain
          within 1e-3 relative.
  path_b  greedy_generate on the same weights, 4 prompts x 128 tokens,
          32 new; the first new token equals forward's argmax; a profiler
          table of four decode steps.
  quant   Llama-2-7B, full depth, int8 and int4 (group 128) weights
          quantized from path_a's: b=2, t=512 forward against the dense
          forward of the dequantized weights (argmax agreement >= 0.9; also
          printed against the bf16 forward), greedy_generate of 4 prompts x
          128 tokens and 32 new; weight bytes, forward ms, decode ms/step,
          and the ms of one dequantize of every matmul weight.
  path_d  the serving engines at Llama-2-7B bf16, full depth: 16 requests
          (torch.Generator seed 3; prompts 16-512 tokens, 16-128 new; 4
          share a registered 256-token prefix, 4 sampled at temperature 0.8
          and top_p 0.9, 2 with log-probs, 1 with penalties) through
          ServingEngine (8 slots, max_len 1024, bursts of 8, bf16 KV) and
          PagedServingEngine (int8 KV, blocks of 16). Greedy tokens within
          0.1 of the teacher-forced forward's maximum logit, exact-argmax
          share >= 0.9; sampled requests replayed alone give the same
          tokens; both engines' first tokens equal; the pool's blocks all
          return and the prefix shares 16 of them. Tokens/s, requests/s,
          time to first token, ms per decode step in a burst, admission ms
          per bucket, a profiler table of one burst. Then full width, 4
          layers, f32, max_len 256: dense-engine tokens equal
          greedy_generate's, paged int8 equals dense int8, log-probs within
          1e-4 of a teacher-forced log_softmax.
  path_e  speculative decoding at Llama-2-7B bf16, full depth, with two
          drafts made of the target's own tensors: the target itself
          (every proposal accepted) and its first 2 layers with its final
          norm and head (layer-skip: rejection and resampling).
          speculative_generate and speculative_sample_generate (T 0.8), 2
          prompts x 128 tokens, 64 new, gamma 4: tokens/s, target passes,
          tokens per pass; greedy tokens within 0.1 of a teacher-forced
          forward's maximum logit, exact share >= 0.9. Then 8 requests
          (torch.Generator seed 3; prompts 16-256 tokens, 16-64 new; 2
          behind a 128-token prefix, 2 sampled at T 0.8) through
          ServingEngine, SpeculativeServingEngine (bf16 KV) and
          PagedSpeculativeServingEngine (int8 KV, blocks of 16), 4 slots,
          max_len 512, bursts of 4, layer-skip draft: tokens/s,
          requests/s, TTFT, ms per pass, tokens per slot-pass; first tokens
          equal; free_blocks back to the total. Then full width, 4 layers,
          f32: the speculative engines' greedy tokens equal the plain
          engine's (bf16 and int8 KV), paged int8 equals dense int8, a
          sampled request replayed alone keeps its tokens,
          speculative_generate equals greedy_generate.
  path_f  at Llama-2-7B bf16: multi-LoRA serving (3 adapters of rank 16
          with a nonzero b, plus base requests, 8 requests) over the bf16
          base and the int8 base, tokens against a teacher-forced forward
          of each adapter's merged (int8: wrapped) model; beam_generate
          (b=2, 64-token prompts, 32 new, beam 1 and 4); the rolling cache
          with the window cut to 256 and 4 sinks (a 384-token greedy stream
          over the ring; its teacher-forced ring logits against
          forward(attn_impl="flash") under the same window: 32 K1
          launches, argmax agreement >= 0.9); from_hf_state_dict of an
          HF-named copy of the weights (tensors and forward bit-equal);
          checkpoints of 4 layers (bf16 and int8) and an adapter bank
          (bit-equal, GiB/s). Then full width, 4 layers, f32: multi-LoRA
          tokens equal greedy_generate over each merged adapter, beam 1
          equals greedy, rolling logits within 1e-3 relative of the plain
          windowed forward.
  path_c  Llama-3-8B sequence-parallel forward (bf16, b=1, t=8192, mesh
          sp=4 on the one card, full depth, random seeded weights): ring +
          flash (exactly 320 ring-step launches, no K1), ring plain, and
          Ulysses + flash (exactly 128 K1 launches), each with argmax
          agreement against the no-mesh flash forward; a profiler table of
          the ring + flash forward; then full width, 4 layers, f32, t=4096:
          ring-flash, ring-plain and Ulysses-flash within 1e-3 relative of
          the no-mesh forward.
  timing  each kernel at its path's shapes beside its bound, its plain
          version and one PyTorch library call (a yardstick only): K1 at
          path_a's shape (its JSON numbers) and at path_c's two (the no-mesh
          forward's [1, 8192, 32, 128] and Ulysses' [1, 8192, 8, 128]). K2's
          JSON numbers are per launch over path_c's mix: per layer, 4
          diagonal and 6 fully visible chunk pairs.

Each phase prints its wall time ("[time]"). The last lines are a JSON
object of per-kernel numbers, the card's name and
power limit as nvidia-smi prints them, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
(count: the cards this run used). Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ALL_PHASES = ("env", "build", "parity", "path_a", "path_b", "quant", "path_d",
              "path_e", "path_f", "path_c", "timing")
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
SEED = 0
CARDS_USED = 1            # every phase runs on cuda:0
SP = 4                    # path_c's ring length: chunks of 2048 at t=8192
DIAGONAL_PER_LAYER = SP                      # path_c's K2 mix per layer
OFF_DIAGONAL_PER_LAYER = SP * (SP - 1) // 2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def time_ms(torch, fn, iters: int, warmup: int = 2, reps: int = 1) -> float:
    """Device time of one fn() call: the mean from CUDA events around `iters`
    back-to-back calls after `warmup` calls, the median of `reps` such
    windows (a short window can catch the card changing clocks)."""
    for _ in range(warmup):
        fn()
    means = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return sorted(means)[len(means) // 2]


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def print_profile(torch, label: str, fn) -> None:
    """Device time by kernel for one fn() call, from torch.profiler; the busy
    share is that kernel time over the wall of an unprofiled call (the
    profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    unprofiled = wall_ms(torch, fn)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernels only: operator rows repeat their kernels' device time.
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[profile] {label}: wall {wall:.2f} ms profiled, {unprofiled:.2f} ms "
          f"unprofiled; kernel time {device_us / 1e3:.2f} ms, busy "
          f"{device_us / 1e3 / unprofiled:.1%} of the unprofiled wall")
    print(events.table(sort_by="self_device_time_total", row_limit=12))


def causal_pairs(t: int, window: int = 0, sinks: int = 0) -> int:
    """(query, key) pairs the mask leaves visible."""
    total = 0
    for q in range(t):
        lo = max(q - window + 1, 0) if window > 0 else 0
        total += q - lo + 1 + (min(sinks, lo) if window > 0 else 0)
    return total


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def partial_work(b, tq, tk, h, d, elem, causal_diagonal: bool):
    """(operations, bytes) of one ring step: QK^T and PV over the visible
    pairs; q, k, v read once, the f32 carry (acc, m, l) read and written."""
    pairs = tq * (tq + 1) // 2 if causal_diagonal else tq * tk
    nbytes = (b * (tq + 2 * tk) * h * d * elem
              + 2 * 4 * b * h * tq * (d + 2))
    return 4 * b * h * d * pairs, nbytes


SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS")


def sass_counts(tool: str, library: Path) -> dict[str, dict[str, int]]:
    """Per kernel of a built library, named as in the source (template
    arguments spelled out): how many of its SASS instructions are each of
    SASS_OPS, from `cuobjdump -sass`."""
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            spelled = re.search(r"(flash_fwd_\w+?)ILi(\d+)ELb([01])E", name)
            if spelled:
                name = (f"{spelled.group(1)}<{spelled.group(2)}, "
                        f"{'true' if spelled.group(3) == '1' else 'false'}>")
            current = counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if current is not None and op and op.group(1) in current:
            current[op.group(1)] += 1
    return counts


def time_flash(torch, dev, b, t, h, d, label, plain_iters=5):
    """K1 (bf16, causal) at one shape beside its bound, its plain version
    and SDPA; returns the numbers of a kernels-line record."""
    import torch.nn.functional as F

    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    iters = max(5, int(50 * (2 * 2048 * 2048 * 32) / (b * t * t * h)))
    kernel_ms = time_ms(torch, lambda: flash_attention(q, k, v), iters=iters, reps=5)
    plain_ms = time_ms(torch, lambda: flash_attention_reference(q, k, v),
                       iters=plain_iters, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        iters=iters, reps=5)
    flops = 4 * b * h * d * causal_pairs(t)
    nbytes = 4 * q.numel() * q.element_size()
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[timing] flash_attention {label} b={b} t={t} h={h} d={d} bf16 causal: "
          f"kernel {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s), "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB), plain {plain_ms:.3f} ms, sdpa "
          f"{library_ms:.4f} ms", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def parity_partial(torch, dev, record) -> None:
    """K2 against its plain version on the card, at path_c's chunk shape."""
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention_partial,
        flash_attention_partial_reference,
        new_carry,
    )

    c = 2048
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, h, d, dtype, tq, tk, q_off, k_off, causal, fold first, tol
        ("k2_diagonal_bf16", 32, 128, bf16, c, c, c, c, True, False, 2e-2),
        ("k2_past_chunk_bf16", 32, 128, bf16, c, c, 2 * c, 0, True, False, 2e-2),
        ("k2_non_causal_bf16", 32, 128, bf16, c, c, 0, c, False, False, 2e-2),
        ("k2_klen_tail_tk1000_bf16", 32, 128, bf16, c, 1000, 0, 0, True, False, 2e-2),
        ("k2_q_padding_tq77_bf16", 32, 128, bf16, 77, c, 1000, 0, True, False, 2e-2),
        ("k2_folded_carry_bf16", 32, 128, bf16, c, c, c, c, True, True, 2e-2),
        ("k2_all_future_chunk_bf16", 32, 128, bf16, c, c, 0, c, True, True, 0.0),
        ("k2_klen_tail_tk1000_d64_f32", 8, 64, f32, c, 1000, 0, 0, True, False, 1e-4),
        ("k2_q_padding_tq77_d64_f32", 8, 64, f32, 77, c, 1000, 0, True, False, 1e-4),
        ("k2_folded_carry_f32", 8, 128, f32, c, c, c, c, True, True, 1e-4),
        ("k2_tq77_tk200_d64_bf16", 8, 64, bf16, 77, 200, 1000, 0, True, False, 2e-2),
    ]
    for i, (name, h, d, dtype, tq, tk, q_off, k_off, causal, fold_first,
            tol) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)

        def draw(t):
            return torch.randn((1, t, h, d), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)

        q, k, v = draw(tq), draw(tk), draw(tk)
        carry = new_carry(1, h, tq, d, dev)
        if fold_first:  # an earlier chunk at global position 0
            carry = flash_attention_partial_reference(
                q, draw(c), draw(c), *carry, q_offset=q_off, k_offset=0)
        kw = dict(q_offset=q_off, k_offset=k_off, causal=causal)
        got = [x.clone() for x in carry]
        before = flash_attention_partial.launches
        out = flash_attention_partial(q, k, v, *got, **kw)
        torch.cuda.synchronize()
        check(flash_attention_partial.launches == before + 1,
              f"{name}: kernel was not launched")
        check(all(o is g for o, g in zip(out, got)),
              f"{name}: the carry was not updated in place")
        if tol == 0.0:
            same = all(torch.equal(g, x) for g, x in zip(got, carry))
            print(f"[parity] {name}: carry unchanged bit for bit: {same}",
                  flush=True)
            check(same, f"{name}: an all-future chunk changed the carry")
            continue
        want = flash_attention_partial_reference(q, k, v, *carry, **kw)
        out_got = got[0] / got[2].clamp(min=1e-30)[..., None]
        out_want = want[0] / want[2].clamp(min=1e-30)[..., None]
        err = (out_got - out_want).abs().max().item()
        err_m = (got[1] - want[1]).abs().max().item()
        print(f"[parity] {name}: max_abs_err acc/l {err:.3e}, m {err_m:.3e} "
              f"(tolerance {tol:g})", flush=True)
        check(err <= tol and err_m <= tol,
              f"{name}: max_abs_err {err} / m {err_m} > {tol}")
        if i == 0:
            record["max_abs_err"] = err
        del q, k, v, carry, got, want, out_got, out_want
    parity_partial_views(torch, dev)


def parity_partial_views(torch, dev) -> None:
    """K2 on sp_chunks views of one longer tensor, as the ring hands them
    over: chunks of 1000 rows (not a multiple of the 128-row tile) of a
    [1, 4000, 8, 128] bf16 tensor; each chunk's tensor maps must end where
    the chunk does."""
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention_partial,
        flash_attention_partial_reference,
        new_carry,
    )
    from bee_code_interpreter_fs_tpu_torch.parallel.mesh import sp_chunks

    b, c, h, d, n = 1, 1000, 8, 128, SP
    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    full = [torch.randn((b, n * c, h, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(3)]
    qs, ks, vs = (sp_chunks(x, n) for x in full)
    for q_rank, k_rank in ((2, 2), (3, 1), (1, 2)):
        kw = dict(q_offset=q_rank * c, k_offset=k_rank * c)
        got = new_carry(b, h, c, d, dev)
        flash_attention_partial(qs[q_rank], ks[k_rank], vs[k_rank], *got, **kw)
        want = flash_attention_partial_reference(
            qs[q_rank].contiguous(), ks[k_rank].contiguous(), vs[k_rank].contiguous(),
            *new_carry(b, h, c, d, dev), **kw)
        name = f"k2_sp_chunk_views_q{q_rank}_k{k_rank}_bf16"
        if k_rank > q_rank:  # the plain version's padded q-tile reaches the
            # future chunk here; the kernel's q-tile ends with the chunk
            same = all(torch.equal(g, f) for g, f in zip(got, new_carry(b, h, c, d, dev)))
            print(f"[parity] {name}: all-future carry unchanged bit for bit: "
                  f"{same}", flush=True)
            check(same, f"{name}: an all-future chunk changed the carry")
            continue
        out_got = got[0] / got[2].clamp(min=1e-30)[..., None]
        out_want = want[0] / want[2].clamp(min=1e-30)[..., None]
        err = (out_got - out_want).abs().max().item()
        print(f"[parity] {name}: max_abs_err acc/l {err:.3e} (tolerance 0.02)",
              flush=True)
        check(err <= 2e-2, f"{name}: max_abs_err {err} > 0.02")


def percentile(values, q: float) -> float:
    """The q-quantile of `values` by linear interpolation."""
    ordered = sorted(values)
    at = (len(ordered) - 1) * q
    lo = int(at)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (at - lo)


def run_quant(torch, dev, params, cfg, gen) -> None:
    """int8 and int4 (group 128) weights quantized from the bf16 7B params:
    the b=2, t=512 forward against the dense forward of the dequantized
    weights, greedy generation, bytes and times."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        decode_step,
        forward,
        greedy_generate,
        init_cache,
        prefill,
    )
    from bee_code_interpreter_fs_tpu_torch.models import quant
    from bee_code_interpreter_fs_tpu_torch.models.llama import _w

    b, t = 2, 512
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device=dev,
                            dtype=torch.int32)
    bf16 = torch.bfloat16
    with torch.inference_mode():
        dense_logits = forward(params, tokens, cfg)
        print(f"[quant] llama2_7b bf16 weights: {quant.quantized_nbytes(params) / 2**30:.2f} "
              f"GiB", flush=True)
        for label, make in (("int8", quant.quantize_params),
                            ("int4 g128", lambda p: quant.quantize4_params(p, 128))):
            qparams = make(params)
            nbytes = quant.quantized_nbytes(qparams)
            logits = forward(qparams, tokens, cfg)
            check(logits.shape == (b, t, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()), f"{label} logits")
            deq = quant._with_matmul_weights(qparams, lambda leaf: _w(leaf, bf16))
            want = forward(deq, tokens, cfg)
            agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
            diff = (logits - want).abs().max().item()
            vs_bf16 = (logits.argmax(-1) == dense_logits.argmax(-1)).float().mean().item()
            del deq, want, logits
            fwd_ms = min(wall_ms(torch, lambda: forward(qparams, tokens, cfg))
                         for _ in range(3))
            leaves = [getattr(blk, name) for blk in qparams.layers
                      for name in quant.QUANTIZED_LAYER_WEIGHTS] + [qparams.lm_head]
            deq_ms = min(wall_ms(torch, lambda: [_w(leaf, bf16) for leaf in leaves])
                         for _ in range(3))
            out = greedy_generate(qparams, prompts, cfg, max_new_tokens=32)
            check(out.shape == (4, 160) and bool((out[:, :128] == prompts).all())
                  and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                  f"{label} greedy_generate output")
            cache = init_cache(cfg, 4, 160, device=dev)
            prefill(qparams, prompts, cache, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(31):
                decode_step(qparams, out[:, 128 + i:129 + i], cache, 128 + i, cfg)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / 31
            del cache, qparams, leaves
            torch.cuda.empty_cache()
            print(f"[quant] llama2_7b {label}: weights {nbytes / 2**30:.2f} GiB; b={b} "
                  f"t={t} forward argmax agreement with the dequantized dense "
                  f"forward {agree:.4f} (>= 0.9), max |diff| {diff:.3e}, with the "
                  f"bf16 forward {vs_bf16:.4f} | forward {fwd_ms:.2f} ms, one "
                  f"dequantize of every matmul weight {deq_ms:.2f} ms; "
                  f"greedy_generate 4 x 128, 32 new: decode {step_ms:.2f} ms/step",
                  flush=True)
            check(agree >= 0.9, f"{label} argmax agreement {agree} < 0.9")
        del dense_logits


def path_d_traffic(vocab: int):
    """path_d's 16 requests from torch.Generator seed 3: (prefix tokens,
    [(prompt, max_new_tokens, submit kwargs, role)])."""
    import torch

    g = torch.Generator().manual_seed(3)

    def draw(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    prefix = torch.randint(0, vocab, (256,), generator=g).tolist()
    reqs = []
    for i in range(16):
        new = draw(16, 128)
        if i < 4:  # prefixed: the suffix makes the prompt 256-512 tokens
            n = 0 if i == 0 else draw(1, 256)
            kw, role = {"prefixed": True}, "prefix"
        else:
            n = draw(16, 512)
            kw, role = {}, "greedy"
            if 4 <= i < 8:
                kw, role = dict(temperature=0.8, top_p=0.9, seed=1000 + i), "sampled"
            elif i in (8, 9):
                kw, role = dict(logprobs=True), "logprobs"
            elif i == 10:
                kw, role = dict(presence_penalty=0.5, frequency_penalty=0.3), "penalty"
        reqs.append((torch.randint(0, vocab, (n,), generator=g).tolist(), new, kw, role))
    return prefix, reqs


def drive_engine(torch, eng, prefix, reqs):
    """Submit every request at once, run to the end; returns (results
    {index: tokens}, logprobs {index: array}, wall s, first-token times s,
    burst walls ms, admission walls ms by bucket)."""
    pid = eng.register_prefix(prefix) if prefix else None
    first_at, bursts, admits = {}, [], {}
    run_burst, install = eng._run_burst, eng._install

    def timed_burst(*a):
        t0 = time.perf_counter()
        out = run_burst(*a)  # ends in the burst's one device-to-host copy
        bursts.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_install(req, i):
        n = req.prompt.size
        bucket = (f"prefix+{eng._suffix_bucket(len(prefix), n)}" if req.prefix_id is not None
                  and n else "prefix only" if req.prefix_id is not None
                  else str(eng._bucket_len(n)))
        t0 = time.perf_counter()
        out = install(req, i)  # its first token comes to the host
        admits.setdefault(bucket, []).append((time.perf_counter() - t0) * 1e3)
        return out

    eng._run_burst, eng._install = timed_burst, timed_install
    t_start = time.perf_counter()
    rids = {}
    for k, (prompt, new, kw, _) in enumerate(reqs):
        kw = dict(kw)
        prefixed = kw.pop("prefixed", False)

        def sink(toks, k=k):
            first_at.setdefault(k, time.perf_counter() - t_start)

        rids[k] = eng.submit(prompt, new, prefix_id=pid if prefixed else None,
                             on_token=sink, **kw)
    res = eng.run()
    wall = time.perf_counter() - t_start
    eng._run_burst, eng._install = run_burst, install
    out = {k: res[r] for k, r in rids.items()}
    lps = {k: eng.take_logprobs(r) for k, r in rids.items()}
    return out, lps, wall, first_at, bursts, admits, pid


def report_engine(label, reqs, out, wall, first_at, bursts, admits, steps) -> None:
    n_tok = sum(len(v) for v in out.values())
    ttft = [first_at[k] * 1e3 for k in sorted(first_at)]
    per_step = [ms / steps for ms in bursts]
    print(f"[path_d] {label}: {len(reqs)} requests, {n_tok} tokens generated in "
          f"{wall:.2f} s: {n_tok / wall:.1f} tokens/s, {len(reqs) / wall:.2f} "
          f"requests/s; time to first token p50 {percentile(ttft, 0.5):.0f} ms, p95 "
          f"{percentile(ttft, 0.95):.0f} ms (all submitted at once); {len(bursts)} "
          f"bursts of {steps}: {percentile(per_step, 0.5):.2f} ms per decode step "
          f"(p50; p95 {percentile(per_step, 0.95):.2f})", flush=True)
    print(f"[path_d] {label}: admission ms per bucket: " + ", ".join(
        f"{b} x{len(v)} p50 {percentile(v, 0.5):.1f}" for b, v in sorted(admits.items())),
        flush=True)


def run_path_d(torch, dev, params, cfg, figures) -> None:
    """The serving engines at Llama-2-7B bf16 width and depth, then the
    strict f32 check at full width, 4 layers."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        PagedServingEngine,
        ServingEngine,
        forward,
    )
    from bee_code_interpreter_fs_tpu_torch.models import serving
    from bee_code_interpreter_fs_tpu_torch.models.quant import dequantize_kv
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_partial,
    )

    prefix, reqs = path_d_traffic(cfg.vocab_size)
    steps = 8
    cfg_dtype = params.embed.dtype
    flash_attention.launches = flash_attention_partial.launches = 0
    dense = ServingEngine(params, cfg, n_slots=8, max_len=1024, steps_per_sync=steps)
    d_out, d_lps, *d_rest = drive_engine(torch, dense, prefix, reqs)
    figures["path_d_tokens_per_s"] = sum(len(v) for v in d_out.values()) / d_rest[0]
    report_engine("ServingEngine bf16 KV", reqs, d_out, *d_rest[:4], steps)
    paged = PagedServingEngine(params, cfg, n_slots=8, max_len=1024, steps_per_sync=steps,
                               kv_quant=True, block_size=16)
    total = paged.free_blocks
    p_out, _, *p_rest = drive_engine(torch, paged, prefix, reqs)
    report_engine("PagedServingEngine int8 KV", reqs, p_out, *p_rest[:4], steps)
    print(f"[path_d] flash kernel launches in both engines: "
          f"{flash_attention.launches} K1, {flash_attention_partial.launches} K2 (the "
          f"serving path attends with the plain grouped contraction, as the "
          f"reference's does)", flush=True)
    with torch.inference_mode():  # one layer's block-table read, as a step makes it
        pool, tables = paged.pool, paged.tables

        def gathered(name):
            return pool[name][0][tables].reshape(8, -1, *pool[name].shape[3:])

        gather_ms = time_ms(torch, lambda: [gathered(n) for n in pool], iters=20)
        read_ms = time_ms(torch, lambda: [dequantize_kv(gathered(q), gathered(s), cfg_dtype)
                                          for q, s in (("kq", "ks"), ("vq", "vs"))], iters=20)
    print(f"[path_d] paged int8 block-table read at 8 slots x {tables.shape[1]} blocks "
          f"of 16: gather {gather_ms:.3f} ms per layer, gather + dequantize "
          f"{read_ms:.3f} ms per layer, {read_ms * cfg.n_layers:.2f} ms per step",
          flush=True)
    shared = paged.stats()["shared_prefix_blocks"]
    check(shared == 256 // 16, f"paged shared_prefix_blocks {shared} != 16")
    paged.unregister_prefix(p_rest[-1])
    check(paged.free_blocks == total == paged.stats()["total_blocks"],
          f"paged free_blocks {paged.free_blocks} != total {total}")
    for k, (prompt, new, _, _) in enumerate(reqs):
        check(len(d_out[k]) == new and len(p_out[k]) == new, f"request {k} length")
        check(int(d_out[k][0]) == int(p_out[k][0]),
              f"request {k}: first tokens differ between the engines")
    with torch.inference_mode():
        gaps, exact = [], 0
        lp_err = 0.0
        for k, (prompt, new, kw, role) in enumerate(reqs):
            if role in ("sampled", "penalty"):
                continue
            full = (prefix if kw.get("prefixed") else []) + prompt + d_out[k].tolist()
            logits = forward(params, torch.tensor([full[:-1]], device=dev), cfg)[0]
            at = logits[len(full) - 1 - new:]
            toks = torch.as_tensor(d_out[k], device=dev).long()
            picked = at.gather(1, toks[:, None])[:, 0]
            gaps.append((at.max(-1).values - picked).max().item())
            exact += int((at.argmax(-1) == toks).sum())
            if role == "logprobs":
                want = torch.log_softmax(at, -1).gather(1, toks[:, None])[:, 0]
                lp_err = max(lp_err, (torch.as_tensor(d_lps[k], device=dev) - want)
                             .abs().max().item())
        n_greedy = sum(len(d_out[k]) for k, r in enumerate(reqs)
                       if r[3] not in ("sampled", "penalty"))
        share = exact / n_greedy
        print(f"[path_d] bf16 greedy tokens of ServingEngine vs a teacher-forced "
              f"forward: largest gap to the maximum logit {max(gaps):.4f} (<= 0.1), "
              f"exact-argmax share {share:.4f} (>= 0.9) over {n_greedy} tokens; "
              f"log-probs max |diff| {lp_err:.3e}", flush=True)
        check(max(gaps) <= 0.1, f"greedy token {max(gaps)} below the maximum logit")
        check(share >= 0.9, f"exact-argmax share {share} < 0.9")
        # Alone, each in an engine of the mix's shape (8 slots, 7 idle): a
        # bf16 matmul over another batch size rounds other bits, which
        # would move a draw; the stream itself is schedule-free (the f32
        # check below replays over 1 slot).
        sampled = [k for k, r in enumerate(reqs) if r[3] == "sampled"]
        same = True
        for k in sampled:
            replay = ServingEngine(params, cfg, n_slots=8, max_len=1024,
                                   steps_per_sync=steps)
            rid = replay.submit(reqs[k][0], reqs[k][1], **reqs[k][2])
            same = same and np.array_equal(replay.run()[rid], d_out[k])
            del replay
        print(f"[path_d] {len(sampled)} sampled requests replayed alone give the "
              f"tokens they had in the mix: {same}", flush=True)
        check(same, "a sampled request's tokens depend on its batch")
        busy = ServingEngine(params, cfg, n_slots=8, max_len=1024, steps_per_sync=steps)
        for prompt, _, _, _ in reqs[4:12]:
            busy.submit(prompt, 128)
        busy.step()
        print_profile(torch, "path_d one ServingEngine burst of 8 steps, 8 slots",
                      lambda: busy._run_burst())
        # Every branch of a burst (log-probs, nucleus, penalties) with any
        # host sync raising; its results are dropped.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            serving._burst(busy._step_fn(), busy.pos, busy.last_tok, busy.remaining,
                           busy.active, busy.temp, busy.keys, steps, cfg.vocab_size - 1,
                           True, busy.top_p, (busy.presence, busy.frequency,
                                              torch.zeros((8, cfg.vocab_size), device=dev,
                                                          dtype=torch.int32)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("[path_d] a burst of 8 steps with log-probs, top_p, penalties and eos "
              "runs under torch.cuda.set_sync_debug_mode('error'): no host sync",
              flush=True)
        del busy, dense, paged
        torch.cuda.empty_cache()
    run_path_d_f32(torch, dev, cfg)


def run_path_d_f32(torch, dev, cfg) -> None:
    """The strict check: full width, 4 layers, f32, max_len 256."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        PagedServingEngine,
        ServingEngine,
        forward,
        greedy_generate,
        init_params,
    )

    cfg32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 4), dev)
    g = torch.Generator().manual_seed(4)
    prefix = torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist()
    reqs = []
    for i in range(8):
        n = int(torch.randint(1 if i < 2 else 16, 97, (1,), generator=g))
        new = int(torch.randint(8, 33, (1,), generator=g))
        kw = ({"prefixed": True} if i < 2 else dict(logprobs=True) if i < 4
              else dict(temperature=0.8, top_p=0.9, seed=i) if i == 7 else {})
        reqs.append((torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist(), new,
                     kw, "sampled" if i == 7 else "greedy"))
    kw = dict(n_slots=4, max_len=256, steps_per_sync=8)
    with torch.inference_mode():
        d_out, d_lps, *_ = drive_engine(torch, ServingEngine(params32, cfg32, **kw),
                                        prefix, reqs)
        mismatched = []
        lp_err = 0.0
        for k, (prompt, new, rkw, role) in enumerate(reqs):
            full = (prefix if rkw.get("prefixed") else []) + prompt
            if role == "greedy":
                want = greedy_generate(params32, torch.tensor([full], device=dev), cfg32,
                                       max_new_tokens=new)[0, len(full):].cpu().numpy()
                if not np.array_equal(d_out[k], want):
                    mismatched.append(k)
            if rkw.get("logprobs"):
                seq = torch.tensor([full + d_out[k].tolist()], device=dev)
                ref = torch.log_softmax(forward(params32, seq[:, :-1], cfg32), -1)[0]
                toks = torch.as_tensor(d_out[k], device=dev).long()
                want_lp = ref[len(full) - 1:].gather(1, toks[:, None])[:, 0]
                lp_err = max(lp_err, (torch.as_tensor(d_lps[k], device=dev) - want_lp)
                             .abs().max().item())
        q_out = [drive_engine(torch, cls(params32, cfg32, kv_quant=True, **extra, **kw),
                              prefix, reqs)[0]
                 for cls, extra in ((ServingEngine, {}), (PagedServingEngine,
                                                          {"block_size": 16}))]
        paged_same = all(np.array_equal(q_out[0][k], q_out[1][k]) for k in range(len(reqs)))
        alone = ServingEngine(params32, cfg32, n_slots=1, max_len=256, steps_per_sync=5)
        rid = alone.submit(reqs[7][0], reqs[7][1], **reqs[7][2])
        replay_same = np.array_equal(alone.run()[rid], d_out[7])
    print(f"[path_d] full width, 4 layers, f32, max_len 256, {len(reqs)} requests: "
          f"ServingEngine greedy tokens equal greedy_generate's: {not mismatched} "
          f"(requests {mismatched} differ); paged int8 equals dense int8: "
          f"{paged_same}; the sampled request replayed alone over 1 slot and "
          f"bursts of 5 gives its tokens: {replay_same}; log-probs vs a "
          f"teacher-forced log_softmax max |diff| {lp_err:.3e} (<= 1e-4)", flush=True)
    check(not mismatched, f"f32 engine tokens differ from greedy_generate: {mismatched}")
    check(paged_same, "f32 paged int8 tokens differ from dense int8")
    check(replay_same, "f32 sampled request's tokens depend on its schedule")
    check(lp_err <= 1e-4, f"f32 log-probs off by {lp_err}")
    del params32
    torch.cuda.empty_cache()


def layer_cut(params, n_layers: int):
    """A Llama over the first `n_layers` Blocks of `params` and its embed,
    final_norm and lm_head: the same tensors, none copied (path_e's
    layer-skip draft, the 4-layer models of path_f's checkpoints)."""
    import copy

    from torch import nn

    out = copy.copy(params)
    out._parameters = dict(params._parameters)
    out._buffers = dict(params._buffers)
    out._modules = dict(params._modules)
    out.layers = nn.ModuleList(list(params.layers)[:n_layers])
    return out


def greedy_criteria(torch, params, cfg, seqs, n_new: int):
    """The bf16 criteria for greedy tokens (path_d's): each of the last
    n_new tokens of every sequence in `seqs` ([b, t] or a list of 1-D
    sequences) against a teacher-forced forward over its prefix: (largest
    gap to the maximum logit, exact-argmax share, tokens checked)."""
    from bee_code_interpreter_fs_tpu_torch.models import forward

    dev = params.device
    gaps, exact, total = [0.0], 0, 0
    rows = [torch.as_tensor(s, device=dev).reshape(-1) for s in seqs]
    for row, new in zip(rows, n_new if isinstance(n_new, list) else [n_new] * len(rows)):
        if new == 0:
            continue
        logits = forward(params, row[None, :-1].long(), cfg)[0]
        at = logits[row.numel() - 1 - new:]
        toks = row[-new:].long()
        picked = at.gather(1, toks[:, None])[:, 0]
        gaps.append((at.max(-1).values - picked).max().item())
        exact += int((at.argmax(-1) == toks).sum())
        total += new
    return max(gaps), exact / max(total, 1), total


def count_verify_passes(llama_module, gamma: int):
    """Wrap models/llama.py's decode_chunk to count the target's verify
    chunks (gamma + 1 tokens; a draft step is one token). Returns (counter
    dict, restore function)."""
    original = llama_module.decode_chunk
    counter = {"passes": 0}

    def counting(params, tokens, *a, **kw):
        if tokens.shape[1] == gamma + 1:
            counter["passes"] += 1
        return original(params, tokens, *a, **kw)

    llama_module.decode_chunk = counting
    return counter, lambda: setattr(llama_module, "decode_chunk", original)


def spec_traffic(vocab: int, n: int = 8, seed: int = 3):
    """path_e's requests from torch.Generator `seed`: (prefix tokens,
    [(prompt, max_new_tokens, submit kwargs, role)]): prompts 16-256
    tokens, 16-64 new; requests 0-1 behind a 128-token prefix (the prompt
    is the suffix), 2-3 sampled at temperature 0.8."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def draw(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    prefix = torch.randint(0, vocab, (128,), generator=g).tolist()
    reqs = []
    for i in range(n):
        new = draw(16, 64)
        if i < 2:
            plen, kw, role = draw(1, 128), {"prefixed": True}, "prefix"
        else:
            plen, kw, role = draw(16, 256), {}, "greedy"
            if i in (2, 3):
                kw, role = dict(temperature=0.8, seed=2000 + i), "sampled"
        reqs.append((torch.randint(0, vocab, (plen,), generator=g).tolist(), new, kw, role))
    return prefix, reqs


def drive_counted(torch, eng, prefix, reqs):
    """drive_engine, also counting each burst's passes: returns its tuple
    plus (slot-passes, burst-emitted tokens, passes per burst)."""
    run_burst = eng._run_burst
    counts = {"slot_passes": 0, "tokens": 0}
    g1 = getattr(eng, "gamma", 0) + 1

    def counted(*a):
        toks, emitted, lps = run_burst(*a)
        # A slot active in a pass emits its first token of the pass.
        counts["slot_passes"] += int(emitted[::g1].sum())
        counts["tokens"] += int(emitted.sum())
        return toks, emitted, lps

    eng._run_burst = counted
    try:
        out = drive_engine(torch, eng, prefix, reqs)
    finally:
        eng._run_burst = run_burst
    return (*out, counts)


def report_spec(label, reqs, out, wall, first_at, bursts, steps, counts) -> None:
    n_tok = sum(len(v) for v in out.values())
    ttft = [first_at[k] * 1e3 for k in sorted(first_at)]
    per_pass = [ms / steps for ms in bursts]
    per_slot_pass = counts["tokens"] / max(counts["slot_passes"], 1)
    print(f"[path_e] {label}: {len(reqs)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.1f} tokens/s, {len(reqs) / wall:.2f} requests/s; TTFT p50 "
          f"{percentile(ttft, 0.5):.0f} ms, p95 {percentile(ttft, 0.95):.0f} ms; "
          f"{len(bursts)} bursts of {steps} passes: {percentile(per_pass, 0.5):.2f} ms "
          f"per pass (p50; p95 {percentile(per_pass, 0.95):.2f}); mean tokens per "
          f"slot-pass {per_slot_pass:.3f} ({counts['tokens']} tokens in "
          f"{counts['slot_passes']} slot-passes)", flush=True)


def run_path_e(torch, dev, params, cfg) -> None:
    """Speculative decoding at Llama-2-7B bf16, full depth: lockstep
    generation with a perfect and a layer-skip draft, then both speculative
    engines beside the plain one; then the strict f32 check."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        PagedSpeculativeServingEngine,
        ServingEngine,
        SpeculativeServingEngine,
        greedy_generate,
        speculative_generate,
        speculative_sample_generate,
    )
    from bee_code_interpreter_fs_tpu_torch.models import llama as llama_module
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_partial,
    )

    gamma, b, p_len, new = 4, 2, 128, 64
    skip_cfg = dataclasses.replace(cfg, n_layers=2)
    drafts = {"perfect": (params, cfg), "layer-skip": (layer_cut(params, 2), skip_cfg)}
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len),
                            generator=torch.Generator().manual_seed(SEED + 5)).to(dev)
    flash_attention.launches = flash_attention_partial.launches = 0
    with torch.inference_mode():
        t0 = time.perf_counter()
        plain = greedy_generate(params, prompts, cfg, max_new_tokens=new)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        print(f"[path_e] greedy_generate {b} prompts x {p_len}, {new} new: "
              f"{b * new / plain_s:.1f} tokens/s ({plain_s:.2f} s)", flush=True)
        for name, (draft, dcfg) in drafts.items():
            for sampled in (False, True):
                counter, restore = count_verify_passes(llama_module, gamma)
                t0 = time.perf_counter()
                try:
                    if sampled:
                        out = speculative_sample_generate(
                            draft, params, prompts, SEED, dcfg, cfg, max_new_tokens=new,
                            gamma=gamma, temperature=0.8)
                    else:
                        out = speculative_generate(draft, params, prompts, dcfg, cfg,
                                                   max_new_tokens=new, gamma=gamma)
                    torch.cuda.synchronize()
                finally:
                    restore()
                secs = time.perf_counter() - t0
                passes = counter["passes"]
                check(out.shape == (b, p_len + new) and bool((out[:, :p_len] == prompts).all())
                      and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                      f"path_e {name} output")
                fn = "speculative_sample_generate T=0.8" if sampled else "speculative_generate"
                line = (f"[path_e] {fn}, {name} draft, gamma {gamma}: "
                        f"{b * new / secs:.1f} tokens/s "
                        f"({secs:.2f} s), {passes} target passes, mean "
                        f"{(new - 1) / max(passes, 1):.2f} tokens per pass")
                if not sampled:
                    gap, share, n = greedy_criteria(torch, params, cfg, out, new)
                    same = float((out == plain).float()[:, p_len:].mean())
                    line += (f"; vs a teacher-forced forward: gap {gap:.4f} (<= 0.1), "
                             f"exact share {share:.4f} (>= 0.9) over {n} tokens; equal to "
                             f"greedy_generate's at {same:.4f} of positions")
                    check(gap <= 0.1 and share >= 0.9,
                          f"path_e {name} greedy tokens: gap {gap}, share {share}")
                print(line, flush=True)

    prefix, reqs = spec_traffic(cfg.vocab_size)
    steps = 4
    kw = dict(n_slots=4, max_len=512, steps_per_sync=steps)
    skip, _ = drafts["layer-skip"]
    spec_kw = dict(draft_params=skip, draft_cfg=skip_cfg, gamma=gamma, **kw)
    runs = {}
    with torch.inference_mode():
        for label, make in (
            ("ServingEngine bf16 KV", lambda: ServingEngine(params, cfg, **kw)),
            ("SpeculativeServingEngine bf16 KV, layer-skip draft",
             lambda: SpeculativeServingEngine(params, cfg, **spec_kw)),
            ("PagedSpeculativeServingEngine int8 KV, blocks of 16, layer-skip draft",
             lambda: PagedSpeculativeServingEngine(params, cfg, kv_quant=True, block_size=16,
                                                   **spec_kw)),
        ):
            eng = make()
            total = getattr(eng, "free_blocks", None)
            out, _, wall, first_at, bursts, _, pid, counts = drive_counted(
                torch, eng, prefix, reqs)
            report_spec(label, reqs, out, wall, first_at, bursts, steps, counts)
            if total is not None:
                eng.unregister_prefix(pid)
                check(eng.free_blocks == total == eng.stats()["total_blocks"],
                      f"{label}: free_blocks {eng.free_blocks} != total {total}")
            runs[label] = out
            del eng
        torch.cuda.empty_cache()
        labels = list(runs)
        for k, (prompt, n, _, _) in enumerate(reqs):
            check(all(len(runs[lb][k]) == n for lb in labels), f"path_e request {k} length")
            check(len({int(runs[lb][k][0]) for lb in labels}) == 1,
                  f"path_e request {k}: first tokens differ between the engines")
        greedy = [k for k, r in enumerate(reqs) if r[3] != "sampled"]
        seqs = [(prefix if reqs[k][2].get("prefixed") else []) + reqs[k][0]
                + runs[labels[1]][k].tolist() for k in greedy]
        gap, share, n = greedy_criteria(torch, params, cfg, seqs,
                                        [len(runs[labels[1]][k]) for k in greedy])
        print(f"[path_e] SpeculativeServingEngine bf16 greedy tokens vs a teacher-forced "
              f"forward: gap {gap:.4f} (<= 0.1), exact share {share:.4f} (>= 0.9) over "
              f"{n} tokens; {flash_attention.launches} K1 and "
              f"{flash_attention_partial.launches} K2 launches in the phase (the "
              f"speculative path attends with the plain grouped contraction, as the "
              f"reference's does)", flush=True)
        check(gap <= 0.1 and share >= 0.9, f"path_e engine greedy tokens: {gap}, {share}")
    run_path_e_f32(torch, dev, cfg)


def run_path_e_f32(torch, dev, cfg) -> None:
    """The strict check: full width, 4 layers, f32, max_len 256, layer-skip
    draft of 2 layers: both speculative engines' greedy tokens equal the
    plain engine's, paged int8 equals dense int8, a sampled request replayed
    alone keeps its tokens; lockstep tokens equal greedy_generate's."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        PagedSpeculativeServingEngine,
        ServingEngine,
        SpeculativeServingEngine,
        greedy_generate,
        init_params,
        speculative_generate,
    )

    cfg32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 6), dev)
    dcfg32 = dataclasses.replace(cfg32, n_layers=2)
    draft32 = layer_cut(params32, 2)
    prefix, reqs = spec_traffic(cfg.vocab_size, seed=6)
    reqs = [(p[:96], min(n, 32), kw, role) for p, n, kw, role in reqs]
    kw = dict(n_slots=4, max_len=256, steps_per_sync=4)
    spec_kw = dict(draft_params=draft32, draft_cfg=dcfg32, gamma=4, **kw)
    with torch.inference_mode():
        out = {}
        for name, make in (
            ("plain", lambda q: ServingEngine(params32, cfg32, kv_quant=q, **kw)),
            ("spec", lambda q: SpeculativeServingEngine(params32, cfg32, kv_quant=q,
                                                        **spec_kw)),
            ("paged_spec", lambda q: PagedSpeculativeServingEngine(
                params32, cfg32, kv_quant=q, block_size=16, **spec_kw)),
        ):
            for quant in (False, True):
                out[name, quant] = drive_engine(torch, make(quant), prefix, reqs)[0]
        greedy = [k for k, r in enumerate(reqs) if r[3] != "sampled"]
        spec_same = all(np.array_equal(out[e, q][k], out["plain", q][k])
                        for e in ("spec", "paged_spec") for q in (False, True) for k in greedy)
        int8_same = all(np.array_equal(out["paged_spec", True][k], out["spec", True][k])
                        for k in range(len(reqs)))
        sampled = next(k for k, r in enumerate(reqs) if r[3] == "sampled")
        alone = SpeculativeServingEngine(params32, cfg32, **dict(spec_kw, n_slots=1,
                                                                 steps_per_sync=3))
        rid = alone.submit(reqs[sampled][0], reqs[sampled][1], **reqs[sampled][2])
        replay_same = np.array_equal(alone.run()[rid], out["spec", False][sampled])
        prompts = torch.randint(0, cfg.vocab_size, (2, 64),
                                generator=torch.Generator().manual_seed(SEED + 7)).to(dev)
        lock = speculative_generate(draft32, params32, prompts, dcfg32, cfg32,
                                    max_new_tokens=32, gamma=4)
        lock_same = torch.equal(lock, greedy_generate(params32, prompts, cfg32,
                                                      max_new_tokens=32))
    print(f"[path_e] full width, 4 layers, f32, max_len 256, {len(reqs)} requests: "
          f"speculative engines' greedy tokens (bf16 and int8 KV, dense and paged) "
          f"equal the plain engine's: {spec_same}; paged int8 equals dense int8 "
          f"(every request): {int8_same}; a sampled request replayed alone over 1 slot "
          f"and bursts of 3 keeps its tokens: {replay_same}; speculative_generate "
          f"equals greedy_generate: {lock_same}", flush=True)
    check(spec_same, "f32 speculative engine tokens differ from the plain engine's")
    check(int8_same, "f32 paged int8 speculative tokens differ from dense int8")
    check(replay_same, "f32 sampled speculative request depends on its schedule")
    check(lock_same, "f32 speculative_generate differs from greedy_generate")
    del params32, draft32
    torch.cuda.empty_cache()


def hf_state_dict_of(torch, params, cfg) -> dict:
    """A HuggingFace-named state dict holding `params`' weights: [out, in]
    projections, q and k rows back in the rotate-half layout (the inverse
    of hf_convert._unpermute_rope)."""

    def permute(w_in_out, n_heads):
        w = w_in_out.T
        out_dim, in_dim = w.shape
        hd = out_dim // n_heads
        return w.reshape(n_heads, hd // 2, 2, in_dim).transpose(1, 2).reshape(out_dim, in_dim)

    sd = {"model.embed_tokens.weight": params.embed, "model.norm.weight": params.final_norm,
          "lm_head.weight": params.lm_head.T}
    for i, blk in enumerate(params.layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "input_layernorm.weight": blk.attn_norm,
            pre + "post_attention_layernorm.weight": blk.mlp_norm,
            pre + "self_attn.q_proj.weight": permute(blk.wq, cfg.n_heads),
            pre + "self_attn.k_proj.weight": permute(blk.wk, cfg.n_kv_heads),
            pre + "self_attn.v_proj.weight": blk.wv.T,
            pre + "self_attn.o_proj.weight": blk.wo.T,
            pre + "mlp.gate_proj.weight": blk.w_gate.T,
            pre + "mlp.up_proj.weight": blk.w_up.T,
            pre + "mlp.down_proj.weight": blk.w_down.T,
        })
    return {k: v.detach().contiguous() for k, v in sd.items()}


def same_weights(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and bool((sa[k] == sb[k]).all()) for k in sa)


def lora_adapters(torch, dev, cfg, n: int, rank: int = 16):
    """n adapters on DEFAULT_TARGETS with a nonzero b, from seeded card
    generators: init_lora's a, b ~ N(0, (0.3 / sqrt(rank))**2)."""
    from bee_code_interpreter_fs_tpu_torch.models import init_lora

    out = []
    for i in range(n):
        gen = torch.Generator(device=dev).manual_seed(SEED + 10 + i)
        tree = init_lora(gen, cfg, rank=rank, device=dev)
        for ab in tree["layers"].values():
            ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device=dev)
                          * 0.3 * rank ** -0.5)
        out.append(tree)
    return out


def lora_traffic(vocab: int, names):
    """path_f's 8 requests from torch.Generator seed 8: prompts 16-256
    tokens, 16-48 new; adapters in turn over `names` and None."""
    import torch

    g = torch.Generator().manual_seed(8)
    reqs = []
    for i in range(8):
        n = int(torch.randint(16, 257, (1,), generator=g))
        new = int(torch.randint(16, 49, (1,), generator=g))
        adapter = (list(names) + [None])[i % (len(names) + 1)]
        reqs.append((torch.randint(0, vocab, (n,), generator=g).tolist(), new, adapter))
    return reqs


def run_path_f(torch, dev, params, cfg, figures) -> None:
    """LoRA, beam search, the rolling cache, HF conversion and checkpoints
    at Llama-2-7B width."""
    run_path_f_lora(torch, dev, params, cfg, figures)
    run_path_f_beam(torch, dev, params, cfg)
    run_path_f_rolling(torch, dev, params,
                       dataclasses.replace(cfg, sliding_window=256, attention_sinks=4),
                       torch.Generator(device=dev).manual_seed(SEED + 15))
    run_path_f_hf(torch, dev, params, cfg)
    run_path_f_checkpoint(torch, dev, params, cfg)
    run_path_f_f32(torch, dev, cfg)


def run_path_f_lora(torch, dev, params, cfg, figures) -> None:
    from bee_code_interpreter_fs_tpu_torch.models import (
        ServingEngine,
        lora_wrap,
        merge_lora,
        quantize_params,
    )

    names = ("a", "b", "c")
    adapters = dict(zip(names, lora_adapters(torch, dev, cfg, 3)))
    reqs = lora_traffic(cfg.vocab_size, names)
    with torch.inference_mode():
        for label, base in (("bf16", params), ("int8 (QLoRA)", quantize_params(params))):
            eng = ServingEngine(base, cfg, n_slots=4, max_len=512, steps_per_sync=8,
                                adapters=adapters)
            t0 = time.perf_counter()
            rids = [eng.submit(p, n, adapter=ad) for p, n, ad in reqs]
            res = eng.run()
            wall = time.perf_counter() - t0
            n_tok = sum(len(res[r]) for r in rids)
            # path_d's criteria: the largest gap, the exact share over all
            # tokens (each against its own adapter's model).
            worst_gap, n_exact, n_checked = 0.0, 0.0, 0
            for ad in (*names, None):
                if ad is None:
                    model = base
                elif base is params:
                    model = merge_lora(params, adapters[ad])
                else:  # a quantized base does not merge: its wrapped model
                    model = lora_wrap(base, adapters[ad])
                mine = [k for k, r in enumerate(reqs) if r[2] == ad]
                gap, share, n = greedy_criteria(
                    torch, model, cfg, [reqs[k][0] + res[rids[k]].tolist() for k in mine],
                    [len(res[rids[k]]) for k in mine])
                worst_gap = max(worst_gap, gap)
                n_exact += share * n
                n_checked += n
                del model
            share = n_exact / n_checked
            plain = figures.get("path_d_tokens_per_s")
            print(f"[path_f] multi-LoRA ServingEngine over the {label} base, 3 adapters of "
                  f"rank 16 on {'/'.join(adapters['a']['layers'])} + base requests, "
                  f"{len(reqs)} requests: {n_tok} tokens in {wall:.2f} s, "
                  f"{n_tok / wall:.1f} tokens/s (path_d's plain ServingEngine: "
                  f"{'%.1f tokens/s' % plain if plain else 'not run'}); tokens vs a "
                  f"teacher-forced forward of each adapter's "
                  f"{'merged' if base is params else 'wrapped'} model: largest gap "
                  f"{worst_gap:.4f} (<= 0.1), exact share {share:.4f} (>= 0.9) over "
                  f"{n_checked} tokens", flush=True)
            check(worst_gap <= 0.1 and share >= 0.9,
                  f"multi-LoRA {label}: gap {worst_gap}, share {share}")
            del eng, base
            torch.cuda.empty_cache()


def run_path_f_beam(torch, dev, params, cfg) -> None:
    from bee_code_interpreter_fs_tpu_torch.models import beam_generate, greedy_generate

    b, p_len, new = 2, 64, 32
    prompts = torch.randint(0, cfg.vocab_size, (b, p_len),
                            generator=torch.Generator().manual_seed(SEED + 8)).to(dev)
    with torch.inference_mode():
        one = beam_generate(params, prompts, cfg, max_new_tokens=new, beam_size=1)
        same = float((one == greedy_generate(params, prompts, cfg, max_new_tokens=new))
                     .float()[:, p_len:].mean())
        t0 = time.perf_counter()
        four = beam_generate(params, prompts, cfg, max_new_tokens=new, beam_size=4)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(four.shape == (b, p_len + new) and bool((four[:, :p_len] == prompts).all())
          and bool(((four >= 0) & (four < cfg.vocab_size)).all()), "beam 4 output")
    print(f"[path_f] beam_generate b={b}, {p_len}-token prompts, {new} new: beam 1 equals "
          f"greedy_generate at {same:.4f} of positions (exact in the f32 check); beam 4 "
          f"{secs * 1e3 / new:.2f} ms per step ({secs:.2f} s)", flush=True)


def run_path_f_hf(torch, dev, params, cfg) -> None:
    from bee_code_interpreter_fs_tpu_torch.models import forward, from_hf_state_dict

    with torch.inference_mode():
        sd = hf_state_dict_of(torch, params, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conv = from_hf_state_dict(sd, cfg, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del sd
        equal = same_weights(conv, params)
        toks = torch.randint(0, cfg.vocab_size, (1, 256),
                             generator=torch.Generator().manual_seed(SEED + 9)).to(dev)
        fwd_same = torch.equal(forward(conv, toks, cfg), forward(params, toks, cfg))
        del conv
        torch.cuda.empty_cache()
    print(f"[path_f] from_hf_state_dict on the card, Llama-2-7B bf16 (an HF-named state "
          f"dict built from the port's weights, q/k rows back in rotate-half order): "
          f"{secs:.2f} s; tensors equal: {equal}; forward bit-equal: {fwd_same}",
          flush=True)
    check(equal and fwd_same, "HF conversion round trip differs")


def run_path_f_checkpoint(torch, dev, params, cfg) -> None:
    import tempfile

    from bee_code_interpreter_fs_tpu_torch.models import forward, quantize_params, stack_loras
    from bee_code_interpreter_fs_tpu_torch.models.quant import quantized_nbytes
    from bee_code_interpreter_fs_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    cfg4 = dataclasses.replace(cfg, n_layers=4)
    model4 = layer_cut(params, 4)
    toks = torch.randint(0, cfg.vocab_size, (1, 128),
                         generator=torch.Generator().manual_seed(SEED + 11)).to(dev)
    bank = stack_loras(lora_adapters(torch, dev, cfg, 2))
    with torch.inference_mode(), tempfile.TemporaryDirectory() as tmp:
        for label, tree in (("bf16 4 layers", model4),
                            ("int8 4 layers", quantize_params(model4)),
                            (f"LoRA bank of 2, rank 16, {cfg.n_layers} layers", bank)):
            is_model = not isinstance(tree, dict)
            nbytes = (quantized_nbytes(tree) if is_model else
                      sum(t.numel() * t.element_size() for ab in tree["layers"].values()
                          for t in ab.values()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(Path(tmp) / "ckpt", tree)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = restore_checkpoint(Path(tmp) / "ckpt", like=tree)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            if is_model:
                equal = same_weights(back, tree)
                fwd_same = torch.equal(forward(back, toks, cfg4), forward(tree, toks, cfg4))
            else:
                equal = fwd_same = all(torch.equal(back["layers"][t][k], ab[k])
                                       for t, ab in tree["layers"].items() for k in ab)
            print(f"[path_f] checkpoint {label}: {nbytes / 2**30:.3f} GiB, save "
                  f"{nbytes / 2**30 / t_save:.2f} GiB/s ({t_save:.2f} s), restore onto the "
                  f"card {nbytes / 2**30 / t_load:.2f} GiB/s ({t_load:.2f} s); bit-equal: "
                  f"{equal}; forward bit-equal: {fwd_same}", flush=True)
            check(equal and fwd_same, f"checkpoint {label} round trip differs")
            del back
        del tree
    torch.cuda.empty_cache()


def run_path_f_rolling(torch, dev, params_window, cfg_window, gen) -> None:
    """The rolling cache at Llama-2-7B width with Mistral's window cut to
    256 and 4 sinks: a 384-token stream (the ring wraps 1.5 times), greedy
    over the ring, its teacher-forced logits against the windowed flash
    forward (K1, counted)."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        forward,
        init_cache,
        init_rolling_cache,
        rolling_decode_logits,
        rolling_greedy_generate,
    )
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_partial,
    )

    b, p_len, new = 2, 320, 64
    t = p_len + new
    prompts = torch.randint(0, cfg_window.vocab_size, (b, p_len), generator=gen, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        stream = rolling_greedy_generate(params_window, prompts, cfg_window,
                                         max_new_tokens=new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        logits = rolling_decode_logits(params_window, stream, cfg_window)
        greedy_same = torch.equal(stream[:, p_len:].long(),
                                  logits[:, p_len - 1:-1].argmax(-1))
        flash_cfg = dataclasses.replace(cfg_window, attn_impl="flash")
        flash_attention.launches = flash_attention_partial.launches = 0
        want = forward(params_window, stream, flash_cfg)
        torch.cuda.synchronize()
        k1, k2 = flash_attention.launches, flash_attention_partial.launches
        agree = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
        diff = (logits - want).abs().max().item()
        ring = sum(c.numel() * c.element_size()
                   for c in init_rolling_cache(cfg_window, b, device=dev).values())
        full = sum(c.numel() * c.element_size()
                   for c in init_cache(cfg_window, b, t, device=dev).values())
        del logits, want
    print(f"[path_f] rolling cache, Llama-2-7B bf16, window {cfg_window.sliding_window}, "
          f"{cfg_window.attention_sinks} sinks, b={b}: rolling_greedy_generate {p_len} + "
          f"{new} tokens in {gen_s:.2f} s ({gen_s * 1e3 / t:.2f} ms per step); its tokens "
          f"equal the argmax of rolling_decode_logits over the same stream: {greedy_same}; "
          f"rolling logits vs forward(attn_impl='flash') under the same window and sinks "
          f"({k1} K1, {k2} K2 launches): argmax agreement {agree:.4f} (>= 0.9), max |diff| "
          f"{diff:.3e}; ring cache {ring / 2**20:.1f} MiB vs init_cache at {t}: "
          f"{full / 2**20:.1f} MiB", flush=True)
    check(k1 == cfg_window.n_layers and k2 == 0,
          f"rolling oracle launched {k1} K1 / {k2} K2, expected {cfg_window.n_layers} / 0")
    check(greedy_same, "rolling greedy tokens differ from the ring's argmax")
    check(agree >= 0.9, f"rolling vs windowed flash argmax agreement {agree} < 0.9")


def run_path_f_f32(torch, dev, cfg) -> None:
    """The strict checks at full width, 4 layers, f32: multi-LoRA tokens
    equal greedy_generate over each merged adapter; beam 1 equals greedy;
    rolling logits within 1e-3 relative of the plain windowed forward."""
    from bee_code_interpreter_fs_tpu_torch.models import (
        ServingEngine,
        beam_generate,
        forward,
        greedy_generate,
        init_params,
        merge_lora,
        rolling_decode_logits,
    )

    cfg32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    params32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 12), dev)
    names = ("a", "b", "c")
    adapters = dict(zip(names, lora_adapters(torch, dev, cfg32, 3)))
    reqs = [(p[:96], min(n, 24), ad) for p, n, ad in lora_traffic(cfg.vocab_size, names)]
    with torch.inference_mode():
        eng = ServingEngine(params32, cfg32, n_slots=4, max_len=256, steps_per_sync=8,
                            adapters=adapters)
        rids = [eng.submit(p, n, adapter=ad) for p, n, ad in reqs]
        res = eng.run()
        mismatched = []
        for ad in (*names, None):
            model = params32 if ad is None else merge_lora(params32, adapters[ad])
            for k, (p, n, a) in enumerate(reqs):
                if a != ad:
                    continue
                want = greedy_generate(model, torch.tensor([p], device=dev), cfg32,
                                       max_new_tokens=n)[0, len(p):].cpu().numpy()
                if not np.array_equal(res[rids[k]], want):
                    mismatched.append(k)
            del model
        prompts = torch.randint(0, cfg.vocab_size, (2, 64),
                                generator=torch.Generator().manual_seed(SEED + 13)).to(dev)
        beam_same = torch.equal(
            beam_generate(params32, prompts, cfg32, max_new_tokens=32, beam_size=1),
            greedy_generate(params32, prompts, cfg32, max_new_tokens=32))
        wcfg = dataclasses.replace(cfg32, sliding_window=256, attention_sinks=4)
        stream = torch.randint(0, cfg.vocab_size, (2, 384),
                               generator=torch.Generator().manual_seed(SEED + 14)).to(dev)
        got = rolling_decode_logits(params32, stream, wcfg)
        want = forward(params32, stream, wcfg)
        rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[path_f] full width, 4 layers, f32: multi-LoRA engine tokens equal "
          f"greedy_generate over each merged adapter (and the base): {not mismatched} "
          f"(requests {mismatched} differ); beam 1 equals greedy_generate: {beam_same}; "
          f"rolling logits (window 256, 4 sinks, 384 tokens) vs the plain windowed "
          f"forward: relative error {rel:.3e} (<= 1e-3)", flush=True)
    check(not mismatched, f"f32 multi-LoRA tokens differ: {mismatched}")
    check(beam_same, "f32 beam 1 differs from greedy_generate")
    check(rel <= 1e-3, f"f32 rolling relative error {rel} > 1e-3")
    del params32, eng
    torch.cuda.empty_cache()


def run_path_c(torch, dev, record) -> None:
    """Llama-3-8B sequence-parallel forward on one card, then the strict f32
    check at full width and 4 layers."""
    from bee_code_interpreter_fs_tpu_torch.models import LlamaConfig, forward, init_params
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_partial,
    )
    from bee_code_interpreter_fs_tpu_torch.parallel import MeshSpec, make_mesh

    def reset():
        flash_attention.launches = 0
        flash_attention_partial.launches = 0

    mesh = make_mesh(MeshSpec((1, SP, 1, 1)), dev)
    base = LlamaConfig.llama3_8b()
    cfgs = {name: dataclasses.replace(base, sp_impl=sp_impl, attn_impl=attn)
            for name, sp_impl, attn in (("flash", "ring", "flash"),
                                        ("ring_flash", "ring", "flash"),
                                        ("ring_plain", "ring", "plain"),
                                        ("ulysses_flash", "ulysses", "flash"))}
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    params = init_params(base, gen, dev)
    torch.cuda.synchronize()
    print(f"[init] llama3_8b bf16 weights on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    b, t = 1, 8192
    tokens = torch.randint(0, base.vocab_size, (b, t), generator=gen, device=dev)
    # Each sp run: (mesh?, K2 launches, K1 launches) it must show.
    n_l = base.n_layers
    runs = (("ring_flash", n_l * SP * (SP + 1) // 2, 0),
            ("ring_plain", 0, 0),
            ("ulysses_flash", 0, n_l * SP))
    with torch.inference_mode():
        ref = forward(params, tokens, cfgs["flash"])  # no mesh: K1 per layer
        ref_arg = ref.argmax(-1)
        for name, want_k2, want_k1 in runs:
            cfg = cfgs[name]
            reset()
            logits = forward(params, tokens, cfg, mesh=mesh)
            torch.cuda.synchronize()
            k2, k1 = flash_attention_partial.launches, flash_attention.launches
            if name == "ring_flash":
                record["launches"] = k2
            check(k2 == want_k2 and k1 == want_k1,
                  f"path_c {name}: {k2} ring-step and {k1} flash launches, "
                  f"expected {want_k2} and {want_k1}")
            check(logits.shape == (b, t, base.vocab_size)
                  and logits.dtype == torch.float32, f"path_c {name} logits shape/dtype")
            check(bool(torch.isfinite(logits).all()), f"path_c {name} logits not finite")
            agree = (logits.argmax(-1) == ref_arg).float().mean().item()
            diff = (logits - ref).abs().max().item()
            del logits
            reps = 1 if name == "ring_plain" else 3
            fwd_ms = min(wall_ms(torch, lambda: forward(params, tokens, cfg, mesh=mesh))
                         for _ in range(reps))
            print(f"[path_c] llama3_8b bf16 b={b} t={t} sp={SP} {name}: {k2} "
                  f"ring-step and {k1} flash launches, logits finite, argmax "
                  f"agreement with the no-mesh flash forward {agree:.4f} "
                  f"(>= 0.9), max |diff| {diff:.3e} | forward {fwd_ms:.2f} ms, "
                  f"{b * t / fwd_ms * 1e3:.0f} tokens/s", flush=True)
            check(agree >= 0.9, f"path_c {name} argmax agreement {agree} < 0.9")
        del ref, ref_arg
        ref_ms = min(wall_ms(torch, lambda: forward(params, tokens, cfgs["flash"]))
                     for _ in range(3))
        print(f"[path_c] llama3_8b bf16 b={b} t={t} no-mesh flash forward "
              f"{ref_ms:.2f} ms, {b * t / ref_ms * 1e3:.0f} tokens/s", flush=True)
        print_profile(torch, "path_c ring+flash forward",
                      lambda: forward(params, tokens, cfgs["ring_flash"], mesh=mesh))
    del params
    torch.cuda.empty_cache()

    f32 = {name: dataclasses.replace(cfg, n_layers=4, dtype="float32")
           for name, cfg in cfgs.items()}
    params32 = init_params(f32["flash"], torch.Generator(device=dev).manual_seed(SEED + 3), dev)
    tokens32 = torch.randint(0, base.vocab_size, (1, 4096), generator=gen, device=dev)
    plain_nomesh = dataclasses.replace(f32["flash"], attn_impl="plain")
    with torch.inference_mode():
        for name, ref_cfg in (("ring_flash", f32["flash"]),
                              ("ulysses_flash", f32["flash"]),
                              ("ring_plain", plain_nomesh)):
            want = forward(params32, tokens32, ref_cfg)
            got = forward(params32, tokens32, f32[name], mesh=mesh)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            del want, got
            print(f"[path_c] full width, 4 layers, f32, t=4096 sp={SP}: {name} "
                  f"vs no-mesh {ref_cfg.attn_impl} relative error {rel:.3e} "
                  f"(<= 1e-3)", flush=True)
            check(rel <= 1e-3, f"f32 {name} relative error {rel} > 1e-3")
    del params32
    torch.cuda.empty_cache()


def time_partial(torch, dev, record) -> None:
    """K2 at path_c's two chunk-pair shapes, beside its bound, its plain
    version and SDPA on the same pair (a yardstick: no carry)."""
    import torch.nn.functional as F

    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention_partial,
        flash_attention_partial_reference,
        new_carry,
    )

    b, c, h, d = 1, 2048, 32, 128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((b, c, h, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mix = {"diagonal": DIAGONAL_PER_LAYER, "off_diagonal": OFF_DIAGONAL_PER_LAYER}
    totals = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "ops", "bytes"), 0.0)
    for label, q_off, k_off in (("diagonal", c, c), ("off_diagonal", 2 * c, 0)):
        diag = label == "diagonal"
        carry = new_carry(b, h, c, d, dev)
        kw = dict(q_offset=q_off, k_offset=k_off)
        kernel_ms = time_ms(torch, lambda: flash_attention_partial(q, k, v, *carry, **kw),
                            iters=50, reps=5)
        plain_ms = time_ms(
            torch, lambda: flash_attention_partial_reference(q, k, v, *carry, **kw),
            iters=5, warmup=1)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=diag),
            iters=50, reps=5)
        flops, nbytes = partial_work(b, c, c, h, d, 2, diag)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[timing] flash_attention_partial {label} b={b} chunk={c} h={h} "
              f"d={d} bf16: kernel {kernel_ms:.4f} ms "
              f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
              f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"plain {plain_ms:.3f} ms, sdpa {library_ms:.4f} ms", flush=True)
        w = mix[label]
        for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bound_ms),
                         ("ops", flops / PEAK_BF16_FLOPS), ("bytes", nbytes / PEAK_BYTES)):
            totals[key] += w * val
        del carry
    n = sum(mix.values())
    record.update(
        ms=totals["ms"] / n, plain_ms=totals["plain_ms"] / n,
        library_ms=totals["library_ms"] / n, bound_ms=totals["bound_ms"] / n,
        bound_by="operations" if totals["ops"] >= totals["bytes"] else "bytes",
    )
    print(f"[timing] flash_attention_partial per launch over path_c's mix "
          f"({DIAGONAL_PER_LAYER} diagonal + {OFF_DIAGONAL_PER_LAYER} "
          f"off-diagonal per layer): kernel {record['ms']:.4f} ms, bound "
          f"{record['bound_ms']:.4f} ms, plain {record['plain_ms']:.3f} ms, "
          f"sdpa {record['library_ms']:.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from bee_code_interpreter_fs_tpu_torch.models import (
        LlamaConfig,
        decode_step,
        forward,
        greedy_generate,
        init_cache,
        init_params,
        prefill,
    )
    from bee_code_interpreter_fs_tpu_torch.ops import _build
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_partial,
        flash_attention_reference,
    )

    dev = torch.device("cuda")
    card = card_line()
    def kernel_record(name, replaces):
        return {
            "name": name, "route": "cuda",
            "source": "bee_code_interpreter_fs_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"bee_code_interpreter_fs_tpu/ops/flash_attention.py:{replaces}",
            "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
        }

    record = kernel_record("flash_attention", 103)                 # K1
    record_k2 = kernel_record("flash_attention_partial", 193)      # K2

    def qkv(b, t, h, d, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((b, t, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype) for _ in range(3)]

    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_time(name):
        now = time.perf_counter()
        print(f"[time] {name} {now - t_phase[0]:.1f} s", flush=True)
        t_phase[0] = now

    if "env" in phases:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} | card {card} | devices "
              f"{torch.cuda.device_count()} | allow_tf32 matmul="
              f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
        phase_time("env")

    if "build" in phases:
        t0 = time.perf_counter()
        _build.build(_build.KERNEL_SOURCES)
        print(f"[build] ok {len(_build.KERNEL_SOURCES)} source(s) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        keep = ("entry function", "registers", "spill", "error", "warning",
                "wgmma", "setmaxnreg")
        cuobjdump = _build.cuda_tool("cuobjdump")
        for name in _build.KERNEL_SOURCES:
            for line in _build.build_logs.get(name, "").splitlines():
                if any(word in line for word in keep):
                    print(f"[build] {name}: {line.strip()}")
            if cuobjdump is None:
                print(f"[build] {name}: no cuobjdump in this toolkit, SASS not "
                      f"counted", flush=True)
                continue
            for kernel, ops in sass_counts(cuobjdump, _build.library_path(name)).items():
                if "bf16" in kernel:
                    print(f"[build] {name}: {kernel} SASS: "
                          + ", ".join(f"{op} {n}" for op, n in ops.items()), flush=True)
        phase_time("build")

    if "parity" in phases:
        cases = [
            # name, b, t, h, d, dtype, window, sinks, tolerance
            ("7b_shape_bf16", 2, 2048, 32, 128, torch.bfloat16, 0, 0, 2e-2),
            ("tail_t1000_bf16", 2, 1000, 32, 128, torch.bfloat16, 0, 0, 2e-2),
            ("window256_sinks4_d64_f32", 2, 2048, 8, 64, torch.float32, 256, 4, 1e-4),
            ("tail_t1000_d64_bf16_window", 1, 1000, 8, 64, torch.bfloat16, 100, 4, 2e-2),
            ("tail_t1000_d128_f32", 1, 1000, 8, 128, torch.float32, 0, 0, 1e-4),
            ("t40_bf16", 2, 40, 32, 128, torch.bfloat16, 0, 0, 2e-2),
            ("t40_d64_bf16", 2, 40, 8, 64, torch.bfloat16, 0, 0, 2e-2),
            ("t129_bf16", 2, 129, 32, 128, torch.bfloat16, 0, 0, 2e-2),
            ("t129_d64_bf16", 2, 129, 8, 64, torch.bfloat16, 0, 0, 2e-2),
            ("head_slice_view_8_16_bf16", 1, 1000, 32, 128, torch.bfloat16, 0, 0, 2e-2),
        ]
        for i, (name, b, t, h, d, dtype, window, sinks, tol) in enumerate(cases):
            q, k, v = qkv(b, t, h, d, dtype, SEED + i)
            if "view" in name:  # strided views into the 32 heads, no copy
                q, k, v = (x[:, :, 8:16] for x in (q, k, v))
            before = flash_attention.launches
            got = flash_attention(q, k, v, window=window, sinks=sinks)
            torch.cuda.synchronize()
            check(flash_attention.launches == before + 1,
                  f"{name}: kernel was not launched")
            want = flash_attention_reference(q, k, v, window=window, sinks=sinks)
            err = (got.float() - want.float()).abs().max().item()
            check(got.dtype == dtype and got.shape == q.shape,
                  f"{name}: got {got.dtype} {tuple(got.shape)}")
            print(f"[parity] {name}: max_abs_err {err:.3e} (tolerance {tol:g})",
                  flush=True)
            check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
            if i == 0:
                record["max_abs_err"] = err
            del q, k, v, got, want
        parity_partial(torch, dev, record_k2)
        phase_time("parity")

    params = None
    cfg = LlamaConfig.llama2_7b(attn_impl="flash")
    cfg_plain = dataclasses.replace(cfg, attn_impl="plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if {"path_a", "path_b", "quant", "path_d", "path_e", "path_f"} & set(phases):
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        torch.cuda.synchronize()
        print(f"[init] llama2_7b bf16 weights on the card in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        phase_time("init")

    if "path_a" in phases:
        b, t = 2, 2048
        tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
        with torch.inference_mode():
            flash_attention.launches = 0
            flash_attention_partial.launches = 0
            logits = forward(params, tokens, cfg)
            torch.cuda.synchronize()
            launches = flash_attention.launches
            record["launches"] = launches
            check(launches == cfg.n_layers and flash_attention_partial.launches == 0,
                  f"path A launched the kernel {launches} times (and the "
                  f"ring-step kernel {flash_attention_partial.launches}), "
                  f"expected {cfg.n_layers} (and 0)")
            check(logits.shape == (b, t, cfg.vocab_size)
                  and logits.dtype == torch.float32, "path A logits shape/dtype")
            check(bool(torch.isfinite(logits).all()), "path A logits not finite")
            plain = forward(params, tokens, cfg_plain)
            agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
            diff = (logits - plain).abs().max().item()
            del plain
            fwd_ms = min(wall_ms(torch, lambda: forward(params, tokens, cfg))
                         for _ in range(3))
            print(f"[path_a] llama2_7b bf16 b={b} t={t}: {launches} kernel "
                  f"launches, logits finite, argmax agreement flash/plain "
                  f"{agree:.4f} (>= 0.9; bf16 plain rounds its scores), "
                  f"max |flash-plain| {diff:.3e} | forward {fwd_ms:.2f} ms, "
                  f"{b * t / fwd_ms * 1e3:.0f} tokens/s", flush=True)
            check(agree >= 0.9, f"flash/plain argmax agreement {agree} < 0.9")
            del logits
            print_profile(torch, "path_a forward", lambda: forward(params, tokens, cfg))

            cfg32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
            params32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(SEED + 1), dev)
            tokens32 = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen, device=dev)
            flash32 = forward(params32, tokens32, cfg32)
            plain32 = forward(params32, tokens32,
                              dataclasses.replace(cfg32, attn_impl="plain"))
            rel = ((flash32 - plain32).abs().max() / plain32.abs().max()).item()
            print(f"[path_a] full width, 4 layers, f32, b=2 t=1024: flash vs "
                  f"plain relative error {rel:.3e} (<= 1e-3)", flush=True)
            check(rel <= 1e-3, f"f32 flash vs plain relative error {rel} > 1e-3")
            del params32, flash32, plain32
        phase_time("path_a")

    if "path_b" in phases:
        b, p_len, new = 4, 128, 32
        prompts = torch.randint(0, cfg.vocab_size, (b, p_len), generator=gen,
                                device=dev, dtype=torch.int32)
        with torch.inference_mode():
            flash_attention.launches = 0
            out = greedy_generate(params, prompts, cfg_plain, max_new_tokens=new)
            torch.cuda.synchronize()
            check(out.shape == (b, p_len + new) and out.dtype == torch.int32,
                  f"path B output {tuple(out.shape)} {out.dtype}")
            check(bool((out[:, :p_len] == prompts).all()), "path B prompt changed")
            check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                  "path B token out of range")
            first = forward(params, prompts, cfg_plain)[:, -1].argmax(-1)
            check(bool((out[:, p_len] == first.to(torch.int32)).all()),
                  f"path B first token {out[:, p_len].tolist()} != forward "
                  f"argmax {first.tolist()}")
            cache = init_cache(cfg, b, p_len + new, device=dev)
            prefill_ms = min(wall_ms(torch, lambda: prefill(params, prompts, cache, cfg_plain))
                             for _ in range(3))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(new - 1):
                _, cache = decode_step(params, out[:, p_len + i:p_len + i + 1],
                                       cache, p_len + i, cfg_plain)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / (new - 1)
            print_profile(torch, "path_b 4 decode steps", lambda: [
                decode_step(params, out[:, p_len + i:p_len + i + 1], cache,
                            p_len + i, cfg_plain) for i in range(4)])
            del cache
            print(f"[path_b] greedy_generate llama2_7b bf16 {b} prompts x "
                  f"{p_len} tokens, {new} new: first token matches forward; "
                  f"prefill {prefill_ms:.2f} ms, decode {step_ms:.2f} ms/step, "
                  f"{b / step_ms * 1e3:.1f} tokens/s", flush=True)
        phase_time("path_b")

    if "quant" in phases:
        run_quant(torch, dev, params, cfg_plain, gen)
        phase_time("quant")

    figures: dict = {}
    if "path_d" in phases:
        run_path_d(torch, dev, params, cfg_plain, figures)
        phase_time("path_d")

    if "path_e" in phases:
        run_path_e(torch, dev, params, cfg_plain)
        phase_time("path_e")

    if "path_f" in phases:
        run_path_f(torch, dev, params, cfg_plain, figures)
        phase_time("path_f")

    params = None  # path_c needs the room
    torch.cuda.empty_cache()
    if "path_c" in phases:
        run_path_c(torch, dev, record_k2)
        phase_time("path_c")

    if "timing" in phases:
        record.update(time_flash(torch, dev, 2, 2048, 32, 128, "path_a"))
        time_flash(torch, dev, 1, 8192, 32, 128, "path_c no-mesh", plain_iters=1)
        time_flash(torch, dev, 1, 8192, 8, 128, "path_c Ulysses", plain_iters=1)
        time_partial(torch, dev, record_k2)
        phase_time("timing")

    print(f"[done] phases {','.join(phases)} in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if set(phases) != set(ALL_PHASES):
        return 0
    print(json.dumps({"kernels": [record, record_k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": CARDS_USED}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
