#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bee_code_interpreter_fs_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases env,build,parity

Phases, one line each; any failure exits non-zero:
  env     torch/CUDA versions, the card's name and power limit, TF32 off.
  build   nvcc of every kernel source under the package's csrc/ (parallel).
  parity  each kernel against its plain PyTorch version on the card.
  path_a  Llama-2-7B forward (bf16, b=2, t=2048, random seeded weights)
          through the flash kernel: 32 launches, finite logits, argmax
          agreement with plain attention; a torch.profiler table of device
          time by kernel; then full width, 4 layers, f32: flash vs plain
          within 1e-3 relative.
  path_b  greedy_generate on the same weights, 4 prompts x 128 tokens,
          32 new tokens; the first new token equals forward's argmax; a
          profiler table of four decode steps.
  timing  each kernel at path A's shapes beside its bound, its plain
          version and one PyTorch library call (a yardstick only).

The last lines are a JSON object of per-kernel numbers, the card's name and
power limit as nvidia-smi prints them, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ALL_PHASES = ("env", "build", "parity", "path_a", "path_b", "timing")
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
SEED = 0


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


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one fn() call, from CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def print_profile(torch, label: str, fn) -> None:
    """Device time by kernel for one fn() call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # Kernels only: operator rows repeat their kernels' device time.
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[profile] {label}: wall {wall:.2f} ms (profiled), kernel time "
          f"{device_us / 1e3:.2f} ms")
    print(events.table(sort_by="self_device_time_total", row_limit=12))


def causal_pairs(t: int, window: int = 0, sinks: int = 0) -> int:
    """(query, key) pairs the mask leaves visible."""
    total = 0
    for q in range(t):
        lo = max(q - window + 1, 0) if window > 0 else 0
        total += q - lo + 1 + (min(sinks, lo) if window > 0 else 0)
    return total


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
    import torch.nn.functional as F

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
        flash_attention_reference,
    )

    dev = torch.device("cuda")
    card = card_line()
    record = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "bee_code_interpreter_fs_tpu_torch/csrc/flash_attention.cu",
        "replaces": "bee_code_interpreter_fs_tpu/ops/flash_attention.py:103",
        "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": None, "library_ms": None,
    }

    def qkv(b, t, h, d, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((b, t, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype) for _ in range(3)]

    t_start = time.perf_counter()
    if "env" in phases:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} | card {card} | devices "
              f"{torch.cuda.device_count()} | allow_tf32 matmul="
              f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
              f"{torch.backends.cudnn.allow_tf32}", flush=True)

    if "build" in phases:
        t0 = time.perf_counter()
        _build.build(_build.KERNEL_SOURCES)
        for name in _build.KERNEL_SOURCES:
            for line in _build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"[build] {name}: {line.strip()}")
        print(f"[build] ok {len(_build.KERNEL_SOURCES)} source(s) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    if "parity" in phases:
        cases = [
            # name, b, t, h, d, dtype, window, sinks, tolerance
            ("7b_shape_bf16", 2, 2048, 32, 128, torch.bfloat16, 0, 0, 2e-2),
            ("tail_t1000_bf16", 2, 1000, 32, 128, torch.bfloat16, 0, 0, 2e-2),
            ("window256_sinks4_d64_f32", 2, 2048, 8, 64, torch.float32, 256, 4, 1e-4),
            ("tail_t1000_d64_bf16_window", 1, 1000, 8, 64, torch.bfloat16, 100, 4, 2e-2),
            ("tail_t1000_d128_f32", 1, 1000, 8, 128, torch.float32, 0, 0, 1e-4),
        ]
        for i, (name, b, t, h, d, dtype, window, sinks, tol) in enumerate(cases):
            q, k, v = qkv(b, t, h, d, dtype, SEED + i)
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

    params = None
    cfg = LlamaConfig.llama2_7b(attn_impl="flash")
    cfg_plain = dataclasses.replace(cfg, attn_impl="plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if "path_a" in phases or "path_b" in phases:
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        torch.cuda.synchronize()
        print(f"[init] llama2_7b bf16 weights on the card in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)

    if "path_a" in phases:
        b, t = 2, 2048
        tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
        with torch.inference_mode():
            flash_attention.launches = 0
            logits = forward(params, tokens, cfg)
            torch.cuda.synchronize()
            launches = flash_attention.launches
            record["launches"] = launches
            check(launches == cfg.n_layers,
                  f"path A launched the kernel {launches} times, "
                  f"expected {cfg.n_layers}")
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

    if "timing" in phases:
        b, t, h, d = 2, 2048, 32, 128
        q, k, v = qkv(b, t, h, d, torch.bfloat16, SEED)
        kernel_ms = time_ms(torch, lambda: flash_attention(q, k, v), iters=50)
        plain_ms = time_ms(torch, lambda: flash_attention_reference(q, k, v),
                           iters=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            iters=50)
        flops = 4 * b * h * d * causal_pairs(t)
        nbytes = 4 * q.numel() * q.element_size()
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        record.update(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )
        print(f"[timing] flash_attention b={b} t={t} h={h} d={d} bf16 causal: "
              f"kernel {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} TFLOP/s), "
              f"bound {record['bound_ms']:.4f} ms ({record['bound_by']}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
              f"plain {plain_ms:.3f} ms, sdpa {library_ms:.4f} ms", flush=True)

    print(f"[done] phases {','.join(phases)} in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if set(phases) != set(ALL_PHASES):
        return 0
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
