"""Closed loop, one client: score documents with the port's
``models.llama.forward`` (K1 does the attention under ``attn_impl="flash"``).

Each step is one document (b = 1); the output is the log-probs of the
document's own next tokens. The next forward is dispatched before the
previous one's result is read: each result goes to pinned host memory
behind a CUDA event, and the host waits on that event only after queueing
the next document.

Record: window seconds, tokens scored in it, documents completed, and
(traced) the K1 launches of a profiled stretch after the window.
"""

from __future__ import annotations

import gc
import time

from pb_core import check, traffic
from pb_core.program import build_params
from reference.llama_ref import Reference
from roofline import model as model_flops


def _score(torch, forward, params, cfg, tokens):
    """Dispatch one document's forward and its log-probs, copied to pinned
    host memory behind an event; returns (host buffer, event)."""
    logits = forward(params, tokens[None], cfg)[0]
    lp = torch.log_softmax(logits[:-1], dim=-1).gather(1, tokens[1:, None])[:, 0]
    del logits
    host = torch.empty(lp.shape, dtype=lp.dtype, pin_memory=lp.is_cuda)
    host.copy_(lp, non_blocking=True)
    ev = torch.cuda.Event() if lp.is_cuda else None
    if ev is not None:
        ev.record()
    return host, ev


def run(ctx) -> dict:
    torch, dev, mix, conf = ctx.torch, ctx.device, ctx.mix, ctx.conf
    from bee_code_interpreter_fs_tpu_torch.models import llama
    from bee_code_interpreter_fs_tpu_torch.ops.flash_attention import flash_attention

    cfg = ctx.cfg
    params = build_params(conf, ctx.seed, dev, cfg)
    params = ctx.program_variant(params)
    n_docs = int(mix["documents_per_run"])
    docs = traffic.documents(mix, ctx.seed, n_docs, cfg.vocab_size)
    # Every document on the device before the window: an upload from
    # pageable memory would synchronize the stream.
    on_dev = [torch.as_tensor(d, device=dev) for d in docs]
    forward = llama.forward

    def wait(ev):
        if ev is not None:
            ev.synchronize()

    with torch.inference_mode():
        # Warm-up at the mix's own warm-up lengths, one in each stratum
        # and the longest last. The port compiles nothing per length (eager
        # PyTorch, K1 built ahead by nvcc), but cuBLAS picks its kernels by
        # the row count and loads each on first use: with only the range's
        # two ends warmed, a checkout's first run lost 12 % of its window.
        # The window's jittered lengths are not these.
        warm = traffic.rng_for(ctx.seed, "warm")
        for t in mix["warm_up_tokens"]:
            doc = torch.as_tensor(warm.integers(0, cfg.vocab_size, size=int(t)), device=dev)
            wait(_score(torch, forward, params, cfg, doc)[1])
        ctx.setup_done()

        done_lp, done_at, launches0 = [], [], flash_attention.launches
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        pending = _score(torch, forward, params, cfg, on_dev[0])
        i = 1
        while True:
            nxt = None
            if time.perf_counter() < deadline:
                if i >= n_docs:
                    raise RuntimeError(f"documents_per_run ({n_docs}) ran out "
                                       "before the window closed")
                nxt = _score(torch, forward, params, cfg, on_dev[i])
                i += 1
            wait(pending[1])
            done_at.append(time.perf_counter())
            done_lp.append(pending[0].numpy())
            if nxt is None:
                break
            pending = nxt
        t1 = done_at[-1]
        k1_window = flash_attention.launches - launches0
        n_done = len(done_lp)

        slice_docs = []
        if ctx.tracer.enabled:
            # A steady stretch after the window: the same loop over the
            # next documents, profiled.
            n_slice = int(mix.get("trace_documents", 3))
            slice_docs = list(range(n_done, n_done + n_slice))
            with ctx.tracer.slice({"k1": r"flash_fwd_(bf16|f32)<.*false>"}):
                pend = None
                for j in slice_docs:
                    with ctx.tracer.label("portbench.dispatch"):
                        cur = _score(torch, forward, params, cfg, on_dev[j])
                    if pend is not None:
                        with ctx.tracer.label("portbench.wait"):
                            wait(pend[1])
                    pend = cur
                with ctx.tracer.label("portbench.wait"):
                    wait(pend[1])

    ctx.read_memory()
    del params, forward, on_dev
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    window_s = t1 - t0
    lengths = [docs[j].size for j in range(n_done)]
    rec = {
        "window_s": window_s,
        "attempted": n_done,
        "failed": 0,
        "scored_tokens": sum(t - 1 for t in lengths),
        "model_flops": sum(model_flops.score_flops(conf, t) for t in lengths),
        "k1_launches_window": k1_window,
    }
    if slice_docs:
        rec["k1_slice_launches"] = [
            (1, docs[j].size, cfg.n_heads, cfg.head_dim, 2 if cfg.dtype == "bfloat16" else 4,
             cfg.sliding_window, cfg.attention_sinks)
            for j in slice_docs for _ in range(cfg.n_layers)]

    picks = check.sample(lengths, int(mix["check"]["documents"]), ctx.seed, lambda t: t)
    ref = Reference(conf, ctx.seed, dev)
    ctx.reference_started()
    control = (Reference(conf, ctx.seed, dev, matmul_fp8=True) if ctx.fp8_control else None)
    numbers = check.score_gaps(ref, [docs[j] for j in picks], [done_lp[j] for j in picks],
                               control)
    numbers["documents_compared"] = len(picks)
    rec["numbers"] = numbers
    return rec
