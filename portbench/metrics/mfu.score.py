"""mfu.score: the model FLOPs of the window's work (roofline/model.py; for a
mixture of experts only the top-k experts each token needs) over the
card's bf16 peak times the window's seconds, in %."""

from roofline.peaks import peaks


def read(rec, ctx):
    if ctx.device.type != "cuda" or not rec.get("model_flops") or not rec.get("window_s"):
        return None  # a CPU run has no peak to share
    kind = ctx.torch.cuda.get_device_name(ctx.device)
    return 100.0 * rec["model_flops"] / (peaks(kind)["bf16_flops"] * rec["window_s"])
