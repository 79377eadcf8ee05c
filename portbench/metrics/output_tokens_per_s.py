"""output_tokens_per_s: generated tokens delivered to the clients in the
window, over the window's seconds (between two scheduler-step ends)."""


def read(rec, ctx):
    if "output_tokens" not in rec or not rec["window_s"]:
        return None
    return rec["output_tokens"] / rec["window_s"]
