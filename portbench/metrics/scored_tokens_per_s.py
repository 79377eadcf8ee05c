"""scored_tokens_per_s: next-token log-probs produced by the documents
completed in the window, over the window's seconds (first dispatch to
the last completion)."""


def read(rec, ctx):
    if "scored_tokens" not in rec or not rec["window_s"]:
        return None
    return rec["scored_tokens"] / rec["window_s"]
