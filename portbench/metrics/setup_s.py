"""setup_s: process start to the window's opening (import, CUDA init,
weights made on the card, the K1 library loaded or built, and warm-up)."""


def read(rec, ctx):
    return rec.get("setup_s")
