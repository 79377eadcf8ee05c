"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet
for the H100 SXM, dense rates without sparsity, at the full 700 W power
limit). A card set below 700 W runs slower under load: every run prints
its card's power limit beside these."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The peaks of a card by its torch.cuda.get_device_name(). A card not
    in the table has no peaks here: its shares of a peak would be wrong."""
    if kind not in PEAKS:
        raise ValueError(f"no published peaks for {kind!r}: add the card to "
                         "roofline/peaks.py")
    return PEAKS[kind]
