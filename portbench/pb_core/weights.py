"""Seeded weights, made on the device in a few large calls.

Every layer's matmul weights are one flat buffer in the served dtype,
filled by one ``normal_`` call from a generator seeded by (run seed,
layer), then scaled by fan_in**-0.5 in two slices. The head and the
embedding are two more buffers. The same function hands the program its
tensors (``program.py`` loads them into the port's module as views) and
the reference its own copy, layer by layer, so the reference never reads
anything the program made.

Norm weights are ones (f32), as the published initialisation has them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of one run (splitmix64 of
    the pair), so that seeds past 32 bits and nearby seeds stay apart."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(stream) + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


@dataclass(frozen=True)
class Shapes:
    """The matmul leaves of one layer, in buffer order, as [in, out]
    (experts leading for the MoE MLP), with each one's fan-in."""

    dim: int
    hidden: int
    n_heads: int
    n_kv_heads: int
    n_experts: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def layer(self) -> list[tuple[str, tuple[int, ...], int]]:
        d, hd = self.dim, self.head_dim
        q, kv = self.n_heads * hd, self.n_kv_heads * hd
        lead = (self.n_experts,) if self.n_experts else ()
        leaves = [("wq", (d, q), d), ("wk", (d, kv), d), ("wv", (d, kv), d),
                  ("wo", (q, d), q)]
        if self.n_experts:
            leaves.append(("router", (d, self.n_experts), d))
        leaves += [("w_gate", lead + (d, self.hidden), d),
                   ("w_up", lead + (d, self.hidden), d),
                   ("w_down", lead + (self.hidden, d), self.hidden)]
        return leaves


def shapes_of(conf: dict) -> Shapes:
    """Shapes from a configuration file's published keys."""
    return Shapes(conf["hidden_size"], conf["intermediate_size"],
                  conf["num_attention_heads"], conf["num_key_value_heads"],
                  int(conf.get("num_local_experts") or 0))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _filled(n: int, seed: int, stream: int, dtype, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    buf = torch.empty(n, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    return buf


def layer_buffer(shapes: Shapes, seed: int, layer: int, dtype, device):
    """Layer `layer`'s matmul weights: {name: view of one flat buffer}."""
    leaves = shapes.layer()
    buf = _filled(sum(_numel(s) for _, s, _ in leaves), seed, layer, dtype, device)
    out, off = {}, 0
    # Runs of equal fan-in are scaled in one call each.
    run_start, run_fan = 0, None
    for name, shape, fan in leaves:
        if fan != run_fan:
            if run_fan is not None:
                buf[run_start:off].mul_(run_fan ** -0.5)
            run_start, run_fan = off, fan
        n = _numel(shape)
        out[name] = buf[off:off + n].view(shape)
        off += n
    buf[run_start:off].mul_(run_fan ** -0.5)
    return out


def head_buffer(shapes: Shapes, vocab: int, n_layers: int, seed: int, dtype,
                device) -> torch.Tensor:
    """The output head [dim, vocab], scaled by dim**-0.5."""
    buf = _filled(shapes.dim * vocab, seed, n_layers, dtype, device)
    return buf.mul_(shapes.dim ** -0.5).view(shapes.dim, vocab)


def embed_buffer(shapes: Shapes, vocab: int, n_layers: int, seed: int, dtype,
                 device) -> torch.Tensor:
    """The embedding [vocab, dim], unit normal."""
    return _filled(vocab * shapes.dim, seed, n_layers + 1, dtype, device).view(
        vocab, shapes.dim)
