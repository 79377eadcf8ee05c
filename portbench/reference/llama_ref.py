"""Plain float32 forward pass of Mistral-7B and Mixtral-8x7B, written from
the published equations.

- x = embed[tokens]; per layer: h = rmsnorm(x) * g_attn; q, k, v = h Wq,
  h Wk, h Wv (grouped: query head i reads kv head i // (n_heads /
  n_kv_heads)); rotary embedding on adjacent lane pairs (2i, 2i+1) at
  frequency theta**(-2i/d); causal softmax(q k^T / sqrt(d)) v, where with
  a sliding window W a query at p sees keys p-W+1..p; x += attn Wo.
- MLP: h = rmsnorm(x) * g_mlp; dense: (silu(h Wg) * h Wu) Wd. Mixture of
  experts (Mixtral): router probabilities softmax(h Wr), the top k kept and
  renormalized to sum to 1, each token's output the weighted sum of its k
  experts' (silu(h Wg_e) * h Wu_e) Wd_e; x += mlp.
- logits = rmsnorm(x) * g_final Whead.

Everything runs in float32 with TF32 off, layer by layer over all the
sequences at once, attention in blocks of queries, so that it fits beside
nothing else on the card. Weights come from ``pb_core.weights``, drawn
again from the run's seed: the reference takes nothing the program made.
It imports neither JAX nor anything of the port.
"""

from __future__ import annotations

import contextlib
import math

import torch

from pb_core import weights as W

Q_BLOCK = 1024
ROW_BLOCK = 2048
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per slice along `dim`
    (its amax onto 448), back in float32: the precision step below bf16
    that the check's control computes its matmuls in."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls in full precision (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Reference:
    """The plain model for one configuration file and one run seed."""

    def __init__(self, conf: dict, seed: int, device, *, weight_dtype=torch.bfloat16,
                 matmul_fp8: bool = False):
        self.conf = conf
        self.seed = int(seed)
        self.device = torch.device(device)
        self.shapes = W.shapes_of(conf)
        self.n_layers = int(conf["num_hidden_layers"])
        self.vocab = int(conf["vocab_size"])
        self.eps = float(conf["rms_norm_eps"])
        self.theta = float(conf["rope_theta"])
        self.window = int(conf.get("sliding_window") or 0)
        self.top_k = int(conf.get("num_experts_per_tok") or 0)
        self.weight_dtype = weight_dtype
        # The control: every matmul's operands rounded through float8 e4m3
        # (weights per output column, activations per row).
        self.matmul_fp8 = matmul_fp8

    def _mm(self, x, w):
        if self.matmul_fp8:
            return fp8(x, -1) @ fp8(w, -2)
        return x @ w

    # -------------------------------------------------------------- weights

    def layer_weights(self, i: int) -> dict:
        bufs = W.layer_buffer(self.shapes, self.seed, i, self.weight_dtype, self.device)
        return {k: v.float() for k, v in bufs.items()}

    def head(self) -> torch.Tensor:
        return W.head_buffer(self.shapes, self.vocab, self.n_layers, self.seed,
                             self.weight_dtype, self.device).float()

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        table = W.embed_buffer(self.shapes, self.vocab, self.n_layers, self.seed,
                               self.weight_dtype, self.device)
        return table[tokens.to(self.device)].float()

    # -------------------------------------------------------------- pieces

    def _norm(self, x):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps)

    def _rope(self, x):
        """x [t, heads, d] at positions 0..t-1, adjacent lane pairs."""
        t, _, d = x.shape
        inv = self.theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                           device=x.device) / d)
        ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)

    def _attention(self, q, k, v):
        """q [t, nh, d], k/v [t, nkv, d] -> [t, nh * d], causal, windowed."""
        t, nh, d = q.shape
        rep = nh // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [nh, t, d]
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        qh = q.transpose(0, 1)
        out = torch.empty_like(qh)
        scale = 1.0 / math.sqrt(d)
        for q0 in range(0, t, Q_BLOCK):
            q1 = min(q0 + Q_BLOCK, t)
            k0 = max(0, q0 - self.window + 1) if self.window else 0
            s = torch.matmul(qh[:, q0:q1], k[:, k0:q1].transpose(1, 2)) * scale
            qp = torch.arange(q0, q1, device=q.device)[:, None]
            kp = torch.arange(k0, q1, device=q.device)[None, :]
            visible = kp <= qp
            if self.window:
                visible &= kp > qp - self.window
            s = s.masked_fill(~visible, float("-inf"))
            out[:, q0:q1] = torch.matmul(torch.softmax(s, dim=-1), v[:, k0:q1])
        return out.transpose(0, 1).reshape(t, nh * d)

    def _mlp(self, h, w, margin=None):
        mm = self._mm
        if "router" not in w:
            return mm(torch.nn.functional.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
        logits = mm(h, w["router"])
        if margin is not None:
            ranked = logits.topk(self.top_k + 1, dim=-1).values
            torch.minimum(margin, ranked[:, -2] - ranked[:, -1], out=margin)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = probs.topk(self.top_k, dim=-1)
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(w["router"].shape[1]):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            he = h[rows]
            ye = mm(torch.nn.functional.silu(mm(he, w["w_gate"][e])) * mm(he, w["w_up"][e]),
                    w["w_down"][e])
            out.index_add_(0, rows, ye * top_p[rows, slot][:, None])
        return out

    def _layer(self, x, w, margin=None):
        sh = self.shapes
        t = x.shape[0]
        h = self._norm(x)  # norm weights are ones
        q = self._mm(h, w["wq"]).view(t, sh.n_heads, sh.head_dim)
        k = self._mm(h, w["wk"]).view(t, sh.n_kv_heads, sh.head_dim)
        v = self._mm(h, w["wv"]).view(t, sh.n_kv_heads, sh.head_dim)
        x = x + self._mm(self._attention(self._rope(q), self._rope(k), v), w["wo"])
        return x + self._mlp(self._norm(x), w, margin)

    # -------------------------------------------------------------- entry

    @torch.no_grad()
    def final_hidden(self, sequences, router_margins=None) -> list:
        """Normed final hidden states [t, dim] f32 of each token sequence
        (1-D int tensors), computed layer by layer over all of them. For a
        mixture of experts, a list passed as `router_margins` receives per
        sequence each token's smallest margin over the layers between its
        k-th and (k+1)-th router logit (how near its routing came to a
        tie)."""
        with exact_f32():
            xs = [self.embed(s) for s in sequences]
            margins = [torch.full((x.shape[0],), float("inf"), device=x.device)
                       for x in xs] if self.top_k else [None] * len(xs)
            for i in range(self.n_layers):
                w = self.layer_weights(i)
                xs = [self._layer(x, w, m) for x, m in zip(xs, margins)]
                del w
            if router_margins is not None and self.top_k:
                router_margins.extend(margins)
            return [self._norm(x) for x in xs]

    @torch.no_grad()
    def logits_rows(self, hidden: torch.Tensor, rows: torch.Tensor, head=None):
        """f32 logits [len(rows), vocab] of the given rows of `hidden`."""
        head = self.head() if head is None else head
        with exact_f32():
            out = [self._mm(hidden[rows[r:r + ROW_BLOCK]], head)
                   for r in range(0, rows.numel(), ROW_BLOCK)]
        return torch.cat(out) if out else hidden.new_zeros((0, head.shape[1]))
