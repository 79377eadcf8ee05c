"""The port's lockstep speculative decoding (models/llama.py:
speculative_generate, speculative_sample_generate, uniform_noise) against
the JAX package's.

Fixture: the JAX spec tests' tiny f32 target (2 layers, dim 64, 4 q / 2 kv
heads, vocab 97, seed 0) and a different, smaller draft (1 layer, dim 32,
seed 3), converted to the port: partial agreement, so passes accept
anywhere from 0 to gamma proposals.

- Greedy: tokens equal to JAX's speculative_generate and to the port's
  greedy_generate.
- Sampled: the port's stream is not jax.random's, so the tokens are held
  to the algorithm: a chi-square test of the emitted marginals against the
  target's exact softmax marginals, seed reproducibility, and the stream's
  sites.
- The cache slack: max_len at exactly prompt + new + gamma + 1 runs,
  one less raises (the port's writes raise where JAX's would clamp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402

TARGET = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
              vocab_size=97, max_seq_len=128, dtype="float32")
DRAFT = dict(TARGET, n_layers=1, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=2)
# tests/unit/test_spec_serving.py's distribution setting: vocab 23, 1 layer.
DIST_TARGET = dict(n_layers=1, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=2,
                   vocab_size=23, max_seq_len=32, dtype="float32")
DIST_DRAFT = dict(DIST_TARGET, dim=16, hidden_dim=32)
# Chi-square critical value at p = 0.001 for 22 degrees of freedom.
CHI2_22_P001 = 48.27


def _pair(target, draft, t_seed=0, d_seed=3):
    out = []
    for fields, seed in ((target, t_seed), (draft, d_seed)):
        jcfg = jl.LlamaConfig.tiny(**fields)
        tcfg = LlamaConfig.tiny(**fields)
        jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
        out.append((jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                               device="cpu"), tcfg))
    return out


@pytest.fixture(scope="module")
def models():
    return _pair(TARGET, DRAFT)


def _prompts(b=3, p=5, seed=4, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(np.int32)


def test_greedy_tokens_equal_jax_and_greedy_generate(models):
    (jt, jtc, tt, ttc), (jd, jdc, td, tdc) = models
    prompts = _prompts()
    want = np.asarray(jl.speculative_generate(jd, jt, jnp.asarray(prompts), jdc, jtc,
                                              max_new_tokens=24, gamma=4))
    got = tl.speculative_generate(td, tt, torch.from_numpy(prompts), tdc, ttc,
                                  max_new_tokens=24, gamma=4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 29)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tl.greedy_generate(tt, torch.from_numpy(prompts), ttc, max_new_tokens=24)
    assert torch.equal(got, plain)
    # The perfect draft (the target itself) accepts everything: still exact.
    perfect = tl.speculative_generate(tt, tt, torch.from_numpy(prompts), ttc, ttc,
                                      max_new_tokens=24, gamma=3)
    assert torch.equal(perfect, plain)


def test_cache_slack_edge(models):
    """gamma = 4 with max_len exactly prompt + new + gamma + 1: every write
    of every pass lands in range; one position less is refused up front."""
    (_, _, tt, ttc), (_, _, td, tdc) = models
    prompts = torch.from_numpy(_prompts(b=2, p=6))
    plain = tl.greedy_generate(tt, prompts, ttc, max_new_tokens=13)
    for draft, dcfg in ((td, tdc), (tt, ttc)):
        got = tl.speculative_generate(draft, tt, prompts, dcfg, ttc, max_new_tokens=13,
                                      gamma=4, max_len=6 + 13 + 4 + 1)
        assert torch.equal(got, plain)
        sampled = tl.speculative_sample_generate(
            draft, tt, prompts, 3, dcfg, ttc, max_new_tokens=13, gamma=4,
            temperature=0.9, max_len=6 + 13 + 4 + 1)
        assert tuple(sampled.shape) == (2, 19)
    with pytest.raises(ValueError, match="prompt\\+new\\+gamma\\+1"):
        tl.speculative_generate(td, tt, prompts, tdc, ttc, max_new_tokens=13, gamma=4,
                                max_len=6 + 13 + 4)


def test_validation(models):
    (_, _, tt, ttc), (_, _, td, tdc) = models
    prompts = torch.from_numpy(_prompts())
    with pytest.raises(ValueError, match="gamma must be >= 1.*greedy_generate"):
        tl.speculative_generate(td, tt, prompts, tdc, ttc, max_new_tokens=4, gamma=0)
    with pytest.raises(ValueError, match="gamma must be >= 1.*sample_generate"):
        tl.speculative_sample_generate(td, tt, prompts, 0, tdc, ttc, max_new_tokens=4,
                                       gamma=0)
    with pytest.raises(ValueError, match="vocabulary"):
        tl.speculative_generate(td, tt, prompts, LlamaConfig.tiny(vocab_size=11), ttc,
                                max_new_tokens=4)


def test_uniform_noise_is_the_gumbel_stream():
    keys = torch.tensor([tl.stream_key(5, r) for r in range(3)])
    pos = torch.tensor([0, 7, 2 ** 31])
    u = tl.uniform_noise(keys, pos, 50)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    assert torch.equal(tl.gumbel_noise(keys, pos, 50), -torch.log(-torch.log(u)))
    # The three draw sites are independent streams at one position.
    sites = [tl.uniform_noise(tl.fold_key(keys, tag), pos, 50) for tag in (1, 2, 3)]
    assert not any(torch.equal(a, b) for a in sites + [u] for b in sites if a is not b)


def test_sampled_is_seed_reproducible(models):
    (_, _, tt, ttc), (_, _, td, tdc) = models
    prompts = torch.from_numpy(_prompts())
    kw = dict(max_new_tokens=16, gamma=3, temperature=1.1)
    a = tl.speculative_sample_generate(td, tt, prompts, 7, tdc, ttc, **kw)
    b = tl.speculative_sample_generate(td, tt, prompts, 7, tdc, ttc, **kw)
    c = tl.speculative_sample_generate(td, tt, prompts, 8, tdc, ttc, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :5], prompts) and bool(((a >= 0) & (a < 97)).all())
    # Temperature -> 0 is greedy decoding of the target.
    cold = tl.speculative_sample_generate(td, tt, prompts, 7, tdc, ttc, max_new_tokens=16,
                                          gamma=3, temperature=0.0)
    assert torch.equal(cold, tl.greedy_generate(tt, prompts, ttc, max_new_tokens=16))


def test_sampled_marginals_pass_chi_square():
    """2048 seeded generations of 3 tokens after a fixed prompt, four rows a
    batch (so passes accept 0..gamma and lockstep cuts them): the emitted
    tokens at the second and third new positions follow the target's exact
    softmax marginals (computed by summing over every earlier token)."""
    (_, _, tt, ttc), (_, _, td, tdc) = _pair(DIST_TARGET, DIST_DRAFT, 0, 5)
    V, N, rows, prompt = 23, 2048, 4, [3, 9]
    outs = []
    for seed in range(N // rows):
        out = tl.speculative_sample_generate(
            td, tt, torch.tensor([prompt] * rows), seed, tdc, ttc,
            max_new_tokens=3, gamma=2, temperature=1.0)
        outs.append(out[:, 2:].numpy())
    toks = np.concatenate(outs)  # [N, 3]
    with torch.inference_mode():
        p0 = torch.softmax(tl.forward(tt, torch.tensor([prompt]), ttc)[0, -1], -1)
        ctx1 = torch.tensor([prompt + [a] for a in range(V)])
        p1 = torch.softmax(tl.forward(tt, ctx1, ttc)[:, -1], -1)  # [V, V]
        ctx2 = torch.tensor([prompt + [a, c] for a in range(V) for c in range(V)])
        p2 = torch.softmax(tl.forward(tt, ctx2, ttc)[:, -1], -1).reshape(V, V, V)
    m1 = p0 @ p1
    m2 = torch.einsum("a,ac,acd->d", p0, p1, p2)
    for col, marginal in ((1, m1), (2, m2)):
        observed = np.bincount(toks[:, col], minlength=V)
        expected = N * marginal.double().numpy()
        chi2 = float(((observed - expected) ** 2 / expected).sum())
        assert chi2 < CHI2_22_P001, (col, chi2)
