"""The port's beam search (models/beam.py) against the JAX package's.

Fixture: tests/unit/test_beam.py's tiny f32 config (2 layers, dim 64, 4 q /
2 kv heads, vocab 61) with JAX's seed-0 weights converted to the port.
Tokens are equal to JAX's beam_generate for beam 1 and beam 4, with and
without eos (f32 at this size has no ties; where one occurs the port's
top-k takes the lower index first, as lax.top_k does).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.models.beam import beam_generate as jax_beam  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.beam import _top_k, beam_generate  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402

FIXTURE = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
               vocab_size=61, max_seq_len=64, dtype="float32")
PROMPTS = np.asarray([[7, 3, 19, 8], [2, 40, 5, 5]], np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(**FIXTURE)
    tcfg = LlamaConfig.tiny(**FIXTURE)
    jp = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("beam,use_eos", [(1, False), (4, False), (1, True), (4, True)])
def test_tokens_equal_jax(model, beam, use_eos):
    jp, jcfg, tp, tcfg = model
    free = tl.greedy_generate(tp, torch.from_numpy(PROMPTS), tcfg, max_new_tokens=10)
    eos = int(free[0, 4 + 3]) if use_eos else None  # row 0's 4th new token
    kw = dict(max_new_tokens=10, beam_size=beam, length_penalty=0.8, eos_id=eos)
    want = np.asarray(jax_beam(jp, jnp.asarray(PROMPTS), jcfg, **kw))
    got = beam_generate(tp, torch.from_numpy(PROMPTS), tcfg, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 14)
    np.testing.assert_array_equal(got.numpy(), want)
    if beam == 1:
        assert torch.equal(got, tl.greedy_generate(tp, torch.from_numpy(PROMPTS), tcfg,
                                                   max_new_tokens=10, eos_id=eos))
    if use_eos:
        gen = got[0, 4:].numpy()
        hits = np.nonzero(gen == eos)[0]
        assert hits.size and (gen[hits[0]:] == eos).all()


def test_exhaustive_beam_is_the_argmax():
    """beam_size >= vocab**steps (5**3 = 125, more beams than vocabulary at
    step 0): the result is the most likely continuation by brute force."""
    cfg = LlamaConfig.tiny(n_layers=2, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=2,
                           vocab_size=5, max_seq_len=32, dtype="float32")
    params = tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    prompt = [1, 2]
    out = beam_generate(params, torch.tensor([prompt]), cfg, max_new_tokens=3,
                        beam_size=125, length_penalty=0.0)
    conts = torch.tensor([[a, c, d] for a in range(5) for c in range(5) for d in range(5)])
    seqs = torch.cat([torch.tensor([prompt]).expand(125, 2), conts], dim=1)
    with torch.inference_mode():
        logp = torch.log_softmax(tl.forward(params, seqs[:, :-1], cfg), -1)
    total = logp[:, 1:].gather(2, conts[..., None])[..., 0].sum(1)
    assert out[0, 2:].tolist() == conts[int(torch.argmax(total))].tolist()


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    values, indices = _top_k(x, 4)
    assert indices.tolist() == [[1, 2, 4, 5]] and values.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_validation(model):
    _, _, tp, tcfg = model
    prompt = torch.tensor([[1]])
    with pytest.raises(ValueError, match="beam_size"):
        beam_generate(tp, prompt, tcfg, max_new_tokens=2, beam_size=0)
    with pytest.raises(ValueError, match="cache too small"):
        beam_generate(tp, prompt, tcfg, max_new_tokens=8, beam_size=2, max_len=4)
