"""The port's serving path (bee_code_interpreter_fs_tpu_torch/models/serving.py
and paged.py, sampling in models/llama.py) against the JAX package's.

Fixture: the JAX serving tests' tiny config (2 layers, dim 64, 4 q / 2 kv
heads, vocab 97, f32) with JAX's seed-0 weights converted to the port.

- Greedy tokens: exactly equal to the JAX engine's over one mixed traffic
  (staggered prompts over 2 slots, eos, a chunked-registered prefix, a
  prefix-only prompt, chunked prefill), for the dense and paged engines,
  with and without int8 KV; log-probs within 1e-5. The JAX engine runs
  twice per module (dense KV and int8 KV).
- Sampling: the port has its own counter-based stream, so sampled tokens
  are held to nucleus_mask parity, the stream's invariances and a chi-square
  test against the softmax, never to JAX's tokens.
- Everything else (cancel, callbacks, stats, penalties, buckets, errors)
  as the JAX tests check it, with the port's greedy_generate (held to
  JAX's in test_torch_llama.py) as the reference.
- The burst's state stays in place and a CPU burst is eager (the card's
  graph replays are held to the CPU in test_torch_cuda_serving.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.models.paged import (  # noqa: E402
    PagedServingEngine as JaxPaged,
)
from bee_code_interpreter_fs_tpu.models.serving import (  # noqa: E402
    ServingEngine as JaxEngine,
)
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.paged import PagedServingEngine  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.serving import (  # noqa: E402
    ServingEngine,
    _sample_next,
)
from bee_code_interpreter_fs_tpu_torch.models.spec_serving import (  # noqa: E402
    PagedSpeculativeServingEngine,
    SpeculativeServingEngine,
)

FIXTURE = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
               vocab_size=97, max_seq_len=128, dtype="float32")
ENGINE = dict(n_slots=2, max_len=96, steps_per_sync=3, prefill_chunk=16)
SYS_PROMPT = list(range(3, 24))  # 21 > the chunk: registers chunked
TRAFFIC = [  # (prompt, max_new_tokens, uses the prefix)
    ([5], 3, False),
    ([1, 2, 3, 4, 5, 6, 7], 9, False),
    (list(range(20, 50)), 5, False),      # bucket 32: chunked admission
    ([88, 2], 17, False),                 # eos fires here
    ([11] * 17, 6, False),                # pow-2 + 1: the next bucket
    ([3, 5], 7, True),
    ([], 6, True),                        # the prefix is the whole prompt
]
LOGPROB_TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny(**FIXTURE)
    tcfg = LlamaConfig.tiny(**FIXTURE)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    # An eos that request 3 emits mid-generation, so it stops early.
    eos = int(_reference(model, tcfg, [88, 2], 17)[5])
    return jparams, jcfg, model, tcfg, eos


def _reference(model, cfg, prompt, max_new, eos_id=None):
    """The port's greedy_generate continuation, cut after the first eos."""
    out = tl.greedy_generate(model, torch.tensor([prompt], dtype=torch.int32), cfg,
                             max_new_tokens=max_new, eos_id=eos_id)
    gen = out[0, len(prompt):].numpy()
    if eos_id is not None:
        hits = np.nonzero(gen == eos_id)[0]
        if hits.size:
            gen = gen[: hits[0] + 1]
    return gen


def _drive(eng):
    """The mixed traffic, every request with log-probs. Returns
    [(tokens, logprobs)] in TRAFFIC's order."""
    pid = eng.register_prefix(SYS_PROMPT)
    rids = [eng.submit(p, m, prefix_id=pid if pre else None, logprobs=True)
            for p, m, pre in TRAFFIC]
    res = eng.run()
    return [(np.asarray(res[r]), np.asarray(eng.take_logprobs(r))) for r in rids]


@pytest.fixture(scope="module")
def jax_runs(tiny):
    jparams, jcfg, _, _, eos = tiny
    runs = {}
    for kv_quant in (False, True):
        eng = JaxEngine(jparams, jcfg, eos_id=eos, kv_quant=kv_quant, **ENGINE)
        runs[kv_quant] = (_drive(eng), eng)
    return runs


def _port_engine(tiny, kind="dense", **kw):
    _, _, model, tcfg, _ = tiny
    if kind == "paged":
        return PagedServingEngine(model, tcfg, block_size=8, device="cpu", **kw)
    return ServingEngine(model, tcfg, device="cpu", **kw)


# ---------------------------------------------------------------- vs JAX


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv", "int8_kv"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_engine_tokens_and_logprobs_equal_jax(tiny, jax_runs, kind, kv_quant):
    _, _, model, tcfg, eos = tiny
    want, _ = jax_runs[kv_quant]
    eng = _port_engine(tiny, kind, eos_id=eos, kv_quant=kv_quant, **ENGINE)
    got = _drive(eng)
    assert len(got[3][0]) < 17  # eos cut request 3 short
    for (toks, lps), (jtoks, jlps) in zip(got, want):
        np.testing.assert_array_equal(toks, jtoks)
        assert lps.shape == toks.shape
        np.testing.assert_allclose(lps, jlps, atol=LOGPROB_TOL, rtol=0)
    if not kv_quant:  # and each request equals its standalone greedy decode
        for (toks, _), (p, m, pre) in zip(got, TRAFFIC):
            prompt = SYS_PROMPT + p if pre else p
            np.testing.assert_array_equal(toks, _reference(model, tcfg, prompt, m, eos))
    if kind == "paged":
        eng.unregister_prefix(0)
        assert eng.free_blocks == eng.stats()["total_blocks"]


def test_buckets_match_jax(tiny):
    jparams, jcfg, model, tcfg, _ = tiny
    configs = [dict(max_len=96), dict(max_len=128, prefill_chunk=32),
               dict(max_len=64, prefill_buckets=(4, 24)),
               dict(max_len=96, prefill_chunk=16)]
    for kw in configs:
        j = JaxEngine(jparams, jcfg, n_slots=1, **kw)
        t = ServingEngine(model, tcfg, n_slots=1, device="cpu", **kw)
        assert t.buckets == j.buckets, kw
        for n in range(1, max(j.buckets) + 1):
            assert t._bucket_len(n) == j._bucket_len(n), (kw, n)
        for plen in (1, 7, 21):
            for n in range(1, kw["max_len"] - plen):
                assert t._suffix_bucket(plen, n) == j._suffix_bucket(plen, n)


def _raises_alike(jax_call, port_call):
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(Exception) as got:
        port_call()
    assert (type(got.value), str(got.value)) == (type(want.value), str(want.value))


SUBMIT_ERRORS = {
    "empty_prompt": (([], 4), {}),
    "exceeds_cache": ((list(range(90)), 8), {}),
    "max_new_tokens": (([1], 0), {}),
    "temperature": (([1], 2), {"temperature": -1.0}),
    "top_p_zero": (([1], 2), {"top_p": 0.0}),
    "top_p_above_one": (([1], 2), {"top_p": 1.5}),
    "unknown_prefix": (([1], 2), {"prefix_id": 99}),
    "unknown_adapter": (([1], 2), {"adapter": "math"}),
    "prefix_exceeds_cache": ((list(range(70)), 8), {"prefix_id": 0}),
}


@pytest.mark.parametrize("case", sorted(SUBMIT_ERRORS))
def test_submit_errors_match_jax(tiny, jax_runs, case):
    _, jeng = jax_runs[False]
    teng = _port_engine(tiny, **ENGINE)
    teng.register_prefix(SYS_PROMPT)
    args, kw = SUBMIT_ERRORS[case]
    _raises_alike(lambda: jeng.submit(*args, **kw), lambda: teng.submit(*args, **kw))


def test_prefix_and_bucket_errors_match_jax(tiny, jax_runs):
    jparams, jcfg, model, tcfg, _ = tiny
    _, jeng = jax_runs[False]
    teng = _port_engine(tiny, **ENGINE)
    for call in (lambda e: e.register_prefix([]),
                 lambda e: e.register_prefix(list(range(96))),
                 lambda e: e.register_prefix([1], adapter="math"),
                 lambda e: e.unregister_prefix(99)):
        _raises_alike(lambda: call(jeng), lambda: call(teng))
    for kw in (dict(max_len=64, prefill_chunk=64), dict(max_len=64, prefill_buckets=(0, 8)),
               dict(max_len=64, prefill_buckets=(8, 65))):
        _raises_alike(lambda: JaxEngine(jparams, jcfg, **kw),
                      lambda: ServingEngine(model, tcfg, device="cpu", **kw))
    small_j = JaxEngine(jparams, jcfg, n_slots=1, max_len=64, prefill_buckets=(4,))
    small_t = ServingEngine(model, tcfg, n_slots=1, max_len=64, prefill_buckets=(4,),
                            device="cpu")
    _raises_alike(lambda: small_j.submit(list(range(8)), 5),
                  lambda: small_t.submit(list(range(8)), 5))
    for kw in (dict(max_len=64, block_size=8, n_blocks=4), dict(block_size=0),
               dict(block_size=8, prefill_chunk=12)):
        _raises_alike(lambda: JaxPaged(jparams, jcfg, **kw),
                      lambda: PagedServingEngine(model, tcfg, device="cpu", **kw))


def test_engine_device_rules(tiny):
    _, _, model, tcfg, _ = tiny
    with pytest.raises(ValueError, match="not an adapter tree"):
        ServingEngine(model, tcfg, adapters={"math": {}}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(model, tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedServingEngine(model, tcfg)
    else:
        with pytest.raises(ValueError, match="params are on cpu"):
            ServingEngine(model, tcfg)


# ---------------------------------------------------------------- sampling


def test_nucleus_mask_equals_jax():
    rng = np.random.default_rng(5)
    scaled = (rng.standard_normal((6, 97)) * 3).astype(np.float32)
    per_row = rng.uniform(0.05, 0.95, (6, 1)).astype(np.float32)
    for top_p in (0.1, 0.5, 0.9, 0.999, per_row):
        want = np.asarray(jl.nucleus_mask(jnp.asarray(scaled), jnp.asarray(top_p)))
        got = tl.nucleus_mask(torch.from_numpy(scaled), torch.as_tensor(top_p))
        np.testing.assert_array_equal(got.numpy(), want)
    # top_p = 1.0 masks nothing, bit for bit, as a number or per row. The
    # reference's f32 cumulative sum can pass 1.0 before the last token and
    # drop it: where it does, only tokens of probability < 1e-6 differ.
    per_row[[0, 3]] = 1.0
    mixed = tl.nucleus_mask(torch.from_numpy(scaled), torch.from_numpy(per_row)).numpy()
    np.testing.assert_array_equal(mixed[[0, 3]], scaled[[0, 3]])
    for top_p in (1.0, np.ones((6, 1), np.float32)):
        got = tl.nucleus_mask(torch.from_numpy(scaled), torch.as_tensor(top_p)).numpy()
        np.testing.assert_array_equal(got, scaled)
    want = np.asarray(jl.nucleus_mask(jnp.asarray(scaled), 1.0))
    probs = torch.softmax(torch.from_numpy(scaled).double(), -1).numpy()
    assert (probs[want != scaled] < 1e-6).all()


def test_sample_generate_rules(tiny):
    _, _, model, tcfg, eos = tiny
    prompt = torch.tensor([[4, 9, 2], [30, 1, 7]], dtype=torch.int32)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            tl.sample_generate(model, prompt, 0, tcfg, max_new_tokens=4, top_p=bad)
    greedy = tl.greedy_generate(model, prompt, tcfg, max_new_tokens=8)
    top1 = tl.sample_generate(model, prompt, 3, tcfg, max_new_tokens=8, top_k=1)
    assert torch.equal(top1, greedy)  # one survivor: the argmax
    a = tl.sample_generate(model, prompt, 3, tcfg, max_new_tokens=8,
                           temperature=1.3, top_p=0.9, top_k=20)
    b = tl.sample_generate(model, prompt, 3, tcfg, max_new_tokens=8,
                           temperature=1.3, top_p=0.9, top_k=20)
    c = tl.sample_generate(model, prompt, 4, tcfg, max_new_tokens=8, temperature=1.3)
    assert a.dtype == torch.int32 and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :3], prompt) and int(a.max()) < tcfg.vocab_size
    pinned = tl.sample_generate(model, prompt, 3, tcfg, max_new_tokens=8,
                                temperature=1.3, top_p=0.9, top_k=20,
                                eos_id=int(a[0, 4]))
    row = pinned[0, 3:].numpy()
    first = int(np.argmax(row == int(a[0, 4])))
    assert first <= 1 and (row[first:] == int(a[0, 4])).all()


def _np_fmix32(h):
    h = h.astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & m
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & m
    return h ^ (h >> np.uint64(16))


def _np_gumbel(key: int, position: int, vocab: int):
    """An independent numpy rendering of the port's documented stream."""
    gold = np.uint64(0x9E3779B9)
    m = np.uint64(0xFFFFFFFF)
    row = _np_fmix32(np.uint64(key) ^ _np_fmix32((np.uint64(position) + gold) & m))
    cols = _np_fmix32((np.arange(vocab, dtype=np.uint64) + gold) & m)
    bits = _np_fmix32(row ^ cols)
    u = ((bits >> np.uint64(9)).astype(np.float64) + 0.5) * 2.0 ** -23
    return -np.log(-np.log(u))


def test_stream_distribution_matches_softmax():
    """Gumbel-max draws from the stream, across keys and across positions,
    against softmax(logits / T) restricted to the nucleus: chi-square below
    the 0.001 critical value."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0, 1.5])
    n, temp = 20000, 0.8
    # chi-square 0.999 quantiles by degrees of freedom
    crit = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47, 5: 20.52, 6: 22.46, 7: 24.32}
    for top_p in (None, 0.8):
        scaled = (logits / temp).double()
        probs = torch.softmax(scaled, -1)
        if top_p is not None:
            probs = torch.softmax(tl.nucleus_mask(scaled, top_p), -1)
        for keys, positions in (
            (tl.fold_key(torch.full((n,), 11), torch.arange(n)), torch.full((n,), 40)),
            (torch.full((n,), tl.stream_key(11)), torch.arange(n)),
        ):
            toks = _sample_next(logits.expand(n, -1), torch.full((n,), temp),
                                keys, positions,
                                None if top_p is None else torch.full((n,), top_p))
            counts = torch.bincount(toks, minlength=8).double()
            live = probs > 0
            assert counts[~live].sum() == 0
            expect = probs[live] * n
            chi2 = float(((counts[live] - expect) ** 2 / expect).sum())
            assert chi2 < crit[int(live.sum()) - 1], (top_p, chi2)


def test_admission_sampling_exact_vs_reimplementation(tiny):
    """Requests of one token finish at admission: each is drawn from the
    last prompt position's logits at position len(prompt) with key
    stream_key(seed); an independent numpy rendering of the stream gives
    the same tokens."""
    _, _, model, tcfg, _ = tiny
    prompt, temp = [3, 14, 15], 1.5
    with torch.no_grad():
        logits = tl.forward(model, torch.tensor([prompt]), tcfg)[0, -1].double().numpy()
    eng = ServingEngine(model, tcfg, n_slots=2, max_len=32, device="cpu")
    seeds = list(range(200))
    rids = [eng.submit(prompt, 1, temperature=temp, seed=s) for s in seeds]
    res = eng.run()
    got = np.concatenate([res[r] for r in rids])
    want = [int(np.argmax(logits / temp + _np_gumbel(tl.stream_key(s), 3, 97)))
            for s in seeds]
    np.testing.assert_array_equal(got, want)


def test_sampled_stream_is_schedule_independent(tiny):
    """A seeded request gives the same tokens alone as beside other
    traffic under another slot count and burst length; a top_p = 1.0 row
    samples the same with or without a tight nucleus row in its bursts;
    greedy rows beside sampled ones stay greedy."""
    _, _, model, tcfg, _ = tiny

    def alone(prompt, m, **kw):
        eng = ServingEngine(model, tcfg, n_slots=1, max_len=64, steps_per_sync=3,
                            device="cpu")
        rid = eng.submit(prompt, m, **kw)
        return eng.run()[rid]

    mixed = ServingEngine(model, tcfg, n_slots=3, max_len=64, steps_per_sync=7,
                          device="cpu")
    others = [mixed.submit([5], 4, temperature=2.0, seed=i) for i in range(2)]
    greedy = mixed.submit([30, 1], 7)
    tight = mixed.submit([8, 15], 9, temperature=1.3, seed=12, top_p=0.2)
    free = mixed.submit([4, 9, 2], 8, temperature=1.3, seed=11)
    same = mixed.submit([4, 9, 2], 8, temperature=1.3, seed=123)
    res = mixed.run()
    np.testing.assert_array_equal(res[free], alone([4, 9, 2], 8, temperature=1.3, seed=11))
    np.testing.assert_array_equal(res[same], alone([4, 9, 2], 8, temperature=1.3, seed=123))
    np.testing.assert_array_equal(res[tight], alone([8, 15], 9, temperature=1.3, seed=12,
                                                    top_p=0.2))
    np.testing.assert_array_equal(res[greedy], _reference(model, tcfg, [30, 1], 7))
    assert not np.array_equal(res[free], res[same])
    assert all(len(res[r]) == 4 for r in others)
    # Every token of the tight row lies in its nucleus at its teacher-forced
    # position (a small allowance for the prefill/forward summation order).
    toks = res[tight]
    full = torch.tensor([[8, 15] + toks.tolist()])
    with torch.no_grad():
        scaled = tl.forward(model, full[:, :-1], tcfg)[0].double() / 1.3
    for i, t in enumerate(toks.tolist()):
        row = scaled[1 + i]
        probs = torch.softmax(row, -1)
        order = torch.argsort(row, descending=True)
        mass_before = torch.cumsum(probs[order], 0) - probs[order]
        rank = int((order == t).nonzero()[0, 0])
        assert mass_before[rank] < 0.2 + 1e-3


# ---------------------------------------------------------------- engine


def test_logprobs_match_teacher_forcing(tiny):
    _, _, model, tcfg, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=2, max_len=64, steps_per_sync=3, device="cpu")
    cases = {
        eng.submit([4, 9, 2], 7, logprobs=True): [4, 9, 2],
        eng.submit([11, 5], 6, temperature=1.1, seed=3, logprobs=True): [11, 5],
        eng.submit([8], 5): None,
    }
    res = eng.run()
    for rid, prompt in cases.items():
        lps = eng.take_logprobs(rid)
        if prompt is None:
            assert lps is None
            continue
        toks = res[rid]
        full = torch.tensor([prompt + toks.tolist()])
        with torch.no_grad():
            ref = torch.log_softmax(tl.forward(model, full[:, :-1], tcfg), -1)[0]
        want = [float(ref[len(prompt) - 1 + i, t]) for i, t in enumerate(toks)]
        np.testing.assert_allclose(lps, want, atol=LOGPROB_TOL, rtol=0)
        assert eng.take_logprobs(rid) is None  # popped


def test_penalties(tiny):
    """A huge presence penalty never generates a token twice; zero
    penalties in a penalized batch equal a penalty-free engine; log-probs
    stay raw-model; a frequency penalty cuts repeats."""
    _, _, model, tcfg, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=2, max_len=64, steps_per_sync=3, device="cpu")
    r_pen = eng.submit([4, 9, 2], 12, presence_penalty=1e9, logprobs=True)
    r_zero = eng.submit([7, 7], 8, logprobs=True)
    res = eng.run()
    out = res[r_pen]
    assert len(set(out.tolist())) == len(out)
    np.testing.assert_array_equal(res[r_zero], _reference(model, tcfg, [7, 7], 8))
    full = torch.tensor([[4, 9, 2] + out.tolist()])
    with torch.no_grad():
        ref = torch.log_softmax(tl.forward(model, full[:, :-1], tcfg), -1)[0]
    np.testing.assert_allclose(eng.take_logprobs(r_pen),
                               [float(ref[2 + i, t]) for i, t in enumerate(out)],
                               atol=LOGPROB_TOL, rtol=0)
    plain = ServingEngine(model, tcfg, n_slots=1, max_len=64, steps_per_sync=3, device="cpu")
    rp = plain.submit([7, 7], 8, logprobs=True)
    np.testing.assert_array_equal(plain.run()[rp], res[r_zero])
    np.testing.assert_allclose(plain.take_logprobs(rp), eng.take_logprobs(r_zero),
                               atol=LOGPROB_TOL)

    def repeats(tokens):
        _, counts = np.unique(tokens, return_counts=True)
        return int((counts - 1).sum())

    rb = plain.submit([5], 40)
    base = plain.run()[rb]
    rf = plain.submit([5], 40, frequency_penalty=2.0)
    assert repeats(plain.run()[rf]) < repeats(base)


def test_cancel_budget_one_and_reuse(tiny):
    _, _, model, tcfg, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=1, max_len=64, steps_per_sync=3, device="cpu")
    r_one = eng.submit([4, 8], 1)
    r_active = eng.submit([4, 9], 40)
    r_queued = eng.submit([8, 8], 5)
    eng.step()  # r_one finishes at admission; r_active runs one burst
    assert eng.cancel(r_queued) is True
    assert eng.cancel(r_active) is True
    assert eng.cancel(12345) is False
    res = eng.run()
    np.testing.assert_array_equal(res[r_one], _reference(model, tcfg, [4, 8], 1))
    assert res[r_queued].size == 0
    partial = res[r_active]
    assert 0 < partial.size < 40
    np.testing.assert_array_equal(partial, _reference(model, tcfg, [4, 9], 40)[: partial.size])
    r_next = eng.submit([17], 4)
    np.testing.assert_array_equal(eng.run()[r_next], _reference(model, tcfg, [17], 4))
    assert eng.cancel(r_next) is False


def test_streaming_callbacks_and_stats(tiny):
    _, _, model, tcfg, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=2, max_len=64, steps_per_sync=3, device="cpu")
    chunks = {}
    rids = []
    for p, m in (([4, 9], 10), ([17] * 5, 7), ([2], 12)):
        rid = eng.submit(p, m, on_token=lambda t, i=len(rids): chunks.setdefault(i, []).append(t))
        rids.append(rid)
    s0 = eng.stats()
    assert s0["queued"] == 3 and s0["active_slots"] == 0
    res = eng.run()
    for i, rid in enumerate(rids):
        flat = [t for c in chunks[i] for t in c]
        np.testing.assert_array_equal(np.asarray(flat, np.int32), res[rid])
        assert all(len(c) <= 1 + eng.steps_per_sync for c in chunks[i])
    s1 = eng.stats()
    assert s1["queued"] == 0 and s1["occupied_slots"] == 0 and s1["results_pending"] == 0


def test_raising_sinks_corrupt_nothing(tiny):
    """A sink raising at admission or in a burst costs no request its
    tokens and no other sink its delivery; run() resumes."""
    _, _, model, tcfg, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=2, max_len=64, steps_per_sync=3, device="cpu")
    got_ok = []

    def bomb(_):
        raise RuntimeError("admission sink down")

    r_bomb = eng.submit([4, 9], 8, on_token=bomb)
    r_ok = eng.submit([17, 2], 8, on_token=got_ok.extend)
    with pytest.raises(RuntimeError, match="admission sink down"):
        eng.step()
    assert eng.stats()["occupied_slots"] == 2
    assert len(got_ok) == 1 + eng.steps_per_sync
    bomb_req = next(r for r in eng._slot_req if r and r.rid == r_bomb)
    assert len(bomb_req.generated) == 1 + eng.steps_per_sync
    state = {"raised": False}

    def once(_):
        if not state["raised"]:
            state["raised"] = True
            raise RuntimeError("sink down")

    bomb_req.on_token = once
    with pytest.raises(RuntimeError, match="sink down"):
        eng.run()
    res = eng.run()
    np.testing.assert_array_equal(res[r_ok], _reference(model, tcfg, [17, 2], 8))
    np.testing.assert_array_equal(res[r_bomb], _reference(model, tcfg, [4, 9], 8))
    np.testing.assert_array_equal(np.asarray(got_ok, np.int32), res[r_ok])


def test_prefix_lifecycle_and_bucket_routes(tiny):
    """unregister_prefix guards and releases; a prefixed suffix longer than
    every custom bucket admits through the exact remainder; with a chunk, a
    long prompt takes the smallest chunk-aligned bucket."""
    _, _, model, tcfg, _ = tiny
    eng = ServingEngine(model, tcfg, n_slots=1, max_len=64, prefill_buckets=(4,),
                        device="cpu")
    sysp = [9, 1, 4, 27]
    pid = eng.register_prefix(sysp)
    rid = eng.submit(list(range(30, 38)), 5, prefix_id=pid)
    with pytest.raises(ValueError, match="queued request"):
        eng.unregister_prefix(pid)
    np.testing.assert_array_equal(eng.run()[rid],
                                  _reference(model, tcfg, sysp + list(range(30, 38)), 5))
    eng.unregister_prefix(pid)
    assert pid not in eng._prefixes
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1], 2, prefix_id=pid)

    eng = ServingEngine(model, tcfg, n_slots=1, max_len=128, steps_per_sync=3,
                        prefill_chunk=32, device="cpu")
    assert 127 in eng.buckets and 128 in eng.buckets
    assert eng._bucket_len(100) == 128 and eng._bucket_len(10) == 32
    prompt = [t % 97 for t in range(1, 101)]
    rid = eng.submit(prompt, 6)
    np.testing.assert_array_equal(eng.run()[rid], _reference(model, tcfg, prompt, 6))


STATE = ("pos", "last_tok", "remaining", "active")


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_burst_state_stays_in_place(tiny, kind):
    """_run_burst copies each burst's results into the engine's state, so
    pos, last_tok, remaining and active stay the same tensors over the
    same storage (what a captured graph reads and writes); a CPU engine
    runs every burst eagerly and captures nothing."""
    _, _, model, tcfg, _ = tiny
    eng = _port_engine(tiny, kind, n_slots=2, max_len=64, steps_per_sync=3)
    before = {name: (getattr(eng, name), getattr(eng, name).data_ptr())
              for name in STATE}
    packed = eng._packed.data_ptr()
    rids = [eng.submit([4, 9], 10), eng.submit([17] * 5, 7, logprobs=True),
            eng.submit([2], 12)]
    res = eng.run()
    for name, (tensor, ptr) in before.items():
        assert getattr(eng, name) is tensor and tensor.data_ptr() == ptr, name
    assert eng._packed.data_ptr() == packed
    for rid, (p, m) in zip(rids, (([4, 9], 10), ([17] * 5, 7), ([2], 12))):
        np.testing.assert_array_equal(res[rid], _reference(model, tcfg, p, m))
    s = eng.stats()
    assert s["eager_bursts"] >= 4
    assert s["graph_bursts"] == 0 and s["burst_graphs"] == 0


@pytest.mark.parametrize("cls", [SpeculativeServingEngine, PagedSpeculativeServingEngine],
                         ids=["dense", "paged"])
def test_speculative_bursts_stay_eager(tiny, cls):
    """The speculative engines run their own burst loop: no graph, every
    burst counted eager. The target is its own draft, so every proposal is
    accepted and the tokens are greedy_generate's."""
    _, _, model, tcfg, _ = tiny
    kw = {"block_size": 8} if cls is PagedSpeculativeServingEngine else {}
    eng = cls(model, tcfg, draft_params=model, draft_cfg=tcfg, gamma=2, n_slots=2,
              max_len=64, steps_per_sync=2, device="cpu", **kw)
    rid = eng.submit([4, 9], 12)
    np.testing.assert_array_equal(eng.run()[rid], _reference(model, tcfg, [4, 9], 12))
    s = eng.stats()
    assert s["eager_bursts"] >= 1
    assert s["graph_bursts"] == 0 and s["burst_graphs"] == 0
