"""The port's speculative engines (models/spec_serving.py) against the JAX
package's, mirroring tests/unit/test_spec_serving.py.

Fixture: that file's tiny f32 target (2 layers, dim 64, 4 q / 2 kv heads,
vocab 97, seed 0) and smaller draft (1 layer, dim 32, seed 3), converted to
the port. Greedy tokens are equal to the JAX spec engine's (one mixed run
through each JAX engine, dense bf16-free and paged int8) and to the port's
greedy_generate / plain engines; sampled requests are held to the
algorithm (seeded replay, schedule independence, the distribution).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.models.spec_serving import (  # noqa: E402
    PagedSpeculativeServingEngine as JaxPagedSpec,
    SpeculativeServingEngine as JaxSpec,
)
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.paged import PagedServingEngine  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.serving import ServingEngine  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.spec_serving import (  # noqa: E402
    PagedSpeculativeServingEngine,
    SpeculativeServingEngine,
)

TARGET = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
              vocab_size=97, max_seq_len=128, dtype="float32")
DRAFT = dict(TARGET, n_layers=1, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=2)
SYS_PROMPT = [9, 1, 1, 4, 27, 60, 2]
TRAFFIC = [([5], 7), ([1, 2, 3, 4, 5, 6, 7], 11), (list(range(20, 40)), 5),
           ([88, 2], 15)]


@pytest.fixture(scope="module")
def model():
    out = []
    for fields, seed in ((TARGET, 0), (DRAFT, 3)):
        jcfg = jl.LlamaConfig.tiny(**fields)
        tcfg = LlamaConfig.tiny(**fields)
        jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
        out += [jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          device="cpu"), tcfg]
    return out


def _reference(m, prompt, max_new, eos_id=None):
    params, cfg = m[2], m[3]
    out = tl.greedy_generate(params, torch.tensor([prompt], dtype=torch.int32), cfg,
                             max_new_tokens=max_new, eos_id=eos_id)
    gen = out[0, len(prompt):].numpy()
    if eos_id is not None:
        hits = np.nonzero(gen == eos_id)[0]
        if hits.size:
            gen = gen[: hits[0] + 1]
    return gen


def _spec(m, cls=SpeculativeServingEngine, perfect=False, **kw):
    draft, dcfg = (m[2], m[3]) if perfect else (m[6], m[7])
    return cls(m[2], m[3], draft_params=draft, draft_cfg=dcfg, device="cpu", **kw)


def _drive(eng):
    """TRAFFIC plus two prefixed requests (one prefix-only)."""
    pid = eng.register_prefix(SYS_PROMPT)
    rids = [eng.submit(p, n) for p, n in TRAFFIC]
    rids += [eng.submit([3, 5], 7, prefix_id=pid), eng.submit([], 6, prefix_id=pid)]
    res = eng.run()
    return [np.asarray(res[r]) for r in rids]


@pytest.mark.parametrize("kind,kv_quant", [("dense", False), ("paged", True)],
                         ids=["dense", "paged_int8_kv"])
def test_greedy_tokens_equal_jax_spec_engine(model, kind, kv_quant):
    jp, jcfg, _, _, jd, jdcfg, _, _ = model
    kw = dict(gamma=3, n_slots=2, max_len=96, steps_per_sync=2, kv_quant=kv_quant)
    if kind == "paged":
        kw["block_size"] = 8
    jcls = JaxPagedSpec if kind == "paged" else JaxSpec
    want = _drive(jcls(jp, jcfg, draft_params=jd, draft_cfg=jdcfg, **kw))
    cls = PagedSpeculativeServingEngine if kind == "paged" else SpeculativeServingEngine
    eng = _spec(model, cls, **kw)
    got = _drive(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if not kv_quant:
        refs = [_reference(model, p, n) for p, n in TRAFFIC]
        refs += [_reference(model, SYS_PROMPT + [3, 5], 7), _reference(model, SYS_PROMPT, 6)]
        for g, r in zip(got, refs):
            np.testing.assert_array_equal(g, r)
    if kind == "paged":
        eng.unregister_prefix(0)
        assert eng.free_blocks == eng.stats()["total_blocks"]


def test_eos_stops_mid_pass(model):
    prompt = [7, 42, 3]
    eos = int(_reference(model, prompt, 12)[2])
    ref = _reference(model, prompt, 12, eos_id=eos)
    assert ref.size < 12
    eng = _spec(model, gamma=4, n_slots=2, max_len=64, steps_per_sync=3, eos_id=eos)
    rid = eng.submit(prompt, 12)
    other = eng.submit([9, 9, 1], 8)
    res = eng.run()
    np.testing.assert_array_equal(res[rid], ref)
    np.testing.assert_array_equal(res[other], _reference(model, [9, 9, 1], 8, eos_id=eos))


def test_perfect_draft_advances_gamma_plus_one(model):
    gamma = 3

    def syncs_to_finish(eng):
        eng.submit([4, 9, 2], 24)
        n = 0
        while eng._queue or any(r is not None for r in eng._slot_req):
            eng.step()
            n += 1
        return n

    plain = syncs_to_finish(ServingEngine(model[2], model[3], n_slots=1, max_len=64,
                                          steps_per_sync=1, device="cpu"))
    spec = syncs_to_finish(_spec(model, perfect=True, gamma=gamma, n_slots=1,
                                 max_len=64, steps_per_sync=1))
    assert plain == 23 + 1
    assert spec <= -(-23 // (gamma + 1)) + 1
    eng = _spec(model, perfect=True, gamma=gamma, n_slots=1, max_len=64)
    rid = eng.submit([4, 9, 2], 24)
    np.testing.assert_array_equal(eng.run()[rid], _reference(model, [4, 9, 2], 24))


def test_streaming_and_budget(model):
    eng = _spec(model, perfect=True, gamma=4, n_slots=1, max_len=64, steps_per_sync=2)
    got = []
    rid = eng.submit([8, 3], 9, on_token=got.extend)
    res = eng.run()
    assert res[rid].size == 9
    np.testing.assert_array_equal(np.asarray(got, np.int32), res[rid])
    np.testing.assert_array_equal(res[rid], _reference(model, [8, 3], 9))


def test_validation(model):
    def mk(**kw):
        return _spec(model, n_slots=1, max_len=32, **kw)

    with pytest.raises(ValueError, match="gamma"):
        mk(gamma=0)
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeServingEngine(model[2], model[3], draft_params=model[6],
                                 draft_cfg=LlamaConfig.tiny(vocab_size=11), n_slots=1,
                                 device="cpu")
    with pytest.raises(ValueError, match="adapters"):
        mk(adapters={"x": {}})
    eng = mk(gamma=2)
    with pytest.raises(ValueError, match="top_p"):
        eng.submit([1], 2, top_p=0.9)
    with pytest.raises(ValueError, match="logprobs"):
        eng.submit([1], 2, logprobs=True)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1], 2, prefix_id=99)
    with pytest.raises(ValueError, match="presence_penalty"):
        eng.submit([1], 2, presence_penalty=0.5)


def test_prefix_caching_both_models(model):
    eng = _spec(model, gamma=3, n_slots=2, max_len=96, steps_per_sync=2)
    pid = eng.register_prefix(SYS_PROMPT)
    assert eng._prefixes[pid]["dk"].shape[2] == len(SYS_PROMPT)
    r3 = eng.submit([42] * 11, 5, prefix_id=pid)
    r4 = eng.submit([7, 7], 5)
    res = eng.run()
    np.testing.assert_array_equal(res[r3], _reference(model, SYS_PROMPT + [42] * 11, 5))
    np.testing.assert_array_equal(res[r4], _reference(model, [7, 7], 5))
    eng.unregister_prefix(pid)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1], 2, prefix_id=pid)


def test_kv_quant_matches_plain_int8_engine(model):
    reqs = [([4, 9, 2], 10), (list(range(30, 45)), 7), ([8], 12)]
    plain = ServingEngine(model[2], model[3], n_slots=2, max_len=64, steps_per_sync=3,
                          kv_quant=True, device="cpu")
    p_rids = [plain.submit(p, m) for p, m in reqs]
    p_res = plain.run()
    spec = _spec(model, gamma=3, n_slots=2, max_len=64, steps_per_sync=2, kv_quant=True)
    s_rids = [spec.submit(p, m) for p, m in reqs]
    s_res = spec.run()
    for pr, sr in zip(p_rids, s_rids):
        np.testing.assert_array_equal(p_res[pr], s_res[sr])


def test_chunked_prefill_spec(model):
    long_prompt = list(range(1, 52))
    sysp = [3] * 37
    eng = _spec(model, gamma=3, n_slots=2, max_len=128, steps_per_sync=2,
                prefill_chunk=16)
    pid = eng.register_prefix(sysp)
    r1 = eng.submit(long_prompt, 7)
    r2 = eng.submit([5, 9], 9)
    r3 = eng.submit([8, 1], 6, prefix_id=pid)
    res = eng.run()
    np.testing.assert_array_equal(res[r1], _reference(model, long_prompt, 7))
    np.testing.assert_array_equal(res[r2], _reference(model, [5, 9], 9))
    np.testing.assert_array_equal(res[r3], _reference(model, sysp + [8, 1], 6))


def test_paged_spec_overrun_cannot_corrupt_neighbor(model):
    """Slot A nearly out of budget (remaining < gamma) shares passes with
    slot B, whose blocks include low physical ids: A's rejected-tail writes
    past its reservation go to the trash block, never into B's blocks."""
    eng = _spec(model, PagedSpeculativeServingEngine, gamma=4, n_slots=2, max_len=64,
                steps_per_sync=1, block_size=4, n_blocks=20)
    rb = eng.submit(list(range(2, 12)), 20)
    ra = eng.submit([7, 7], 2)
    ra2 = eng.submit([8, 1, 3], 3)
    res = eng.run()
    np.testing.assert_array_equal(res[rb], _reference(model, list(range(2, 12)), 20))
    np.testing.assert_array_equal(res[ra], _reference(model, [7, 7], 2))
    np.testing.assert_array_equal(res[ra2], _reference(model, [8, 1, 3], 3))
    assert eng.free_blocks == eng.stats()["total_blocks"]


@pytest.mark.parametrize("cls", [SpeculativeServingEngine, PagedSpeculativeServingEngine],
                         ids=["dense", "paged"])
def test_end_of_cache_writes_are_dropped(model, cls):
    """prompt + max_new_tokens == max_len with gamma = 4 and a perfect
    draft: the last passes' chunks and draft steps reach up to 4 positions
    past the cache's end. They land in the scratch column (dense) or the
    trash block (paged), never raise and never change a token; a second
    slot keeps decoding beside them."""
    kw = {"block_size": 8} if cls is PagedSpeculativeServingEngine else {}
    for perfect in (True, False):
        eng = _spec(model, cls, perfect=perfect, gamma=4, n_slots=2, max_len=32,
                    steps_per_sync=2, **kw)
        r = eng.submit(list(range(1, 21)), 12)
        r2 = eng.submit([3, 4], 30)
        res = eng.run()
        np.testing.assert_array_equal(res[r], _reference(model, list(range(1, 21)), 12))
        np.testing.assert_array_equal(res[r2], _reference(model, [3, 4], 30))
    if cls is SpeculativeServingEngine:
        assert eng.cache["k"].shape[2] == 33 and eng.dcache["k"].shape[2] == 33


def test_sampled_requests_seeded_and_schedule_free(model):
    """Seeded sampled requests replay identically, alone or beside other
    traffic (the stream is keyed by request and position), different seeds
    differ, and greedy traffic in the same bursts stays exact."""
    def drive(alone=False):
        eng = _spec(model, gamma=3, n_slots=3, max_len=64, steps_per_sync=2)
        g = None if alone else eng.submit([4, 9, 2], 8)
        s7 = eng.submit([4, 9, 2], 8, temperature=1.2, seed=7)
        s8 = None if alone else eng.submit([4, 9, 2], 8, temperature=1.2, seed=8)
        res = eng.run()
        return [res.get(r) for r in (g, s7, s8)]

    g_a, s7_a, s8_a = drive()
    _, s7_b, _ = drive(alone=True)
    np.testing.assert_array_equal(g_a, _reference(model, [4, 9, 2], 8))
    np.testing.assert_array_equal(s7_a, s7_b)
    assert not np.array_equal(s7_a, s8_a)
    assert ((s7_a >= 0) & (s7_a < 97)).all()
    paged = _spec(model, PagedSpeculativeServingEngine, gamma=3, n_slots=2, max_len=64,
                  steps_per_sync=2, block_size=8, kv_quant=True)
    rid = paged.submit([8], 7, temperature=1.1, seed=5)
    again = _spec(model, PagedSpeculativeServingEngine, gamma=3, n_slots=2, max_len=64,
                  steps_per_sync=2, block_size=8, kv_quant=True)
    rid2 = again.submit([8], 7, temperature=1.1, seed=5)
    np.testing.assert_array_equal(paged.run()[rid], again.run()[rid2])


def test_sampled_distribution_matches_plain_engine():
    """The engine's speculative sampling is distribution-exact: over 2048
    seeded requests (tests/unit/test_spec_serving.py's setting: vocab 23,
    1-layer target and draft), the first burst-emitted token's histogram
    matches the plain engine's within the noise floor, and both pass a
    chi-square test against the target's exact marginal."""
    V = 23
    base = dict(n_layers=1, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=2,
                vocab_size=V, max_seq_len=32, dtype="float32")
    params = []
    for fields, seed in ((base, 0), (dict(base, dim=16, hidden_dim=32), 5)):
        jp = jl.init_params(jax.random.PRNGKey(seed), jl.LlamaConfig.tiny(**fields))
        params.append((params_from_jax(jax.tree.map(np.asarray, jp),
                                       LlamaConfig.tiny(**fields), device="cpu"),
                       LlamaConfig.tiny(**fields)))
    (tp, tcfg), (dp, dcfg) = params
    N, prompt = 2048, [3, 9]

    def second_tokens(make):
        toks = np.zeros((N,), np.int64)
        for done in range(0, N, 512):
            eng = make()
            rids = [eng.submit(prompt, 2, temperature=1.0, seed=done + i) for i in range(512)]
            res = eng.run()
            for i, r in enumerate(rids):
                toks[done + i] = res[r][1]
        return toks

    plain = second_tokens(lambda: ServingEngine(tp, tcfg, n_slots=64, max_len=32,
                                                steps_per_sync=1, device="cpu"))
    spec = second_tokens(lambda: SpeculativeServingEngine(
        tp, tcfg, draft_params=dp, draft_cfg=dcfg, gamma=2, n_slots=64, max_len=32,
        steps_per_sync=1, device="cpu"))
    h_plain = np.bincount(plain, minlength=V) / N
    h_spec = np.bincount(spec, minlength=V) / N
    assert 0.5 * np.abs(h_plain - h_spec).sum() < 0.15
    with torch.inference_mode():
        p0 = torch.softmax(tl.forward(tp, torch.tensor([prompt]), tcfg)[0, -1], -1)
        p1 = torch.softmax(tl.forward(tp, torch.tensor([prompt + [a] for a in range(V)]),
                                      tcfg)[:, -1], -1)
    expected = N * (p0 @ p1).double().numpy()
    for toks in (plain, spec):
        observed = np.bincount(toks, minlength=V)
        assert float(((observed - expected) ** 2 / expected).sum()) < 48.27  # p = 0.001
