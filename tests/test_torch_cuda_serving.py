"""The port's serving path on the card against the same run on the CPU.

Every test here carries the `cuda` marker and skips without a CUDA device.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, without the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_serving.py

Tiny f32 model, random weights from a seeded CPU generator, copied to the
card (the speculative engines' draft is a 1-layer model made the same
way). Greedy and sampled tokens must be equal on both devices (the sampling
stream is computed in int64 ops on each device; the logits differ by f32
summation order only); quantized forwards within 1e-4.
"""

import collections
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bee_code_interpreter_fs_tpu_torch.models import serving, spec_serving  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import (  # noqa: E402
    LlamaConfig,
    PagedServingEngine,
    PagedSpeculativeServingEngine,
    ServingEngine,
    SpeculativeServingEngine,
    forward,
    init_lora,
    init_params,
    quantize4_params,
    quantize_params,
    sample_generate,
)

pytestmark = pytest.mark.cuda

CFG = LlamaConfig.tiny(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
                       vocab_size=97, max_seq_len=128, dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(device):
    cpu = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    return cpu if device.type == "cpu" else copy.deepcopy(cpu).to(device)


def _drive(cls, device, rounds=3, **kw):
    """The mixed traffic, `rounds` times over one engine. Every burst
    variant it uses (log-probs; nucleus with penalties; neither) runs at
    least three bursts, so on the card each is captured and then replayed
    at least twice. Returns (tokens, the log-prob request's log-probs,
    engine, bursts per variant)."""
    eng = cls(_params(device), CFG, n_slots=2, max_len=96, steps_per_sync=3,
              prefill_chunk=16, eos_id=7, device=device, **kw)
    variants = collections.Counter()
    launch = eng._launch_burst

    def counted(variant):
        variants[variant] += 1
        launch(variant)

    eng._launch_burst = counted
    pid = eng.register_prefix(list(range(3, 24)))
    toks, lps = [], []
    for _ in range(rounds):
        rids = [eng.submit([5], 3), eng.submit(list(range(20, 50)), 5, logprobs=True),
                eng.submit([88, 2], 17), eng.submit([3, 5], 7, prefix_id=pid),
                eng.submit([], 6, prefix_id=pid),
                eng.submit([4, 9, 2], 9, temperature=1.1, seed=3, top_p=0.9),
                eng.submit([8], 9, presence_penalty=0.5, frequency_penalty=0.3)]
        res = eng.run()
        toks += [res[r] for r in rids]
        lps.append(eng.take_logprobs(rids[1]))
    return toks, np.concatenate(lps), eng, variants


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv", "int8_kv"])
@pytest.mark.parametrize("cls", [ServingEngine, PagedServingEngine],
                         ids=["dense", "paged"])
def test_engine_tokens_on_the_card_equal_the_cpu(cuda, cls, kv_quant):
    """The card's bursts replay graphs; their tokens and log-probs are the
    CPU engine's, whose bursts are eager."""
    kw = dict(kv_quant=kv_quant, **({"block_size": 8} if cls is PagedServingEngine else {}))
    got, got_lp, eng, variants = _drive(cls, cuda, **kw)
    want, want_lp, _, _ = _drive(cls, torch.device("cpu"), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got_lp, want_lp, atol=1e-4, rtol=0)
    assert min(variants.values()) >= 3
    s = eng.stats()
    assert s["burst_graphs"] == s["eager_bursts"] == len(variants)
    assert s["graph_bursts"] == sum(variants.values()) - len(variants) > 0
    if cls is PagedServingEngine:
        eng.unregister_prefix(0)
        assert eng.free_blocks == eng.stats()["total_blocks"]


def test_engine_defaults_to_the_card(cuda):
    eng = ServingEngine(_params(cuda), CFG, n_slots=1, max_len=32)
    assert eng.device.type == "cuda" and eng.cache["k"].is_cuda
    rid = eng.submit([1, 2, 3], 4)
    assert len(eng.run()[rid]) == 4
    with pytest.raises(ValueError, match="params are on"):
        ServingEngine(_params(torch.device("cpu")), CFG)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_forward_on_the_card_matches_the_cpu(cuda, precision):
    def quantized(device):
        p = _params(device)
        return quantize_params(p) if precision == "int8" else quantize4_params(p, 32)

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (2, 16)))
    with torch.inference_mode():
        got = forward(quantized(cuda), toks.to(cuda), CFG).cpu()
        want = forward(quantized(torch.device("cpu")), toks, CFG)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_sample_generate_on_the_card_equals_the_cpu(cuda):
    prompt = torch.tensor([[4, 9, 2], [30, 1, 7]], dtype=torch.int32)
    kw = dict(max_new_tokens=8, temperature=1.2, top_k=20, top_p=0.9)
    got = sample_generate(_params(cuda), prompt, 5, CFG, **kw).cpu()
    want = sample_generate(_params(torch.device("cpu")), prompt, 5, CFG, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cls", [ServingEngine, PagedServingEngine], ids=["dense", "paged"])
def test_burst_makes_no_host_sync(cuda, cls):
    """A whole burst, every branch on (log-probs, nucleus, penalties, eos,
    int8 KV), runs with host syncs made errors: eagerly, and replayed from
    the engine's graph of that variant before its one copy to the host."""
    kw = {"block_size": 8} if cls is PagedServingEngine else {}
    eng = cls(_params(cuda), CFG, n_slots=2, max_len=64, steps_per_sync=4,
              kv_quant=True, **kw)
    eng.submit([4, 9, 2], 30, temperature=1.1, seed=3, top_p=0.9, logprobs=True)
    eng.submit([8], 30, presence_penalty=0.5)
    eng.step()
    counts = torch.zeros((2, CFG.vocab_size), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = serving._burst(eng._step_fn(), eng.pos, eng.last_tok, eng.remaining,
                                 eng.active, eng.temp, eng.keys, 4, 7, True, eng.top_p,
                                 (eng.presence, eng.frequency, counts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[4].shape == (4, 2) and int(counts.sum()) > 0
    variant = (True, True, True)  # step() ran it eagerly: this captures it
    with torch.inference_mode():
        eng._launch_burst(variant)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            eng._launch_burst(variant)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s = eng.stats()
    assert s["graph_bursts"] == 2 and s["eager_bursts"] == s["burst_graphs"] == 1


@pytest.mark.parametrize("cls", [ServingEngine, PagedServingEngine], ids=["dense", "paged"])
def test_cancel_and_admit_between_replays(cuda, cls):
    """A request cancelled, and a queued one admitted into its slot,
    between two replays of the burst's graph: every request's tokens are
    the CPU engine's under the same schedule."""
    def drive(device):
        kw = {"block_size": 8} if cls is PagedServingEngine else {}
        eng = cls(_params(device), CFG, n_slots=2, max_len=64, steps_per_sync=3,
                  device=device, **kw)
        rids = [eng.submit([4, 9], 30), eng.submit([17, 2, 5], 30),
                eng.submit([8, 8], 12, temperature=0.8, seed=5)]
        eng.step()  # the variant's eager burst
        eng.step()  # its capture, replayed
        assert eng.cancel(rids[0])
        eng.step()  # rids[2] takes slot 0; a replay
        res = eng.run()
        if cls is PagedServingEngine:
            assert eng.free_blocks == eng.stats()["total_blocks"]
        return [res[r] for r in rids], eng.stats()

    got, s = drive(cuda)
    want, _ = drive(torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < len(got[0]) < 30 and [len(g) for g in got[1:]] == [30, 12]
    assert s["eager_bursts"] == s["burst_graphs"] == 1 and s["graph_bursts"] >= 3


MOE = LlamaConfig.tiny(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
                       vocab_size=97, max_seq_len=128, n_experts=4, dtype="bfloat16")


def test_moe_bf16_graph_bursts_equal_eager_bursts(cuda):
    """The benchmark's kind of model (bf16, dense MoE dispatch): bursts
    replayed from graphs give the eager bursts' tokens and log-probs bit
    for bit, as they launch the same kernels in the same order."""
    cpu = init_params(MOE, torch.Generator().manual_seed(0), device="cpu")

    def drive(graphed):
        eng = ServingEngine(copy.deepcopy(cpu).to(cuda), MOE, n_slots=4, max_len=96,
                            steps_per_sync=4, device=cuda)
        eng._graphed = graphed
        rids = [eng.submit(list(range(1 + i, 9 + 3 * i)), 20, logprobs=i % 2 == 0)
                for i in range(6)]
        res = eng.run()
        return [res[r] for r in rids], [eng.take_logprobs(r) for r in rids[::2]], eng.stats()

    got, got_lp, s = drive(True)
    want, want_lp, eager = drive(False)
    for g, w in zip(got + got_lp, want + want_lp):
        np.testing.assert_array_equal(g, w)
    assert s["graph_bursts"] > 0 and eager["graph_bursts"] == 0


DRAFT = LlamaConfig.tiny(n_layers=1, dim=32, hidden_dim=64, n_heads=2, n_kv_heads=2,
                         vocab_size=97, max_seq_len=128, dtype="float32")


def _draft(device):
    cpu = init_params(DRAFT, torch.Generator().manual_seed(3), device="cpu")
    return cpu if device.type == "cpu" else copy.deepcopy(cpu).to(device)


def _spec(cls, device, **kw):
    if cls is PagedSpeculativeServingEngine:
        kw["block_size"] = 8
    return cls(_params(device), CFG, draft_params=_draft(device), draft_cfg=DRAFT,
               gamma=4, device=device, **kw)


@pytest.mark.parametrize("cls", [SpeculativeServingEngine, PagedSpeculativeServingEngine],
                         ids=["dense", "paged"])
def test_spec_end_of_cache_writes_on_the_card(cuda, cls):
    """prompt + max_new_tokens == max_len with gamma = 4: the chunks and
    draft steps that reach past the end land in the scratch column or the
    trash block (no device-side assert); tokens equal the CPU's, greedy and
    sampled."""
    def drive(device):
        eng = _spec(cls, device, n_slots=2, max_len=32, steps_per_sync=2)
        rids = [eng.submit(list(range(1, 21)), 12), eng.submit([3, 4], 30),
                eng.submit([5, 6, 7], 29, temperature=0.9, seed=4)]
        res = eng.run()
        return [res[r] for r in rids], eng

    got, eng = drive(cuda)
    torch.cuda.synchronize()
    want, _ = drive(torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [len(g) for g in got] == [12, 30, 29]
    assert eng.stats()["graph_bursts"] == 0  # the speculative loop stays eager
    if cls is PagedSpeculativeServingEngine:
        assert eng.free_blocks == eng.stats()["total_blocks"]


def test_spec_burst_makes_no_host_sync(cuda):
    """A speculative burst with greedy and sampled slots, eos and an int8
    target cache runs with host syncs made errors."""
    eng = _spec(SpeculativeServingEngine, cuda, n_slots=2, max_len=64, steps_per_sync=3,
                kv_quant=True)
    eng.submit([4, 9, 2], 40, temperature=1.1, seed=3)
    eng.submit([8], 40)
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = spec_serving._spec_burst(
                eng._verify_fn(), eng.draft_params, eng.dcache, eng.dcfg, eng.max_len,
                eng.pos, eng.last_tok, eng.remaining, eng.active, eng.temp, eng.keys,
                3, eng.gamma, 7, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out[4].shape == (3, 2, 5) and bool(out[5].any())


def test_multi_lora_tokens_on_the_card_equal_the_cpu(cuda):
    def adapter(seed):
        tree = init_lora(torch.Generator().manual_seed(seed), CFG, rank=4, device="cpu")
        for ab in tree["layers"].values():
            ab["b"] += 0.02
        return tree

    def drive(device, quant):
        params = _params(device)
        if quant:
            params = quantize_params(params)
        eng = ServingEngine(params, CFG, n_slots=3, max_len=64, steps_per_sync=4,
                            adapters={"a": adapter(1), "b": adapter(2)}, device=device)
        pid = eng.register_prefix([9, 4, 27, 3], adapter="b")
        rids = [eng.submit([5, 9, 2], 8, adapter=ad) for ad in (None, "a", "b")]
        rids += [eng.submit([1, 2], 6, prefix_id=pid, adapter="b"),
                 eng.submit([44, 3], 6, adapter="a", temperature=1.0, seed=2)]
        res = eng.run()
        return [res[r] for r in rids], eng.stats()["graph_bursts"]

    for quant in (False, True):
        got, replays = drive(cuda, quant)
        want, _ = drive(torch.device("cpu"), quant)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert replays > 0  # the adapter ids are read in place by the graph
