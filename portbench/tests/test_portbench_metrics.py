"""The yardstick's arithmetic: the window-aware pair count, K1's work, the
active-expert FLOP count, the idle union on a synthetic trace, the
percentiles, and the metric readers on a synthetic record."""

from __future__ import annotations

import types

import pytest

from tiny import BENCH  # noqa: F401  (puts the benchmark on sys.path)

from pb_core import spec, stats, trace  # noqa: E402
from roofline import flash_attention_k1 as k1  # noqa: E402
from roofline import model  # noqa: E402


def _pairs_loop(t, window=0, sinks=0):
    """chip_smoke.py's causal_pairs, as it counts them."""
    total = 0
    for q in range(t):
        lo = max(q - window + 1, 0) if window > 0 else 0
        total += q - lo + 1 + (min(sinks, lo) if window > 0 else 0)
    return total


@pytest.mark.parametrize("t,window,sinks", [
    (1, 0, 0), (100, 0, 0), (100, 16, 0), (100, 16, 4), (4096, 4096, 0),
    (5000, 4096, 0), (16384, 4096, 0), (300, 64, 100), (64, 128, 0)])
def test_pairs_match_the_loop(t, window, sinks):
    assert k1.causal_pairs(t, window, sinks) == _pairs_loop(t, window, sinks)


def test_k1_work_and_bound():
    flops, nbytes = k1.launch_work(1, 8192, 32, 128, 2, window=4096)
    pairs = 4096 * 4097 // 2 + 4096 * 4096
    assert flops == 4 * 32 * 128 * pairs
    assert nbytes == 4 * 8192 * 32 * 128 * 2
    pk = {"bf16_flops": 1e15, "hbm_bytes_per_s": 1e12}
    assert k1.bound_s(flops, nbytes, pk) == max(flops / 1e15, nbytes / 1e12)


def _conf(name):
    return spec.config(spec.load_benchmark(), name)


def test_model_flops_count_active_experts():
    mix = _conf("mixtral-8x7b")
    dense_mlp = 3 * 4096 * 14336
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    assert model.body_params(mix) == 16 * (attn + 2 * dense_mlp + 4096 * 8)
    mis = _conf("mistral-7b")
    assert model.body_params(mis) == 32 * (attn + dense_mlp)
    # Decoding at context c: the body, the head, and c visible keys.
    c = 1000
    want = 2 * (model.body_params(mis) + 4096 * 32000) + 4 * 128 * 32 * 32 * c
    assert model.decode_flops(mis, c) == want
    # The window caps a decode step's keys and a document's pairs.
    assert model.decode_flops(mis, 9000) == model.decode_flops(mis, 4096)
    t = 10000
    assert model.score_flops(mis, t) == (
        2 * (t * model.body_params(mis) + (t - 1) * 4096 * 32000)
        + 4 * 128 * 32 * 32 * k1.causal_pairs(t, 4096))
    assert model.prefill_flops(mix, 10) == (
        2 * (10 * model.body_params(mix) + 4096 * 32000) + 4 * 128 * 32 * 16 * 55)


def test_idle_union_on_a_synthetic_trace():
    ms = 1_000_000
    device = [(10 * ms, 30 * ms, "void gemm<1>(int)"),
              (20 * ms, 40 * ms, "void flash_fwd_bf16<128, false>(Params)"),  # overlaps
              (60 * ms, 70 * ms, "void gemm<1>(int)"),
              (95 * ms, 120 * ms, "void late<2>()")]  # crosses the end
    host = [(0, 100 * ms, "portbench.step"), (40 * ms, 60 * ms, "portbench.admit"),
            (45 * ms, 55 * ms, "aten::copy_")]
    s = trace.summarize(device, host, (0, 100 * ms),
                        {"k1": k1.KERNEL_NAME})
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.045)  # 10..40, 60..70, 95..100
    assert s["device_ops"][0] == ["gemm<1>", pytest.approx(0.03)]
    gaps = {name: sec for name, sec in s["idle_gaps"]}
    assert s["idle_gaps"][0][1] == pytest.approx(0.025)  # 70..95
    assert gaps["portbench.admit"] == pytest.approx(0.02)  # 40..60, no op at 40
    assert gaps["portbench.step"] == pytest.approx(0.01)  # 0..10
    assert s["kernels"]["k1"] == [(pytest.approx(0.02), pytest.approx(0.02))]


def test_percentiles():
    assert stats.percentile([], 0.9) is None
    assert stats.percentile([5], 0.9) == 5
    assert stats.percentile(list(range(11)), 0.9) == pytest.approx(9.0)
    assert stats.percentile([1, 2, 3, 4], 0.5) == pytest.approx(2.5)


CARD = "NVIDIA H100 80GB HBM3"


def _ctx(summary=None, card=CARD):
    return types.SimpleNamespace(
        torch=types.SimpleNamespace(cuda=types.SimpleNamespace(get_device_name=lambda d: card)),
        device=types.SimpleNamespace(type="cuda" if card else "cpu"),
        tracer=types.SimpleNamespace(summary=summary))


def test_readers_on_a_synthetic_record():
    rec = {"window_s": 10.0, "scored_tokens": 250000, "output_tokens": 9000,
           "model_flops": 989e12 * 10 * 0.4, "tpot_ms": list(range(1, 101)),
           "burst_ms": [400.0, 320.0, 360.0], "steps_per_sync": 8, "occupancy": [0.5, 1.0],
           "setup_s": 12.5}
    ctx = _ctx({"window_s": 2.0, "busy_s": 1.5, "kernels": {}})
    read = lambda name: spec.reader(name).read(rec, ctx)  # noqa: E731
    assert read("scored_tokens_per_s") == 25000
    assert read("output_tokens_per_s") == 900
    assert read("mfu.score") == pytest.approx(40.0)
    assert read("mfu.serve") == pytest.approx(40.0)
    assert read("tpot_p90_ms") == pytest.approx(90.1)
    assert read("decode_step_ms") == 45.0
    assert read("slot_occupancy_pct") == 75.0
    assert read("device_idle_pct.score") == pytest.approx(25.0)
    assert read("device_idle_pct.serve") == pytest.approx(25.0)
    assert read("setup_s") == 12.5
    # Nothing to read: no value, never 0.
    assert spec.reader("k1_roofline").read(rec, ctx) is None
    assert spec.reader("device_idle_pct.score").read(rec, _ctx(None)) is None
    # A CPU run has no peak; a card the table lacks is refused, not guessed.
    assert read_on("mfu.score", rec, _ctx(card=None)) is None
    with pytest.raises(ValueError, match="no published peaks"):
        read_on("mfu.serve", rec, _ctx(card="NVIDIA H200"))


def read_on(name, rec, ctx):
    return spec.reader(name).read(rec, ctx)


def test_k1_roofline_pairs_launches_with_kernels():
    shape = (1, 8192, 32, 128, 2, 4096, 0)
    rec = {"k1_slice_launches": [shape, shape]}
    pk = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    least = k1.bound_s(*k1.launch_work(*shape), pk)
    ctx = _ctx({"kernels": {"k1": [(0.0, least * 2), (1.0, least * 2)]}})
    assert spec.reader("k1_roofline").read(rec, ctx) == pytest.approx(50.0)
    ctx = _ctx({"kernels": {"k1": [(0.0, least)]}})  # counts differ
    assert spec.reader("k1_roofline").read(rec, ctx) is None


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(spec.reader(m["name"]), "read"), m["name"]
    for cell in bench["workloads"]:
        mix = spec.mix(cell["traffic"])
        assert hasattr(spec.driver(mix["driver"]), "run")
        assert spec.limits(cell["name"])
        names = {m["name"] for m in spec.metrics_of(bench, cell["name"], False)}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_of(bench, cell["name"], True)


def test_kernel_names_keep_their_namespace():
    assert trace.short_name("void (anonymous namespace)::flash_fwd_bf16<128, false>"
                            "(Params, CUtensorMap)") == "(anon)::flash_fwd_bf16<128, false>"
    assert trace.short_name("void at::native::elementwise_kernel<128, 4>(int, F)") == \
        "at::native::elementwise_kernel<128, 4>"
