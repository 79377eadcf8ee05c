"""The architecture seam (arch/__init__.py): a configuration reaches the
harness only through the module its "arch" key names. A second,
test-only architecture (second_arch/, found through `look_in`) runs a
score cell and a serve cell to `correct`, and the kernel pattern it
declares reaches both drivers' traced slices; one that declares none runs
them too. The llama module's FLOP counts and K1 launch list are pinned at
the published sizes."""

from __future__ import annotations

from contextlib import contextmanager

import pytest

from tiny import BENCH, TESTS, run_tiny

from pb_core import spec  # noqa: E402
from pb_core.trace import Tracer  # noqa: E402

SEED = 2**31 + 6131
SECOND = TESTS / "second_arch"


def _second_bench() -> dict:
    bench = dict(spec.load_benchmark())
    file = (SECOND / "configs" / "toy-moe.json").relative_to(BENCH.parent)
    bench["configs"] = [{"name": "toy-moe", "source": "test-only", "file": str(file),
                         "reduced": [], "why": "a second architecture"}]
    bench["workloads"] = [
        {"name": f"toy-moe.{mix}", "config": "toy-moe", "traffic": mix, "chips": 1,
         "why": "a second architecture"} for mix in ("score-long", "serve-batch")]
    return bench


@pytest.mark.parametrize("cell", ["toy-moe.score-long", "toy-moe.serve-batch"])
def test_second_architecture_runs_correct(cell):
    bench = _second_bench()
    conf = spec.config(bench, "toy-moe")
    assert "rope_theta" not in conf and "num_local_experts" not in conf
    assert conf["num_experts"] == 4
    cfg = spec.arch(conf, (SECOND,)).port_config(conf)
    assert (cfg.n_experts, cfg.n_experts_per_token, cfg.rope_theta) == (4, 2, 500000.0)
    result, _, _, _ = run_tiny(cell, SEED, bench=bench, look_in=(SECOND,))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", ["toy-moe.score-long", "toy-moe.serve-batch"])
@pytest.mark.parametrize("arch,declared", [("toy_moe", {"toy_attn": "toy_attention<"}),
                                           ("toy_moe_bare", {})],
                         ids=["declares-a-kernel", "declares-none"])
def test_both_drivers_trace_what_the_architecture_declares(monkeypatch, cell, arch, declared):
    seen = []

    @contextmanager
    def spy(self, kernel_patterns=None):
        seen.append(kernel_patterns)
        yield

    monkeypatch.setattr(Tracer, "slice", spy)
    result, _, _, rec = run_tiny(cell, SEED, trace=True, bench=_second_bench(),
                                 look_in=(SECOND,), arch=arch)
    assert seen == [declared]
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    sliced = rec["slice"]
    if cell.endswith("score-long"):
        assert len(sliced["documents"]) == 3 and min(sliced["documents"]) >= 24
        return
    # The CPU captures no graph: every burst runs eagerly, and the counters'
    # deltas agree with the bursts the harness timed.
    assert sliced["admits"] and sliced["bursts"]
    assert sliced["stats"]["eager_bursts"] == len(sliced["bursts"])
    assert sliced["stats"]["graph_bursts"] == 0
    assert all(steps == 4 and 0 < active <= 6 for active, steps in sliced["bursts"])
    window = rec["stats_window"]
    assert window["eager_bursts"] + window["graph_bursts"] == len(rec["burst_ms"]) > 0


def test_an_architecture_gets_the_optional_entries_defaults():
    module = spec.arch({"arch": "toy_moe_bare"}, (SECOND,))
    assert module.kernels(None) == {}
    assert module.kernel_work(None, "k1", {"documents": [10]}) is None


def test_a_configuration_without_arch_is_refused():
    with pytest.raises(SystemExit, match='"arch"'):
        spec.arch({"name": "mistral-7b", "hidden_size": 4096})


# The llama module's counts at the published sizes, as exact integers
# (plain integer arithmetic: nothing here can drift with torch).
FLOPS = {
    "mistral-7b": {
        "score": {1: 13959168000, 4096: 62647204577280, 10000: 159285478686720,
                  16384: 263780523048960},
        "prefill": {1: 14221312000, 64: 894705860608, 1024: 14569059647488,
                    2048: 29687612964864},
        "decode": {1: 14221312000, 1000: 14745075712, 4096: 16368271360,
                   9000: 16368271360},
    },
    "mixtral-8x7b": {
        "score": {1: 12617777152, 4096: 54954381279232, 10000: 141904838656000,
                  16384: 246206590615552},
        "prefill": {1: 12879921152, 64: 808328364032, 1024: 13058170683392,
                    2048: 26390957129728},
        "decode": {1: 12879921152, 1000: 13141803008, 4096: 13953400832,
                   9000: 15238955008},
    },
}
K1 = {"mistral-7b": (32, (32, 128, 2, 4096, 0)), "mixtral-8x7b": (16, (32, 128, 2, 0, 0))}


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_llama_counts_at_published_sizes(config):
    bench = spec.load_benchmark()
    conf = spec.config(bench, config)
    arch = spec.arch(conf)
    fns = {"score": arch.score_flops, "prefill": arch.prefill_flops,
           "decode": arch.decode_flops}
    for kind, want in FLOPS[config].items():
        assert {n: fns[kind](conf, n) for n in want} == want, kind
    layers, shape = K1[config]
    cfg = arch.port_config(conf)
    for t in (4096, 9731, 16384):
        assert arch.k1_launches(cfg, t) == [(1, t, *shape)] * layers
