"""The port's paged engine (bee_code_interpreter_fs_tpu_torch/models/paged.py):
its gathered logical cache held to the dense engine's cache rows step by
step, its tokens to the dense engine's, and its block pool (recycling,
exhaustion, reservations, shared prefix blocks, copy-on-write frontiers,
unregister guards) checked as the JAX package's tests/unit/test_paged.py
checks the reference. Greedy tokens are also held to the port's
greedy_generate; both engines are held to the JAX engine in
test_torch_serving.py. Same tiny config and weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.paged import PagedServingEngine  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.serving import ServingEngine  # noqa: E402

FIXTURE = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
               vocab_size=97, max_seq_len=128, dtype="float32")


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(**FIXTURE)
    cfg = LlamaConfig.tiny(**FIXTURE)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu"), cfg


def _reference(params, cfg, prompt, max_new):
    out = tl.greedy_generate(params, torch.tensor([prompt], dtype=torch.int32), cfg,
                             max_new_tokens=max_new)
    return out[0, len(prompt):].numpy()


def _engine(cls, params, cfg, **kw):
    return cls(params, cfg, device="cpu", **kw)


def _logical(eng, slot, name):
    """Slot `slot`'s pool leaf `name` gathered through its block table."""
    leaf = eng.pool[name]
    return leaf[:, eng.tables[slot]].reshape(leaf.shape[0], -1, *leaf.shape[3:])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv", "int8_kv"])
def test_logical_cache_equals_dense_rows_step_by_step(model, kv_quant):
    """Both engines driven in lockstep over traffic with a shared prefix:
    after every sync, each occupied slot's gathered logical cache equals
    the dense engine's row over the positions the request has written."""
    params, cfg = model
    kw = dict(n_slots=2, max_len=64, steps_per_sync=3, kv_quant=kv_quant)
    dense = _engine(ServingEngine, params, cfg, **kw)
    paged = _engine(PagedServingEngine, params, cfg, block_size=8, **kw)
    sysp = list(range(40, 53))  # plen 13: 1 shared block + 5 copy-on-write
    for eng in (dense, paged):
        pid = eng.register_prefix(sysp)
        eng.submit([4, 9, 2, 40, 7], 9)
        eng.submit([1, 2], 12, prefix_id=pid)
        eng.submit([], 6, prefix_id=pid)
        eng.submit([60] * 20, 5, temperature=1.1, seed=4)
    names = ("kq", "ks", "vq", "vs") if kv_quant else ("k", "v")
    checked = 0
    while dense._queue or any(r is not None for r in dense._slot_req):
        dense.step()
        paged.step()
        for i, req in enumerate(dense._slot_req):
            preq = paged._slot_req[i]
            assert (req is None) == (preq is None)
            if req is None:
                continue
            assert preq.generated == req.generated
            written = int(dense.pos[i])
            assert int(paged.pos[i]) == written
            for name in names:
                got = _logical(paged, i, name)[:, :written]
                want = dense.cache[name][:, i, :written]
                torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
            checked += 1
    assert checked >= 6
    assert paged.stats()["shared_prefix_blocks"] == 1


def test_paged_tokens_equal_dense_with_eos_sampling_and_logprobs(model):
    params, cfg = model

    def drive(cls, **kw):
        eng = _engine(cls, params, cfg, n_slots=3, max_len=64, steps_per_sync=4,
                      eos_id=7, **kw)
        rids = [eng.submit([3, 9, 27], 10, logprobs=True),
                eng.submit([3, 9, 27], 10, temperature=1.1, seed=5, logprobs=True),
                eng.submit([50, 60], 12, temperature=0.8, seed=6, top_p=0.7)]
        res = eng.run()
        return [(res[r], eng.take_logprobs(r)) for r in rids]

    for (dt, dlp), (pt, plp) in zip(drive(ServingEngine),
                                    drive(PagedServingEngine, block_size=4)):
        np.testing.assert_array_equal(dt, pt)
        if dlp is not None:
            np.testing.assert_allclose(dlp, plp, atol=1e-5, rtol=0)


def test_staggered_and_chunked_traffic_matches_greedy(model):
    params, cfg = model
    reqs = [([5], 3), ([1, 2, 3, 4, 5, 6, 7], 9), (list(range(20, 50)), 5),
            ([88, 2], 17), ([11] * 17, 6), (list(range(2, 60)), 6)]
    eng = _engine(PagedServingEngine, params, cfg, n_slots=2, max_len=128,
                  steps_per_sync=3, block_size=8, prefill_chunk=16)
    rids = [eng.submit(p, m) for p, m in reqs]
    res = eng.run()
    for rid, (p, m) in zip(rids, reqs):
        np.testing.assert_array_equal(res[rid], _reference(params, cfg, p, m))


def test_blocks_recycle_queue_and_return(model):
    """A pool for about one request at a time completes many (admission
    waits for retirements); every block returns, including those of a
    request done at admission and of a cancelled one."""
    params, cfg = model
    eng = _engine(PagedServingEngine, params, cfg, n_slots=3, max_len=64,
                  block_size=8, n_blocks=8, steps_per_sync=4)
    total = eng.free_blocks
    reqs = [(list(range(1, 10)), 12), ([60, 61], 20), ([7] * 30, 10), ([2, 4, 6], 8),
            ([4, 8], 1)]
    rids = [eng.submit(p, m) for p, m in reqs]
    res = eng.run()
    for rid, (p, m) in zip(rids, reqs):
        np.testing.assert_array_equal(res[rid], _reference(params, cfg, p, m))
    assert eng.free_blocks == total
    rid = eng.submit([3] * 20, 30)
    eng.step()
    assert eng.free_blocks < total
    assert eng.cancel(rid) is True
    assert eng.free_blocks == total
    assert eng.run()[rid].size >= 1


def test_prefix_blocks_shared_across_requests(model):
    """Three requests sharing a prefix occupy 2 shared + 3 x 3 private
    blocks (per-request copies would not fit the pool); their tables point
    at the same physical prefix blocks; tokens stay exact; shared blocks
    stay pinned until unregister, which an active user refuses."""
    params, cfg = model
    sysp = list(range(1, 11))  # plen 10, bs 4: 2 shared blocks + rem 2
    eng = _engine(PagedServingEngine, params, cfg, n_slots=3, max_len=64,
                  block_size=4, n_blocks=16, steps_per_sync=3)
    pid = eng.register_prefix(sysp)
    free0 = eng.free_blocks
    suffixes = [[20, 21], [30, 31], [40, 41]]
    rids = [eng.submit(s, 8, prefix_id=pid) for s in suffixes]
    eng.step()
    s = eng.stats()
    assert s["shared_prefix_blocks"] == 2 and s["occupied_slots"] == 3
    assert free0 - eng.free_blocks == 2 + 3 * 3
    tables = eng.tables.numpy()
    for row in range(3):
        np.testing.assert_array_equal(tables[row, :2], eng._prefixes[pid]["pool_blocks"])
    with pytest.raises(ValueError, match="active slot"):
        eng.unregister_prefix(pid)
    res = eng.run()
    for rid, sfx in zip(rids, suffixes):
        np.testing.assert_array_equal(res[rid], _reference(params, cfg, sysp + sfx, 8))
    assert eng.free_blocks == free0 - 2
    eng.unregister_prefix(pid)
    assert eng.free_blocks == free0 == eng.stats()["total_blocks"]
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1], 2, prefix_id=pid)


@pytest.mark.parametrize("plen", [8, 10], ids=["aligned", "copy_on_write"])
def test_prefix_only_sharers_and_aligned_prefix(model, plen):
    params, cfg = model
    sysp = [3] * plen
    eng = _engine(PagedServingEngine, params, cfg, n_slots=2, max_len=64,
                  block_size=4, steps_per_sync=4)
    pid = eng.register_prefix(sysp)
    r1 = eng.submit([], 6, prefix_id=pid)
    r2 = eng.submit([], 6, prefix_id=pid)
    r3 = eng.submit([9, 8, 7], 5, prefix_id=pid)
    res = eng.run()
    want = _reference(params, cfg, sysp, 6)
    np.testing.assert_array_equal(res[r1], want)
    np.testing.assert_array_equal(res[r2], want)
    np.testing.assert_array_equal(res[r3], _reference(params, cfg, sysp + [9, 8, 7], 5))


def test_int8_pool_equals_dense_int8_at_half_the_bytes(model):
    params, cfg = model
    sysp = list(range(5, 18))  # plen 13: 1 shared block (bs 8) + rem 5

    def drive(cls, **kw):
        eng = _engine(cls, params, cfg, n_slots=2, max_len=96, steps_per_sync=3,
                      kv_quant=True, **kw)
        pid = eng.register_prefix(sysp)
        rids = [eng.submit(list(range(1, 20)), 8), eng.submit([40, 2], 7, prefix_id=pid),
                eng.submit([], 6, prefix_id=pid),
                eng.submit([8, 3], 6, temperature=1.0, seed=2)]
        res = eng.run()
        return eng, [res[r] for r in rids]

    _, dense_out = drive(ServingEngine)
    pe, paged_out = drive(PagedServingEngine, block_size=8)
    for d, p in zip(dense_out, paged_out):
        np.testing.assert_array_equal(d, p)
    full = _engine(PagedServingEngine, params, cfg, n_slots=2, max_len=96, block_size=8)

    def nbytes(pool):
        return sum(v.numel() * v.element_size() for v in pool.values())

    assert nbytes(pe.pool) < 0.6 * nbytes(full.pool)
