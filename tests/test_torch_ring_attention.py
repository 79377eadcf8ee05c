"""The PyTorch port's sequence-parallel forward (bee_code_interpreter_fs_tpu_torch/
ops/flash_attention.py's ring step, parallel/, models/llama.py forward(mesh=))
against the JAX package on the same numpy inputs.

The JAX side runs as its own tests run it: Pallas kernels in interpret
mode, ring and Ulysses attention under shard_map on the conftest's 8
virtual CPU devices. The port lays the sp ranks on one device. The CUDA
kernel itself runs only on a card: tests/test_torch_cuda_kernels.py.
Tolerances: f32 1e-5 for one ring step and 2e-5 for the whole ring (the
same recurrence, sums in another order), 1e-4 for the f32 model; bf16 2e-2
for one step (P may round one bf16 step apart) and 0.05 in logits for the
model (the reference's own ring-vs-plain spread at `tiny`, 0.039).
"""

import dataclasses
import functools
import importlib
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from bee_code_interpreter_fs_tpu import parallel as jpar  # noqa: E402
from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.parallel.mesh import shard_map  # noqa: E402
from bee_code_interpreter_fs_tpu_torch import parallel as tpar  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import params_from_jax  # noqa: E402

jax_fa = importlib.import_module("bee_code_interpreter_fs_tpu.ops.flash_attention")
port_fa = importlib.import_module("bee_code_interpreter_fs_tpu_torch.ops.flash_attention")

STEP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
RING_TOL = 2e-5
F32_LOGIT_TOL = 1e-4
BF16_LOGIT_TOL = 0.05
SPEC = P("dp", "sp", "tp", None)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _fresh_carry(b, h, tq, d):
    return (np.zeros((b, h, tq, d), np.float32),
            np.full((b, h, tq), -1e30, np.float32),
            np.zeros((b, h, tq), np.float32))


def _port_mesh(sp):
    return tpar.make_mesh(tpar.MeshSpec((1, sp, 1, 1)), device="cpu")


# ---------------------------------------------------------------- ring step

# name: (tq, tk, q_offset, k_offset, causal, block_q, block_k)
STEP_CASES = {
    "zero_carry_diagonal": (40, 40, 0, 0, True, 16, 16),
    "past_chunk": (32, 32, 32, 0, True, 16, 16),
    "q_offset_gt_k_offset_partly_visible": (24, 32, 40, 16, True, 16, 16),
    "non_causal_future_chunk": (32, 32, 0, 32, False, 16, 16),
    "tq_tk_not_dividing_blocks": (20, 36, 40, 8, True, 16, 16),
}


def _step_jax(q, k, v, carry, dtype, **kw):
    cast = lambda a: jnp.asarray(a, getattr(jnp, dtype))  # noqa: E731
    acc, m, l = jax_fa.flash_attention_partial(
        cast(q), cast(k), cast(v), *map(jnp.asarray, carry), interpret=True, **kw)
    return _np(acc), _np(m), _np(l)


def _step_port(q, k, v, carry, dtype, **kw):
    cast = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    carry_t = [torch.from_numpy(c.copy()) for c in carry]
    out = port_fa.flash_attention_partial(cast(q), cast(k), cast(v), *carry_t, **kw)
    assert all(o is c for o, c in zip(out, carry_t))  # updated in place
    return [c.numpy() for c in carry_t]


def _finalized(acc, l):
    return acc / np.maximum(l, 1e-30)[..., None]


@pytest.mark.parametrize(
    "case,dtype",
    [(c, "float32") for c in STEP_CASES]
    + [("past_chunk", "bfloat16"), ("tq_tk_not_dividing_blocks", "bfloat16")],
)
def test_partial_matches_jax_kernel(case, dtype):
    tq, tk, q_off, k_off, causal, bq, bk = STEP_CASES[case]
    b, h, d = 2, 2, 16
    q, k, v = _normal(len(case), (b, tq, h, d), (b, tk, h, d), (b, tk, h, d))
    carry = _fresh_carry(b, h, tq, d)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, block_q=bq, block_k=bk)
    want = _step_jax(q, k, v, carry, dtype, **kw)
    got = _step_port(q, k, v, carry, dtype, **kw)
    tol = STEP_TOL[dtype]
    assert np.abs(_finalized(got[0], got[2]) - _finalized(want[0], want[2])).max() <= tol
    assert np.abs(got[1] - want[1]).max() <= tol
    if case == "zero_carry_diagonal" and dtype == "float32":
        # From a zero carry, one diagonal step is plain causal attention.
        full = port_fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
        out = _finalized(got[0], got[2]).transpose(0, 2, 1, 3)
        assert np.abs(out - full.numpy()).max() <= tol


def test_partial_two_chunk_fold_matches_jax_kernel():
    b, c, h, d = 1, 24, 2, 16
    q, k0, v0, k1, v1 = _normal(11, *[(b, c, h, d)] * 5)
    kw = dict(q_offset=c, causal=True, block_q=16, block_k=16)
    want = got = _fresh_carry(b, h, c, d)
    for k, v, k_off in ((k0, v0, 0), (k1, v1, c)):
        want = _step_jax(q, k, v, want, "float32", k_offset=k_off, **kw)
        got = _step_port(q, k, v, got, "float32", k_offset=k_off, **kw)
    assert np.abs(_finalized(got[0], got[2]) - _finalized(want[0], want[2])).max() <= 1e-5
    # Two chunks folded = causal attention over their concatenation, last rows.
    q_full = np.concatenate([np.zeros_like(q), q], axis=1)  # first c rows unused
    full = port_fa.flash_attention_reference(*(
        torch.from_numpy(np.concatenate(x, axis=1))
        for x in ((q_full,), (k0, k1), (v0, v1))))
    out = _finalized(got[0], got[2]).transpose(0, 2, 1, 3)
    assert np.abs(out - full.numpy()[:, c:]).max() <= 1e-5


def test_partial_all_future_chunk_leaves_carry_bit_exact():
    b, c, h, d = 1, 24, 2, 16
    q, k, v = _normal(12, *[(b, c, h, d)] * 3)
    carry = _step_port(q, k, v, _fresh_carry(b, h, c, d), "float32",
                       q_offset=0, k_offset=0, block_q=16, block_k=16)
    after = _step_port(q, k, v, carry, "float32", q_offset=0, k_offset=c,
                       block_q=16, block_k=16)
    for x, y in zip(carry, after):
        assert np.array_equal(x, y)


def test_partial_refuses_mismatched_carry():
    q = torch.zeros((1, 8, 2, 16))
    acc, m, l = (torch.from_numpy(x) for x in _fresh_carry(1, 2, 8, 16))
    with pytest.raises(ValueError, match="carry shapes"):
        port_fa.flash_attention_partial(q, q, q, acc[:, :, :4], m, l,
                                        q_offset=0, k_offset=0)


def test_partial_kernel_wrapper_refuses_a_carry_copy():
    q = torch.zeros((1, 8, 2, 64))
    acc = torch.zeros((1, 8, 2, 64)).transpose(1, 2)  # [b, h, tq, d], strided
    m = torch.full((1, 2, 8), -1e30)
    with pytest.raises(ValueError, match="contiguous"):
        port_fa._launch_partial_kernel(q, q, q, acc, m, m.clone(), 0, 0, 1.0, True)
    with pytest.raises(ValueError, match="float32"):
        port_fa._launch_partial_kernel(q, q, q, acc.contiguous().double(), m,
                                       m.clone(), 0, 0, 1.0, True)


# ---------------------------------------------------------------- mesh


@pytest.mark.parametrize(
    "n,kw",
    [(8, {}), (8, {"tp": 2, "sp": 2}), (8, {"tp": 2, "sp": 2, "ep": 2}),
     (1, {}), (6, {"tp": 2}), (8, {"tp": 1, "sp": 4})],
)
def test_best_mesh_shape_equals_jax(n, kw):
    assert tpar.best_mesh_shape(n, **kw).shape == jpar.best_mesh_shape(n, **kw).shape
    assert tpar.AXES == jpar.MeshSpec((1, 1, 1, 1)).axes


def test_ring_permute_matches_jax():
    from bee_code_interpreter_fs_tpu.parallel.collectives import ring_permute

    n = 4
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    mesh = jpar.make_mesh(jpar.MeshSpec((n,), ("sp",)))
    want = shard_map(partial(ring_permute, axis="sp", shift=1), mesh=mesh,
                     in_specs=P("sp"), out_specs=P("sp"))(jnp.asarray(x))
    got = tpar.ring_permute([torch.from_numpy(r[None]) for r in x])
    assert np.array_equal(torch.cat(got).numpy(), _np(want))


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize(
    "tp,sp,t,use_flash",
    [(2, 2, 64, False), (2, 2, 64, True), (2, 4, 64, False), (2, 4, 64, True),
     (2, 2, 48, True)],
)
def test_ring_attention_matches_jax(tp, sp, t, use_flash):
    b, h, d = 2, 4, 16
    q, k, v = _normal(t + sp + use_flash, *[(b, t, h, d)] * 3)
    mesh = jpar.make_mesh(jpar.best_mesh_shape(8, tp=tp, sp=sp))
    want = shard_map(
        partial(jpar.ring_attention, axis_name="sp", use_flash=use_flash,
                flash_interpret=True, flash_block=16),
        mesh=mesh, in_specs=(SPEC,) * 3, out_specs=SPEC, check_rep=False,
    )(*map(jnp.asarray, (q, k, v)))
    got = tpar.ring_attention(*map(torch.from_numpy, (q, k, v)), _port_mesh(sp),
                              use_flash=use_flash, flash_block=16)
    assert np.abs(got.numpy() - _np(want)).max() <= RING_TOL


@pytest.mark.parametrize("h_kv,use_flash", [(2, False), (2, True), (1, False)])
def test_ulysses_attention_gqa_matches_jax(h_kv, use_flash):
    b, t, h, d, sp = 2, 32, 4, 16, 2
    q, k, v = _normal(h_kv + use_flash, (b, t, h, d), (b, t, h_kv, d), (b, t, h_kv, d))
    mesh = jpar.make_mesh(jpar.MeshSpec((1, sp, 1, 1)))
    want = shard_map(
        partial(jpar.ulysses_attention, axis_name="sp", use_flash=use_flash,
                flash_interpret=True),
        mesh=mesh, in_specs=(SPEC,) * 3, out_specs=SPEC, check_rep=False,
    )(*map(jnp.asarray, (q, k, v)))
    got = tpar.ulysses_attention(*map(torch.from_numpy, (q, k, v)), _port_mesh(sp),
                                 use_flash=use_flash)
    assert np.abs(got.numpy() - _np(want)).max() <= RING_TOL


def test_ulysses_raises_as_the_reference_does():
    q = torch.zeros((1, 8, 6, 16))
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tpar.ulysses_attention(q, q[:, :, :4], q[:, :, :4], _port_mesh(2))
    with pytest.raises(ValueError, match="n_heads % axis_size"):
        tpar.ulysses_attention(q, q, q, _port_mesh(4))


# ---------------------------------------------------------------- model


@functools.lru_cache(maxsize=None)
def _sharded_models(dtype):
    """(jax mesh, sharded jax params, port module) on the same GQA weights."""
    jcfg = jl.LlamaConfig.tiny(n_kv_heads=2, dtype=dtype)
    params = jl.init_params(jax.random.PRNGKey(5), jcfg)
    mesh = jpar.make_mesh(jpar.best_mesh_shape(8, tp=2, sp=2))
    sharded = jpar.shard_pytree(mesh, params, jl.param_specs(jcfg))
    tree = jax.tree.map(np.asarray, sharded)  # np.asarray gathers the shards
    return mesh, sharded, params_from_jax(tree, LlamaConfig.tiny(n_kv_heads=2, dtype=dtype),
                                          device="cpu")


def test_params_from_jax_takes_a_sharded_tree():
    jcfg = jl.LlamaConfig.tiny(n_kv_heads=2, dtype="float32")
    unsharded = params_from_jax(
        jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(5), jcfg)),
        LlamaConfig.tiny(n_kv_heads=2, dtype="float32"), device="cpu")
    _, sharded, model = _sharded_models("float32")
    assert len(sharded["layers"]["wq"].sharding.device_set) == 8
    for (name, a), (_, b) in zip(model.named_parameters(), unsharded.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "sp_impl,attn_impl",
    [("ring", "plain"), ("ring", "flash"), ("ulysses", "plain"), ("ulysses", "flash")],
)
def test_forward_mesh_matches_jax(sp_impl, attn_impl, dtype):
    jmesh, sharded, model = _sharded_models(dtype)
    over = dict(n_kv_heads=2, dtype=dtype, sp_impl=sp_impl, attn_impl=attn_impl)
    jcfg, tcfg = jl.LlamaConfig.tiny(**over), LlamaConfig.tiny(**over)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(np.int32)
    want = jax.jit(lambda p, t: jl.forward(p, t, jcfg, mesh=jmesh))(sharded, tokens)
    got = tl.forward(model, torch.from_numpy(tokens), tcfg, mesh=_port_mesh(2))
    tol = F32_LOGIT_TOL if dtype == "float32" else BF16_LOGIT_TOL
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - _np(want)).max() <= tol


def test_forward_sp1_mesh_is_the_single_device_forward():
    _, _, model = _sharded_models("float32")
    cfg = LlamaConfig.tiny(n_kv_heads=2, dtype="float32", attn_impl="flash")
    tokens = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    assert torch.equal(tl.forward(model, tokens, cfg, mesh=_port_mesh(1)),
                       tl.forward(model, tokens, cfg))


def test_forward_mesh_raises_as_the_reference_does():
    _, _, model = _sharded_models("float32")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    base = LlamaConfig.tiny(n_kv_heads=2, dtype="float32")
    with pytest.raises(ValueError, match="sliding_window"):
        tl.forward(model, tokens, dataclasses.replace(base, sliding_window=4),
                   mesh=_port_mesh(2))
    with pytest.raises(ValueError, match="sp_impl"):
        tl.forward(model, tokens, dataclasses.replace(base, sp_impl="striped"),
                   mesh=_port_mesh(2))
    for spec in (tpar.best_mesh_shape(8, tp=2, sp=2), tpar.MeshSpec((2, 2, 1, 1)),
                 tpar.MeshSpec((4,), ("pp",))):
        with pytest.raises(NotImplementedError, match="torch.distributed"):
            tpar.make_mesh(spec, device="cpu")
