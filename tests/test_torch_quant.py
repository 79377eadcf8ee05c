"""The port's quantizers (bee_code_interpreter_fs_tpu_torch/models/quant.py)
against the JAX package's models/quant.py, and the quantized model path.

The quantizers are held bit for bit (same f32 scale math, round half to
even); the int4 unpack's int8 shifts are checked over every byte. The
quantized tiny forward is held to JAX's within 1e-5 in f32 (the same
dequantized weights, another summation order).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bee_code_interpreter_fs_tpu.models import llama as jl  # noqa: E402
from bee_code_interpreter_fs_tpu.models import quant as jq  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import llama as tl  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models import quant as tq  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.config import LlamaConfig  # noqa: E402
from bee_code_interpreter_fs_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    to_torch,
)

FIXTURE = dict(n_layers=2, dim=64, hidden_dim=128, n_heads=4, n_kv_heads=2,
               vocab_size=97, max_seq_len=128, dtype="float32")


def _weights(shape, dtype="float32", seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output column: the 1e-12 scale floor
    return w if dtype == "float32" else np.asarray(jnp.asarray(w, jnp.bfloat16))


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
        want = want.view(np.int16)
    return got.dtype.itemsize == want.dtype.itemsize and np.array_equal(
        got.numpy().view(f"u{want.dtype.itemsize}"),
        np.ascontiguousarray(want).view(f"u{want.dtype.itemsize}"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 32), (2, 48, 40)])
def test_int8_quantizer_bit_equal_to_jax(shape, dtype):
    w = _weights(shape, dtype, seed=1)
    want = jq.quantize_int8(jnp.asarray(w))
    got = tq.quantize_int8(to_torch(w))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    assert _same_bits(got.q, want["q"]) and _same_bits(got.s, want["s"])
    for out_dtype in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
        assert _same_bits(tq.dequantize(got, out_dtype), jq.dequantize(want, jdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", [((64, 24), 32), ((2, 64, 24), 128),
                                         ((256, 16), 128)])
def test_int4_quantizer_bit_equal_to_jax(shape, group, dtype):
    w = _weights(shape, dtype, seed=2)
    want = jq.quantize_int4(jnp.asarray(w), group)
    got = tq.quantize_int4(to_torch(w), group)
    assert got.q4.dtype == torch.int8 and tuple(got.q4.shape) == want["q4"].shape
    assert _same_bits(got.q4, want["q4"]) and _same_bits(got.s4, want["s4"])
    for out_dtype in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
        assert _same_bits(tq.dequantize4(got, out_dtype), jq.dequantize4(want, jdt))


def test_int4_rejects_a_group_that_does_not_divide():
    for quantize, w in ((jq.quantize_int4, jnp.zeros((48, 8))),
                        (tq.quantize_int4, torch.zeros(48, 8))):
        with pytest.raises(ValueError, match="even group"):
            quantize(w, 32)


def test_int8_nibble_shifts_equal_jax_over_every_byte():
    """The int4 unpack's sign extension: int8 << wraps into the sign bit and
    >> is arithmetic, in torch as in XLA."""
    every = np.arange(-128, 128, dtype=np.int8)
    jx = jnp.asarray(every)
    tx = torch.from_numpy(every.copy())
    assert np.array_equal(((tx << 4) >> 4).numpy(), np.asarray((jx << 4).astype(jnp.int8) >> 4))
    assert np.array_equal((tx >> 4).numpy(), np.asarray(jx >> 4))
    assert np.array_equal((tx & 0x0F).numpy(), np.asarray(jx & 0x0F))
    lo, hi = tx & 0x0F, tx.flip(0) & 0x0F
    assert np.array_equal((lo | (hi << 4)).to(torch.int8).numpy(),
                          np.asarray(((jx & 0x0F) | ((jx[::-1] & 0x0F) << 4)).astype(jnp.int8)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantizer_bit_equal_to_jax(dtype):
    x = _weights((2, 9, 2, 16), dtype, seed=3)
    jqk, jsk = jq.quantize_kv(jnp.asarray(x))
    q, s = tq.quantize_kv(to_torch(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == (2, 9, 2, 1)
    assert _same_bits(q, jqk) and _same_bits(s, jsk)
    tdt = getattr(torch, dtype)
    assert _same_bits(tq.dequantize_kv(q, s, tdt),
                      jq.dequantize_kv(jqk, jsk, getattr(jnp, dtype)))


@functools.lru_cache(maxsize=None)
def _trees():
    jcfg = jl.LlamaConfig.tiny(**FIXTURE)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, LlamaConfig.tiny(**FIXTURE), jparams


def _quantize_jax(jparams, precision):
    if precision == "int8":
        return jq.quantize_params(jparams)
    return jq.quantize4_params(jparams, group=32)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantized_forward_matches_jax(precision):
    jcfg, tcfg, jparams = _trees()
    jtree = _quantize_jax(jparams, precision)
    model = params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, device="cpu")
    leaf = model.layers[1].w_down
    assert (tq.is_quantized if precision == "int8" else tq.is_quantized4)(leaf)
    toks = np.random.default_rng(4).integers(0, 97, (2, 16)).astype(np.int32)
    want = np.asarray(jl.forward(jtree, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        got = tl.forward(model, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The port's own quantize_params gives the same leaves from the dense
    # weights, and its cached decode path agrees with its forward.
    dense = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    mine = (tq.quantize_params(dense) if precision == "int8"
            else tq.quantize4_params(dense, group=32))
    for a, b in zip(mine.buffers(), model.buffers()):
        assert torch.equal(a, b)
    assert mine.embed is dense.embed  # unquantized leaves are shared
    assert torch.is_tensor(dense.layers[0].wq)  # the source stays dense
    with torch.no_grad():
        cache = tl.init_cache(tcfg, 2, 16, device="cpu")
        last, _ = tl.prefill(mine, torch.from_numpy(toks), cache, tcfg)
    np.testing.assert_allclose(last.numpy(), want[:, -1], atol=1e-5, rtol=0)


def test_quantized_nbytes_and_random_params_match_jax():
    jcfg, tcfg, jparams = _trees()
    for precision in ("int8", "int4"):
        jtree = (jq.quantize_params(jparams) if precision == "int8"
                 else jq.quantize4_params(jparams))
        model = params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, device="cpu")
        assert tq.quantized_nbytes(model) == jq.quantized_nbytes(jtree)
        shapes = jax.eval_shape(lambda k, p=precision: jq.random_quantized_params(k, jcfg, p),
                                jax.random.PRNGKey(0))
        rand = tq.random_quantized_params(torch.Generator().manual_seed(0), tcfg,
                                          precision, device="cpu")
        for name in tq.QUANTIZED_LAYER_WEIGHTS:
            for key, want in shapes["layers"][name].items():
                got = getattr(rand.layers[1], name).get_buffer(key)
                assert (tuple(got.shape), str(got.dtype).split(".")[-1]) == (
                    want.shape[1:], str(want.dtype)), (name, key)
        assert tq.quantized_nbytes(rand) == tq.quantized_nbytes(model)
        with torch.no_grad():
            logits = tl.forward(rand, torch.zeros((1, 4), dtype=torch.int32), tcfg)
        assert torch.isfinite(logits).all()
    dense = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert tq.quantized_nbytes(dense) == jq.quantized_nbytes(jparams)
    with pytest.raises(ValueError, match="precision"):
        tq.random_quantized_params(torch.Generator(), tcfg, "int2", device="cpu")
