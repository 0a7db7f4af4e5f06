"""PyTorch port: LayerNorm, attention, dense and the SANM block against the
JAX package on the same numpy inputs and parameters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.layers import attention as jattn
from asr_tpu.layers import norms as jnorms
from asr_tpu.layers import sanm as jsanm
from asr_tpu.layers import transformer as jtr
from asr_tpu.quant.quantize import quantize_linear
from asr_tpu.runtime.artifact import flatten_pytree
from asr_tpu_torch.layers import attention as tattn
from asr_tpu_torch.layers import norms as tnorms
from asr_tpu_torch.layers import sanm as tsanm
from asr_tpu_torch.layers import transformer as ttr
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.runtime.artifact import params_from_flat

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    mm = tqm._CONFIG["mm"]
    tqm.set_quant_config(mm="f32")  # the JAX package's CPU route is the exact f32 product
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def _block_params(rng, in_size, hidden=64, ffn=128, kernel=5):
    def lin(i, o):
        return {"w": (rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32),
                "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}

    def norm(n):
        return {"scale": (1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)}

    return {
        "norm1": norm(in_size), "qkv": lin(in_size, 3 * hidden),
        "fsmn_w": (rng.standard_normal((kernel, hidden)) * 0.1).astype(np.float32),
        "out": lin(hidden, hidden), "norm2": norm(hidden),
        "ffn": {"w1": lin(hidden, ffn)["w"], "b1": np.zeros(ffn, np.float32),
                "w2": lin(ffn, hidden)["w"], "b2": (0.1 * rng.standard_normal(hidden)).astype(np.float32)},
    }


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 7, 64)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mha_with_length_bias_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((3, 9, 4, 16)).astype(np.float32) for _ in range(3))
    valid = np.array([9, 5, 1], np.int32)
    jb = jattn.attention_bias_from_lengths(jnp.asarray(valid), 9)
    tb = tattn.attention_bias_from_lengths(torch.from_numpy(valid), 9)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb))
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias=tb).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_dense_matches_jax(quantized):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 96)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jw = quantize_linear(jnp.asarray(w), bits=8, block=64) if quantized else jnp.asarray(w)
    jp = {"w": jw, "b": jnp.asarray(b)}
    tp = params_from_flat(flatten_pytree(jp), "cpu")
    want = np.asarray(jtr.dense(jnp.asarray(x), jp))
    got = ttr.dense(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_depthwise_conv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    w = rng.standard_normal((5, 8)).astype(np.float32)
    for lp, rp in ((2, 2), (4, 0), (0, 1)):
        want = np.asarray(jsanm.depthwise_conv1d_time(jnp.asarray(x), jnp.asarray(w), lp, rp))
        got = tsanm.depthwise_conv1d_time(torch.from_numpy(x), torch.from_numpy(w), lp, rp).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("residual,quantized", [(False, False), (True, False), (True, True)])
def test_sanm_block_matches_jax(residual, quantized):
    rng = np.random.default_rng(4)
    in_size = 64 if residual else 80
    p = _to_jax(_block_params(rng, in_size))
    if quantized:
        from asr_tpu.quant.quantize import quantize_pytree

        p = quantize_pytree(p, bits=8, block=32, min_size=1024)
    tp = params_from_flat(flatten_pytree(p), "cpu")
    x = rng.standard_normal((2, 11, in_size)).astype(np.float32)
    valid = np.array([11, 6], np.int32)
    jmask = jattn.length_mask(jnp.asarray(valid), 11)
    jbias = jattn.attention_bias_from_lengths(jnp.asarray(valid), 11)
    tmask = tattn.length_mask(torch.from_numpy(valid), 11)
    tbias = tattn.attention_bias_from_lengths(torch.from_numpy(valid), 11)
    want = np.asarray(jsanm.sanm_block(jnp.asarray(x), p, 4, 16, jbias, jmask, residual))
    got = tsanm.sanm_block(torch.from_numpy(x), tp, 4, 16, tbias, tmask, residual).numpy()
    np.testing.assert_allclose(got, want, **TOL)
