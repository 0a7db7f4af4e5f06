"""PyTorch port: int8 quantizer and the dequant-matmul kernel's plain version,
held against the JAX package (Pallas kernel in interpret mode, XLA route)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant import quantize as jquant
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant import quantize as tquant


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    mm = tqm._CONFIG["mm"]
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def _leaf_pair(k, n, block, seed, refine_iters=0):
    """The same weight quantized by JAX; the port gets JAX's exact leaf."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jleaf = jquant.quantize_linear(jnp.asarray(w), bits=8, block=block, refine_iters=refine_iters)
    tleaf = tquant.QuantizedLinear(
        torch.tensor(np.asarray(jleaf.q)), torch.tensor(np.asarray(jleaf.scale)),
        torch.tensor(np.asarray(jleaf.zero)), 8, jleaf.block)
    return w, jleaf, tleaf


# (M, K, N, block): ragged M, block = K = 140, the slice's 560-row single block.
CASES = [(5, 256, 256, 128), (16, 140, 256, 140), (37, 512, 384, 128), (9, 560, 128, 560)]


@pytest.mark.parametrize("m,k,n,block", CASES)
def test_reference_matches_pallas_f32(m, k, n, block):
    _, jleaf, tleaf = _leaf_pair(k, n, block, seed=m + k)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    got = tqm.quant_dense_reference(torch.from_numpy(x), tleaf.q, tleaf.scale, tleaf.zero, block, "f32")
    want = np.asarray(jqm._pallas_quant_dense_2d(jnp.asarray(x), jleaf, interpret=True, mm="f32"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_reference_matches_pallas_kernel_direct():
    m, k, n, block = 16, 256, 256, 128
    _, jleaf, tleaf = _leaf_pair(k, n, block, seed=3)
    x = np.random.default_rng(3).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul_pallas(
        jnp.asarray(x), jleaf.q, jleaf.scale, jleaf.zero, block,
        tile_m=8, tile_n=128, tile_k=256, interpret=True, mm="f32"))
    got = tqm.quant_dense_reference(torch.from_numpy(x), tleaf.q, tleaf.scale, tleaf.zero, block, "f32")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("m,k,n,block", CASES)
def test_reference_bf16_mode(m, k, n, block):
    _, jleaf, tleaf = _leaf_pair(k, n, block, seed=m + k + 1)
    x = np.random.default_rng(m + 1).standard_normal((m, k)).astype(np.float32)
    got = tqm.quant_dense_reference(torch.from_numpy(x), tleaf.q, tleaf.scale, tleaf.zero, block, "bf16").numpy()
    want16 = np.asarray(jqm._pallas_quant_dense_2d(jnp.asarray(x), jleaf, interpret=True, mm="bf16"))
    scale = np.abs(want16).max()
    # Same bf16-rounded x and the same weights: only the f32 summation order differs.
    assert np.abs(got - want16).max() <= 1e-4 * scale
    want32 = np.asarray(jqm._xla_quant_dense(jnp.asarray(x), jleaf))
    assert np.abs(got - want32).max() / np.abs(want32).max() < 5e-2


def test_reference_ragged_n_matches_xla_route():
    m, k, n, block = 7, 256, 300, 128
    _, jleaf, tleaf = _leaf_pair(k, n, block, seed=9)
    x = np.random.default_rng(9).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jqm._xla_quant_dense(jnp.asarray(x), jleaf))
    got = tqm.quant_dense(torch.from_numpy(x), tleaf, mm="f32")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_runs_plain_version_without_launch():
    _, _, tleaf = _leaf_pair(128, 128, 64, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 128)).astype(np.float32))
    before = tqm.LAUNCHES
    out = tqm.quant_dense(x, tleaf, mm="f32")
    assert tqm.LAUNCHES == before
    assert out.shape == (2, 3, 128)
    want = tqm.quant_dense_reference(x.reshape(6, 128), tleaf.q, tleaf.scale, tleaf.zero, 64, "f32")
    torch.testing.assert_close(out.reshape(6, 128), want, rtol=0, atol=0)
    # The kernel wrapper itself takes CUDA tensors only: no silent CPU route.
    with pytest.raises(ValueError):
        tqm.quant_matmul_int8(x.reshape(6, 128), tleaf.q, tleaf.scale, tleaf.zero, 64, "f32")
    assert tqm.LAUNCHES == before


def test_mm_mode_resolution():
    tqm._CONFIG["mm"] = None
    assert tqm._resolve_mm(None) == "bf16"
    tqm.set_quant_config(mm="f32")
    assert tqm._resolve_mm(None) == "f32"
    assert tqm._resolve_mm("bf16") == "bf16"
    with pytest.raises(ValueError):
        tqm.set_quant_config(mm="fp32")
    with pytest.raises(ValueError):
        tqm._resolve_mm("F32")


@pytest.mark.parametrize("k,n,block", [(256, 96, 128), (560, 64, 128), (140, 32, 140)])
def test_quantize_weight_rtn_matches_jax(k, n, block):
    w = (np.random.default_rng(k).standard_normal((k, n)) * 0.05).astype(np.float32)
    jleaf = jquant.quantize_linear(jnp.asarray(w), bits=8, block=block, refine_iters=0)
    tleaf = tquant.quantize_linear(torch.from_numpy(w), bits=8, block=block, refine_iters=0)
    assert tleaf.block == jleaf.block == (block if k % block == 0 else k)
    assert tleaf.q.dtype == torch.int8
    np.testing.assert_array_equal(tleaf.q.numpy(), np.asarray(jleaf.q))
    np.testing.assert_allclose(tleaf.scale.numpy(), np.asarray(jleaf.scale), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tleaf.zero.numpy(), np.asarray(jleaf.zero), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tquant.dequantize_weight(tleaf).numpy(),
                               np.asarray(jquant.dequantize_weight(jleaf)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("k,n,block", [(256, 128, 128), (512, 64, 64)])
def test_quantize_weight_refined_matches_jax(k, n, block):
    w = (np.random.default_rng(n).standard_normal((k, n)) * 0.05).astype(np.float32)
    jq, js, jz = (np.asarray(a) for a in jquant.quantize_weight(jnp.asarray(w), 8, block, 2))
    tq, ts, tz = (a.numpy() for a in tquant.quantize_weight(torch.from_numpy(w), 8, block, 2))
    assert (tq == jq).mean() >= 0.999
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tz, jz, rtol=1e-6, atol=0)


def test_quantize_pytree_same_leaves_as_jax():
    from asr_tpu.runtime.artifact import flatten_pytree as jflat
    from asr_tpu_torch.runtime.artifact import flatten_pytree as tflat

    rng = np.random.default_rng(0)
    tree = {
        "a": {"w": rng.standard_normal((128, 64)).astype(np.float32), "b": np.zeros(64, np.float32)},
        "ffn": {"w1": rng.standard_normal((64, 256)).astype(np.float32),
                "w2": rng.standard_normal((16, 16)).astype(np.float32)},
        "dw": {"w": rng.standard_normal((128, 64)).astype(np.float32)},
        "blocks": [{"w": rng.standard_normal((96, 64)).astype(np.float32)}],
    }

    def tmap(f, t):
        if isinstance(t, dict):
            return {k: tmap(f, v) for k, v in t.items()}
        if isinstance(t, list):
            return [tmap(f, v) for v in t]
        return f(t)

    jout = jflat(jquant.quantize_pytree(tmap(jnp.asarray, tree), block=64, min_size=1024))
    tout = tflat(tquant.quantize_pytree(tmap(torch.from_numpy, tree), block=64, min_size=1024))
    assert sorted(jout) == sorted(tout)
    assert "ffn/w1/__quant__/q" in tout and "dw/w" in tout and "ffn/w2" in tout
    for key in jout:
        if key.endswith("/q"):
            assert (jout[key] == tout[key]).mean() >= 0.999, key
        else:
            np.testing.assert_allclose(tout[key], jout[key], rtol=1e-6, atol=0, err_msg=key)


# Unpacked leaves of every width: the JAX package stores them centered int8
# and runs them through its int8 kernel (``asr_tpu/ops/quant_matmul.py``,
# ``elif not packed``); the port once refused every unpacked leaf but 8-bit.
# The three writers of such leaves: ``quantize --bits 4`` without ``--pack``,
# a 4-bit pack whose K/2 is not a block multiple, and every 2-bit tied head.
@pytest.mark.parametrize("bits,pack,k", [(2, False, 512), (4, False, 512), (8, False, 512),
                                         (4, True, 384), (2, True, 256)])
@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_unpacked_leaves_of_every_width_match_jax(bits, pack, k, mm):
    rng = np.random.default_rng(bits + k)
    w = (rng.standard_normal((k, 256)) * 0.05).astype(np.float32)
    jleaf = jquant.quantize_linear(jnp.asarray(w), bits=bits, block=128, pack=pack)
    tleaf = tquant.quantize_linear(torch.from_numpy(w), bits=bits, block=128, pack=pack)
    assert not jleaf.packed and not tleaf.packed and tleaf.bits == bits
    np.testing.assert_array_equal(tleaf.q.numpy(), np.asarray(jleaf.q))
    x = rng.standard_normal((7, k)).astype(np.float32)
    want = np.asarray(jqm._pallas_quant_dense_2d(jnp.asarray(x), jleaf, interpret=True, mm=mm))
    before = tqm.LAUNCHES
    got = tqm.quant_dense(torch.from_numpy(x), tleaf, mm=mm).numpy()
    assert tqm.LAUNCHES == before  # a CPU tensor: the plain version
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_two_bit_tied_head_matches_jax():
    table = (np.random.default_rng(5).standard_normal((700, 256)) * 0.02).astype(np.float32)
    je = jquant.quantize_embedding(jnp.asarray(table), bits=2, block=128)
    te = tquant.quantize_embedding(torch.from_numpy(table), bits=2, block=128)
    assert not je.q_t_packed and not te.q_t_packed and tuple(te.q_t.shape) == (256, 1024)
    for f in ("q", "scale", "zero", "q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)), err_msg=f)
    y = np.random.default_rng(6).standard_normal((2, 256)).astype(np.float32)
    tqm.set_quant_config(mm="f32")
    got = tquant.embedding_logits(te, torch.from_numpy(y)).numpy()
    want = np.asarray(jquant.embedding_logits(je, jnp.asarray(y)))
    assert got.shape == (2, 700)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
