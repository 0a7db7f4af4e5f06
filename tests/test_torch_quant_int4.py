"""PyTorch port: packed int4 storage and the int4 matmul's plain version
against the JAX package.

Packing, ``quantize_linear(bits=4, pack=True)`` (range fit) and the packed
tied head are bit-identical to JAX's (the range fit folds ``/ qmax`` into a
multiply by its f32 reciprocal, as XLA does). The plain p4 version holds JAX's Pallas
p4 kernel in interpret mode to 1e-4 of max|ref| in both modes (f32: exact
products summed in another order; bf16: x rounded to bf16 in both, weights
and sums f32). A q4 artifact written by the JAX package loads into the port
with equal tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant import quantize as jq
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime import metadata as jmeta
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant import quantize as tq
from asr_tpu_torch.runtime import artifact as tart

TOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_mode():
    prev = tqm._CONFIG["mm"]
    tqm.set_quant_config(mm="f32")  # JAX's CPU product: the exact f32 dequant dot
    yield
    tqm._CONFIG["mm"] = prev


def _w(k, n, seed=0):
    return (np.random.default_rng(seed).standard_normal((k, n)) * k ** -0.5).astype(np.float32)


def test_pack_unpack_halves_match_jax():
    u = np.random.default_rng(1).integers(0, 16, (256, 40)).astype(np.uint8)
    jp = np.asarray(jq.pack4_halves(jnp.asarray(u)))
    tp = tq.pack4_halves(torch.from_numpy(u)).numpy()
    assert tp.dtype == np.int8 and tp.shape == (128, 40)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tq.unpack4_halves(torch.from_numpy(tp)).numpy(),
                                  np.asarray(jq.unpack4_halves(jnp.asarray(jp))))
    np.testing.assert_array_equal(tq.unpack4_halves(torch.from_numpy(tp)).numpy(), u)


@pytest.mark.parametrize("k,n,refine", [(512, 384, 0), (1024, 256, 0), (256, 128, 0), (1024, 256, 2)])
def test_quantize_linear_packed_bit_identical(k, n, refine):
    """Bit-identical for the range fit; the least-squares refinement sums
    each block in another order than XLA, so there q agrees on >= 99.9 % of
    the nibbles and scale / zero to 1e-6 relative, as for int8."""
    w = _w(k, n, k + refine)
    jl = jq.quantize_linear(jnp.asarray(w), 4, 128, refine, pack=True)
    tl = tq.quantize_linear(torch.from_numpy(w), 4, 128, refine, pack=True)
    assert jl.packed and tl.packed and tl.bits == 4 and tl.block == 128
    assert tuple(tl.q.shape) == (k // 2, n)
    if refine:
        nib_t = tq.unpack4_halves(tl.q).numpy()
        assert (nib_t == np.asarray(jq.unpack4_halves(jl.q))).mean() >= 0.999
        for f in ("scale", "zero"):
            np.testing.assert_allclose(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                       rtol=1e-6, atol=0, err_msg=f)
        return
    for f in ("q", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), err_msg=f)
    np.testing.assert_array_equal(tq.dequantize_weight(tl).numpy(),
                                  np.asarray(jq.dequantize_weight(jl)))


def test_unaligned_halves_stay_unpacked():
    w = _w(384, 128, 3)  # K/2 = 192 is not a multiple of the block
    tl = tq.quantize_linear(torch.from_numpy(w), 4, 128, 0, pack=True)
    jl = jq.quantize_linear(jnp.asarray(w), 4, 128, 0, pack=True)
    assert not tl.packed and not jl.packed
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))


@pytest.mark.parametrize("v", [151, 2048, 3000])
def test_packed_tied_head_bit_identical(v):
    table = (np.random.default_rng(v).standard_normal((v, 256)) * 0.02).astype(np.float32)
    je = jq.quantize_embedding(jnp.asarray(table), bits=4, block=128)
    te = tq.quantize_embedding(torch.from_numpy(table), bits=4, block=128)
    assert je.q_t_packed and te.q_t_packed
    v_pad = -(-v // 2048) * 2048
    assert tuple(te.q_t.shape) == (128, v_pad) and tuple(te.scale_t.shape) == (2, v_pad)
    for f in ("q", "scale", "zero", "q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)), err_msg=f)
    y = np.random.default_rng(0).standard_normal((3, 256)).astype(np.float32)
    got = tq.embedding_logits(te, torch.from_numpy(y)).numpy()
    want = np.asarray(jq.embedding_logits(je, jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    assert got.shape == (3, v)


def test_quantize_pytree_pack_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"embed": (rng.standard_normal((300, 256)) * 0.02).astype(np.float32),
            "layers": [{"attn": {"q": {"w": _w(256, 512, 5)}}, "small": {"w": _w(8, 8, 6)}}]}
    jt = jq.quantize_pytree(jax.tree.map(jnp.asarray, tree), bits=4, pack=True,
                            min_size=1024, refine_iters=0, quantize_embeddings=True)
    tt = tq.quantize_pytree(jax.tree.map(torch.from_numpy, tree), bits=4, pack=True,
                            min_size=1024, refine_iters=0, quantize_embeddings=True)
    tl, jl = tt["layers"][0]["attn"]["q"]["w"], jt["layers"][0]["attn"]["q"]["w"]
    assert tl.packed and jl.packed
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    assert isinstance(tt["layers"][0]["small"]["w"], torch.Tensor)
    assert tt["embed"].q_t_packed
    np.testing.assert_array_equal(tt["embed"].q_t.numpy(), np.asarray(jt["embed"].q_t))


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (2, 256, 256), (8, 1024, 512), (16, 1024, 512),
                                   (17, 512, 384), (37, 512, 384)])
def test_p4_plain_matches_jax_interpret_kernel(mm, m, k, n):
    leaf = jq.quantize_linear(jnp.asarray(_w(k, n, m)), 4, 128, 0, pack=True)
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // 8) * 8
    xp = np.zeros((m_pad, k), np.float32)
    xp[:m] = x
    want = np.asarray(jqm.quant_matmul_pallas_p4(
        jnp.asarray(xp), leaf.q, leaf.scale, leaf.zero, 128, tile_m=m_pad, tile_n=128,
        tile_k2=k // 2, interpret=True, mm=mm))[:m]
    got = tqm.quant_dense_p4_reference(torch.from_numpy(x), *(torch.from_numpy(np.asarray(a))
                                       for a in (leaf.q, leaf.scale, leaf.zero)), 128, mm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    # and quant_dense on a CPU tensor takes the plain version, not the kernel
    tleaf = tart.params_from_flat(jart.flatten_pytree({"w": leaf}), "cpu")["w"]
    before = tqm.LAUNCHES_INT4
    out = tqm.quant_dense(torch.from_numpy(x), tleaf, mm=mm)
    assert tqm.LAUNCHES_INT4 == before
    np.testing.assert_array_equal(out.numpy(), got)


def test_int4_launcher_refuses_cpu_tensors():
    leaf = tq.quantize_linear(torch.from_numpy(_w(256, 128)), 4, 128, 0, pack=True)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_int4(torch.zeros((1, 256)), leaf.q, leaf.scale, leaf.zero, 128, "f32")


def test_q4_artifact_written_by_jax_loads_into_the_port(tmp_path):
    rng = np.random.default_rng(7)
    tree = {"embed": jnp.asarray((rng.standard_normal((500, 256)) * 0.02).astype(np.float32)),
            "lin": {"w": jnp.asarray(_w(512, 256, 8)), "b": jnp.zeros((256,))}}
    jp = jq.quantize_pytree(tree, bits=4, pack=True, min_size=0, refine_iters=0,
                            quantize_embeddings=True)
    jart.save_model(tmp_path, jp, jmeta.ModelMetadata(family="qwen_asr"))
    tp, meta = tart.load_model(tmp_path, "cpu")
    assert meta.family == "qwen_asr"
    jl, tl = jp["lin"]["w"], tp["lin"]["w"]
    assert tl.packed and tl.bits == 4
    for f in ("q", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    je, te = jp["embed"], tp["embed"]
    assert te.q_t_packed and te.bits == 4
    for f in ("q", "scale", "zero", "q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)), err_msg=f)
    # and the port writes what the JAX package reads back
    tart.save_model(tmp_path / "back", tp, tart.ModelMetadata(family="qwen_asr"))
    jb, _ = jart.load_model(tmp_path / "back")
    np.testing.assert_array_equal(np.asarray(jb["lin"]["w"].q), np.asarray(jl.q))
    assert jb["lin"]["w"].packed and jb["embed"].q_t_packed
