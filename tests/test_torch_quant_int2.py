"""PyTorch port: packed int2 storage and the int2 matmul's plain version
against the JAX package.

Packing, ``quantize_linear(bits=2, pack=True)`` (range fit) and
``quantize_pytree(bits=2, pack=True, quantize_embeddings=True)`` (whose
2-bit tied head stays centered int8) are bit-identical to JAX's. The plain
p2 version holds JAX's Pallas p2 kernel in interpret mode to 1e-4 of
max|ref| in both modes (f32: exact products summed in another order; bf16:
JAX feeds the raw 2-bit values and bf16 x to the MXU and subtracts
``rowsum(x) * zero * scale`` per block, the port dequantizes in f32 against
bf16-rounded x). A q2 artifact written by the JAX package loads into the
port with equal tensors, and the port writes back what JAX reads.
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


@pytest.mark.parametrize("k", [512, 1024])
def test_pack_unpack_quarters_match_jax(k):
    u = np.random.default_rng(k).integers(0, 4, (k, 40)).astype(np.uint8)
    jp = np.asarray(jq.pack2_quarters(jnp.asarray(u)))
    tp = tq.pack2_quarters(torch.from_numpy(u)).numpy()
    assert tp.dtype == np.int8 and tp.shape == (k // 4, 40)
    np.testing.assert_array_equal(tp, jp)
    back = tq.unpack2_quarters(torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.unpack2_quarters(jnp.asarray(jp))))
    np.testing.assert_array_equal(back, u)


@pytest.mark.parametrize("k,n,refine", [(512, 384, 0), (1024, 256, 0), (2048, 128, 0),
                                        (1024, 256, 2)])
def test_quantize_linear_packed_bit_identical(k, n, refine):
    """Bit-identical for the range fit; the least-squares refinement sums
    each block in another order than XLA, so there the 2-bit values agree
    on >= 99.9 % and scale / zero to 1e-6 relative, as for int4."""
    w = _w(k, n, k + refine)
    jl = jq.quantize_linear(jnp.asarray(w), 2, 128, refine, pack=True)
    tl = tq.quantize_linear(torch.from_numpy(w), 2, 128, refine, pack=True)
    assert jl.packed and tl.packed and tl.bits == 2 and tl.block == 128
    assert tuple(tl.q.shape) == (k // 4, n)
    assert float(tl.zero.min()) >= 0 and float(tl.zero.max()) <= 3  # the unsigned zero
    if refine:
        vals_t = tq.unpack2_quarters(tl.q).numpy()
        assert (vals_t == np.asarray(jq.unpack2_quarters(jl.q))).mean() >= 0.999
        for f in ("scale", "zero"):
            np.testing.assert_allclose(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                       rtol=1e-6, atol=0, err_msg=f)
        return
    for f in ("q", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), err_msg=f)
    np.testing.assert_array_equal(tq.dequantize_weight(tl).numpy(),
                                  np.asarray(jq.dequantize_weight(jl)))


@pytest.mark.parametrize("k", [256, 384, 96])
def test_unaligned_quarters_stay_unpacked(k):
    """K/4 not a multiple of the block (256, 384), or K not (96, where the
    block becomes K): both packages keep centered, unpacked storage."""
    w = _w(k, 128, k)
    tl = tq.quantize_linear(torch.from_numpy(w), 2, 128, 0, pack=True)
    jl = jq.quantize_linear(jnp.asarray(w), 2, 128, 0, pack=True)
    assert not tl.packed and not jl.packed and tl.bits == 2 and tl.block == jl.block
    for f in ("q", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), err_msg=f)


def test_quantize_pytree_pack_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"embed": (rng.standard_normal((700, 512)) * 0.02).astype(np.float32),
            "layers": [{"attn": {"q": {"w": _w(512, 512, 5)}, "o": {"w": _w(256, 512, 7)}},
                        "small": {"w": _w(8, 8, 6)}}]}
    jt = jq.quantize_pytree(jax.tree.map(jnp.asarray, tree), bits=2, pack=True,
                            min_size=1024, refine_iters=0, quantize_embeddings=True)
    tt = tq.quantize_pytree(jax.tree.map(torch.from_numpy, tree), bits=2, pack=True,
                            min_size=1024, refine_iters=0, quantize_embeddings=True)
    for name, packed in (("q", True), ("o", False)):  # K/4 = 128 packs, K/4 = 64 does not
        tl, jl = tt["layers"][0]["attn"][name]["w"], jt["layers"][0]["attn"][name]["w"]
        assert tl.packed == jl.packed == packed and tl.bits == 2
        for f in ("q", "scale", "zero"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    assert isinstance(tt["layers"][0]["small"]["w"], torch.Tensor)
    te, je = tt["embed"], jt["embed"]
    assert te.bits == 2 and not te.q_t_packed and not je.q_t_packed
    assert tuple(te.q_t.shape) == (512, 1024)  # centered int8, V padded to a 512 multiple
    for f in ("q", "scale", "zero", "q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)), err_msg=f)
    y = np.random.default_rng(0).standard_normal((3, 512)).astype(np.float32)
    before = tqm.LAUNCHES
    got = tq.embedding_logits(te, torch.from_numpy(y)).numpy()
    assert tqm.LAUNCHES == before  # a CPU tensor: the plain version
    want = np.asarray(jq.embedding_logits(je, jnp.asarray(y)))
    assert got.shape == (3, 700)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (2, 512, 256), (8, 2048, 384), (16, 2048, 384),
                                   (17, 1024, 128), (37, 1024, 128), (8, 4096, 256)])
def test_p2_plain_matches_jax_interpret_kernel(mm, m, k, n):
    """K/4 of one block (512) and of several (1024 .. 4096)."""
    leaf = jq.quantize_linear(jnp.asarray(_w(k, n, m + n)), 2, 128, 0, pack=True)
    assert leaf.packed
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // 8) * 8
    xp = np.zeros((m_pad, k), np.float32)
    xp[:m] = x
    want = np.asarray(jqm.quant_matmul_pallas_p2(
        jnp.asarray(xp), leaf.q, leaf.scale, leaf.zero, 128, tile_m=m_pad, tile_n=128,
        tile_k4=k // 4, interpret=True, mm=mm))[:m]
    got = tqm.quant_dense_p2_reference(torch.from_numpy(x), *(torch.from_numpy(np.asarray(a))
                                       for a in (leaf.q, leaf.scale, leaf.zero)), 128, mm).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    # and quant_dense on a CPU tensor takes the plain version, not the kernel
    tleaf = tart.params_from_flat(jart.flatten_pytree({"w": leaf}), "cpu")["w"]
    before = (tqm.LAUNCHES, tqm.LAUNCHES_INT4, tqm.LAUNCHES_INT2)
    out = tqm.quant_dense(torch.from_numpy(x), tleaf, mm=mm)
    assert (tqm.LAUNCHES, tqm.LAUNCHES_INT4, tqm.LAUNCHES_INT2) == before
    np.testing.assert_array_equal(out.numpy(), got)


def test_p2_plain_matches_jax_quant_dense_multi_tile():
    """JAX's own dispatch (``quant_dense`` in interpret mode) on a weight
    whose K/4 spans several K tiles, against the port's ``quant_dense``."""
    k, n, m = 4096, 256, 5
    leaf = jq.quantize_linear(jnp.asarray(_w(k, n, 11)), 2, 128, 0, pack=True)
    x = np.random.default_rng(12).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jqm._pallas_quant_dense_2d(jnp.asarray(x), leaf, interpret=True, mm="f32"))
    tleaf = tart.params_from_flat(jart.flatten_pytree({"w": leaf}), "cpu")["w"]
    got = tqm.quant_dense(torch.from_numpy(x), tleaf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_int2_launcher_refuses_cpu_tensors():
    leaf = tq.quantize_linear(torch.from_numpy(_w(512, 128)), 2, 128, 0, pack=True)
    assert leaf.packed
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_int2(torch.zeros((1, 512)), leaf.q, leaf.scale, leaf.zero, 128, "f32")


def test_quant_dense_refuses_what_no_kernel_takes():
    leaf = tq.quantize_linear(torch.from_numpy(_w(512, 128)), 8, 512)
    dyn = {"q": leaf.q, "scale": leaf.scale, "zero": leaf.zero, "bits": 8, "block": 512,
           "packed": False, "dynamic": True}
    with pytest.raises(NotImplementedError, match="dynamic"):
        tqm.quant_dense(torch.zeros((1, 512)), dyn)
    with pytest.raises(ValueError, match="packed"):
        tqm.quant_dense(torch.zeros((1, 512)), dict(dyn, dynamic=False, packed=True))


def test_q2_artifact_written_by_jax_loads_into_the_port(tmp_path):
    rng = np.random.default_rng(7)
    tree = {"embed": jnp.asarray((rng.standard_normal((500, 512)) * 0.02).astype(np.float32)),
            "lin": {"w": jnp.asarray(_w(1024, 256, 8)), "b": jnp.zeros((256,))},
            "odd": {"w": jnp.asarray(_w(256, 256, 9))}}
    jp = jq.quantize_pytree(tree, bits=2, pack=True, min_size=0, refine_iters=0,
                            quantize_embeddings=True)
    jart.save_model(tmp_path, jp, jmeta.ModelMetadata(family="qwen_asr"))
    tp, meta = tart.load_model(tmp_path, "cpu")
    assert meta.family == "qwen_asr"
    for name, packed in (("lin", True), ("odd", False)):
        jl, tl = jp[name]["w"], tp[name]["w"]
        assert tl.packed == packed and tl.bits == 2 and tl.block == jl.block
        for f in ("q", "scale", "zero"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    je, te = jp["embed"], tp["embed"]
    assert not te.q_t_packed and te.bits == 2
    for f in ("q", "scale", "zero", "q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)), err_msg=f)
    # and the port writes what the JAX package reads back
    tart.save_model(tmp_path / "back", tp, tart.ModelMetadata(family="qwen_asr"))
    jb, _ = jart.load_model(tmp_path / "back")
    for name in ("lin", "odd"):
        for f in ("q", "scale", "zero"):
            np.testing.assert_array_equal(np.asarray(getattr(jb[name]["w"], f)),
                                          np.asarray(getattr(jp[name]["w"], f)))
        assert jb[name]["w"].packed == jp[name]["w"].packed and jb[name]["w"].bits == 2
    for f in ("q_t", "scale_t", "zero_t"):
        np.testing.assert_array_equal(np.asarray(getattr(jb["embed"], f)), np.asarray(getattr(je, f)))
