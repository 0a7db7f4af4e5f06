"""The port's block fits and dynamic int8 against the JAX package's
``quant/quantize.py`` on the CPU: rtn, kquant and hqq at 2, 4 and 8 bits,
packed and unpacked, refine 0 and 2, give the same q and zero points and
the same scales up to the rounding of their f32 sums; the dynamic
objective's leaves likewise, and its product, ``dynamic_quant_dense``, is
JAX's jitted one given the same rows; a tiny SenseVoice with dynamic leaves
agrees product by product; ``quantize_pytree``'s objectives,
``is_quantized`` and ``quantization_error`` agree.

The port sums a block with plain torch reductions and XLA in its own order
(runs of 32, multiplies fused into adds), and the port's kquant grid is
``jnp.linspace(0.6, 1.2, 16)`` run alone, which XLA computes one ulp apart
at three factors inside its fit. Run in XLA's order (the ``xla_order``
fixture, on the test's side), the port's fits are JAX's bit for bit. In
its own order each block must be the same fit up to that rounding: zero
bitwise, the scale within ``SCALE_ULPS``, the codes bitwise but for codes
on a rounding boundary (``chip_smoke.fit_gap``, the card's gate (b), which
on weights where a refine step meets such a boundary also counts the
blocks it moved on).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from asr_tpu.quant import quantize as jq
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.quant import quantize as tq
from asr_tpu_torch.runtime import artifact as tart


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads a test: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _w(k, n, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    w = {"normal": lambda: rng.standard_normal((k, n)),
         "heavy": lambda: rng.standard_t(2, (k, n)),
         "uniform": lambda: rng.uniform(-1, 1, (k, n))}[kind]()
    w = (w * rng.uniform(0.01, 2.0)).astype(np.float32)
    w[:, :3] *= 10  # a few wide columns
    return w


SCALE_ULPS = chip_smoke.FIT_SCALE_ULPS
TIE_RTOL = 1e-5  # kquant: two candidates' f32 error scores within their own rounding


def _ulps(a, b):
    """ulps between f32 arrays (a sign change counts as far apart)."""
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
    return np.where(np.signbit(a) == np.signbit(b), d, 1 << 40)


def _assert_same_scales(a, b, what="scale"):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, what
    assert _ulps(a, b).max(initial=0) <= SCALE_ULPS, (what, int(_ulps(a, b).max()))


def _arrays(leaf) -> dict:
    return {f: np.asarray(getattr(leaf, f)) for f in ("q", "scale", "zero", "bits", "block", "packed")}


def _assert_same_leaf(jleaf, tleaf, w, objective="rtn"):
    """The two fits of ``w`` (K, N) are the same in every block up to the
    rounding of their sums (``chip_smoke.fit_gap`` with no block moved):
    zero bitwise, the scale within SCALE_ULPS, the codes q - zero bitwise
    but where ``w / scale + zero`` lies on a rounding boundary. Under
    kquant a block may instead hold another pick of the grid if it is a
    tie: both picks' x^2-weighted errors (f64) within TIE_RTOL."""
    assert (jleaf.bits, jleaf.block, jleaf.packed, jleaf.dynamic) == (
        tleaf.bits, tleaf.block, tleaf.packed, tleaf.dynamic)
    for f in ("q", "scale", "zero"):
        a, b = np.asarray(getattr(jleaf, f)), getattr(tleaf, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
    gap = chip_smoke.fit_gap(np, w, _arrays(tleaf), _arrays(jleaf), kquant=objective == "kquant")
    assert gap["moved"] == 0, gap
    if gap["picks"]:
        k, n = w.shape
        wb = w.astype(np.float64).reshape(k // tleaf.block, -1, n)
        err = lambda leaf, mod: ((wb * wb + 1e-12) * (wb - np.asarray(mod.dequantize_weight(leaf), np.float64)
                                                       .reshape(wb.shape)) ** 2).sum(axis=1)
        ej, et = err(jleaf, jq), err(tleaf, tq)
        picked = _ulps(np.asarray(jleaf.scale), tleaf.scale.numpy()) > SCALE_ULPS
        assert int(picked.sum()) == gap["picks"]
        assert np.all((np.abs(ej - et) <= TIE_RTOL * np.maximum(ej, et))[picked]), "a kquant pick is no tie"


# ── the JAX package's f32 order, on the test's side ─────────────────────────
def _xla_factors() -> tuple:
    """The kquant grid as the JAX package's compiled fit computes
    ``jnp.linspace(0.6, 1.2, 16)``: ``0.6 * (1 - i * r) + i * c`` with
    ``r = f32(1/15)`` and ``c = f32(1.2 * r)`` (XLA folds both constants),
    each step rounded to f32, and 1.2 last."""
    f32 = np.float32
    i = np.arange(15, dtype=f32)
    r = f32(1) / f32(15)
    c = f32(f32(1.2) * r)
    head = f32(0.6) * (f32(1) - i * r) + i * c
    return tuple(float(v) for v in head.astype(f32)) + (float(f32(1.2)),)


def _xla_mul_add(a, b, c):
    """``a * b + c`` rounded once, as XLA's CPU code contracts a multiply
    feeding an add (in f64: the product is exact there)."""
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b.double() + c).float()


def _ordered_sum(x, dim):
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _xla_block_sum(x, y=None):
    """The block sum in XLA's CPU order: over more than 32 rows, the rows
    padded with zeros to a multiple of 32 (half the pad in front), each run
    of 32 summed in order, repeated on the run sums; 32 rows or fewer in
    order, a product's terms fused into the running sum."""
    if y is not None and x.shape[1] <= 32:
        acc = torch.zeros_like(x[:, 0])
        for i in range(x.shape[1]):
            acc = _xla_mul_add(x[:, i], y[:, i], acc)
        return acc.unsqueeze(1)
    if y is not None:
        x = x * y
    while x.shape[1] > 32:
        pad = -x.shape[1] % 32
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = _ordered_sum(x.reshape(x.shape[0], -1, 32, x.shape[2]), 2)
    return _ordered_sum(x, 1).unsqueeze(1)


def _xla_block_mean(x):
    """:func:`_xla_block_sum` times the f32 reciprocal of B (XLA folds a
    constant divisor so)."""
    return _xla_block_sum(x) * torch.tensor(np.float32(1.0 / x.shape[1]))


@pytest.fixture
def xla_order(monkeypatch):
    """The port's fits with their sums, fused products and kquant grid in
    the JAX package's f32 order (XLA's CPU code): the same algorithm in
    another rounding order. Tests that hold whole artifacts or trees to
    JAX's bitwise take it; the fits' own tests show what the port's order
    changes."""
    monkeypatch.setattr(tq, "_mul_add", _xla_mul_add)
    monkeypatch.setattr(tq, "_block_sum", _xla_block_sum)
    monkeypatch.setattr(tq, "_block_mean", _xla_block_mean)
    monkeypatch.setattr(tq, "KQUANT_FACTORS", _xla_factors())


def test_kquant_factors_are_the_jax_fits():
    """The grid is ``jnp.linspace(0.6, 1.2, 16)`` bit for bit. Inside its
    compiled fit XLA computes three of them one ulp apart, so every scale
    JAX's kquant picks, over four weight distributions, lies within 2 ulps
    of the range-fit scale times exactly one of the port's factors."""
    ref = np.asarray(jnp.linspace(0.6, 1.2, 16))
    got = np.asarray(tq.KQUANT_FACTORS, np.float32)
    assert got.tobytes() == ref.tobytes()
    fit = jax.jit(jq._fit_kquant, static_argnums=1)
    picked = set()
    for seed, (qmax, b, kind) in enumerate([(3, 32, "normal"), (15, 64, "heavy"), (255, 128, "uniform"),
                                            (3, 64, "heavy"), (15, 32, "uniform"), (255, 64, "normal")]):
        blocks = _w(4 * b, 300, seed, kind).reshape(4, b, 300)
        js = np.asarray(fit(jnp.asarray(blocks), qmax)[0])
        s0 = tq._fit_rtn(torch.from_numpy(blocks), qmax)[0].numpy()
        cands = (s0[None] * got[:, None, None, None]).astype(np.float32)
        hit = _ulps(cands, np.broadcast_to(js, cands.shape)) <= 2
        assert np.all(hit.sum(0) == 1)
        picked |= set(np.nonzero(hit.any(axis=(1, 2, 3)))[0].tolist())
    assert len(picked) >= 8


@pytest.mark.parametrize("objective", ["rtn", "kquant", "hqq"])
@pytest.mark.parametrize("bits,pack", [(2, False), (2, True), (4, False), (4, True), (8, False)])
@pytest.mark.parametrize("refine", [0, 2])
def test_quantize_linear_bitwise(objective, bits, pack, refine):
    """Blocks of 128 and 64 (K = 512 packs at both), and a K the block
    does not divide (one block per column)."""
    for i, (k, n, block, kind) in enumerate([(512, 48, 128, "normal"), (512, 40, 64, "heavy"),
                                             (320, 24, 128, "uniform")]):
        w = _w(k, n, 17 * bits + i, kind)
        jleaf = jq.quantize_linear(jnp.asarray(w), bits, block, refine, pack=pack, objective=objective)
        tleaf = tq.quantize_linear(torch.from_numpy(w), bits, block, refine, pack=pack, objective=objective)
        _assert_same_leaf(jleaf, tleaf, w, objective)
        assert tleaf.packed == (pack and bits in (2, 4) and k % 128 == 0)


@pytest.mark.parametrize("objective", ["rtn", "kquant", "hqq", "dynamic"])
@pytest.mark.parametrize("bits,pack", [(2, True), (4, True), (4, False), (8, False)])
def test_fits_in_the_jax_order_are_bitwise(xla_order, objective, bits, pack):
    """The port's fits run in XLA's f32 order give JAX's leaves bit for bit
    (refine 2, blocks of 128 and 64 and one block a column): every
    difference of the port's own order is the order of the rounding."""
    for i, (k, n, block, kind) in enumerate([(512, 48, 128, "normal"), (512, 40, 64, "heavy"),
                                             (320, 24, 128, "uniform")]):
        w = _w(k, n, 31 * bits + i, kind)
        jleaf = jq.quantize_linear(jnp.asarray(w), bits, block, 2, pack=pack, objective=objective)
        tleaf = tq.quantize_linear(torch.from_numpy(w), bits, block, 2, pack=pack, objective=objective)
        for f in ("q", "scale", "zero"):
            assert np.asarray(getattr(jleaf, f)).tobytes() == getattr(tleaf, f).numpy().tobytes(), f
        assert (jleaf.bits, jleaf.block, jleaf.packed, jleaf.dynamic) == (
            tleaf.bits, tleaf.block, tleaf.packed, tleaf.dynamic)


@pytest.mark.parametrize("objective", ["rtn", "kquant", "dynamic"])
def test_fit_gap_classes_the_port_against_jax(objective):
    """``chip_smoke.fit_gap``, the card's gate (b), on two fits made in two
    rounding orders (the port's and JAX's, refine 2) of SenseVoice-like
    weights where a refine step's codes land on rounding boundaries: every
    block is the same fit or one such a boundary moved on, at most 1 %,
    and a fit without the refine fails it."""
    from asr_tpu.models.sensevoice import SenseVoiceConfig
    from tests.test_loaders import _sensevoice_sd

    cfg = SenseVoiceConfig(vocab_size=64, hidden=512, num_heads=4, head_dim=128, ffn_dim=512,
                           num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
    sd = _sensevoice_sd(cfg, np.random.default_rng(0))
    ws = [np.ascontiguousarray(np.asarray(v).T * 0.05, dtype=np.float32) for _, v in sorted(sd.items())
          if v.ndim == 2 and v.numel() >= 1 << 18]
    total = {"blocks": 0, "same": 0, "moved": 0, "picks": 0}
    for w in ws:
        jl = jq.quantize_linear(jnp.asarray(w), 8, 128, 2, objective=objective)
        tl = tq.quantize_linear(torch.from_numpy(w), 8, 128, 2, objective=objective)
        gap = chip_smoke.fit_gap(np, w, _arrays(tl), _arrays(jl), objective == "kquant")
        total = {c: total[c] + gap[c] for c in total}
    assert total["moved"] + total["picks"] <= chip_smoke.FIT_MOVED_MAX * total["blocks"]
    assert total["same"] < total["blocks"]  # the boundary cases are met, not missed
    jl = jq.quantize_linear(jnp.asarray(ws[0]), 8, 128, 2, objective=objective)
    tl = tq.quantize_linear(torch.from_numpy(ws[0]), 8, 128, 0, objective=objective)
    with pytest.raises(RuntimeError, match="beyond a rounding boundary"):
        chip_smoke.fit_gap(np, ws[0], _arrays(tl), _arrays(jl), objective == "kquant")


@pytest.mark.parametrize("objective", ["rtn", "kquant", "hqq"])
def test_blocks_of_32_without_refine_bitwise(objective):
    w = _w(256, 80, 5, "heavy")
    for bits in (2, 4, 8):
        _assert_same_leaf(jq.quantize_linear(jnp.asarray(w), bits, 32, 0, objective=objective),
                          tq.quantize_linear(torch.from_numpy(w), bits, 32, 0, objective=objective), w, objective)


def test_hqq_skips_the_refine():
    w = torch.from_numpy(_w(256, 64, 3))
    for a, b in zip(tq.quantize_weight(w, 4, 64, 2, objective="hqq"), tq.quantize_weight(w, 4, 64, 0, objective="hqq")):
        assert torch.equal(a, b)
    assert not torch.equal(tq.quantize_weight(w, 4, 64, 2)[1], tq.quantize_weight(w, 4, 64, 0)[1])


@pytest.mark.parametrize("objective", ["kquant", "hqq"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_embedding_bitwise(objective, bits):
    table = (np.random.default_rng(bits).standard_normal((700, 256)) * 0.05).astype(np.float32)
    je = jq.quantize_embedding(jnp.asarray(table), bits, 128, objective=objective)
    te = tq.quantize_embedding(torch.from_numpy(table), bits, 128, objective=objective)
    for f in ("q", "scale", "zero", "q_t", "scale_t", "zero_t"):
        a, b = np.asarray(getattr(je, f)), getattr(te, f).numpy()
        if f.startswith("scale"):
            _assert_same_scales(a, b, f)
        else:
            assert a.tobytes() == b.tobytes(), f
    assert je.q_t_packed == te.q_t_packed == (bits == 4)


# ── dynamic-activation int8 ─────────────────────────────────────────────────
@pytest.mark.parametrize("k", [256, 560, 1280])
@pytest.mark.parametrize("refine", [0, 2])
def test_dynamic_leaf_bitwise(k, refine):
    """8-bit, one block per column (block = K, whatever ``bits``/``block``
    say), marked dynamic; K = 560 and 1280 pad XLA's runs of 32."""
    w = _w(k, 72, k + refine)
    jleaf = jq.quantize_linear(jnp.asarray(w), 4, 64, refine, pack=True, objective="dynamic")
    tleaf = tq.quantize_linear(torch.from_numpy(w), 4, 64, refine, pack=True, objective="dynamic")
    _assert_same_leaf(jleaf, tleaf, w)
    assert (tleaf.bits, tleaf.block, tleaf.dynamic, tleaf.packed) == (8, k, True, False)


@pytest.mark.parametrize("shape", [(1, 256), (17, 256), (3, 5, 560), (40, 1280)])
def test_dynamic_quant_dense_bitwise_jitted_jax(shape):
    """Per-row absmax int8 activations, an exact int32 product, the f32
    epilogue in JAX's order: bitwise JAX's jitted product (the way its
    models call it) at N = 300, where XLA does not contract the epilogue
    (at other widths it may: see the SenseVoice test); a row of zeros takes
    sx = 1."""
    rng = np.random.default_rng(shape[-1] + shape[0])
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    w = _w(shape[-1], 300, 9)
    jleaf = jq.quantize_linear(jnp.asarray(w), objective="dynamic")
    tleaf = tq.quantize_linear(torch.from_numpy(w), objective="dynamic")
    want = np.asarray(jax.jit(jq.dynamic_quant_dense)(jnp.asarray(x), jleaf))
    got = tq.dynamic_quant_dense(torch.from_numpy(x), tleaf).numpy()
    assert got.shape == want.shape == (*shape[:-1], 300)
    assert got.tobytes() == want.tobytes()


def test_dense_routes_dynamic_leaves():
    """``layers/transformer.dense`` takes a dynamic leaf to the dynamic
    product (``quant_dense`` refuses it), with the bias after it."""
    from asr_tpu_torch.layers.transformer import dense

    w = torch.from_numpy(_w(256, 64, 4))
    leaf = tq.quantize_linear(w, objective="dynamic")
    x, b = torch.randn(5, 256, generator=torch.Generator().manual_seed(0)), torch.arange(64.0)
    assert torch.equal(dense(x, {"w": leaf, "b": b}), tq.dynamic_quant_dense(x, leaf) + b)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_quant_dense_takes_half_activations(dtype):
    """An artifact built from an f16 checkpoint keeps f16 plain leaves, so
    activations reach the quantized products in f16: ``quant_dense`` widens
    them exactly to f32 for the kernel and returns their dtype."""
    from asr_tpu_torch.ops.quant_matmul import quant_dense

    leaf = tq.quantize_linear(torch.from_numpy(_w(256, 96, 5)), 8, 128)
    x = torch.randn(3, 7, 256, generator=torch.Generator().manual_seed(1)).to(dtype)
    got = quant_dense(x, leaf, mm="f32")
    assert got.dtype == dtype and got.shape == (3, 7, 96)
    assert torch.equal(got, quant_dense(x.float(), leaf, mm="f32").to(dtype))


SV_TINY = dict(vocab_size=300, hidden=256, num_heads=4, head_dim=64, ffn_dim=512,
               num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)


def test_sensevoice_with_dynamic_leaves_matches_jax(monkeypatch):
    """A SenseVoice tree with every linear dynamic through both forwards,
    each product fed the same rows. Left alone the two forwards part: the
    f32 work between products (FSMN, attention, norms) differs between XLA
    and torch in the last ulps, an activation on a rounding boundary moves
    its int8 value by one, and the next layers amplify it. So JAX's forward
    (its products jitted, as its models run them) records each product's
    rows and result, and the port's forward runs with every product taking
    JAX's rows: its result must lie within 1e-6 of max|result| of JAX's (the
    int32 sums are exact; at these widths XLA contracts the f32 epilogue
    into fused multiply-adds, a last-ulp difference), and it passes JAX's
    result on. Each product's own rows from the port's forward must then lie
    within 1e-5 of JAX's, and the logits within 1e-5 of max|logit| (the
    static q8 tree, the control, agrees as closely run free). A port that
    skipped the activation quantization would miss the products by ~1e-3."""
    from asr_tpu.models import sensevoice as jsv
    from asr_tpu_torch.layers import transformer as ttr
    from asr_tpu_torch.models import sensevoice as tsv
    from asr_tpu_torch.ops import quant_matmul as tqm

    jcfg, tcfg = jsv.SenseVoiceConfig(**SV_TINY), tsv.SenseVoiceConfig(**SV_TINY)
    j32 = jsv.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 16000)) * 2000).astype(np.float32)
    valid, lang = np.array([16000, 12000], np.int32), np.array([0, 3], np.int32)
    jargs = (jnp.asarray(audio), jnp.asarray(valid), jnp.asarray(lang))
    targs = (torch.from_numpy(audio), torch.from_numpy(valid), torch.from_numpy(lang))
    mm = tqm._CONFIG["mm"]
    tqm.set_quant_config(mm="f32")
    try:
        jp = jq.quantize_pytree(j32, objective="rtn", min_size=4096)
        jl = np.asarray(jsv.encode_logits(jp, jcfg, *jargs)[0])
        tl = tsv.encode_logits(tart.params_from_flat(jart.flatten_pytree(jp), "cpu"), tcfg, *targs)[0].numpy()
        assert np.abs(tl - jl).max() <= 1e-5 * np.abs(jl).max()  # the control

        jp = jq.quantize_pytree(j32, objective="dynamic", min_size=4096)
        tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
        assert tp["encoders"][0]["qkv"]["w"].dynamic
        jitted, calls = jax.jit(jq.dynamic_quant_dense), []

        def record(x, leaf):
            y = jitted(x, leaf)
            calls.append((np.asarray(x), np.asarray(y)))
            return y

        monkeypatch.setattr(jq, "dynamic_quant_dense", record)
        with jax.disable_jit():
            jl, jv = jsv.encode_logits(jp, jcfg, *jargs)
        jl = np.asarray(jl)
        real, step, x_gap, y_gap = tq.dynamic_quant_dense, iter(calls), [], []

        def forced(x, leaf):
            xj, yj = next(step)
            assert tuple(x.shape) == xj.shape
            x_gap.append(np.abs(x.numpy() - xj).max() / np.abs(xj).max())
            y = real(torch.from_numpy(xj.copy()), leaf).numpy()
            y_gap.append(np.abs(y - yj).max() / np.abs(yj).max())
            return torch.from_numpy(yj.copy())

        monkeypatch.setattr(ttr, "dynamic_quant_dense", forced)
        before = tqm.LAUNCHES
        tl, tv = tsv.encode_logits(tp, tcfg, *targs)
        assert tqm.LAUNCHES == before  # no weight-only product on a dynamic tree
    finally:
        tqm._CONFIG["mm"] = mm
    assert len(x_gap) == len(calls) == 4 * 3 + 1
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert max(y_gap) <= 1e-6, y_gap
    assert max(x_gap) <= 1e-5, x_gap
    assert np.abs(tl.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()


@pytest.mark.parametrize("objective", ["rtn", "kquant", "hqq", "dynamic"])
def test_quantize_pytree_objectives_bitwise(objective):
    """The walk with ``objective`` over a tree with linears, a depthwise
    kernel and an embedding table: the same leaves in both packages; under
    dynamic the table takes an 8-bit rtn fit although ``bits`` is 4."""
    rng = np.random.default_rng(6)
    tree = {"embed": (rng.standard_normal((600, 256)) * 0.05).astype(np.float32),
            "layers": [{"attn": {"w": _w(256, 256, 1), "b": np.zeros(256, np.float32)},
                        "dw": {"w": _w(256, 256, 2)}}],
            "small": {"w": _w(64, 32, 3)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = tart.params_from_flat(jart.flatten_pytree(jtree), "cpu")
    kw = dict(bits=4, block=64, min_size=4096, objective=objective, quantize_embeddings=True)
    jflat = jart.flatten_pytree(jq.quantize_pytree(jtree, **kw))
    tout = tq.quantize_pytree(ttree, **kw)
    tflat = tart.flatten_pytree(tout)
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        if key.endswith(("/scale", "/scale_t")) and "__q" in key:
            _assert_same_scales(want, tflat[key], key)
        else:
            assert tflat[key].dtype == want.dtype and tflat[key].tobytes() == want.tobytes(), key
    assert tout["embed"].bits == (8 if objective == "dynamic" else 4)
    assert tq.is_quantized(tout["layers"][0]["attn"]["w"]) and not tq.is_quantized(tout["layers"][0]["dw"]["w"])
    assert jq.is_quantized({"q": 1, "scale": 1, "bits": 8}) == tq.is_quantized({"q": 1, "scale": 1, "bits": 8})


@pytest.mark.parametrize("objective", ["rtn", "kquant", "hqq", "dynamic"])
def test_quantization_error_matches(objective):
    w = _w(512, 128, 8, "heavy")
    jleaf = jq.quantize_linear(jnp.asarray(w), 4, 128, 2, objective=objective)
    tleaf = tq.quantize_linear(torch.from_numpy(w), 4, 128, 2, objective=objective)
    want = jq.quantization_error(jnp.asarray(w), jleaf)
    got = tq.quantization_error(torch.from_numpy(w), tleaf)
    assert abs(got - want) <= 1e-6 * want
    assert 0 < got < 0.2
