"""PyTorch port: the batch-1 AED decode step (stacking, the plain version, the
wrapper) against the JAX package's ``fused_whisper_step(interpret=True)``.

Geometry: the JAX test's own (``tests/test_fused_aed_step.py``), which the
Pallas kernel tiles: head_dim 64, d_model 256, ffn 1024, two decoder layers.

Tolerances. Both versions round every matvec input to bf16. A last-bit f32
difference from another summation order can flip one such rounding (2^-9
relative) and the flip moves every later layer, so after two layers the two
agree to a bf16 step: logits within 1e-2 of max|logit| (measured: up to
3e-3). The rows each step writes agree to the same bound (a bf16 cache adds
its own rounding, 2^-8 of max|row|); rows it does not write are bitwise
unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.models import whisper as jwh
from asr_tpu.ops import fused_aed_step as jfs
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedLinear
from asr_tpu_torch.runtime import artifact as tart

TINY = dict(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4,
            ffn_dim=1024, n_mels=16, max_source_positions=24, max_target_positions=16,
            sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4)
JCFG, TCFG = jwh.WhisperConfig(**TINY), twh.WhisperConfig(**TINY)
T_SELF, TC_VALID = 16, 24
LOGIT_TOL = 1e-2


@pytest.fixture(scope="module")
def models():
    jp = jquantize_pytree(jwh.init_params(JCFG, jax.random.PRNGKey(0)), bits=8, block=128,
                          min_size=0, refine_iters=0, quantize_embeddings=True)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    return jp, tp, jfs.stack_whisper_step_params(jp, JCFG), tfs.stack_whisper_step_params(tp, TCFG)


@pytest.fixture(autouse=True)
def _threads():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")  # the per-weight path: the JAX package's exact CPU product
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def test_stacked_arrays_match_jax_bitwise(models):
    _, _, sj, st = models
    assert sorted(sj) == sorted(st)
    v_pad = st["wh"].shape[1]
    assert v_pad % 512 == 0 and v_pad >= TCFG.vocab_size
    for k, want in sj.items():
        want = np.asarray(want)
        got = st[k].numpy()
        if k in ("wh", "h_s", "h_zs"):  # the JAX head is re-padded to its strip width
            assert not want[..., v_pad:].any(), k
            want = want[..., :v_pad]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_stack_returns_none_for_other_layouts():
    jp = jwh.init_params(JCFG, jax.random.PRNGKey(1))
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    assert tfs.stack_whisper_step_params(tp, TCFG) is None  # f32
    q8_no_embed = jquantize_pytree(jp, bits=8, block=128, min_size=0, refine_iters=0)
    assert tfs.stack_whisper_step_params(
        tart.params_from_flat(jart.flatten_pytree(q8_no_embed), "cpu"), TCFG) is None
    q8 = tart.params_from_flat(jart.flatten_pytree(jquantize_pytree(
        jp, bits=8, block=128, min_size=0, refine_iters=0, quantize_embeddings=True)), "cpu")
    assert tfs.stack_whisper_step_params(q8, TCFG) is not None
    w = q8["decoder"]["blocks"][1]["mlp"]["fc2"]["w"]
    q8["decoder"]["blocks"][1]["mlp"]["fc2"]["w"] = QuantizedLinear(w.q, w.scale, w.zero, 4, w.block)
    assert tfs.stack_whisper_step_params(q8, TCFG) is None  # q8 only


def _prefilled(jp, seed=1):
    enc = jax.random.normal(jax.random.PRNGKey(seed), (1, TC_VALID, JCFG.d_model), jnp.float32) * 0.3
    state = jwh.make_state(jp, JCFG, enc)
    _, state = jwh.prefill(jp, JCFG, state, jnp.asarray([[3, 7, 11, 2]], jnp.int32))
    return state


def _stacked_caches(state, t_cross, dtype):
    d = JCFG.d_model
    out = []
    for name, rows in (("self_k", T_SELF), ("self_v", T_SELF), ("cross_k", TC_VALID),
                       ("cross_v", TC_VALID)):
        a = jnp.stack([ls[name][0].reshape(rows, d) for ls in state["layers"]])
        if name.startswith("cross") and t_cross > rows:
            a = jnp.pad(a, ((0, 0), (0, t_cross - rows), (0, 0)))
        out.append(a.astype(dtype))
    return out


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_cross", [24, 1600])  # 1600: the JAX kernel's chunked cross path
def test_plain_version_matches_jax_interpret_kernel(models, cache, t_cross):
    """Two steps; the JAX kernel and the plain version start from the same
    caches, and each next step starts from the JAX kernel's caches."""
    jp, tp, sj, st = models
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    kc, vc, ck, cv = _stacked_caches(_prefilled(jp), t_cross, jdt)
    tc_valid = 20  # rows 20..23 hold real values: masking, not zeros, must drop them
    emb, posemb = jp["decoder"]["embed"], jp["decoder"]["pos"]
    v = TCFG.vocab_size
    for i, tok in enumerate((5, 9)):
        pos = 4 + i
        x = (emb[jnp.asarray([tok])] + posemb[pos][None]).astype(jnp.float32)
        jl, jk, jv = jfs.fused_whisper_step(sj, JCFG, x, kc, vc, ck, cv, jnp.asarray(pos, jnp.int32),
                                            tc_valid=tc_valid, interpret=True)
        tk, tv = _to_torch(kc), _to_torch(vc)
        tl, tk2, tv2 = tfs.fused_whisper_step(st, TCFG, torch.from_numpy(np.array(x)), tk, tv,
                                              _to_torch(ck), _to_torch(cv), pos, tc_valid=tc_valid)
        assert tk2 is tk and tv2 is tv  # written in place
        jl = np.asarray(jl)
        got = tl.numpy()
        assert got.shape == (1, st["wh"].shape[1])
        np.testing.assert_allclose(got[:, :v], jl[:, :v], rtol=0, atol=LOGIT_TOL * np.abs(jl).max())
        np.testing.assert_array_equal(got[:, v:], 0.0)
        for want, have, old in ((jk, tk, kc), (jv, tv, vc)):
            want = np.asarray(want.astype(jnp.float32))
            have = have.float().numpy()
            bound = (LOGIT_TOL + (2.0**-8 if cache == "bfloat16" else 0)) * np.abs(want[:, pos]).max()
            np.testing.assert_allclose(have[:, pos], want[:, pos], rtol=0, atol=bound)
            keep = np.arange(T_SELF) != pos
            np.testing.assert_array_equal(have[:, keep], np.asarray(old.astype(jnp.float32))[:, keep])
        kc, vc = jk, jv


def test_plain_version_matches_per_weight_step(models):
    """The JAX test's own comparison: one step against the per-weight decoder
    (q8 weights dequantized, f32 matmuls), within 3e-2 of max|logit|."""
    jp, tp, _, st = models
    state = _prefilled(jp, seed=2)
    kc, vc, ck, cv = (_to_torch(a) for a in _stacked_caches(state, TC_VALID, jnp.float32))
    tstate = {"layers": tuple({k: _to_torch(val) for k, val in ls.items()} for ls in state["layers"])}
    tok, pos = torch.tensor([[5]]), 4
    want, _ = twh.step(tp, TCFG, tstate, tok, pos)
    dec = tp["decoder"]
    x = dec["embed"][tok[:, 0]] + dec["pos"][pos : pos + 1]
    got, kc, vc = tfs.fused_whisper_step(st, TCFG, x, kc, vc, ck, cv, pos, tc_valid=TC_VALID)
    v = TCFG.vocab_size
    assert float((got[:, :v] - want).abs().max()) <= 3e-2 * float(want.abs().max())
    for name, cache in (("self_k", kc), ("self_v", vc)):
        rows = torch.stack([ls[name][0].reshape(T_SELF, -1) for ls in tstate["layers"]])
        assert float((cache[:, pos] - rows[:, pos]).abs().max()) <= 2e-2 * float(rows[:, pos].abs().max())


def test_cross_rows_past_tc_valid_are_ignored(models):
    _, _, _, st = models
    g = torch.Generator().manual_seed(3)
    nl, d = 2, TCFG.d_model
    kc, vc = torch.randn((nl, T_SELF, d), generator=g), torch.randn((nl, T_SELF, d), generator=g)
    ck, cv = torch.randn((nl, 40, d), generator=g), torch.randn((nl, 40, d), generator=g)
    x = torch.randn((1, d), generator=g) * 0.1
    a, _, _ = tfs.fused_whisper_step(st, TCFG, x, kc.clone(), vc.clone(), ck, cv, 7, tc_valid=30)
    ck2, cv2 = ck.clone(), cv.clone()
    ck2[:, 30:] = 1e4
    cv2[:, 30:] = -1e4
    b, _, _ = tfs.fused_whisper_step(st, TCFG, x, kc.clone(), vc.clone(), ck2, cv2, 7, tc_valid=30)
    assert torch.equal(a, b)
    c, _, _ = tfs.fused_whisper_step(st, TCFG, x, kc.clone(), vc.clone(), ck[:, :30], cv[:, :30], 7)
    assert torch.equal(a, c)


def test_cpu_wrapper_runs_plain_version_and_launcher_refuses_cpu(models):
    _, _, _, st = models
    nl, d = 2, TCFG.d_model
    args = (torch.zeros((1, d)), torch.zeros((nl, T_SELF, d)), torch.zeros((nl, T_SELF, d)),
            torch.zeros((nl, 8, d)), torch.zeros((nl, 8, d)), 0)
    geom = tfs.AedGeom(d, TCFG.ffn_dim, TCFG.num_heads)
    before = tfs.LAUNCHES
    got, _, _ = tfs.fused_aed_step(st, geom, *args)
    want, _, _ = tfs.fused_aed_step_reference(st, geom, *(a.clone() if torch.is_tensor(a) else a
                                                           for a in args))
    assert torch.equal(got, want) and tfs.LAUNCHES == before
    with pytest.raises(ValueError):
        tfs.fused_aed_step_cuda(st, geom, *args)
