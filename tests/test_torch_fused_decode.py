"""PyTorch port: the batch-1 Qwen3 decode step (stacking, the plain version,
the wrapper) against the JAX package's ``fused_decode_step(interpret=True)``.

Geometry: the JAX test's own (``tests/test_fused_decode.py``), which the
Pallas kernel tiles: head width 128, hidden 256, 2/1 heads, ffn 512, two
layers, q4-packed weights (and a q4 tied head).

Tolerances. Both versions round every matvec input to bf16. A last-bit f32
difference from another summation order can flip one such rounding (2^-9
relative) and the flip moves every later layer, so the two agree to a bf16
step: logits and the final-normalized hidden within 1e-2 of their max. The
first layer's written k/v row sits behind one rounding only (its RMSNorm
output): within 1e-3 of max|row|, plus 2^-8 for a bf16 cache's own
rounding. Rows the step does not write are bitwise unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.layers import qwen3 as jq3
from asr_tpu.layers.rope import rope_tables as jrope
from asr_tpu.ops import fused_decode as jfd
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.ops import fused_decode as tfd
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.runtime import artifact as tart

SIZE = dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
            ffn_dim=512, rope_theta=1e4, max_seq_len=32)
JCFG, TCFG = jq3.Qwen3Config(**SIZE), tq3.Qwen3Config(**SIZE)
T_MAX, PROMPT = 16, 6
LOGIT_TOL = 1e-2
ROW0_TOL = {"float32": 1e-3, "bfloat16": 1e-3 + 2.0**-8}


@pytest.fixture(scope="module")
def models():
    jp = jq3.fuse_params(jquantize_pytree(jq3.init_params(JCFG, jax.random.PRNGKey(5)), bits=4,
                                          block=128, min_size=0, pack=True, refine_iters=0,
                                          quantize_embeddings=True), JCFG)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    return jp, tp, jfd.stack_decode_params(jp, JCFG), tfd.stack_decode_params(tp, TCFG)


@pytest.fixture(autouse=True)
def _threads():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")  # the per-weight path: the JAX package's exact CPU product
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _prefilled(jp, shift, dtype):
    embeds = jax.random.normal(jax.random.PRNGKey(7), (1, PROMPT, JCFG.hidden), jnp.float32) * 0.3
    state = jq3.make_kv_state(JCFG, 1, T_MAX, jnp.float32)
    bias = jq3.left_prefill_bias(jnp.asarray([shift], jnp.int32), PROMPT, T_MAX)
    _, state = jq3.decoder_pass(jp, JCFG, embeds, state, jnp.asarray(0, jnp.int32), bias,
                                pos_offset=jnp.asarray([shift], jnp.int32))
    kvw = JCFG.num_kv_heads * JCFG.head_dim
    k = jnp.stack([ls["k"][0].reshape(T_MAX, kvw) for ls in state["layers"]]).astype(dtype)
    v = jnp.stack([ls["v"][0].reshape(T_MAX, kvw) for ls in state["layers"]]).astype(dtype)
    return state, k, v


def _rope_rows(pos, shift):
    cs = np.asarray(jrope(T_MAX, JCFG.head_dim, JCFG.rope_theta))
    logical = int(np.clip(pos - shift, 0, T_MAX - 1))
    return cs[0][logical][None], cs[1][logical][None]


def test_stacked_arrays_match_jax_bitwise(models):
    _, _, sj, st = models
    assert sorted(sj) == sorted(st) and "wh" in st
    assert st["wh"].shape[1] % 2048 == 0 and st["wh"].shape[0] == TCFG.hidden // 2
    assert st["qkv_s"].shape == (2, 2, 1, 512)  # (NL, 2 nibble planes, NB/2, N)
    for k, want in sj.items():
        want = np.asarray(want)
        got = st[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_stack_returns_none_for_other_layouts(models):
    jp = jq3.init_params(JCFG, jax.random.PRNGKey(1))
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    assert tfd.stack_decode_params(tq3.fuse_params(tp, TCFG), TCFG) is None  # f32
    q8 = tart.params_from_flat(jart.flatten_pytree(jq3.fuse_params(
        jquantize_pytree(jp, bits=8, min_size=0, refine_iters=0), JCFG)), "cpu")
    assert tfd.stack_decode_params(q8, TCFG) is None
    unfused = tart.params_from_flat(jart.flatten_pytree(jquantize_pytree(
        jp, bits=4, block=128, min_size=0, pack=True, refine_iters=0)), "cpu")
    assert tfd.stack_decode_params(unfused, TCFG) is None  # no qkv / gateup leaves
    _, tq, _, _ = models
    no_final = {k: v for k, v in tq.items() if k != "final_norm"}
    assert tfd.stack_decode_params(no_final, TCFG) is None
    no_head = {**tq, "embed": tq["embed"].dequant()}
    st = tfd.stack_decode_params(no_head, TCFG)
    assert st is not None and "wh" not in st


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("head", ["in_kernel", "separate"])
def test_plain_version_matches_jax_interpret_kernel(models, cache, shift, head):
    """Three consecutive steps; the JAX kernel and the plain version start
    each step from the same caches (the JAX kernel's)."""
    jp, tp, sj, st = models
    if head == "separate":
        sj = {k: v for k, v in sj.items() if k not in ("wh", "h_s", "h_zs")}
        st = {k: v for k, v in st.items() if k not in ("wh", "h_s", "h_zs")}
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    _, kc, vc = _prefilled(jp, shift, jdt)
    v = TCFG.vocab_size
    for i in range(3):
        pos = PROMPT + i
        x = (jax.random.normal(jax.random.PRNGKey(20 + i), (1, JCFG.hidden), jnp.float32) * 0.3)
        cos, sin = _rope_rows(pos, shift)
        jh, jl, jk, jv = jfd.fused_decode_step(sj, JCFG, x, kc, vc, jnp.asarray(pos, jnp.int32),
                                               jnp.asarray(shift, jnp.int32), jnp.asarray(cos),
                                               jnp.asarray(sin), interpret=True)
        tk, tv = _to_torch(kc), _to_torch(vc)
        th, tl, tk2, tv2 = tfd.fused_decode_step(st, TCFG, torch.from_numpy(np.array(x)), tk, tv,
                                                 pos, shift, torch.from_numpy(cos),
                                                 torch.from_numpy(sin))
        assert tk2 is tk and tv2 is tv  # written in place
        jh = np.asarray(jh)
        np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=LOGIT_TOL * np.abs(jh).max())
        if head == "in_kernel":
            jl = np.asarray(jl)
            got = tl.numpy()
            assert got.shape == (1, st["wh"].shape[1])
            np.testing.assert_allclose(got[:, :v], jl[:, :v], rtol=0,
                                       atol=LOGIT_TOL * np.abs(jl).max())
            np.testing.assert_array_equal(got[:, v:], 0.0)
        else:
            assert tl is None and jl is None
            jlg = np.asarray(jq3.logits_from_normalized(jp, JCFG, jnp.asarray(jh)))
            tlg = tq3.logits_from_normalized(tp, TCFG, th).numpy()
            np.testing.assert_allclose(tlg, jlg, rtol=0, atol=LOGIT_TOL * np.abs(jlg).max())
        for want, have, old in ((jk, tk, kc), (jv, tv, vc)):
            want = np.asarray(want.astype(jnp.float32))
            have = have.float().numpy()
            ref = np.abs(want[0, pos]).max()
            np.testing.assert_allclose(have[0, pos], want[0, pos], rtol=0, atol=ROW0_TOL[cache] * ref)
            bound = (LOGIT_TOL + (2.0**-8 if cache == "bfloat16" else 0)) * np.abs(want[:, pos]).max()
            np.testing.assert_allclose(have[:, pos], want[:, pos], rtol=0, atol=bound)
            keep = np.arange(T_MAX) != pos
            np.testing.assert_array_equal(have[:, keep], np.asarray(old.astype(jnp.float32))[:, keep])
        kc, vc = jk, jv


def test_plain_version_matches_per_weight_step(models):
    """The JAX test's own comparison: a step against the per-weight decoder
    (q4 weights dequantized, f32 matmuls); final-normalized hidden within
    2e-2 and logits within 3e-2 of their max."""
    jp, tp, _, st = models
    shift = 2
    jstate, kc, vc = _prefilled(jp, shift, jnp.bfloat16)
    tstate = {"layers": tuple({k: _to_torch(a) for k, a in ls.items()} for ls in jstate["layers"])}
    x = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(9), (1, 1, JCFG.hidden))
                                    * 0.3, np.float32))
    pos = PROMPT
    sh = torch.tensor([shift])
    h_ref, _ = tq3.decoder_pass(tp, TCFG, x, tstate, pos, tq3.left_step_bias(sh, pos, T_MAX),
                                pos_offset=sh)
    want = tq3.logits_from_hidden(tp, TCFG, h_ref[:, 0])
    ref_h = tq3.rms_norm(h_ref[:, 0], tp["final_norm"]["scale"], TCFG.rms_eps)
    cos, sin = _rope_rows(pos, shift)
    h, lg, _, _ = tfd.fused_decode_step(st, TCFG, x[:, 0], _to_torch(kc), _to_torch(vc), pos, shift,
                                        torch.from_numpy(cos), torch.from_numpy(sin))
    assert float((h - ref_h).abs().max()) <= 2e-2 * float(ref_h.abs().max())
    v = TCFG.vocab_size
    assert float((lg[:, :v] - want).abs().max()) <= 3e-2 * float(want.abs().max())


def test_cpu_wrapper_runs_plain_version_and_launcher_refuses_cpu(models):
    _, _, _, st = models
    kvw = TCFG.num_kv_heads * 128
    g = torch.Generator().manual_seed(3)
    kc, vc = torch.randn((2, T_MAX, kvw), generator=g), torch.randn((2, T_MAX, kvw), generator=g)
    x = torch.randn((1, TCFG.hidden), generator=g) * 0.3
    cos, sin = (torch.from_numpy(a) for a in _rope_rows(7, 1))
    before = tfd.LAUNCHES
    got = tfd.fused_decode_step(st, TCFG, x, kc.clone(), vc.clone(), 7, 1, cos, sin)
    want = tfd.fused_decode_step_reference(st, TCFG, x, kc.clone(), vc.clone(), 7, 1, cos, sin)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tfd.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tfd.fused_decode_step_cuda(st, TCFG, x, kc, vc, 7, 1, cos, sin)


def test_rows_below_shift_are_ignored(models):
    _, _, _, st = models
    kvw = TCFG.num_kv_heads * 128
    g = torch.Generator().manual_seed(4)
    kc, vc = torch.randn((2, T_MAX, kvw), generator=g), torch.randn((2, T_MAX, kvw), generator=g)
    x = torch.randn((1, TCFG.hidden), generator=g) * 0.3
    cos, sin = (torch.from_numpy(a) for a in _rope_rows(9, 3))
    a = tfd.fused_decode_step(st, TCFG, x, kc.clone(), vc.clone(), 9, 3, cos, sin)
    k2, v2 = kc.clone(), vc.clone()
    k2[:, :3], v2[:, :3] = 1e4, -1e4
    k2[:, 10:], v2[:, 10:] = -1e4, 1e4
    b = tfd.fused_decode_step(st, TCFG, x, k2, v2, 9, 3, cos, sin)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
