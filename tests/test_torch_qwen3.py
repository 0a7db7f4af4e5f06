"""PyTorch port: the Qwen3 decoder stack, RoPE and RMSNorm against the JAX
package on the same parameters and inputs.

Geometry: the fused-decode test's (head width 128, hidden 256, 2/1 heads,
ffn 512, two layers) and a GQA one with 4/2 heads of 64. Tolerance 1e-4 of
max|ref|: both sides compute in f32 (JAX at "highest" matmul precision, the
port's quantized linears in the exact ``mm="f32"`` mode), so they differ by
summation order only; biases and RoPE tables are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.layers import norms as jnorms
from asr_tpu.layers import qwen3 as jq3
from asr_tpu.layers import rope as jrope
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.layers import norms as tnorms
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.layers import rope as trope
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.runtime import artifact as tart

TOL = 1e-4
SIZES = {
    "h128": dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1,
                 head_dim=128, ffn_dim=512, rope_theta=1e4, max_seq_len=32),
    "gqa": dict(vocab_size=96, hidden=128, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=64, ffn_dim=256, rope_theta=1e4, max_seq_len=32),
}
T_MAX = 16


@pytest.fixture(autouse=True)
def _f32_mode():
    prev = tqm._CONFIG["mm"]
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = prev


def _params(size, quant, seed=0):
    cfg = jq3.Qwen3Config(**SIZES[size])
    jp = jq3.init_params(cfg, jax.random.PRNGKey(seed))
    if quant == "q4":
        jp = jquantize_pytree(jp, bits=4, block=128 if cfg.hidden >= 256 else 64, min_size=0,
                              pack=True, refine_iters=0, quantize_embeddings=True)
    elif quant == "q8":
        jp = jquantize_pytree(jp, bits=8, min_size=0, refine_iters=0, quantize_embeddings=True)
    return cfg, tq3.Qwen3Config(**SIZES[size]), jp


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_rope_tables_and_rotation_match():
    for args in ((16, 128, 1e4), (40, 64, 5e6)):
        np.testing.assert_array_equal(trope.rope_tables(*args), jrope.rope_tables(*args))
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 64)).astype(np.float32)
    cs = jrope.rope_tables(8, 64, 1e4)
    for cos, sin in ((cs[0][:5], cs[1][:5]), (np.stack([cs[0][:5], cs[0][3:8]]),
                                              np.stack([cs[1][:5], cs[1][3:8]]))):
        want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
        got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
        _close(got, want, 1e-6)
    np.testing.assert_array_equal(trope.rotate_half(torch.from_numpy(x)).numpy(),
                                  np.asarray(jrope.rotate_half(jnp.asarray(x))))


def test_rms_norm_matches():
    x = np.random.default_rng(1).standard_normal((3, 7, 128)).astype(np.float32) * 3
    s = np.random.default_rng(2).standard_normal(128).astype(np.float32)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), 1e-6)


def test_biases_match_bitwise():
    shift = np.asarray([0, 3, 5], np.int32)
    valid = np.asarray([6, 3, 1], np.int32)
    for name, args in (("causal_prefill_bias", (valid, 6, T_MAX)), ("step_bias", (valid, 9, T_MAX)),
                       ("left_prefill_bias", (shift, 6, T_MAX)),
                       ("left_step_bias", (shift, 9, T_MAX))):
        want = np.asarray(getattr(jq3, name)(jnp.asarray(args[0]), *args[1:]))
        got = getattr(tq3, name)(torch.from_numpy(args[0]), *args[1:]).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_fuse_params_match_bitwise():
    _, tcfg, jp = _params("h128", "q4")
    jf = jq3.fuse_params(jp, jq3.Qwen3Config(**SIZES["h128"]))
    tf = tq3.fuse_params(tart.params_from_flat(jart.flatten_pytree(jp), "cpu"), tcfg)
    want = jart.flatten_pytree(jf)
    got = tart.flatten_pytree(tf)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert "qkv" in tf["layers"][0]["attn"] and "gateup" in tf["layers"][1]["mlp"]
    assert tf["layers"][0]["attn"]["qkv"]["w"].packed
    assert tq3.fuse_params(None, tcfg) is None


@pytest.mark.parametrize("size", ["h128", "gqa"])
@pytest.mark.parametrize("quant", ["f32", "q4", "q8"])
@pytest.mark.parametrize("fused", [False, True])
def test_left_padded_prefill_and_steps_match(size, quant, fused):
    """Prefill of a left-padded batch (shift 0 and 3, pos_offset), then two
    single-token steps with the left step bias; hidden, caches and logits."""
    jcfg, tcfg, jp = _params(size, quant)
    if fused:
        jp = jq3.fuse_params(jp, jcfg)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    rng = np.random.default_rng(3)
    s = 6
    x = (rng.standard_normal((2, s, jcfg.hidden)) * 0.3).astype(np.float32)
    shift = np.asarray([0, 3], np.int32)
    jstate = jq3.make_kv_state(jcfg, 2, T_MAX)
    tstate = tq3.make_kv_state(tcfg, 2, T_MAX)
    jh, jstate = jq3.decoder_pass(jp, jcfg, jnp.asarray(x), jstate, jnp.asarray(0, jnp.int32),
                                  jq3.left_prefill_bias(jnp.asarray(shift), s, T_MAX),
                                  pos_offset=jnp.asarray(shift))
    th, tstate2 = tq3.decoder_pass(tp, tcfg, torch.from_numpy(x), tstate, 0,
                                   tq3.left_prefill_bias(torch.from_numpy(shift), s, T_MAX),
                                   pos_offset=torch.from_numpy(shift))
    assert tstate2 is tstate  # written in place
    _close(th, jh)
    for pos in (s, s + 1):
        xs = (rng.standard_normal((2, 1, jcfg.hidden)) * 0.3).astype(np.float32)
        jh, jstate = jq3.decoder_pass(jp, jcfg, jnp.asarray(xs), jstate, jnp.asarray(pos, jnp.int32),
                                      jq3.left_step_bias(jnp.asarray(shift), pos, T_MAX),
                                      pos_offset=jnp.asarray(shift))
        th, _ = tq3.decoder_pass(tp, tcfg, torch.from_numpy(xs), tstate, pos,
                                 tq3.left_step_bias(torch.from_numpy(shift), pos, T_MAX),
                                 pos_offset=torch.from_numpy(shift))
        _close(th, jh)
    for jl, tl in zip(jstate["layers"], tstate["layers"]):
        _close(tl["k"], jl["k"])
        _close(tl["v"], jl["v"])
    _close(tq3.logits_from_hidden(tp, tcfg, th[:, -1]),
           jq3.logits_from_hidden(jp, jcfg, jh[:, -1]))


def test_causal_prefill_without_offset_matches():
    jcfg, tcfg, jp = _params("gqa", "f32", seed=2)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    x = (np.random.default_rng(5).standard_normal((2, 5, jcfg.hidden)) * 0.3).astype(np.float32)
    valid = np.asarray([5, 3], np.int32)
    jh, _ = jq3.decoder_pass(jp, jcfg, jnp.asarray(x), jq3.make_kv_state(jcfg, 2, 8),
                             jnp.asarray(0, jnp.int32),
                             jq3.causal_prefill_bias(jnp.asarray(valid), 5, 8))
    th, _ = tq3.decoder_pass(tp, tcfg, torch.from_numpy(x), tq3.make_kv_state(tcfg, 2, 8), 0,
                             tq3.causal_prefill_bias(torch.from_numpy(valid), 5, 8))
    _close(th, jh)


def test_init_params_layout_matches():
    jcfg, tcfg, jp = _params("gqa", "f32")
    tp = tq3.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: np.asarray(v) for k, v in jart.flatten_pytree(jp).items()}
    got = tart.flatten_pytree(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    w = got["layers/0/attn/q/w"]
    assert abs(float(w.std()) - jcfg.hidden ** -0.5) < 0.1 * jcfg.hidden ** -0.5


def test_rowwise_step_bias_matches_bitwise():
    pos = np.asarray([0, 5, 15, 9], np.int32)
    want = np.asarray(jq3.rowwise_step_bias(jnp.asarray(pos), T_MAX))
    got = tq3.rowwise_step_bias(torch.from_numpy(pos), T_MAX).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,quant", [("gqa", "f32"), ("h128", "q4")])
def test_decoder_step_rowwise_matches(size, quant):
    """Per-row positions over compact caches (continuous batching), one row
    parked: hidden and every cache row against JAX's
    ``decoder_step_rowwise``; the parked row's caches are untouched."""
    jcfg, tcfg, jp = _params(size, quant, seed=4)
    jp = jq3.fuse_params(jp, jcfg)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    rng = np.random.default_rng(6)
    lens = [6, 3, 9, 5]
    # one prefill of all rows: row b's prompt fills its compact cache [0, lens[b]);
    # the rows past it hold pad garbage that the step's bias masks
    emb = jnp.asarray((rng.standard_normal((len(lens), 9, jcfg.hidden)) * 0.3).astype(np.float32))
    _, state = jq3.decoder_pass(jp, jcfg, emb, jq3.make_kv_state(jcfg, len(lens), T_MAX),
                                jnp.asarray(0, jnp.int32),
                                jq3.causal_prefill_bias(jnp.asarray(lens, jnp.int32), 9, T_MAX))
    tstate = {"layers": tuple({k: torch.from_numpy(np.array(v)) for k, v in ls.items()}
                              for ls in state["layers"])}
    before = [ls["k"].clone() for ls in tstate["layers"]]
    x = (rng.standard_normal((len(lens), 1, jcfg.hidden)) * 0.3).astype(np.float32)
    pos, active = np.asarray(lens, np.int32), np.asarray([True, True, False, True])
    jh, jst = jq3.decoder_step_rowwise(jp, jcfg, jnp.asarray(x), state, jnp.asarray(pos),
                                       jnp.asarray(active))
    th, tst = tq3.decoder_step_rowwise(tp, tcfg, torch.from_numpy(x), tstate,
                                       torch.from_numpy(pos), torch.from_numpy(active))
    assert tst is tstate  # written in place
    _close(th, jh, 1e-5)
    for tl, jl, old in zip(tst["layers"], jst["layers"], before):
        _close(tl["k"], jl["k"], 1e-5)
        _close(tl["v"], jl["v"], 1e-5)
        assert torch.equal(tl["k"][2], old[2])  # the parked row wrote nowhere
    # without ``active`` every row writes, as in JAX
    jh2, _ = jq3.decoder_step_rowwise(jp, jcfg, jnp.asarray(x), state, jnp.asarray(pos))
    th2, _ = tq3.decoder_step_rowwise(tp, tcfg, torch.from_numpy(x), tstate, torch.from_numpy(pos))
    _close(th2, jh2, 1e-5)
