"""PyTorch port: the multi-slot Qwen3 decode step (the plain version and the
wrapper) against the JAX package's ``fused_decode_step_multi(interpret=True)``.

Geometry: the JAX test's own (``tests/test_fused_decode_multi.py``): head
width 128, hidden 256, 2/1 heads, ffn 512, two layers, 16 cache rows, 4
slots, q4-packed weights and a q4 tied head. The slots' compact caches come
from one JAX prefill of prompts of 6, 3, 9 and 5 tokens; the step runs the
slots at positions 6, 3, parked (-1) and 5.

Tolerances. Both versions round every matvec input to bf16, so a last-bit
f32 difference from another summation order can flip one rounding, and the
flip moves every later value: the hidden state and the logits agree within
2^-8 of their max (one bf16 step), and each written cache row within the
same bound plus one rounding of the cache dtype (2^-8 relative for bf16).
Measured on these inputs: slot 3 agrees to 1.6e-7 (no rounding flips),
slot 0 to 1.6e-3 of max|logit| (one flip in its first layer), which is why
the bound is a bf16 step and not 1e-3. Rows a step does not write, and
every row of a parked slot, are bitwise unchanged. A parked slot's outputs
are garbage in both packages (the TPU kernel averages the whole plane, the
port attends the fresh row only): they are only checked to be finite.
Each slot of the plain version equals the port's batch-1 plain
version (``fused_decode_step_reference`` at shift 0) bitwise: it runs the
same per-layer code on the same values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.layers import qwen3 as jq3
from asr_tpu.layers.rope import rope_tables as jrope
from asr_tpu.ops import fused_decode as jfd
from asr_tpu.ops import fused_decode_multi as jfm
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.ops import fused_decode as tfd
from asr_tpu_torch.ops import fused_decode_multi as tfm
from asr_tpu_torch.runtime import artifact as tart

SIZE = dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
            ffn_dim=512, rope_theta=1e4, max_seq_len=32)
JCFG, TCFG = jq3.Qwen3Config(**SIZE), tq3.Qwen3Config(**SIZE)
T_MAX, LENS = 16, (6, 3, 9, 5)
POS = (6, 3, -1, 5)  # slot 2 parked
TOL = 2.0**-8
CACHES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
HEADLESS = ("wh", "h_s", "h_zs")


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rope_rows(pos):
    cs = np.asarray(jrope(T_MAX, JCFG.head_dim, JCFG.rope_theta))
    logical = np.clip(np.asarray(pos), 0, T_MAX - 1)
    return cs[0][logical], cs[1][logical]


@pytest.fixture(scope="module")
def models():
    jp = jq3.fuse_params(jquantize_pytree(jq3.init_params(JCFG, jax.random.PRNGKey(5)), bits=4,
                                          block=128, min_size=0, pack=True, refine_iters=0,
                                          quantize_embeddings=True), JCFG)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    return jp, jfd.stack_decode_params(jp, JCFG), tfd.stack_decode_params(tp, TCFG)


@pytest.fixture(scope="module")
def jax_steps(models):
    """Inputs and JAX's interpret-mode outputs, once per (cache, head) case."""
    jp, sj, _ = models
    rng = np.random.default_rng(11)
    prompt = jnp.asarray((rng.standard_normal((4, max(LENS), JCFG.hidden)) * 0.3).astype(np.float32))
    # row b's prompt fills its compact cache [0, LENS[b]); the rows past it
    # hold pad garbage that the step never reads
    _, state = jq3.decoder_pass(jp, JCFG, prompt, jq3.make_kv_state(JCFG, 4, T_MAX),
                                jnp.asarray(0, jnp.int32),
                                jq3.causal_prefill_bias(jnp.asarray(LENS, jnp.int32), max(LENS),
                                                        T_MAX))
    kvw = JCFG.num_kv_heads * JCFG.head_dim
    k = jnp.stack([ls["k"].reshape(4, T_MAX, kvw) for ls in state["layers"]])
    v = jnp.stack([ls["v"].reshape(4, T_MAX, kvw) for ls in state["layers"]])
    x = (rng.standard_normal((4, JCFG.hidden)) * 0.3).astype(np.float32)
    cos, sin = _rope_rows(POS)
    out = {}
    for cache, jdt in CACHES.items():
        for head in ("in_kernel", "separate"):
            stk = sj if head == "in_kernel" else {n: a for n, a in sj.items() if n not in HEADLESS}
            kc, vc = k.astype(jdt), v.astype(jdt)
            res = jfm.fused_decode_step_multi(stk, JCFG, jnp.asarray(x), kc, vc,
                                              jnp.asarray(POS, jnp.int32), jnp.asarray(cos),
                                              jnp.asarray(sin), interpret=True)
            out[cache, head] = (kc, vc, res)
    return x, cos, sin, out


def _port_inputs(x, cos, sin, kc, vc):
    return (torch.from_numpy(x), _to_torch(kc), _to_torch(vc), torch.tensor(POS, dtype=torch.int32),
            torch.from_numpy(cos), torch.from_numpy(sin))


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("head", ["in_kernel", "separate"])
def test_plain_version_matches_jax_interpret_kernel(models, jax_steps, cache, head):
    jp, _, st = models
    if head == "separate":
        st = {n: a for n, a in st.items() if n not in HEADLESS}
    x, cos, sin, out = jax_steps
    kc, vc, (jh, jl, jk, jv) = out[cache, head]
    tx, tk, tv, tpos, tcos, tsin = _port_inputs(x, cos, sin, kc, vc)
    before_k, before_v = tk.clone(), tv.clone()
    th, tl, tk2, tv2 = tfm.fused_decode_step_multi(st, TCFG, tx, tk, tv, tpos, tcos, tsin)
    assert tk2 is tk and tv2 is tv  # written in place
    jh = np.asarray(jh)
    assert np.isfinite(th.numpy()).all()
    live = [b for b, p in enumerate(POS) if p >= 0]
    np.testing.assert_allclose(th.numpy()[live], jh[live], rtol=0, atol=TOL * np.abs(jh[live]).max())
    v = TCFG.vocab_size
    if head == "in_kernel":
        jl, got = np.asarray(jl), tl.numpy()
        assert got.shape == (4, st["wh"].shape[1]) and np.isfinite(got).all()
        np.testing.assert_array_equal(got[:, v:], 0.0)
        np.testing.assert_allclose(got[live, :v], jl[live, :v], rtol=0,
                                   atol=TOL * np.abs(jl[live, :v]).max())
    else:
        assert tl is None and jl is None
    row_tol = TOL + (2.0**-8 if cache == "bfloat16" else 0.0)
    for want, have, old in ((jk, tk, before_k), (jv, tv, before_v)):
        want = np.asarray(want.astype(jnp.float32))
        for b, p in enumerate(POS):
            if p < 0:  # parked: writes nothing
                assert torch.equal(have[:, b], old[:, b])
                continue
            np.testing.assert_allclose(have[:, b, p].float().numpy(), want[:, b, p], rtol=0,
                                       atol=row_tol * np.abs(want[:, b, p]).max())
            keep = torch.arange(T_MAX) != p
            assert torch.equal(have[:, b, keep], old[:, b, keep])


@pytest.mark.parametrize("cache", list(CACHES))
def test_each_slot_equals_the_batch1_plain_version(models, jax_steps, cache):
    """Bitwise, slot by slot, against ``fused_decode_step_reference`` at
    shift 0 on that slot's planes alone."""
    _, _, st = models
    x, cos, sin, out = jax_steps
    kc, vc, _ = out[cache, "in_kernel"]
    tx, tk, tv, tpos, tcos, tsin = _port_inputs(x, cos, sin, kc, vc)
    planes = (tk.clone(), tv.clone())
    h, lg, _, _ = tfm.fused_decode_step_multi(st, TCFG, tx, tk, tv, tpos, tcos, tsin)
    for b, p in enumerate(POS):
        k1, v1 = planes[0][:, b].clone(), planes[1][:, b].clone()
        if p < 0:  # a parked slot attends its fresh row only, as at position 0
            k1, v1, p = k1[:, :1].clone(), v1[:, :1].clone(), 0
        wh, wl, _, _ = tfd.fused_decode_step_reference(st, TCFG, tx[b : b + 1], k1, v1, p, 0,
                                                       tcos[b : b + 1], tsin[b : b + 1])
        assert torch.equal(h[b : b + 1], wh) and torch.equal(lg[b : b + 1], wl)
        if POS[b] >= 0:
            assert torch.equal(tk[:, b], k1) and torch.equal(tv[:, b], v1)


def test_slot_layout_does_not_change_a_slot(models, jax_steps):
    """A request's row does not depend on which slot it rides in or on the
    other slots: slot 3's request moved to slot 0, the others parked."""
    _, _, st = models
    x, cos, sin, out = jax_steps
    kc, vc, _ = out["bfloat16", "in_kernel"]
    tx, tk, tv, tpos, tcos, tsin = _port_inputs(x, cos, sin, kc, vc)
    h, lg, _, _ = tfm.fused_decode_step_multi(st, TCFG, tx, tk.clone(), tv.clone(), tpos, tcos, tsin)
    perm = [3, 0, 1, 2]
    pos2 = torch.tensor([POS[3], -1, -1, -1], dtype=torch.int32)
    h2, lg2, _, _ = tfm.fused_decode_step_multi(st, TCFG, tx[perm], tk[:, perm].contiguous(),
                                                tv[:, perm].contiguous(), pos2, tcos[perm],
                                                tsin[perm])
    assert torch.equal(h2[0], h[3]) and torch.equal(lg2[0], lg[3])


def test_wrapper_routes_and_refuses(models):
    """A CPU tensor runs the plain version without counting a launch; the
    launcher refuses CPU tensors; batch 1 is refused; the batcher's gate
    follows the kernel's rule."""
    _, _, st = models
    kvw = TCFG.num_kv_heads * 128
    g = torch.Generator().manual_seed(3)
    args = (torch.randn((2, TCFG.hidden), generator=g) * 0.3, torch.randn((2, 2, T_MAX, kvw), generator=g),
            torch.randn((2, 2, T_MAX, kvw), generator=g), torch.tensor([7, -1], dtype=torch.int32),
            torch.rand((2, 128), generator=g), torch.rand((2, 128), generator=g))
    before = tfm.LAUNCHES
    got = tfm.fused_decode_step_multi(st, TCFG, *(a.clone() for a in args))
    want = tfm.fused_decode_step_multi_reference(st, TCFG, *(a.clone() for a in args))
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and tfm.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_decode_step_multi_cuda(st, TCFG, *args)
    with pytest.raises(ValueError, match=">= 2 slots"):
        tfm.fused_decode_step_multi(st, TCFG, args[0][:1], args[1][:, :1], args[2][:, :1],
                                    args[3][:1], args[4][:1], args[5][:1])
    assert tfm.kernel_takes(TCFG, 2) and tfm.kernel_takes(TCFG, tfm.MAX_SLOTS)
    assert not tfm.kernel_takes(TCFG, 1) and not tfm.kernel_takes(TCFG, tfm.MAX_SLOTS + 1)
    assert not tfm.kernel_takes(tq3.Qwen3Config(hidden=48, num_heads=4, num_kv_heads=2, head_dim=16,
                                                ffn_dim=64), 4)
    assert tfm.kernel_takes(tq3.Qwen3Config(), 8)  # Qwen3-ASR-0.6B's LLM
