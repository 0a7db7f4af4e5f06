"""PyTorch port: the multi-slot AED decode step (the plain version and the
wrapper) against the JAX package's ``fused_aed_step_multi(interpret=True)``.

Geometry: the JAX test's own (``tests/test_fused_aed_multi.py``): head_dim
64, d_model 256, ffn 1024, two decoder layers, 16 self rows, 32 cross rows.

Tolerances, as for the batch-1 step (``tests/test_torch_fused_aed_step.py``):
both versions round every matvec input to bf16, so a last-bit f32 difference
from another summation order can flip one rounding, and the flip moves every
later layer: logits agree within 1e-2 of max|logit| and each written row
within the same bound (plus 2^-8 for a bf16 cache's own rounding). Rows a
step does not write, and every row of a parked slot, are bitwise unchanged.
A parked slot's logits are garbage in both packages (the TPU kernel averages
the whole plane, the port attends the fresh row only): they are only
checked to be finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.models import whisper as jwh
from asr_tpu.ops import fused_aed_multi as jfm
from asr_tpu.ops import fused_aed_step as jfs
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.ops import fused_aed_multi as tfm
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.runtime import artifact as tart

TINY = dict(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4,
            ffn_dim=1024, n_mels=16, max_source_positions=24, max_target_positions=16,
            sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4)
JCFG = jwh.WhisperConfig(**TINY)
GEOM = tfs.AedGeom(JCFG.d_model, JCFG.ffn_dim, JCFG.num_heads)
JGEOM = jfs.AedGeom(JCFG.d_model, JCFG.ffn_dim, JCFG.num_heads)
T_SELF, TC_PAD = 16, 32
LOGIT_TOL = 1e-2


@pytest.fixture(scope="module")
def models():
    jp = jquantize_pytree(jwh.init_params(JCFG, jax.random.PRNGKey(0)), bits=8, block=128,
                          min_size=0, refine_iters=0, quantize_embeddings=True)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    from asr_tpu_torch.models import whisper as twh

    st = tfs.stack_whisper_step_params(tp, twh.WhisperConfig(**TINY))
    return jp, jfs.stack_whisper_step_params(jp, JCFG), st


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _slot_planes(jp, seed):
    """One request's planes: its own encoder output and prompt prefill, the
    cross rows past its tc_valid filled with noise (masking must drop them)."""
    tc_valid = 16 + 4 * (seed % 3)
    enc = jax.random.normal(jax.random.PRNGKey(100 + seed), (1, tc_valid, JCFG.d_model)) * 0.3
    state = jwh.make_state(jp, JCFG, enc)
    _, state = jwh.prefill(jp, JCFG, state, jnp.asarray([[3 + seed, 7, 11, 2]], jnp.int32))
    d = JCFG.d_model
    k, v, ck, cv = (jnp.stack([ls[name][0].reshape(-1, d) for ls in state["layers"]])
                    for name in ("self_k", "self_v", "cross_k", "cross_v"))
    noise = jax.random.normal(jax.random.PRNGKey(200 + seed), (2, k.shape[0], TC_PAD - tc_valid, d))
    ck = jnp.concatenate([ck, noise[0]], axis=1)
    cv = jnp.concatenate([cv, noise[1]], axis=1)
    return k, v, ck, cv, tc_valid


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _as_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_plain_version_matches_jax_interpret_kernel(models, cache):
    """B = 3 with mixed positions and tc_valid, then a second step with slot 1
    parked: logits, written rows, untouched rows and the parked slot."""
    jp, sj, st = models
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    slots = [_slot_planes(jp, s) for s in range(3)]
    kc, vc, ck, cv = (jnp.stack([s[i] for s in slots], axis=1).astype(jdt) for i in range(4))
    tcv = jnp.asarray([s[4] for s in slots], jnp.int32)
    emb, posemb = jp["decoder"]["embed"], jp["decoder"]["pos"]
    v = JCFG.vocab_size
    tk, tv, tck, tcv_t = _to_torch(kc), _to_torch(vc), _to_torch(ck), _to_torch(cv)
    for pos, toks in (([4, 6, 5], [5, 9, 13]), ([5, -1, 6], [17, 0, 21])):
        pos_j, toks_j = jnp.asarray(pos, jnp.int32), jnp.asarray(toks, jnp.int32)
        x = (emb[toks_j] + posemb[jnp.maximum(pos_j, 0)]).astype(jnp.float32)
        jl, jk, jv = jfm.fused_aed_step_multi(sj, JGEOM, x, kc, vc, ck, cv, pos_j, tcv,
                                              interpret=True)
        before_k, before_v = tk.clone(), tv.clone()
        tl, tk2, tv2 = tfm.fused_aed_step_multi(
            st, GEOM, torch.from_numpy(np.array(x)), tk, tv, tck, tcv_t,
            torch.tensor(pos, dtype=torch.int32), torch.from_numpy(np.array(tcv)))
        assert tk2 is tk and tv2 is tv  # written in place
        jl, got = np.asarray(jl), tl.numpy()
        assert got.shape == (3, st["wh"].shape[1]) and np.isfinite(got).all()
        np.testing.assert_array_equal(got[:, v:], 0.0)
        for b, p in enumerate(pos):
            if p < 0:  # parked: writes nothing, finite garbage
                assert torch.equal(tk[:, b], before_k[:, b]) and torch.equal(tv[:, b], before_v[:, b])
                continue
            np.testing.assert_allclose(got[b, :v], jl[b, :v], rtol=0,
                                       atol=LOGIT_TOL * np.abs(jl[b, :v]).max())
            keep = np.arange(T_SELF) != p
            for want, have, old in ((jk, tk, before_k), (jv, tv, before_v)):
                want = np.asarray(want.astype(jnp.float32))[:, b]
                bound = (LOGIT_TOL + (2.0**-8 if cache == "bfloat16" else 0)) * np.abs(want[:, p]).max()
                np.testing.assert_allclose(_as_np(have[:, b, p]), want[:, p], rtol=0, atol=bound)
                assert torch.equal(have[:, b, keep], old[:, b, keep])
        kc, vc = jk, jv  # the next step starts from the JAX kernel's caches
        tk, tv = _to_torch(kc), _to_torch(vc)


def test_each_slot_equals_the_batch1_plain_version(models):
    """Per slot, the multi step is the batch-1 step on that slot alone."""
    _, _, st = models
    g = torch.Generator().manual_seed(5)
    nl, d, bs = 2, GEOM.d_model, 4
    kc, vc = torch.randn((nl, bs, T_SELF, d), generator=g), torch.randn((nl, bs, T_SELF, d), generator=g)
    ck, cv = torch.randn((nl, bs, TC_PAD, d), generator=g), torch.randn((nl, bs, TC_PAD, d), generator=g)
    x = torch.randn((bs, d), generator=g) * 0.1
    pos, tcv = [3, 0, 15, 9], [32, 1, 20, 7]
    lg, kc2, vc2 = tfm.fused_aed_step_multi(st, GEOM, x, kc.clone(), vc.clone(), ck, cv,
                                            torch.tensor(pos, dtype=torch.int32),
                                            torch.tensor(tcv, dtype=torch.int32))
    for b in range(bs):
        k1, v1 = kc[:, b].clone(), vc[:, b].clone()
        want, _, _ = tfs.fused_aed_step(st, GEOM, x[b : b + 1], k1, v1, ck[:, b], cv[:, b],
                                        pos[b], tcv[b])
        assert torch.equal(lg[b : b + 1], want)
        assert torch.equal(kc2[:, b], k1) and torch.equal(vc2[:, b], v1)


def test_cross_rows_past_tc_valid_are_ignored(models):
    _, _, st = models
    g = torch.Generator().manual_seed(3)
    nl, d = 2, GEOM.d_model
    kc, vc = torch.randn((nl, 2, T_SELF, d), generator=g), torch.randn((nl, 2, T_SELF, d), generator=g)
    ck, cv = torch.randn((nl, 2, TC_PAD, d), generator=g), torch.randn((nl, 2, TC_PAD, d), generator=g)
    x = torch.randn((2, d), generator=g) * 0.1
    pos, tcv = torch.tensor([7, 2], dtype=torch.int32), torch.tensor([30, 12], dtype=torch.int32)
    a, _, _ = tfm.fused_aed_step_multi(st, GEOM, x, kc.clone(), vc.clone(), ck, cv, pos, tcv)
    ck2, cv2 = ck.clone(), cv.clone()
    ck2[:, 0, 30:], cv2[:, 0, 30:] = 1e4, -1e4
    ck2[:, 1, 12:], cv2[:, 1, 12:] = -1e4, 1e4
    b, _, _ = tfm.fused_aed_step_multi(st, GEOM, x, kc.clone(), vc.clone(), ck2, cv2, pos, tcv)
    assert torch.equal(a, b)


def test_wrapper_routes_and_refuses(models):
    """A CPU tensor runs the plain version without counting a launch; the
    launcher refuses CPU tensors; batch 1 and slot counts past the kernel's
    are refused; the batcher's gate follows the kernel's rule."""
    _, _, st = models
    nl, d = 2, GEOM.d_model
    args = (torch.zeros((2, d)), torch.zeros((nl, 2, T_SELF, d)), torch.zeros((nl, 2, T_SELF, d)),
            torch.zeros((nl, 2, 8, d)), torch.zeros((nl, 2, 8, d)),
            torch.tensor([0, -1], dtype=torch.int32), torch.tensor([8, 8], dtype=torch.int32))
    before = tfm.LAUNCHES
    got, _, _ = tfm.fused_aed_step_multi(st, GEOM, *args)
    want, _, _ = tfm.fused_aed_step_multi_reference(
        st, GEOM, *(a.clone() for a in args))
    assert torch.equal(got, want) and tfm.LAUNCHES == before
    with pytest.raises(ValueError):
        tfm.fused_aed_step_multi_cuda(st, GEOM, *args)
    with pytest.raises(ValueError, match=">= 2 slots"):
        tfm.fused_aed_step_multi(st, GEOM, args[0][:1], *(a[:, :1] for a in args[1:5]),
                                 args[5][:1], args[6][:1])
    assert tfm.kernel_takes(GEOM, 2) and tfm.kernel_takes(GEOM, tfm.MAX_SLOTS)
    assert not tfm.kernel_takes(GEOM, 1) and not tfm.kernel_takes(GEOM, tfm.MAX_SLOTS + 1)
    assert not tfm.kernel_takes(tfs.AedGeom(32, 48, 4), 4)  # head_dim 8
