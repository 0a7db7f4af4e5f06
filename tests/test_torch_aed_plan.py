"""PyTorch port: the plan of the AED decode-step kernels and the arithmetic
it fixes, on the CPU.

``aed_plan`` gives each of the step's seven matvecs (q|k|v, self-o,
cross-q, cross-o, fc1, fc2, the tied head) its column tile BN and its split
of K into equal runs of whole 128-row blocks, and each attention its row
chunks (one thread block cluster per head and slot) and the rows a chunk
stages. The same plan serves the batch-1 and the multi-slot kernel at every
slot count, which is what keeps a slot of the multi-slot step bitwise the
batch-1 result; its blocks cover each K once; each Whisper-Large-v3-Turbo
matvec gets at least 132 blocks (one an H100 SM) and every tile fits in
shared memory at 1..32 slots; the chunks cover every row count of a cache
once, within the cluster limit.

The arithmetic, written out in PyTorch along the plan (each 128-row block's
term ``p*s - xs*zs`` with p its eight k16 steps accumulated in order in f32
and xs its four 32-value chunk sums added in k order, the terms folded in
block order within a part and the parts added in order; each attention
chunk's max and sum of exponentials combined as the cluster combines them,
probabilities rounded to bf16 after the global normalisation, the chunks'
contexts added in chunk order), holds JAX's interpret-mode batch-1 and
multi-slot Pallas kernels within the tolerances of
``tests/test_torch_fused_aed_step.py``: logits within 1e-2 of max|logit|
(a bf16 step after a flipped rounding), the written cache rows within the
same bound plus a bf16 cache's own rounding (2^-8).
"""

import inspect

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
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import fused_aed_multi as tfm
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.ops.fused_decode import attn_chunks, chunk_rows  # the chunk rule of aed_common.cuh
from asr_tpu_torch.runtime import artifact as tart

# The tiny geometry of tests/test_torch_fused_aed_step.py and its tolerances.
TINY = dict(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4,
            ffn_dim=1024, n_mels=16, max_source_positions=24, max_target_positions=16,
            sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4)
JCFG, TCFG = jwh.WhisperConfig(**TINY), twh.WhisperConfig(**TINY)
GEOM = tfs.AedGeom(JCFG.d_model, JCFG.ffn_dim, JCFG.num_heads)
JGEOM = jfs.AedGeom(JCFG.d_model, JCFG.ffn_dim, JCFG.num_heads)
T_SELF, TC = 16, 24
LOGIT_TOL = 1e-2

# Whisper-Large-v3-Turbo's decoder: (D, F, V_pad, self rows, cross rows),
# the seven (K, N) of its matvecs, and other geometries the kernels take
# (head_dim 64, D and F multiples of 128).
TURBO = (1280, 5120, 52224, 448, 1500)
TURBO_MATVECS = {"qkv": (1280, 3840), "so": (1280, 1280), "cq": (1280, 1280), "co": (1280, 1280),
                 "fc1": (1280, 5120), "fc2": (5120, 1280), "head": (1280, 52224)}
# FireRedASR-AED-L (16 layers at the turbo width, a head of 7832 -> 8192
# columns, 750 cross rows) and Dolphin (d 512, a head of 27588 -> 27648
# columns, the embedding's 512 multiple; 749 cross rows: an odd count), and
# Dolphin's head at 28160 columns, the width the TPU kernel re-pads it to.
FIRERED = (1280, 5120, 8192, 448, 750)
DOLPHIN = (512, 2048, 27648, 448, 749)
GEOMETRIES = [TURBO, (256, 1024, 512, T_SELF, TC), (384, 1536, 5120, 448, 750),
              (1024, 4096, 10240, 448, 1500), FIRERED, (512, 2048, 28160, 448, 749), DOLPHIN]


# ── the plan ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_plan_is_the_same_for_every_slot_count(geo):
    """Neither wrapper has a slot count to give the plan: both pass
    ``aed_plan(d, f, vp, t_self, t_cross)``, and every tile of it fits the
    kernel's shared memory at 1..32 slots."""
    assert "slots" not in "".join(inspect.signature(tfs.aed_plan).parameters)
    d, f, vp, t_self, t_cross = geo
    plan = tfs.aed_plan(d, f, vp, t_self, t_cross)
    assert plan == tfs.aed_plan(d, f, vp, t_self, t_cross)
    for rows in range(1, tfm.MAX_SLOTS + 1):
        for name, (k, n) in tfs.matvec_shapes(d, f, vp).items():
            bn, parts = getattr(plan, name)
            assert (bn, parts) == tfs.matvec_plan(k, n)
            assert tfs.matvec_smem(bn, parts, k, rows) <= tfs.MAX_SMEM
    for cap, srows in ((plan.self_cap, plan.self_srows), (plan.cross_cap, plan.cross_srows)):
        assert srows <= cap and tfs.attn_smem(cap, srows, 4) <= tfs.MAX_SMEM // 2
    assert plan.attn_max_chunks == tfs.ATTN_MAX_CHUNKS and plan.pdl
    assert len(plan.c_array()) == tfs.PLAN_INTS


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_parts_cover_each_k_once_in_whole_blocks(geo):
    d, f, vp = geo[:3]
    for name, (k, n) in tfs.matvec_shapes(d, f, vp).items():
        bn, parts = tfs.matvec_plan(k, n)
        nb = k // tfs.BLOCK
        assert 1 <= parts <= tfs.MAX_PARTS and nb % parts == 0 and n % bn == 0
        assert bn in tfs.MV_WIDTHS
        covered = np.zeros(nb, np.int64)
        jper = nb // parts
        for r in range(parts):
            covered[r * jper : (r + 1) * jper] += 1
        assert (covered == 1).all(), name


@pytest.mark.parametrize("name", list(TURBO_MATVECS))
def test_turbo_matvecs_fill_the_card(name):
    k, n = TURBO_MATVECS[name]
    assert tfs.matvec_shapes(*TURBO[:3])[name] == (k, n)
    bn, parts = tfs.matvec_plan(k, n)
    assert n // bn * parts >= tfs.SMS == 132


@pytest.mark.parametrize("attn", ["self", "cross"])
def test_attention_chunks_cover_every_row_count_once(attn):
    """Self attends 0..447 cached rows of a 448-row cache (checked up to
    448), cross 1..1500 rows; every chunk fits the score rows the plan gives
    it (what the kernel checks before it launches: ``launch_attn``)."""
    plan = tfs.aed_plan(*TURBO)
    t_rows = TURBO[3] if attn == "self" else TURBO[4]
    cap = plan.self_cap if attn == "self" else plan.cross_cap
    assert cap >= plan.attn_min_rows and cap * plan.attn_max_chunks >= t_rows
    for rows in range(t_rows + 1):
        nc = attn_chunks(rows, plan.attn_min_rows, plan.attn_max_chunks)
        assert 1 <= nc <= plan.attn_max_chunks == tfs.ATTN_MAX_CHUNKS
        covered = np.zeros(rows, np.int64)
        for c in range(nc):
            r0, r1 = chunk_rows(rows, nc, c)
            assert r1 - r0 <= cap
            covered[r0:r1] += 1
        assert (covered == 1).all(), rows


@pytest.mark.parametrize("attn", ["self", "cross"])
@pytest.mark.parametrize("geo", [FIRERED, DOLPHIN], ids=["firered", "dolphin"])
def test_attention_chunks_cover_every_row_count_once_at_firered_and_dolphin(geo, attn):
    """As above at FireRed's 750 and Dolphin's 749 cross rows: every row
    count a slot can hold (tc_valid 1..Tc, the utterance's encoder rows)
    splits into chunks the plan's score rows hold."""
    plan = tfs.aed_plan(*geo)
    t_rows = geo[3] if attn == "self" else geo[4]
    cap = plan.self_cap if attn == "self" else plan.cross_cap
    assert cap >= plan.attn_min_rows and cap * plan.attn_max_chunks >= t_rows
    for rows in range(t_rows + 1):
        nc = attn_chunks(rows, plan.attn_min_rows, plan.attn_max_chunks)
        covered = np.zeros(rows, np.int64)
        for c in range(nc):
            r0, r1 = chunk_rows(rows, nc, c)
            assert r1 - r0 <= cap
            covered[r0:r1] += 1
        assert (covered == 1).all(), rows


# ── the arithmetic ──────────────────────────────────────────────────────


def _matvec(x, q, s, zs, parts):
    """(1, K) -> (1, N) as the kernel associates it for a split into ``parts``."""
    k, n = q.shape
    nb = k // tfs.BLOCK
    x16 = tfs._bf16(x).reshape(nb, tfs.BLOCK)
    w = q.to(torch.float32).reshape(nb, tfs.BLOCK, n)
    jper = nb // parts
    total = None
    for r in range(parts):
        run = None
        for b in range(r * jper, (r + 1) * jper):
            p = torch.zeros(n)
            for i in range(0, tfs.BLOCK, 16):  # the block's k16 steps, accumulated in order
                p = p + x16[b, i : i + 16] @ w[b, i : i + 16]
            xs = None
            for i in range(0, tfs.BLOCK, tfs.CHUNK):  # the staged chunk sums, in k order
                cs = x16[b, i : i + tfs.CHUNK].sum()
                xs = cs if xs is None else xs + cs
            term = p * s[b] - xs * zs[b]
            run = term if run is None else run + term  # block order within the part
        total = run if total is None else total + run  # the parts in order
    return total[None]


def _attention(q, kf, vf, kr, vr, chunking):
    """One head over the cached rows kr, vr (rows, 64) and, for the self
    attention, the fresh kf, vf (64): chunks as ``attn_chunks`` cuts them
    under ``chunking`` (min rows a chunk, max chunks), each chunk's max and
    sum of exponentials combined as the cluster combines them, probabilities
    rounded to bf16 after the global normalisation, contexts added in chunk
    order."""
    rows = kr.shape[0]
    nc = attn_chunks(rows, *chunking)
    scale = tfs.HEAD_DIM ** -0.5
    qs = tfs._bf16(q * scale)
    fresh = kf is not None
    snew = (q * kf * scale).sum() if fresh else None
    spans = [chunk_rows(rows, nc, c) for c in range(nc)]
    scores = [tfs._bf16(kr[r0:r1]) @ qs for r0, r1 in spans]
    stats = []
    for c, sc in enumerate(scores):
        allsc = torch.cat([sc, snew[None]]) if fresh and c == 0 else sc
        m = allsc.amax() if allsc.numel() else torch.tensor(-torch.inf)
        stats.append((m, torch.exp(allsc - m).sum()))
    big = torch.stack([m for m, _ in stats]).amax()
    total = sum(l * torch.exp(m - big) for m, l in stats if l > 0)
    ctx = None
    for c, ((r0, r1), sc) in enumerate(zip(spans, scores)):
        part = tfs._bf16(torch.exp(sc - big) / total) @ tfs._bf16(vr[r0:r1])
        if fresh and c == 0:
            part = part + torch.exp(snew - big) / total * vf
        ctx = part if ctx is None else ctx + part
    return ctx


def _step(st, plan, chunking, x, kc, vc, ck, cv, pos, tc_valid):
    """The step as the kernels associate it (the plain version's order with
    the kernels' matvec and attention); row ``pos`` of kc, vc written in place."""
    d, f, h = GEOM.d_model, GEOM.ffn_dim, GEOM.num_heads
    hd = tfs.HEAD_DIM
    x = x.to(torch.float32).reshape(1, d)
    for l in range(kc.shape[0]):
        wa, a_s, a_zs, ba = st["wa_all"][l], st["a_s"][l], st["a_zs"][l], st["ba"][l]

        def seg(name, y, c0, n):
            return _matvec(y, wa[:, c0 : c0 + n], a_s[:, c0 : c0 + n], a_zs[:, c0 : c0 + n],
                           getattr(plan, name)[1])

        y = tfs._layer_norm(x, st["ln1_s"][l], st["ln1_b"][l])
        qkv = seg("qkv", y, 0, 3 * d) + ba[:, : 3 * d]
        q, k, v = (qkv[0, i * d : (i + 1) * d].reshape(h, hd) for i in range(3))
        kr, vr = kc[l, :pos].float().reshape(pos, h, hd), vc[l, :pos].float().reshape(pos, h, hd)
        kc[l, pos] = k.reshape(d).to(kc.dtype)
        vc[l, pos] = v.reshape(d).to(vc.dtype)
        ctx = torch.cat([_attention(q[i], k[i], v[i], kr[:, i], vr[:, i], chunking) for i in range(h)])
        x = (x + seg("so", ctx[None], 3 * d, d)) + ba[:, 3 * d : 4 * d]
        y = tfs._layer_norm(x, st["lnc_s"][l], st["lnc_b"][l])
        qc = (seg("cq", y, 4 * d, d) + ba[:, 4 * d : 5 * d])[0].reshape(h, hd)
        kr = ck[l, :tc_valid].float().reshape(tc_valid, h, hd)
        vr = cv[l, :tc_valid].float().reshape(tc_valid, h, hd)
        ctx = torch.cat([_attention(qc[i], None, None, kr[:, i], vr[:, i], chunking) for i in range(h)])
        x = (x + seg("co", ctx[None], 5 * d, d)) + ba[:, 5 * d : 6 * d]
        y = tfs._layer_norm(x, st["ln2_s"][l], st["ln2_b"][l])
        h1 = seg("fc1", y, 6 * d, f) + ba[:, 6 * d :]
        h1 = 0.5 * h1 * (1.0 + torch.erf(h1 * 0.7071067811865476))
        x = (x + _matvec(h1, st["wb_all"][l], st["b_s"][l], st["b_zs"][l], plan.fc2[1])) + st["bb"][l]
    xn = tfs._layer_norm(x, st["lnf_s"], st["lnf_b"])
    return _matvec(xn, st["wh"], st["h_s"][0], st["h_zs"][0], plan.head[1])


@pytest.fixture(scope="module")
def models():
    jp = jquantize_pytree(jwh.init_params(JCFG, jax.random.PRNGKey(0)), bits=8, block=128,
                          min_size=0, refine_iters=0, quantize_embeddings=True)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    return jp, jfs.stack_whisper_step_params(jp, JCFG), tfs.stack_whisper_step_params(tp, TCFG)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _planes(jp, seed, tc_valid, dtype):
    """One request's (NL, rows, D) self and cross caches after a 4-token
    prefill, the cross rows past tc_valid filled with noise (masking must
    drop them)."""
    enc = jax.random.normal(jax.random.PRNGKey(100 + seed), (1, tc_valid, JCFG.d_model)) * 0.3
    state = jwh.make_state(jp, JCFG, enc)
    _, state = jwh.prefill(jp, JCFG, state, jnp.asarray([[3 + seed, 7, 11, 2]], jnp.int32))
    d = JCFG.d_model
    k, v, ck, cv = (jnp.stack([ls[name][0].reshape(-1, d) for ls in state["layers"]])
                    for name in ("self_k", "self_v", "cross_k", "cross_v"))
    noise = jax.random.normal(jax.random.PRNGKey(200 + seed), (2, k.shape[0], TC - tc_valid, d))
    ck = jnp.concatenate([ck, noise[0]], axis=1)
    cv = jnp.concatenate([cv, noise[1]], axis=1)
    return tuple(a.astype(dtype) for a in (k, v, ck, cv))


def _check(tl, jl, have_rows, want_rows, cache):
    """Logits within a bf16 step of JAX's, pad columns exactly 0; the written
    rows ((k, v) pairs of (NL, D)) within the same bound plus a bf16 cache's
    own rounding."""
    v = TCFG.vocab_size
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy()[:, :v], jl[:, :v], rtol=0, atol=LOGIT_TOL * np.abs(jl[:, :v]).max())
    np.testing.assert_array_equal(tl.numpy()[:, v:], 0.0)
    for have, want in zip(have_rows, want_rows):
        want = np.asarray(want.astype(jnp.float32))
        bound = (LOGIT_TOL + (2.0**-8 if cache == "bfloat16" else 0)) * np.abs(want).max()
        np.testing.assert_allclose(have.float().numpy(), want, rtol=0, atol=bound)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
# (min rows a chunk, max chunks): the kernel's rule cut to the 4-5 self and
# 20 cross rows (several chunks of 2 and 3 rows), and a cap on the chunk
# count that binds (three chunks)
@pytest.mark.parametrize("chunking", [(2, tfs.ATTN_MAX_CHUNKS), (1, 3)])
def test_batch1_association_matches_jax_interpret_kernel(models, cache, chunking):
    """Two consecutive steps at tc_valid 20 of 24 cross rows, from the same
    caches as JAX's kernel; each next step starts from JAX's caches."""
    jp, sj, st = models
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    kc, vc, ck, cv = _planes(jp, 0, 20, jdt)
    plan = tfs.aed_plan(GEOM.d_model, GEOM.ffn_dim, st["wh"].shape[1], T_SELF, TC)
    emb, posemb = jp["decoder"]["embed"], jp["decoder"]["pos"]
    for i, tok in enumerate((5, 9)):
        pos = 4 + i
        x = (emb[jnp.asarray([tok])] + posemb[pos][None]).astype(jnp.float32)
        jl, jk, jv = jfs.fused_whisper_step(sj, JCFG, x, kc, vc, ck, cv, jnp.asarray(pos, jnp.int32),
                                            tc_valid=20, interpret=True)
        tk, tv = _to_torch(kc), _to_torch(vc)
        tl = _step(st, plan, chunking, torch.from_numpy(np.array(x)), tk, tv, _to_torch(ck),
                   _to_torch(cv), pos, 20)
        _check(tl, jl, (tk[:, pos], tv[:, pos]), (jk[:, pos], jv[:, pos]), cache)
        keep = np.arange(T_SELF) != pos
        assert torch.equal(tk[:, keep], _to_torch(kc)[:, keep])
        kc, vc = jk, jv


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_multi_slot_association_matches_jax_interpret_kernel(models, cache):
    """Three slots at positions 4, 6 and 5 with tc_valid 16, 20 and 24 (chunks
    of 2 rows), each through the association on its own planes, against
    JAX's multi-slot kernel."""
    jp, sj, st = models
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    tcs = (16, 20, 24)
    planes = [_planes(jp, s, tc, jdt) for s, tc in enumerate(tcs)]
    kc, vc, ck, cv = (jnp.stack([p[i] for p in planes], axis=1) for i in range(4))
    plan = tfs.aed_plan(GEOM.d_model, GEOM.ffn_dim, st["wh"].shape[1], T_SELF, TC)
    pos, toks = [4, 6, 5], [5, 9, 13]
    emb, posemb = jp["decoder"]["embed"], jp["decoder"]["pos"]
    pos_j = jnp.asarray(pos, jnp.int32)
    x = (emb[jnp.asarray(toks, jnp.int32)] + posemb[pos_j]).astype(jnp.float32)
    jl, jk, jv = jfm.fused_aed_step_multi(sj, JGEOM, x, kc, vc, ck, cv, pos_j,
                                          jnp.asarray(tcs, jnp.int32), interpret=True)
    for b, p in enumerate(pos):
        tk, tv = _to_torch(kc[:, b]), _to_torch(vc[:, b])
        tl = _step(st, plan, (2, tfs.ATTN_MAX_CHUNKS), torch.from_numpy(np.array(x[b : b + 1])), tk, tv,
                   _to_torch(ck[:, b]), _to_torch(cv[:, b]), p, tcs[b])
        _check(tl, np.asarray(jl)[b : b + 1], (tk[:, p], tv[:, p]), (jk[:, b, p], jv[:, b, p]), cache)


@pytest.mark.parametrize("parts", [1, 2, 5])
def test_matvec_association_matches_plain_version(parts):
    """The association against the plain version's ``_matvec`` (one product a
    block, the terms summed at once) within f32 rounding, for each split."""
    rng = np.random.default_rng(3)
    k, n = 1280, 256
    q = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(rng.random((k // 128, n)).astype(np.float32)) * 0.01
    zs = s * torch.from_numpy(rng.integers(-8, 8, (k // 128, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32))
    want = tfs._matvec(x, q, s, zs)
    got = _matvec(x, q, s, zs, parts)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
