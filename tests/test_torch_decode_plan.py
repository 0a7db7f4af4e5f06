"""PyTorch port: the plan of the Qwen3 decode-step kernels and the
arithmetic it fixes, on the CPU.

``decode_plan`` gives each matvec of the step its column tile BN and its
split of K into runs of whole 128-row blocks, and the attention its row
chunks (one thread block cluster per kv head and slot). The same plan serves
the batch-1 and the multi-slot kernel at every slot count, which is what
keeps a slot of the multi-slot step bitwise the batch-1 result; its blocks
cover each K once; each Qwen3-ASR-0.6B matvec gets at least 132 blocks (one
an H100 SM) and fits in shared memory at 32 slots; the chunks cover every
row count of a cache once, within the cluster limit.

The arithmetic, written out in PyTorch along the plan (each 128-row block's
term ``p*s - xs*zs`` with p the sum, in stage order, of its four 32-row
stages' sums over their two k16 steps in f32, and xs its four 32-value chunk
sums, the terms added in plane-major block order;
each attention chunk's max and sum of exponentials combined as the cluster
combines them, probabilities rounded to bf16 after the global
normalisation, the chunks' contexts added in chunk order), holds JAX's
interpret-mode batch-1 and multi-slot Pallas kernels within the tolerances
of ``tests/test_torch_fused_decode.py``: a bf16 step of the hidden state and
the logits, 1e-3 of the first layer's written row (plus a bf16 cache's own
rounding).
"""

import inspect

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

# The tiny geometry of tests/test_torch_fused_decode.py and its tolerances.
SIZE = dict(vocab_size=64, hidden=256, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
            ffn_dim=512, rope_theta=1e4, max_seq_len=32)
JCFG, TCFG = jq3.Qwen3Config(**SIZE), tq3.Qwen3Config(**SIZE)
T_MAX, PROMPT = 16, 6
LOGIT_TOL = 1e-2
ROW0_TOL = {"float32": 1e-3, "bfloat16": 1e-3 + 2.0**-8}
HEADLESS = ("wh", "h_s", "h_zs")

QWEN = tq3.Qwen3Config()  # Qwen3-ASR-0.6B's LLM
QWEN_VP = 153600          # its tied head's padded columns
QWEN_T = 776              # the continuous server's cache rows
# (K, N, paired) of its five matvecs: q|k|v, o, gate|up, down, the head
QWEN_MATVECS = {"qkv": (1024, 4096, False), "o": (2048, 1024, False), "gu": (1024, 6144, True),
                "down": (3072, 1024, False), "head": (1024, 153600, False)}
SMALL = tq3.Qwen3Config(vocab_size=3000, hidden=512, num_layers=3, num_heads=4, num_kv_heads=2,
                        ffn_dim=1024)  # the card tests' small geometry


def _matvec_shapes(cfg, vp):
    h, f = cfg.hidden, cfg.ffn_dim
    qd = cfg.num_heads * tfd.HEAD_DIM
    qn = qd + 2 * cfg.num_kv_heads * tfd.HEAD_DIM
    return {"qkv": (h, qn, False), "o": (qd, h, False), "gu": (h, 2 * f, True), "down": (f, h, False),
            "head": (h, vp, False)}


# ── the plan ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("cfg,t,vp", [(QWEN, QWEN_T, QWEN_VP), (SMALL, 456, 3072), (TCFG, T_MAX, 2048)])
def test_plan_is_the_same_for_every_slot_count(cfg, t, vp):
    """Neither wrapper has a slot count to give the plan: both pass
    ``decode_plan(cfg, t, vp)``, and every tile of it fits the kernel's
    shared memory at 1..32 slots."""
    assert "slots" not in inspect.signature(tfd.decode_plan).parameters
    plan = tfd.decode_plan(cfg, t, vp)
    assert plan == tfd.decode_plan(cfg, t, vp)
    shapes = _matvec_shapes(cfg, vp)
    for rows in range(1, tfm.MAX_SLOTS + 1):
        for name, (k, n, paired) in shapes.items():
            bn, parts = getattr(plan, name)
            assert (bn, parts) == tfd.matvec_plan(k, n, paired)
            assert tfd.matvec_smem(bn, parts, k, rows) <= tfd.MAX_SMEM
    assert plan.attn_max_chunks == tfd.ATTN_MAX_CHUNKS and plan.pdl
    assert len(plan.c_array()) == tfd.PLAN_INTS


@pytest.mark.parametrize("cfg,vp", [(QWEN, QWEN_VP), (SMALL, 3072), (TCFG, 2048)])
def test_parts_cover_each_k_once_in_whole_blocks(cfg, vp):
    for name, (k, n, paired) in _matvec_shapes(cfg, vp).items():
        bn, parts = tfd.matvec_plan(k, n, paired)
        nbj = k // 2 // tfd.BLOCK  # 128-row blocks of packed rows: block j carries K-blocks j and nbj + j
        assert 1 <= parts <= tfd.MAX_PARTS and nbj % parts == 0 and n % bn == 0
        assert bn in tfd.MV_WIDTHS and (bn >= 64 or not paired)
        covered = np.zeros(k // tfd.BLOCK, np.int64)
        for r in range(parts):
            jper = nbj // parts
            for j in range(r * jper, (r + 1) * jper):
                covered[j] += 1        # low nibble: rows [128 j, 128 j + 128)
                covered[nbj + j] += 1  # high nibble: rows K/2 + [128 j, ..)
        assert (covered == 1).all(), name


@pytest.mark.parametrize("name", list(QWEN_MATVECS))
def test_qwen_matvecs_fill_the_card(name):
    k, n, paired = QWEN_MATVECS[name]
    assert _matvec_shapes(QWEN, QWEN_VP)[name] == (k, n, paired)
    bn, parts = tfd.matvec_plan(k, n, paired)
    assert n // bn * parts >= tfd.SMS == 132


@pytest.mark.parametrize("t", [T_MAX, 456, QWEN_T])
def test_attention_chunks_cover_every_row_count_once(t):
    plan = tfd.decode_plan(QWEN, t, QWEN_VP)
    # what the kernel checks before it launches (launch_attn)
    assert plan.attn_cap >= plan.attn_min_rows and plan.attn_cap * plan.attn_max_chunks >= t - 1
    for rows in range(t + 1):
        nc = tfd.attn_chunks(rows, plan.attn_min_rows, plan.attn_max_chunks)
        assert 1 <= nc <= plan.attn_max_chunks == tfd.ATTN_MAX_CHUNKS
        covered = np.zeros(rows, np.int64)
        for c in range(nc):
            r0, r1 = tfd.chunk_rows(rows, nc, c)
            assert r1 - r0 <= plan.attn_cap
            covered[r0:r1] += 1
        assert (covered == 1).all(), rows


# ── the arithmetic ──────────────────────────────────────────────────────


def _matvec(x, vals, s, zs):
    """(1, K) -> (1, N) as the kernel associates it."""
    k, n = vals.shape
    nb = k // tfd.BLOCK
    x16 = tfd._bf16(x).reshape(nb, tfd.BLOCK)
    u = vals.reshape(nb, tfd.BLOCK, n)
    s, zs = s.reshape(nb, n), zs.reshape(nb, n)
    out = None
    for b in range(nb):  # plane-major block order
        p = None
        for st in range(0, tfd.BLOCK, tfd.MV_STAGE):  # a warp's stage: two mma k16 steps, f32
            q = torch.zeros(n)
            for i in range(st, st + tfd.MV_STAGE, 16):
                q = q + x16[b, i : i + 16] @ u[b, i : i + 16]
            p = q if p is None else p + q  # the stages in order
        xs = None
        for i in range(0, tfd.BLOCK, 32):  # the staged 32-value chunk sums, in k order
            cs = x16[b, i : i + 32].sum()
            xs = cs if xs is None else xs + cs
        term = p * s[b] - xs * zs[b]
        out = term if out is None else out + term
    return out[None]


def _attention(q, k, v, kr, vr, chunking):
    """One kv head's G q heads over the cached rows kr, vr (rows, 128) and
    the fresh k, v (128): chunks as ``attn_chunks`` cuts them under
    ``chunking`` (min rows a chunk, max chunks), each chunk's max and sum
    combined as the cluster combines them, probabilities rounded to bf16
    after the global normalisation, contexts added in chunk order."""
    rows = kr.shape[0]
    nc = tfd.attn_chunks(rows, *chunking)
    qs = tfd._bf16(q * tfd.HEAD_DIM ** -0.5)  # (G, 128)
    snew = (q * tfd.HEAD_DIM ** -0.5 * k[None]).sum(-1)  # (G,)
    spans = [tfd.chunk_rows(rows, nc, c) for c in range(nc)]
    scores = [qs @ tfd._bf16(kr[r0:r1]).T for r0, r1 in spans]  # (G, len)
    stats = []
    for c, sc in enumerate(scores):
        allsc = torch.cat([sc, snew[:, None]], -1) if c == 0 else sc
        m = allsc.amax(-1) if allsc.shape[1] else torch.full((q.shape[0],), -torch.inf)
        stats.append((m, torch.exp(allsc - m[:, None]).sum(-1)))
    big = torch.stack([m for m, _ in stats]).amax(0)
    total = sum(torch.where(l > 0, l * torch.exp(m - big), torch.zeros_like(l)) for m, l in stats)
    ctx = None
    for c, ((r0, r1), sc) in enumerate(zip(spans, scores)):
        p = tfd._bf16(torch.exp(sc - big[:, None]) / total[:, None])
        part = p @ tfd._bf16(vr[r0:r1])
        if c == 0:
            part = part + (torch.exp(snew - big) / total)[:, None] * v[None]
        ctx = part if ctx is None else ctx + part
    return ctx


def _layer(st, l, cfg, chunking, x, kc, vc, pos, shift, cos, sin):
    """Layer l of the step as the kernels associate it (the plain version's
    ``_layer`` with the kernels' matvec and attention)."""
    nh, nkv, hd, f, eps = cfg.num_heads, cfg.num_kv_heads, tfd.HEAD_DIM, cfg.ffn_dim, cfg.rms_eps
    g, qd, kvw = nh // nkv, nh * hd, nkv * hd
    mats = tfd._layer_weights(st, l)
    qkv = _matvec(tfd._rms(x, st["in_s"][l], eps), *mats["wq"])
    q = tfd._rms(qkv[0, :qd].reshape(nh, hd), st["qn_s"][l], eps)
    k = tfd._rms(qkv[0, qd : qd + kvw].reshape(nkv, hd), st["kn_s"][l], eps)
    v = qkv[0, qd + kvw :].reshape(nkv, hd)
    q = q * cos + tfd._rot_half(q) * sin
    k = k * cos + tfd._rot_half(k) * sin
    kr = kc[shift:pos].float().reshape(pos - shift, nkv, hd)
    vr = vc[shift:pos].float().reshape(pos - shift, nkv, hd)
    kc[pos] = k.reshape(kvw).to(kc.dtype)
    vc[pos] = v.reshape(kvw).to(vc.dtype)
    ctx = torch.cat([_attention(q[h * g : (h + 1) * g], k[h], v[h], kr[:, h], vr[:, h], chunking)
                     for h in range(nkv)])
    x = x + _matvec(ctx.reshape(1, qd), *mats["wo"])
    gu = _matvec(tfd._rms(x, st["post_s"][l], eps), *mats["wgu"])
    return x + _matvec(gu[:, :f] / (1 + torch.exp(-gu[:, :f])) * gu[:, f:], *mats["wd"])


def _step(st, cfg, chunking, x, kc, vc, pos, shift, cos, sin):
    x = x.reshape(1, cfg.hidden)
    for l in range(kc.shape[0]):
        x = _layer(st, l, cfg, chunking, x, kc[l], vc[l], pos, shift, cos, sin)
    hidden = tfd._rms(x, st["fn_s"], cfg.rms_eps)
    logits = None
    if "wh" in st:
        logits = _matvec(hidden, tfd._nibbles(st["wh"]), st["h_s"][0], st["h_zs"][0])
    return hidden, logits


@pytest.fixture(scope="module")
def models():
    jp = jq3.fuse_params(jquantize_pytree(jq3.init_params(JCFG, jax.random.PRNGKey(5)), bits=4,
                                          block=128, min_size=0, pack=True, refine_iters=0,
                                          quantize_embeddings=True), JCFG)
    tp = tart.params_from_flat(jart.flatten_pytree(jp), "cpu")
    return jp, jfd.stack_decode_params(jp, JCFG), tfd.stack_decode_params(tp, TCFG)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rope(pos):
    cs = np.asarray(jrope(T_MAX, JCFG.head_dim, JCFG.rope_theta))
    logical = np.clip(np.asarray(pos), 0, T_MAX - 1)
    return cs[0][logical], cs[1][logical]


def _prefill(jp, lens, dtype):
    """Compact caches (NL, B, T, kvw) of B prompts of `lens` tokens."""
    rng = np.random.default_rng(7)
    prompt = jnp.asarray((rng.standard_normal((len(lens), max(lens), JCFG.hidden)) * 0.3).astype(np.float32))
    _, state = jq3.decoder_pass(jp, JCFG, prompt, jq3.make_kv_state(JCFG, len(lens), T_MAX),
                                jnp.asarray(0, jnp.int32),
                                jq3.causal_prefill_bias(jnp.asarray(lens, jnp.int32), max(lens), T_MAX))
    kvw = JCFG.num_kv_heads * JCFG.head_dim
    k = jnp.stack([ls["k"].reshape(len(lens), T_MAX, kvw) for ls in state["layers"]]).astype(dtype)
    v = jnp.stack([ls["v"].reshape(len(lens), T_MAX, kvw) for ls in state["layers"]]).astype(dtype)
    return k, v


def _check(th, tl, jh, jl, rows, want_rows, cache):
    """Hidden and logits within a bf16 step of JAX's; the written cache rows
    ((k, v) pairs of (NL, kvw)) within 1e-3 at layer 0 (plus the cache's own
    rounding) and a bf16 step deeper."""
    jh = np.asarray(jh)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=LOGIT_TOL * np.abs(jh).max())
    v = TCFG.vocab_size
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy()[:, :v], jl[:, :v], rtol=0, atol=LOGIT_TOL * np.abs(jl).max())
    for have, want in zip(rows, want_rows):
        have = have.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(have[0], want[0], rtol=0, atol=ROW0_TOL[cache] * np.abs(want[0]).max())
        bound = (LOGIT_TOL + (2.0**-8 if cache == "bfloat16" else 0)) * np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=0, atol=bound)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
# (min rows a chunk, max chunks): the kernel's rule cut to 3-4 attended rows
# (two chunks), and a cap on the chunk count that binds (three chunks of one
# row, then of two rows and an empty one)
@pytest.mark.parametrize("chunking", [(2, tfd.ATTN_MAX_CHUNKS), (1, 3)])
def test_batch1_association_matches_jax_interpret_kernel(models, cache, chunking):
    """Two consecutive steps at shift 3, from the same caches as JAX's
    kernel; small chunks so the 3-4 attended rows split."""
    _, sj, st = models
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    k, v = _prefill(models[0], [PROMPT], jdt)
    kc, vc = k[:, 0], v[:, 0]
    shift = 3
    for i in range(2):
        pos = PROMPT + i
        x = np.random.default_rng(20 + i).standard_normal((1, JCFG.hidden)).astype(np.float32) * 0.3
        cos, sin = (a[None] for a in _rope(pos - shift))
        jh, jl, jk, jv = jfd.fused_decode_step(sj, JCFG, jnp.asarray(x), kc, vc, jnp.asarray(pos, jnp.int32),
                                               jnp.asarray(shift, jnp.int32), jnp.asarray(cos),
                                               jnp.asarray(sin), interpret=True)
        tk, tv = _to_torch(kc), _to_torch(vc)
        th, tl = _step(st, TCFG, chunking, torch.from_numpy(x), tk, tv, pos, shift, torch.from_numpy(cos),
                       torch.from_numpy(sin))
        _check(th, tl, jh, jl, (tk[:, pos], tv[:, pos]), (jk[:, pos], jv[:, pos]), cache)
        keep = np.arange(T_MAX) != pos
        assert torch.equal(tk[:, keep], _to_torch(kc)[:, keep])
        kc, vc = jk, jv


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_multi_slot_association_matches_jax_interpret_kernel(models, cache):
    """Four slots at positions 6, 3, 9 (chunks of 2 rows: up to 5 chunks)
    and 5, each through the association at shift 0 on its own planes."""
    _, sj, st = models
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    lens, pos = (6, 3, 9, 5), (6, 3, 9, 5)
    k, v = _prefill(models[0], lens, jdt)
    x = np.random.default_rng(11).standard_normal((4, JCFG.hidden)).astype(np.float32) * 0.3
    cos, sin = _rope(pos)
    jh, jl, jk, jv = jfm.fused_decode_step_multi(sj, JCFG, jnp.asarray(x), k, v, jnp.asarray(pos, jnp.int32),
                                                 jnp.asarray(cos), jnp.asarray(sin), interpret=True)
    for b, p in enumerate(pos):
        tk, tv = _to_torch(k[:, b]), _to_torch(v[:, b])
        th, tl = _step(st, TCFG, (2, tfd.ATTN_MAX_CHUNKS), torch.from_numpy(x[b : b + 1]), tk, tv, p, 0,
                       torch.from_numpy(cos[b : b + 1]), torch.from_numpy(sin[b : b + 1]))
        _check(th, tl, np.asarray(jh)[b : b + 1], np.asarray(jl)[b : b + 1], (tk[:, p], tv[:, p]),
               (jk[:, b, p], jv[:, b, p]), cache)


def test_matvec_association_matches_plain_dot():
    """The association against the plain version's ``_dot`` (one product a
    block) within f32 rounding."""
    rng = np.random.default_rng(3)
    k, n = 512, 256
    vals = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(np.float32))
    s = torch.from_numpy(rng.random((2, k // 256, n)).astype(np.float32)) * 0.01
    zs = s * 7.5
    x = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32))
    want = tfd._dot(x, vals, s, zs)
    got = _matvec(x, vals, s, zs)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
