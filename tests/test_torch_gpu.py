"""PyTorch port on a CUDA card: the int8 dequant-matmul kernel against its
plain version at the SenseVoiceSmall q8 shapes and at ragged ones (K = block
= 560 and 140, N = 25055 and 30) for M = 1..17, rows of a batched call
bitwise the row alone across every schedule its plan switches between and
every tile it has, and the kernel launch count of one full-geometry forward; the fused AED decode-step kernel against its
plain version at a small and at the Whisper-Large-v3-Turbo geometry, its
wrapper's checks, and its launch count in a one-window transcription; its
device-position entry bitwise the host-position one, and the graphed
greedy decode (one CUDA graph replay a token) against the eager loop at
the turbo width, with its replay and capture counts; the
multi-slot AED decode-step kernel likewise and, slot by slot, bitwise
against the batch-1 kernel (at B = 2, 5, 8, 17 and 32 with parked slots),
and its launch count in a continuous-serving run; the two AED steps'
shared tensor-core int8 matvec alone against its plain version at the
Whisper-Large-v3-Turbo shapes for 1-32 rows, and the AED plan's limits
and shared-memory formulas against the kernels'; the packed-int4 and packed-int2 matmuls at the
Qwen3-ASR-0.6B shapes (and a row alone against the same row in a batch),
unpacked leaves of 2, 4 and 8 bits through the int8 kernel, the fused Qwen3 decode
step at a small and at the full geometry, their wrappers' checks, and the
launch counts of a batch-1 Qwen3-ASR transcription; the multi-slot Qwen3
step against its plain version and, slot by slot, bitwise against the
batch-1 kernel (at B = 2, 8, 17 and 32 with parked slots too), its
wrapper's checks, and its launch count in a continuous Qwen3-ASR serving
run; the two steps' shared tensor-core matvec alone against its plain
version at the five Qwen3-ASR-0.6B shapes for 1-32 rows; the int8, int4
and int2 sources each built twice (two cache keys) and both libraries
launched side by side in one process; the fused and multi-slot AED steps
at FireRedASR-AED-L's and Dolphin's decoder geometry (slots bitwise the
batch-1 kernel), tiny FireRed and Dolphin sessions' launch counts on
the batch-1, per-weight and continuous routes, and small q8 Paraformer,
Parakeet and Nemotron models (encoder and joint / decoder logits against
plain matmuls on the dequantized weights, int8 launches a forward, one
host read of the greedy loop's stop flags a chunk of steps); the three
training steps, the RNN-T and TDT losses and the training checkpoint on
the card against the CPU; the int8 and int4 kernels on the pieces that
``parallel/mesh.shard_params`` cuts (heads, rows at block boundaries, an
uneven vocabulary head), a ``data_parallel=2`` and a ``tensor_parallel=2``
continuous server on a repeated card, tiny dp x tp training steps on a
repeated card against the same steps on CPU positions, and, with two
cards, the kernels' per-device shared-memory limit; with TF32
off. Each test skips where no card is present.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import pytest
import torch

from asr_tpu_torch.ops import quant_matmul as qm
from asr_tpu_torch.quant.quantize import quantize_linear

# Every distinct (K, N, block) of the SenseVoiceSmall q8 forward.
SLICE_SHAPES = [(560, 1536, 560), (512, 1536, 128), (512, 512, 128),
                (512, 2048, 128), (2048, 512, 128), (512, 25055, 128)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("k,n,block", SLICE_SHAPES)
def test_kernel_matches_plain_version(k, n, block, mm):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 8, 128)
    assert leaf.block == block
    for m in (1, 137, 1096):
        x = torch.randn((m, k), generator=g, device="cuda")
        before = qm.LAUNCHES
        got = qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        torch.cuda.synchronize()
        assert qm.LAUNCHES == before + 1
        want = qm.quant_dense_reference(x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# Shapes off the aligned path: K = block = 560 (SenseVoice's first linear)
# and 140 (one scale block padded to whole stages), N = 25055 (rows not 16-byte
# aligned: byte staging) and N = 30.
RAGGED_INT8 = [(560, 1536), (140, 100), (512, 25055), (140, 30)]


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", RAGGED_INT8)
def test_int8_kernel_at_ragged_shapes(k, n, mm):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 8, 128)
    assert leaf.block == (128 if k % 128 == 0 else k)
    for m in range(1, 18):
        x = torch.randn((m, k), generator=g, device="cuda")
        got = qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        want = qm.quant_dense_reference(x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), f"M={m}"
        one = qm.quant_matmul_int8(x[m - 1 :].contiguous(), leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        assert torch.equal(one[0], got[m - 1]), f"M={m}"


# Row counts across every schedule switch of the int8 plan: cluster at
# M <= 16, a walking or cluster tile above.
INT8_ROW_M = (1, 4, 8, 16, 17, 137, 1096, 1500)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(512, 512), (1280, 1280), (5120, 1280), (512, 25055)])
def test_int8_rows_bitwise_across_schedules(k, n):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k * 3 + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 8, 128)
    x = torch.randn((max(INT8_ROW_M), k), generator=g, device="cuda")
    alone = {}
    for m in INT8_ROW_M:
        got = qm.quant_matmul_int8(x[:m].contiguous(), leaf.q, leaf.scale, leaf.zero, 128, "bf16")
        for r in sorted({0, m // 2, m - 1}):
            if r not in alone:
                alone[r] = qm.quant_matmul_int8(x[r : r + 1].contiguous(), leaf.q, leaf.scale, leaf.zero,
                                                128, "bf16")[0]
            assert torch.equal(alone[r], got[r]), f"M={m} row {r} plan {qm.int8_plan(m, k, n, 128)}"
    v = qm.int8_split(k, n, 128)[0]
    want = qm.quant_matmul_int8(x[:137].contiguous(), leaf.q, leaf.scale, leaf.zero, 128, "bf16")
    schedules = ([(bm, bn, False) for bm, bn in qm.INT8_CLUSTER_TILES]
                 + [(bm, bn, True) for bm, bn in qm.INT8_WALK_TILES])
    for bm, bn, walk in schedules:
        other = qm.quant_matmul_int8(x[:137].contiguous(), leaf.q, leaf.scale, leaf.zero, 128, "bf16",
                                     plan=(v, bn, bm, walk))
        assert torch.equal(other, want), f"tile {bm}x{bn} walk={walk}"


@pytest.mark.gpu
def test_int8_bf16_mode_refuses_a_plan_it_has_no_tile_for():
    _need_card()
    leaf = quantize_linear(torch.randn((256, 128), device="cuda"), 8, 128)
    x = torch.randn((4, 256), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, 128, "bf16", plan=(2, 96, 16, False))
    with pytest.raises(RuntimeError, match="CUDA error"):  # V must divide the scale blocks
        qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, 128, "bf16", plan=(3, 128, 16, False))


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    leaf = quantize_linear(torch.randn((256, 128), device="cuda"), 8, 128)
    x = torch.randn((4, 256), device="cuda")
    with pytest.raises(TypeError):
        qm.quant_matmul_int8(x.double(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int8(x.t().contiguous().t(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, 96, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int8(x, leaf.q.cpu(), leaf.scale, leaf.zero, 128, "f32")


@pytest.mark.gpu
def test_q8_forward_launches_kernel_once_per_linear():
    _need_card()
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.quant.quantize import quantize_pytree

    cfg = sv.SenseVoiceConfig()
    params = quantize_pytree(sv.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
    audio = torch.randn((2, 32000), device="cuda") * 2000
    valid = torch.tensor([32000, 20000], device="cuda")
    lang = torch.zeros(2, dtype=torch.int64, device="cuda")
    before = qm.LAUNCHES
    with torch.inference_mode():
        toks, counts = sv.forward(params, cfg, audio, valid, lang)
    torch.cuda.synchronize()
    assert qm.LAUNCHES - before == 4 * cfg.num_blocks + 1 == 281
    assert toks.shape[0] == 2 and counts.shape == (2,)


# ── the fused AED decode step (Whisper) ──────────────────────────────────
# Tolerances as in chip_smoke.py: both versions round every matvec input to
# bf16, and a flipped rounding moves every later layer, so logits agree to a
# bf16 step (1e-2 of max|logit|), the first layer's written row to one
# flipped input (1e-3 of max|row|, plus 2^-8 in a bf16 cache).
SMALL_WHISPER = dict(vocab_size=300, d_model=256, encoder_layers=1, decoder_layers=2, num_heads=4,
                     ffn_dim=1024, n_mels=16, max_source_positions=24, max_target_positions=16,
                     sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4,
                     no_timestamps_id=7, transcribe_id=6, translate_id=5)


def _fused_setup(cfg_kw, seed=0):
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.quant.quantize import quantize_pytree

    cfg = wh.WhisperConfig(**cfg_kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = quantize_pytree(wh.init_params(cfg, g), bits=8, block=128, min_size=0,
                             quantize_embeddings=True)
    stacked = fs.stack_whisper_step_params(params, cfg)
    assert stacked is not None
    for key in ("ba", "bb", "ln1_b", "lnc_b", "ln2_b", "lnf_b"):
        stacked[key] = 0.1 * torch.randn(stacked[key].shape, generator=g, device="cuda")
    for key in ("ln1_s", "lnc_s", "ln2_s", "lnf_s"):
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device="cuda")
    return fs, cfg, params, stacked, g


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("turbo", [False, True])
def test_fused_step_kernel_matches_plain_version(turbo, cache):
    _need_card()
    fs, cfg, params, stacked, g = _fused_setup({"encoder_layers": 0} if turbo else SMALL_WHISPER)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, v = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.vocab_size
    tc = cfg.max_source_positions
    ks, vs = (torch.randn((nl, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
    ck, cv = (torch.randn((nl, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
    for pos in (0, 3, t - 1):
        x = torch.randn((1, d), generator=g, device="cuda") * 0.05
        for tc_valid in (tc, tc // 2):
            kk, vk, kp, vp = ks.clone(), vs.clone(), ks.clone(), vs.clone()
            before = fs.LAUNCHES
            got, _, _ = fs.fused_aed_step(stacked, geom, x, kk, vk, ck, cv, pos, tc_valid)
            torch.cuda.synchronize()
            assert fs.LAUNCHES == before + 1
            want, _, _ = fs.fused_aed_step_reference(stacked, geom, x, kp, vp, ck, cv, pos, tc_valid)
            assert (got[:, :v] - want[:, :v]).abs().max().item() <= 1e-2 * want.abs().max().item()
            assert (got[:, v:] == 0).all()
            keep = torch.arange(t, device="cuda") != pos
            assert torch.equal(kk[:, keep], ks[:, keep]) and torch.equal(vk[:, keep], vs[:, keep])
            bound = 1e-3 + (2.0**-8 if cache == torch.bfloat16 else 0.0)
            for have, ref in ((kk, kp), (vk, vp)):
                err = (have[0, pos].float() - ref[0, pos].float()).abs().max().item()
                assert err <= bound * ref[0, pos].float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_fused_step_reads_rows_past_the_staged_ones(cache):
    """2000 cross rows: a chunk holds 250 rows, more than the 192 it stages
    in shared memory, so the rest are read from device memory; batch 1 and
    a multi-slot slot (bitwise the batch-1 kernel) against the plain
    version."""
    _need_card()
    from asr_tpu_torch.ops import fused_aed_multi as fm

    fs, cfg, params, stacked, g = _fused_setup({**SMALL_WHISPER, "max_source_positions": 2000})
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc, v = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, 2000, cfg.vocab_size
    plan = fs.aed_plan(d, cfg.ffn_dim, stacked["wh"].shape[1], t, tc)
    assert plan.cross_srows < -(-tc // plan.attn_max_chunks) <= plan.cross_cap
    ks, vs = (torch.randn((nl, 2, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
    ck, cv = (torch.randn((nl, 2, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
    x = torch.randn((2, d), generator=g, device="cuda") * 0.05
    pos, tcv = [9, 5], [tc, 1700]
    kk, vk = ks.clone(), vs.clone()
    got, _, _ = fm.fused_aed_step_multi_cuda(stacked, geom, x, kk, vk, ck, cv,
                                             torch.tensor(pos, dtype=torch.int32, device="cuda"),
                                             torch.tensor(tcv, dtype=torch.int32, device="cuda"))
    for b in range(2):
        kb, vb = ks[:, b].contiguous(), vs[:, b].contiguous()
        one, _, _ = fs.fused_aed_step_cuda(stacked, geom, x[b : b + 1], kb, vb, ck[:, b].contiguous(),
                                           cv[:, b].contiguous(), pos[b], tcv[b])
        assert torch.equal(got[b : b + 1], one)
        want, _, _ = fs.fused_aed_step_reference(stacked, geom, x[b : b + 1], ks[:, b].clone(),
                                                 vs[:, b].clone(), ck[:, b], cv[:, b], pos[b], tcv[b])
        assert (one[:, :v] - want[:, :v]).abs().max().item() <= 1e-2 * want[:, :v].abs().max().item()


@pytest.mark.gpu
def test_fused_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    fs, cfg, params, stacked, g = _fused_setup(SMALL_WHISPER)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d = cfg.decoder_layers, cfg.d_model
    x = torch.zeros((1, d), device="cuda")
    kc, vc = torch.zeros((nl, 16, d), device="cuda"), torch.zeros((nl, 16, d), device="cuda")
    ck, cv = torch.zeros((nl, 24, d), device="cuda"), torch.zeros((nl, 24, d), device="cuda")
    fs.fused_aed_step(stacked, geom, x, kc, vc, ck, cv, 2)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        fs.fused_aed_step(stacked, geom, x, kc.cpu(), vc, ck, cv, 2)
    with pytest.raises(TypeError):  # caches of another dtype
        fs.fused_aed_step(stacked, geom, x, kc.half(), vc.half(), ck.half(), cv.half(), 2)
    with pytest.raises(TypeError):  # self and cross caches of different dtypes
        fs.fused_aed_step(stacked, geom, x, kc, vc, ck.bfloat16(), cv.bfloat16(), 2)
    with pytest.raises(ValueError):  # wrong shape
        fs.fused_aed_step(stacked, geom, x, kc[:1], vc, ck, cv, 2)
    with pytest.raises(ValueError):  # pos outside the cache
        fs.fused_aed_step(stacked, geom, x, kc, vc, ck, cv, 16)
    with pytest.raises(ValueError):  # a head width other than 64
        fs.fused_aed_step(stacked, fs.AedGeom(d, cfg.ffn_dim, 8), x, kc, vc, ck, cv, 2)
    with pytest.raises(ValueError):  # not contiguous
        fs.fused_aed_step(stacked, geom, x, kc.transpose(1, 2).contiguous().transpose(1, 2), vc,
                          ck, cv, 2)
    with pytest.raises(ValueError):  # fused_aed_step_cuda refuses the CPU
        fs.fused_aed_step_cuda(stacked, geom, x.cpu(), kc.cpu(), vc.cpu(), ck.cpu(), cv.cpu(), 2)
    plan = fs.aed_plan(d, cfg.ffn_dim, stacked["wh"].shape[1], 16, 24)
    with pytest.raises(RuntimeError):  # a column tile the kernel has no instance for
        fs.fused_aed_step_cuda(stacked, geom, x, kc, vc, ck, cv, 2, plan=plan._replace(qkv=(48, 1)))
    with pytest.raises(RuntimeError):  # a cross cap too short for the cache's rows
        fs.fused_aed_step_cuda(stacked, geom, x, kc, vc, ck, cv, 2, plan=plan._replace(cross_cap=2))


@pytest.mark.gpu
def test_one_window_transcribe_launches_fused_kernel_once_per_step():
    _need_card()
    import numpy as np

    from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig

    fs, cfg, params, stacked, g = _fused_setup(SMALL_WHISPER, seed=1)
    mm = qm._CONFIG["mm"]
    qm.set_quant_config(mm="bf16")  # the session stacks for the fused step in this mode only
    try:
        sess = WhisperSession(params, cfg, session_cfg=WhisperSessionConfig(
            max_new_tokens=10, no_speech_threshold=None), window_seconds=0.48)
    finally:
        qm._CONFIG["mm"] = mm
    assert sess.stacked is not None
    audio = np.random.default_rng(0).standard_normal(5000).astype(np.float32) * 0.1
    before_f, before_q = fs.LAUNCHES, qm.LAUNCHES
    res = sess.transcribe(audio)
    steps = fs.LAUNCHES - before_f
    assert 0 < steps <= 10 and len(res.token_ids) in (steps, steps + 1)
    assert qm.LAUNCHES - before_q == 6 + 2 * 2 * 2 + 2 * (2 * 8 + 1)  # encoder, cross-KV, prefills
    before_f = fs.LAUNCHES
    sess.transcribe(np.concatenate([audio, audio]))  # 2 windows: the per-weight route
    assert fs.LAUNCHES == before_f


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_fused_step_device_pos_entry_is_bitwise_the_host_pos_entry(cache):
    """Turbo geometry: the entry that reads pos and tc_valid on the device
    (what the decode graph replays) gives the host-pos entry's logits and
    cache rows bit for bit, at pos 4, 100 and 447."""
    _need_card()
    fs, cfg, params, stacked, g = _fused_setup({"encoder_layers": 0})
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.max_source_positions
    ks, vs = (torch.randn((nl, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
    ck, cv = (torch.randn((nl, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
    logits = torch.empty((1, stacked["wh"].shape[1]), device="cuda")
    scratch = torch.empty((fs.step_scratch_floats(geom),), device="cuda")
    for pos in (4, 100, 447):
        x = torch.randn((1, d), generator=g, device="cuda") * 0.05
        for tc_valid in (tc, 700):
            kh, vh, kd, vd = ks.clone(), vs.clone(), ks.clone(), vs.clone()
            want, _, _ = fs.fused_aed_step_cuda(stacked, geom, x, kh, vh, ck, cv, pos, tc_valid)
            before = fs.LAUNCHES
            got, _, _ = fs.fused_aed_step_dev_cuda(
                stacked, geom, x, kd, vd, ck, cv, torch.tensor([pos], dtype=torch.int32, device="cuda"),
                torch.tensor([tc_valid], dtype=torch.int32, device="cuda"), logits, scratch)
            torch.cuda.synchronize()
            assert fs.LAUNCHES == before + 1 and got.data_ptr() == logits.data_ptr()
            assert torch.equal(got, want), (pos, tc_valid)
            assert torch.equal(kd, kh) and torch.equal(vd, vh), (pos, tc_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_graphed_greedy_decode_equals_eager_at_turbo_width(cache):
    """A full-width Whisper-Large-v3-Turbo q8 decoder on random prefilled
    caches: the decoder's greedy route (one CUDA graph replay a token)
    against the eager ``ar_decode`` loop, tokens and counts equal, to the
    budget and with EOT in mid-loop; ``LAUNCHES`` one a step, every step of
    the second request of a shape a replay, one graph for the two."""
    _need_card()
    from asr_tpu_torch.decode.ar import DecodeConfig
    from asr_tpu_torch.models import whisper as wh

    fs, cfg, params, stacked, g = _fused_setup({"encoder_layers": 0})
    decoder = wh.fused_decoder(params, cfg, stacked)
    nl, d, t, tc = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.max_source_positions
    p_len, budget = 4, 200

    def layers(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        out = []
        for _ in range(nl):
            sk, sv = (torch.zeros((1, t, d), device="cuda") for _ in range(2))
            sk[0, :p_len] = torch.randn((p_len, d), generator=g, device="cuda")
            sv[0, :p_len] = torch.randn((p_len, d), generator=g, device="cuda")
            ck, cv = (torch.randn((1, tc, d), generator=g, device="cuda") for _ in range(2))
            out.append({k: v.to(cache) for k, v in
                        (("self_k", sk), ("self_v", sv), ("cross_k", ck), ("cross_v", cv))})
        return out

    buf = torch.zeros((1, p_len + budget + 1), dtype=torch.int64, device="cuda")
    buf[0, :p_len] = torch.tensor([50258, 50259, 50360, 50364])
    first = torch.tensor([220], device="cuda")

    def run(lay, dcfg, graphed):
        l0, r0, c0 = fs.LAUNCHES, fs.GRAPH_REPLAYS, fs.GRAPH_CAPTURES
        loop = decoder.decode if graphed else decoder.host_loop
        toks, counts = loop(lay, p_len, first, buf, dcfg)
        torch.cuda.synchronize()
        steps = int(counts[0]) - 1
        assert fs.LAUNCHES - l0 == steps
        return toks, counts, steps, fs.GRAPH_REPLAYS - r0, fs.GRAPH_CAPTURES - c0

    to_budget = DecodeConfig(max_new_tokens=budget, eot_id=-1)
    lay = layers(1)
    e_toks, e_counts, steps, replays, captures = run(lay, to_budget, False)
    assert steps == budget and replays == 0 and captures == 0
    g_toks, g_counts, steps, replays, captures = run(lay, to_budget, True)
    assert torch.equal(g_toks, e_toks) and torch.equal(g_counts, e_counts)
    assert captures == 1 and replays == steps - 1  # the first step of a shape's first request is eager
    seq = e_toks[0, p_len:].tolist()
    k = next(i for i in range(2, len(seq)) if seq[i] not in seq[:i])
    mid = DecodeConfig(max_new_tokens=budget, eot_id=seq[k])
    e_toks, e_counts, steps, _, _ = run(lay, mid, False)
    assert steps == k
    g_toks, g_counts, steps, replays, captures = run(lay, mid, True)
    assert torch.equal(g_toks, e_toks) and torch.equal(g_counts, e_counts)
    assert captures == 1 and replays == steps - 1  # another EOT: another graph
    lay2 = layers(2)
    e_toks, e_counts, _, _, _ = run(lay2, to_budget, False)
    g_toks, g_counts, steps, replays, captures = run(lay2, to_budget, True)
    assert torch.equal(g_toks, e_toks) and torch.equal(g_counts, e_counts)
    assert captures == 0 and replays == steps == budget  # the second request of the shape


# ── the multi-slot AED decode step (continuous Whisper serving) ─────────
# Tolerances as for the batch-1 step above; a slot of the multi-slot step
# rounds and sums as the batch-1 kernel does for it alone.


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("turbo", [False, True])
def test_multi_step_kernel_matches_plain_version(turbo, cache):
    _need_card()
    from asr_tpu_torch.ops import fused_aed_multi as fm

    fs, cfg, params, stacked, g = _fused_setup({"encoder_layers": 0} if turbo else SMALL_WHISPER)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, v = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.vocab_size
    tc = cfg.max_source_positions
    pos_l, tc_l = [3, -1, t - 1, 0], [tc, tc, tc // 2, 1]
    bs = len(pos_l)
    ks, vs = (torch.randn((nl, bs, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
    ck, cv = (torch.randn((nl, bs, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
    x = torch.randn((bs, d), generator=g, device="cuda") * 0.05
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    tcv = torch.tensor(tc_l, dtype=torch.int32, device="cuda")
    kk, vk, kp, vp = ks.clone(), vs.clone(), ks.clone(), vs.clone()
    before = fm.LAUNCHES
    got, _, _ = fm.fused_aed_step_multi(stacked, geom, x, kk, vk, ck, cv, pos, tcv)
    torch.cuda.synchronize()
    assert fm.LAUNCHES == before + 1
    want, _, _ = fm.fused_aed_step_multi_reference(stacked, geom, x, kp, vp, ck, cv, pos, tcv)
    assert torch.isfinite(got).all() and (got[:, v:] == 0).all()
    assert (got[:, :v] - want[:, :v]).abs().max().item() <= 1e-2 * want[:, :v].abs().max().item()
    bound = 1e-3 + (2.0**-8 if cache == torch.bfloat16 else 0.0)
    for b, p in enumerate(pos_l):
        keep = torch.arange(t, device="cuda") != p
        assert torch.equal(kk[:, b, keep], ks[:, b, keep]) and torch.equal(vk[:, b, keep], vs[:, b, keep])
        if p < 0:
            assert torch.equal(kk[:, b], ks[:, b]) and torch.equal(vk[:, b], vs[:, b])
            continue
        for have, ref in ((kk, kp), (vk, vp)):
            err = (have[0, b, p].float() - ref[0, b, p].float()).abs().max().item()
            assert err <= bound * ref[0, b, p].float().abs().max().item()
        kb, vb = ks[:, b].contiguous(), vs[:, b].contiguous()
        one, _, _ = fs.fused_aed_step(stacked, geom, x[b : b + 1], kb, vb, ck[:, b].contiguous(),
                                      cv[:, b].contiguous(), p, tc_l[b])
        assert torch.equal(got[b : b + 1], one), f"slot {b}"  # bitwise the batch-1 kernel
        assert torch.equal(kk[:, b], kb) and torch.equal(vk[:, b], vb), f"slot {b}"


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [2, 5, 8, 17, 32])
def test_multi_aed_slots_equal_batch1_kernel_bitwise(bs, cache):
    """Turbo width, two layers: every live slot of the multi-slot AED kernel
    (rows 0-15 of the first m16 tile and, past 16 slots, of the second) is
    bitwise the batch-1 kernel on that slot alone, logits and written rows,
    at mixed positions and cross lengths; every fifth slot is parked and
    its planes are left as they were."""
    _need_card()
    from asr_tpu_torch.ops import fused_aed_multi as fm

    fs, cfg, params, stacked, g = _fused_setup({"encoder_layers": 0, "decoder_layers": 2}, seed=bs)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.max_source_positions
    pos_l = [-1 if b % 5 == 1 else (37 * b + 5) % (t - 6) for b in range(bs)]
    tc_l = [tc - 97 * b % (tc - 1) for b in range(bs)]
    ks, vs = (torch.randn((nl, bs, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
    ck, cv = (torch.randn((nl, bs, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
    x = torch.randn((bs, d), generator=g, device="cuda") * 0.05
    k1, v1 = ks.clone(), vs.clone()
    lg, _, _ = fm.fused_aed_step_multi_cuda(stacked, geom, x, k1, v1, ck, cv,
                                            torch.tensor(pos_l, dtype=torch.int32, device="cuda"),
                                            torch.tensor(tc_l, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert torch.isfinite(lg).all()
    for b, p in enumerate(pos_l):
        if p < 0:
            assert torch.equal(k1[:, b], ks[:, b]) and torch.equal(v1[:, b], vs[:, b])
            continue
        kb, vb = ks[:, b].contiguous(), vs[:, b].contiguous()
        one, _, _ = fs.fused_aed_step_cuda(stacked, geom, x[b : b + 1], kb, vb, ck[:, b].contiguous(),
                                           cv[:, b].contiguous(), p, tc_l[b])
        assert torch.equal(lg[b : b + 1], one), f"slot {b}"
        assert torch.equal(k1[:, b], kb) and torch.equal(v1[:, b], vb), f"slot {b}"


# The Whisper-Large-v3-Turbo matvecs of both AED step kernels: q|k|v, self-o,
# cross-q and cross-o (one shape), fc1, fc2, the head.
AED_STEP_MATVECS = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (1280, 52224)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", AED_STEP_MATVECS)
def test_aed_matvec_matches_plain_and_rows_alone(k, n):
    """The AED steps' shared tensor-core matvec alone against the plain
    version's ``_matvec`` (1e-4 of max|plain|) at every slot count the
    kernels see, one and two m16 tiles, each row bitwise the row alone."""
    _need_card()
    from asr_tpu_torch.ops import fused_aed_step as fs

    g = torch.Generator(device="cuda").manual_seed(k + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 8, 128)
    s, zs = leaf.scale.contiguous(), (leaf.zero * leaf.scale).contiguous()
    x = torch.randn((32, k), generator=g, device="cuda")
    alone = [fs.aed_matvec_cuda(x[r : r + 1].contiguous(), leaf.q, s, zs)[0] for r in range(32)]
    for b in (1, 2, 8, 16, 17, 32):
        before = fs.MATVEC_LAUNCHES
        got = fs.aed_matvec_cuda(x[:b].contiguous(), leaf.q, s, zs)
        torch.cuda.synchronize()
        assert fs.MATVEC_LAUNCHES == before + 1
        want = torch.cat([fs._matvec(x[i : i + 1], leaf.q, s, zs) for i in range(b)])
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        assert all(torch.equal(got[r], alone[r]) for r in range(b))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", AED_STEP_MATVECS + [(256, 768), (384, 1536), (1024, 4096)])
def test_aed_plan_shared_memory_is_the_kernels(k, n):
    """``matvec_smem`` and ``attn_smem``, which ``aed_plan`` sizes tiles and
    staged rows by, give the kernel's own figures (``aed_matvec_smem``,
    ``aed_attn_smem``) for every column tile and split of K it may choose,
    at 1..32 slots; the library's limits are the plan's (``_load`` checks
    them, so loading must succeed)."""
    _need_card()
    from asr_tpu_torch.ops import fused_aed_step as fs

    lib = fs._load()
    nb = k // 128
    for bn in fs.MV_WIDTHS:
        for parts in (d for d in range(1, fs.MAX_PARTS + 1) if nb % d == 0):
            for rows in range(1, fs.MAX_ROWS + 1):
                assert fs.matvec_smem(bn, parts, k, rows) == lib.aed_matvec_smem(bn, parts, k, rows), \
                    (bn, parts, rows)
    for t_rows in (15, 447, 750, 1500, 3000):
        cap, srows = fs.attn_cap(t_rows)
        for itemsize in (2, 4):
            assert fs.attn_smem(cap, srows, itemsize) == lib.aed_attn_smem(cap, srows, itemsize)


@pytest.mark.gpu
def test_multi_wrapper_rejects_what_the_kernel_does_not_take():

    _need_card()
    from asr_tpu_torch.ops import fused_aed_multi as fm

    fs, cfg, params, stacked, g = _fused_setup(SMALL_WHISPER)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d = cfg.decoder_layers, cfg.d_model
    x = torch.zeros((2, d), device="cuda")
    kc, vc = torch.zeros((nl, 2, 16, d), device="cuda"), torch.zeros((nl, 2, 16, d), device="cuda")
    ck, cv = torch.zeros((nl, 2, 24, d), device="cuda"), torch.zeros((nl, 2, 24, d), device="cuda")
    pos = torch.tensor([2, -1], dtype=torch.int32, device="cuda")
    tcv = torch.tensor([24, 24], dtype=torch.int32, device="cuda")
    fm.fused_aed_step_multi(stacked, geom, x, kc, vc, ck, cv, pos, tcv)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        fm.fused_aed_step_multi(stacked, geom, x, kc.cpu(), vc, ck, cv, pos, tcv)
    with pytest.raises(ValueError):  # positions on the host
        fm.fused_aed_step_multi(stacked, geom, x, kc, vc, ck, cv, pos.cpu(), tcv)
    with pytest.raises(TypeError):  # int64 positions
        fm.fused_aed_step_multi(stacked, geom, x, kc, vc, ck, cv, pos.long(), tcv)
    with pytest.raises(TypeError):  # caches of another dtype
        fm.fused_aed_step_multi(stacked, geom, x, kc.half(), vc.half(), ck.half(), cv.half(), pos, tcv)
    with pytest.raises(ValueError):  # wrong shape
        fm.fused_aed_step_multi(stacked, geom, x, kc[:1], vc, ck, cv, pos, tcv)
    with pytest.raises(ValueError):  # batch 1 is the batch-1 kernel's
        fm.fused_aed_step_multi(stacked, geom, x[:1], kc[:, :1].contiguous(), vc[:, :1].contiguous(),
                                ck[:, :1].contiguous(), cv[:, :1].contiguous(), pos[:1], tcv[:1])
    with pytest.raises(ValueError):  # a head width other than 64
        fm.fused_aed_step_multi(stacked, fs.AedGeom(d, cfg.ffn_dim, 8), x, kc, vc, ck, cv, pos, tcv)
    with pytest.raises(ValueError):  # not contiguous
        fm.fused_aed_step_multi(stacked, geom, x, kc.transpose(2, 3).contiguous().transpose(2, 3), vc,
                                ck, cv, pos, tcv)


@pytest.mark.gpu
def test_continuous_run_launches_multi_kernel_once_per_step():
    _need_card()
    import io
    import wave

    import numpy as np

    from asr_tpu_torch.ops import fused_aed_multi as fm
    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer
    from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig

    fs, cfg, params, stacked, g = _fused_setup(SMALL_WHISPER, seed=1)
    mm = qm._CONFIG["mm"]
    qm.set_quant_config(mm="bf16")  # the session stacks for the fused steps in this mode only
    try:
        sess = WhisperSession(params, cfg, session_cfg=WhisperSessionConfig(
            max_new_tokens=10, no_speech_threshold=None), window_seconds=0.48)
        srv = ContinuousSessionServer(sess, n_slots=2)
        try:
            before_m, before_f = fm.LAUNCHES, fs.LAUNCHES
            rng = np.random.default_rng(0)
            for n in (5000, 3000, 7000):
                buf = io.BytesIO()
                with wave.open(buf, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes((rng.standard_normal(n) * 900).astype(np.int16).tobytes())
                srv.transcribe_bytes(buf.getvalue())
            st = srv.stats()
        finally:
            srv.close()
    finally:
        qm._CONFIG["mm"] = mm
    assert st["step_kernel"] == "fused" and st["requests_served"] == 3
    assert fm.LAUNCHES - before_m == st["decode_steps"] > 0
    assert fs.LAUNCHES == before_f


# ── the packed-int4 matmul and the fused Qwen3 decode step ──────────────
# Every distinct (K, N) of the Qwen3-ASR-0.6B q4 path: q|k|v, o, gate|up,
# down and the packed tied head (V padded to 153600).
QWEN_P4_SHAPES = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 153600)]


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", QWEN_P4_SHAPES)
def test_int4_kernel_matches_plain_version(k, n, mm):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 4, 128,
                           pack=True)
    assert leaf.packed and tuple(leaf.q.shape) == (k // 2, n)
    _packed_matches_plain(g, qm.quant_matmul_int4, qm.quant_dense_p4_reference, "LAUNCHES_INT4",
                          leaf, k, 128, mm)


# Rows of the packed calls: decode steps (1), the micro-batcher (2, 4), the
# continuous server's slots (8), one m16 tile and one row past it (16, 17)
# and a 30 s prefill (432).
PACKED_M = (1, 2, 4, 8, 16, 17, 432)


def _packed_matches_plain(g, launch, plain, counter, leaf, k, block, mm):
    for m in PACKED_M:
        x = torch.randn((m, k), generator=g, device="cuda")
        before = getattr(qm, counter)
        got = launch(x, leaf.q, leaf.scale, leaf.zero, block, mm)
        torch.cuda.synchronize()
        assert getattr(qm, counter) == before + 1
        want = plain(x, leaf.q, leaf.scale, leaf.zero, block, mm)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        # the sum behind each output does not depend on M: a row alone is bitwise the same
        for r in sorted({0, m // 2, m - 1}) if m > 1 else ():
            one = launch(x[r : r + 1].contiguous(), leaf.q, leaf.scale, leaf.zero, block, mm)
            assert torch.equal(one[0], got[r])


@pytest.mark.gpu
def test_int4_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    leaf = quantize_linear(torch.randn((256, 128), device="cuda"), 4, 128, pack=True)
    x = torch.randn((4, 256), device="cuda")
    with pytest.raises(TypeError):
        qm.quant_matmul_int4(x.double(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int4(x[:, :128].contiguous(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int4(x, leaf.q, leaf.scale, leaf.zero, 96, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int4(x, leaf.q.cpu(), leaf.scale, leaf.zero, 128, "f32")


# ── the packed-int2 matmul, unpacked leaves of every width ───────────────
# Every packed (K, N) of the Qwen3-ASR-0.6B q2 LLM: q|k|v, o, gate|up, down.
QWEN_P2_SHAPES = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", QWEN_P2_SHAPES)
def test_int2_kernel_matches_plain_version(k, n, mm):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k + n + 2)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 2, 128,
                           pack=True)
    assert leaf.packed and tuple(leaf.q.shape) == (k // 4, n)
    _packed_matches_plain(g, qm.quant_matmul_int2, qm.quant_dense_p2_reference, "LAUNCHES_INT2",
                          leaf, k, 128, mm)


# Packed leaves off the main path: blocks 32 and 64, a column count that is
# not a multiple of 16 (byte-staged weights) or of 4 (scalar scales), a
# single scale block, and the CPU tests' widths.
ODD_PACKED = [(4, 512, 100, 64), (4, 256, 30, 32), (4, 512, 1024, 128), (4, 1024, 512, 32),
              (2, 512, 100, 64), (2, 1024, 30, 32), (2, 512, 1024, 128), (2, 1024, 2048, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("bits,k,n,block", ODD_PACKED)
def test_packed_kernels_at_odd_shapes(bits, k, n, block, mm):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k + n + block + bits)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, bits, block,
                           pack=True)
    assert leaf.packed and leaf.block == block
    if bits == 4:
        _packed_matches_plain(g, qm.quant_matmul_int4, qm.quant_dense_p4_reference, "LAUNCHES_INT4",
                              leaf, k, block, mm)
    else:
        _packed_matches_plain(g, qm.quant_matmul_int2, qm.quant_dense_p2_reference, "LAUNCHES_INT2",
                              leaf, k, block, mm)


@pytest.mark.gpu
def test_int2_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    leaf = quantize_linear(torch.randn((512, 128), device="cuda"), 2, 128, pack=True)
    assert leaf.packed
    x = torch.randn((4, 512), device="cuda")
    with pytest.raises(TypeError):
        qm.quant_matmul_int2(x.double(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):  # K is not 4 x the packed rows
        qm.quant_matmul_int2(x[:, :256].contiguous(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):  # K/4 is not a multiple of the block
        qm.quant_matmul_int2(x, leaf.q, leaf.scale, leaf.zero, 96, "f32")
    with pytest.raises(ValueError):  # the block is not a multiple of the staging depth
        qm.quant_matmul_int2(torch.randn((4, 40), device="cuda"), leaf.q[:10].contiguous(),
                             leaf.scale, leaf.zero, 10, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int2(x, leaf.q.cpu(), leaf.scale, leaf.zero, 128, "f32")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpacked_leaves_of_every_width_take_the_int8_kernel(bits):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(bits)
    leaf = quantize_linear(torch.randn((1024, 512), generator=g, device="cuda") * 0.03, bits, 128)
    assert not leaf.packed and leaf.bits == bits
    x = torch.randn((5, 1024), generator=g, device="cuda")
    for mm in ("f32", "bf16"):
        before = (qm.LAUNCHES, qm.LAUNCHES_INT4, qm.LAUNCHES_INT2)
        got = qm.quant_dense(x, leaf, mm=mm)
        torch.cuda.synchronize()
        assert (qm.LAUNCHES, qm.LAUNCHES_INT4, qm.LAUNCHES_INT2) == (before[0] + 1, *before[1:])
        want = qm.quant_dense_reference(x, leaf.q, leaf.scale, leaf.zero, 128, mm)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _qwen_stacked(cfg, seed):
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.quant.quantize import quantize_pytree

    p = qwen3.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    p = qwen3.fuse_params(quantize_pytree(p, bits=4, pack=True, refine_iters=0, min_size=0,
                                          quantize_embeddings=True), cfg)
    st = fd.stack_decode_params(p, cfg)
    assert st is not None and "wh" in st
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    for key in ("in_s", "post_s", "qn_s", "kn_s", "fn_s"):  # the init has ones
        st[key] = 1 + 0.1 * torch.randn(st[key].shape, generator=g, device="cuda")
    return p, st


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full", [False, True])
def test_fused_decode_kernel_matches_plain_version(full, cache):
    _need_card()
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.ops import fused_decode as fd

    # Full width at two layers: every bf16 rounding of a matvec input can flip
    # between the two versions, and over the 28 random layers the flips add up
    # to the plain version's own host/card drift (~2e-2, chip_smoke phase 15);
    # at two layers they stay within a bf16 step.
    cfg = qwen3.Qwen3Config(num_layers=2) if full else qwen3.Qwen3Config(
        vocab_size=3000, hidden=512, num_layers=3, num_heads=4, num_kv_heads=2, ffn_dim=1024)
    _, st = _qwen_stacked(cfg, 5)
    nl, t, kvw, v = cfg.num_layers, 456, cfg.num_kv_heads * 128, cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(6)
    kc = torch.randn((nl, t, kvw), generator=g, device="cuda").to(cache)
    vc = torch.randn((nl, t, kvw), generator=g, device="cuda").to(cache)
    x = torch.randn((1, cfg.hidden), generator=g, device="cuda") * 0.05
    ang = torch.rand((1, 128), generator=g, device="cuda") * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    for pos, shift in ((0, 0), (7, 3), (440, 17)):
        for head in (True, False):
            stk = st if head else {k: a for k, a in st.items() if k not in ("wh", "h_s", "h_zs")}
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            before = fd.LAUNCHES
            h, lg, _, _ = fd.fused_decode_step_cuda(stk, cfg, x, k1, v1, pos, shift, cos, sin)
            torch.cuda.synchronize()
            assert fd.LAUNCHES == before + 1
            hr, lr, _, _ = fd.fused_decode_step_reference(stk, cfg, x, k2, v2, pos, shift, cos, sin)
            assert (h - hr).abs().max().item() <= 1e-2 * hr.abs().max().item()
            if head:
                assert (lg[:, :v] - lr[:, :v]).abs().max().item() <= 1e-2 * lr.abs().max().item()
                assert bool((lg[:, v:] == 0).all())
            else:
                assert lg is None and lr is None
            tol0 = 1e-3 + (2.0**-8 if cache == torch.bfloat16 else 0.0)
            for a, b in ((k1, k2), (v1, v2)):
                assert (a[0, pos].float() - b[0, pos].float()).abs().max().item() <= \
                    tol0 * b[0, pos].float().abs().max().item()
            others = torch.arange(t, device="cuda") != pos
            assert torch.equal(k1[:, others], kc[:, others]) and torch.equal(v1[:, others], vc[:, others])


@pytest.mark.gpu
def test_fused_decode_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.ops import fused_decode as fd

    cfg = qwen3.Qwen3Config(vocab_size=300, hidden=256, num_layers=1, num_heads=2, num_kv_heads=1,
                            ffn_dim=512)
    _, st = _qwen_stacked(cfg, 7)
    kc = torch.zeros((1, 16, 128), device="cuda")
    x = torch.zeros((1, 256), device="cuda")
    cs = torch.zeros((1, 128), device="cuda")
    with pytest.raises(ValueError):
        fd.fused_decode_step_cuda(st, cfg, x, kc, kc.clone(), 16, 0, cs, cs)  # pos past the cache
    with pytest.raises(ValueError):
        fd.fused_decode_step_cuda(st, cfg, x, kc, kc.clone(), 3, 4, cs, cs)  # shift past pos
    with pytest.raises(TypeError):
        fd.fused_decode_step_cuda(st, cfg, x, kc, kc.to(torch.bfloat16), 3, 0, cs, cs)
    with pytest.raises(ValueError):
        fd.fused_decode_step_cuda(st, cfg, x[:, :128].contiguous(), kc, kc.clone(), 3, 0, cs, cs)
    with pytest.raises(ValueError):
        fd.fused_decode_step_cuda(st, cfg, x, kc, kc.clone(), 3, 0, cs.cpu(), cs)


@pytest.mark.gpu
def test_qwen_transcribe_launches_fused_kernel_once_per_step():
    _need_card()
    import numpy as np

    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=3000, hidden=512, num_layers=3, num_heads=4,
                             num_kv_heads=2, ffn_dim=1024)
    cfg = qa.QwenAsrConfig(tower_dim=256, tower_layers=2, tower_heads=4, tower_ffn=512,
                           output_dim=512, llm=lcfg, eot_id=-1)
    tower = quantize_pytree(qa.init_tower_params(cfg, torch.Generator(device="cuda").manual_seed(0)),
                            bits=8, min_size=0)
    llm, _ = _qwen_stacked(lcfg, 1)
    prev = qm._CONFIG["mm"]
    qm.set_quant_config(mm="bf16")
    try:
        sess = QwenAsrSession(tower, llm, cfg, template=QwenPromptTemplate((1, 2), (3,), (4, 5)),
                              max_new_tokens=12, max_seconds=4.0)
        assert sess.stacked is not None
        audio = (np.random.default_rng(0).standard_normal(3 * 16000) * 0.1).astype(np.float32)
        before_f, before_4 = fd.LAUNCHES, qm.LAUNCHES_INT4
        res = sess.transcribe(audio)
        assert fd.LAUNCHES - before_f == len(res.token_ids) - 1 == 12
        # the prefill's linears and the first logits; the steps' head runs in the fused kernel
        assert qm.LAUNCHES_INT4 - before_4 == 4 * lcfg.num_layers + 1
    finally:
        qm._CONFIG["mm"] = prev


# ── the multi-slot Qwen3 decode step (continuous Qwen3-ASR serving) ──────
# Tolerances as for the batch-1 step above; a slot of the multi-slot step
# rounds and sums as the batch-1 kernel does for it alone at shift 0, so it
# equals that kernel bitwise.


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full", [False, True])
def test_multi_decode_kernel_matches_plain_version_and_batch1_kernel(full, cache):
    _need_card()
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.ops import fused_decode_multi as fdm

    cfg = qwen3.Qwen3Config(num_layers=2) if full else qwen3.Qwen3Config(
        vocab_size=3000, hidden=512, num_layers=3, num_heads=4, num_kv_heads=2, ffn_dim=1024)
    _, st = _qwen_stacked(cfg, 8)
    nl, t, kvw, v = cfg.num_layers, 456, cfg.num_kv_heads * 128, cfg.vocab_size
    pos_l = [3, -1, 440, 0, 70]
    bs = len(pos_l)
    g = torch.Generator(device="cuda").manual_seed(9)
    kc = torch.randn((nl, bs, t, kvw), generator=g, device="cuda").to(cache)
    vc = torch.randn((nl, bs, t, kvw), generator=g, device="cuda").to(cache)
    x = torch.randn((bs, cfg.hidden), generator=g, device="cuda") * 0.05
    ang = torch.rand((bs, 128), generator=g, device="cuda") * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    for head in (True, False):
        stk = st if head else {k: a for k, a in st.items() if k not in ("wh", "h_s", "h_zs")}
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = fdm.LAUNCHES
        h, lg, _, _ = fdm.fused_decode_step_multi(stk, cfg, x, k1, v1, pos, cos, sin)
        torch.cuda.synchronize()
        assert fdm.LAUNCHES == before + 1
        hr, lr, _, _ = fdm.fused_decode_step_multi_reference(stk, cfg, x, k2, v2, pos, cos, sin)
        assert torch.isfinite(h).all()
        assert (h - hr).abs().max().item() <= 1e-2 * hr.abs().max().item()
        if head:
            assert (lg[:, :v] - lr[:, :v]).abs().max().item() <= 1e-2 * lr[:, :v].abs().max().item()
            assert bool((lg[:, v:] == 0).all())
        else:
            assert lg is None and lr is None
        tol0 = 1e-3 + (2.0**-8 if cache == torch.bfloat16 else 0.0)
        for b, p in enumerate(pos_l):
            if p < 0:  # parked: its planes bitwise unchanged
                assert torch.equal(k1[:, b], kc[:, b]) and torch.equal(v1[:, b], vc[:, b])
                continue
            others = torch.arange(t, device="cuda") != p
            assert torch.equal(k1[:, b, others], kc[:, b, others])
            assert torch.equal(v1[:, b, others], vc[:, b, others])
            for a, r in ((k1, k2), (v1, v2)):
                assert (a[0, b, p].float() - r[0, b, p].float()).abs().max().item() <= \
                    tol0 * r[0, b, p].float().abs().max().item()
            # slot by slot, the batch-1 kernel at shift 0 on this slot alone
            kb, vb = kc[:, b].contiguous(), vc[:, b].contiguous()
            hb, lb, _, _ = fd.fused_decode_step_cuda(stk, cfg, x[b : b + 1], kb, vb, p, 0,
                                                     cos[b : b + 1].contiguous(),
                                                     sin[b : b + 1].contiguous())
            assert torch.equal(h[b : b + 1], hb)
            if head:
                assert torch.equal(lg[b : b + 1], lb)
            assert torch.equal(k1[:, b], kb) and torch.equal(v1[:, b], vb)


# The Qwen3-ASR-0.6B matvecs of both step kernels: q|k|v, o, gate|up, down, the head.
QWEN_STEP_MATVECS = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 153600)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", QWEN_STEP_MATVECS)
def test_step_matvec_matches_plain_dot_and_rows_alone(k, n):
    """The steps' shared tensor-core matvec alone against the plain
    version's ``_dot`` (1e-4 of max|plain|) at every slot count the kernels
    see, one and two m16 tiles, each row bitwise the row alone."""
    _need_card()
    from asr_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device="cuda").manual_seed(k + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 4, 128, pack=True)
    s = leaf.scale.reshape(2, k // 256, n).contiguous()
    zs = (leaf.zero * leaf.scale).reshape(2, k // 256, n).contiguous()
    vals = fd._nibbles(leaf.q)
    x = torch.randn((32, k), generator=g, device="cuda")
    alone = [fd.nibble_matvec_cuda(x[r : r + 1].contiguous(), leaf.q, s, zs)[0] for r in range(32)]
    for b in (1, 2, 8, 16, 17, 32):
        before = fd.MATVEC_LAUNCHES
        got = fd.nibble_matvec_cuda(x[:b].contiguous(), leaf.q, s, zs)
        torch.cuda.synchronize()
        assert fd.MATVEC_LAUNCHES == before + 1
        want = torch.cat([fd._dot(x[i : i + 1], vals, s, zs) for i in range(b)])
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        assert all(torch.equal(got[r], alone[r]) for r in range(b))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", QWEN_STEP_MATVECS + [(256, 768), (512, 2048)])
def test_plan_shared_memory_is_the_kernels(k, n):
    """``matvec_smem``, which ``decode_plan`` chooses tiles by, gives the
    kernel's own figure (``qwen_matvec_smem``) for every column tile and
    split of K it may choose, at 1..32 slots; the library's limits are the
    plan's (``_load`` checks them, so loading must succeed)."""
    _need_card()
    from asr_tpu_torch.ops import fused_decode as fd

    lib = fd._load()
    nbj = k // 256
    for bn in fd.MV_WIDTHS:
        for parts in (d for d in range(1, fd.MAX_PARTS + 1) if nbj % d == 0):
            for rows in range(1, fd.MAX_ROWS + 1):
                assert fd.matvec_smem(bn, parts, k, rows) == lib.qwen_matvec_smem(bn, parts, k, rows), \
                    (bn, parts, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [2, 8, 17, 32])
def test_multi_decode_slots_equal_batch1_kernel_bitwise(bs, cache):
    """Full width, two layers: every live slot of the multi-slot kernel
    (rows 0-15 of the first m16 tile and, past 16 slots, of the second) is
    bitwise the batch-1 kernel on that slot alone at shift 0; every fifth
    slot is parked and its planes are left as they were."""
    _need_card()
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.ops import fused_decode_multi as fdm

    cfg = qwen3.Qwen3Config(num_layers=2)
    _, st = _qwen_stacked(cfg, 8)
    nl, t, kvw = cfg.num_layers, 456, cfg.num_kv_heads * 128
    pos_l = [-1 if b % 5 == 1 else (37 * b + 5) % (t - 6) for b in range(bs)]
    g = torch.Generator(device="cuda").manual_seed(bs)
    kc = torch.randn((nl, bs, t, kvw), generator=g, device="cuda").to(cache)
    vc = torch.randn((nl, bs, t, kvw), generator=g, device="cuda").to(cache)
    x = torch.randn((bs, cfg.hidden), generator=g, device="cuda") * 0.05
    ang = torch.rand((bs, 128), generator=g, device="cuda") * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    k1, v1 = kc.clone(), vc.clone()
    h, lg, _, _ = fdm.fused_decode_step_multi_cuda(st, cfg, x, k1, v1, pos, cos, sin)
    torch.cuda.synchronize()
    assert torch.isfinite(h).all() and torch.isfinite(lg).all()
    for b, p in enumerate(pos_l):
        if p < 0:
            assert torch.equal(k1[:, b], kc[:, b]) and torch.equal(v1[:, b], vc[:, b])
            continue
        kb, vb = kc[:, b].contiguous(), vc[:, b].contiguous()
        hb, lb, _, _ = fd.fused_decode_step_cuda(st, cfg, x[b : b + 1], kb, vb, p, 0,
                                                 cos[b : b + 1].contiguous(), sin[b : b + 1].contiguous())
        assert torch.equal(h[b : b + 1], hb) and torch.equal(lg[b : b + 1], lb), f"slot {b}"
        assert torch.equal(k1[:, b], kb) and torch.equal(v1[:, b], vb), f"slot {b}"


@pytest.mark.gpu
def test_multi_decode_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.ops import fused_decode_multi as fdm

    cfg = qwen3.Qwen3Config(vocab_size=300, hidden=256, num_layers=1, num_heads=2, num_kv_heads=1,
                            ffn_dim=512)
    _, st = _qwen_stacked(cfg, 7)
    kc = torch.zeros((1, 2, 16, 128), device="cuda")
    x = torch.zeros((2, 256), device="cuda")
    cs = torch.zeros((2, 128), device="cuda")
    pos = torch.tensor([3, -1], dtype=torch.int32, device="cuda")
    fdm.fused_decode_step_multi(st, cfg, x, kc, kc.clone(), pos, cs, cs)
    with pytest.raises(ValueError):  # positions on the host
        fdm.fused_decode_step_multi(st, cfg, x, kc, kc.clone(), pos.cpu(), cs, cs)
    with pytest.raises(TypeError):  # int64 positions
        fdm.fused_decode_step_multi(st, cfg, x, kc, kc.clone(), pos.long(), cs, cs)
    with pytest.raises(TypeError):  # caches of two dtypes
        fdm.fused_decode_step_multi(st, cfg, x, kc, kc.to(torch.bfloat16), pos, cs, cs)
    with pytest.raises(ValueError):  # one cos row for two slots
        fdm.fused_decode_step_multi(st, cfg, x, kc, kc.clone(), pos, cs[:1].contiguous(), cs)
    with pytest.raises(ValueError):  # batch 1 is the batch-1 kernel's
        fdm.fused_decode_step_multi(st, cfg, x[:1], kc[:, :1].contiguous(), kc[:, :1].contiguous(),
                                    pos[:1], cs[:1], cs[:1])
    with pytest.raises(ValueError):  # more slots than the kernel takes
        n = fdm.MAX_SLOTS + 1
        big = torch.zeros((1, n, 16, 128), device="cuda")
        fdm.fused_decode_step_multi(st, cfg, torch.zeros((n, 256), device="cuda"), big, big.clone(),
                                    torch.zeros(n, dtype=torch.int32, device="cuda"),
                                    torch.zeros((n, 128), device="cuda"),
                                    torch.zeros((n, 128), device="cuda"))


@pytest.mark.gpu
def test_qwen_continuous_serving_launches_multi_kernel_once_per_step():
    _need_card()
    import io
    import wave

    import numpy as np

    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.ops import fused_decode_multi as fdm
    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=3000, hidden=512, num_layers=3, num_heads=4,
                             num_kv_heads=2, ffn_dim=1024)
    cfg = qa.QwenAsrConfig(tower_dim=256, tower_layers=2, tower_heads=4, tower_ffn=512,
                           output_dim=512, llm=lcfg, eot_id=-1)
    tower = quantize_pytree(qa.init_tower_params(cfg, torch.Generator(device="cuda").manual_seed(0)),
                            bits=8, min_size=0)
    llm, _ = _qwen_stacked(lcfg, 1)
    prev = qm._CONFIG["mm"]
    qm.set_quant_config(mm="bf16")
    try:
        sess = QwenAsrSession(tower, llm, cfg, template=QwenPromptTemplate((1, 2), (3,), (4, 5)),
                              max_new_tokens=10, max_seconds=4.0)
        assert sess.stacked is not None
        srv = ContinuousSessionServer(sess, n_slots=2, kv_dtype="bf16")
        try:
            before_m, before_f = fdm.LAUNCHES, fd.LAUNCHES
            rng = np.random.default_rng(0)
            for n in (20000, 9000, 30000):
                buf = io.BytesIO()
                with wave.open(buf, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes((rng.standard_normal(n) * 900).astype(np.int16).tobytes())
                srv.transcribe_bytes(buf.getvalue())
            st = srv.stats()
        finally:
            srv.close()
    finally:
        qm._CONFIG["mm"] = prev
    assert st["step_kernel"] == "fused" and st["decoder"] == "llm" and st["requests_served"] == 3
    assert fdm.LAUNCHES - before_m == st["decode_steps"] > 0
    assert fd.LAUNCHES == before_f


# (source attribute of quant_matmul, packed parts or 0 for int8, K, N): a
# decode (M = 1) and a prefill (M = 432) call through each of two libraries.
LINKAGE_CASES = [("SOURCE", 0, 1280, 5120), ("SOURCE_INT4", 2, 1024, 6144),
                 ("SOURCE_INT2", 4, 1024, 6144)]


@pytest.mark.gpu
@pytest.mark.parametrize("attr,parts,k,n", LINKAGE_CASES)
def test_two_libraries_of_one_source_launch_side_by_side(attr, parts, k, n):
    """The same source built under two cache keys and both libraries loaded
    in this process: bf16 calls through each launch and agree bitwise (the
    kernels' launch helpers have internal linkage, so the second library
    sets its own kernels' shared-memory limit)."""
    _need_card()
    source = getattr(qm, attr)
    second = qm.load_library(source, salt="linkage-test")
    g = torch.Generator(device="cuda").manual_seed(k + n + parts)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5,
                           {0: 8, 2: 4, 4: 2}[parts], 128, pack=parts > 0)
    for m in (1, 432):
        x = torch.randn((m, k), generator=g, device="cuda")
        args = (x, leaf.q, leaf.scale, leaf.zero, 128, "bf16")
        if parts:
            first = qm._packed_launch(source.stem, parts, *args)
            other = qm._packed_launch(source.stem, parts, *args, lib=second)
        else:
            first = qm._int8_launch(*args)
            other = qm._int8_launch(*args, lib=second)
        torch.cuda.synchronize()
        assert torch.equal(first, other)


# ── FireRedASR-AED-L and Dolphin on the AED steps ───────────────────────
# Their decoders at full width (FireRed: 16 layers at d 1280, a head of 8192
# columns, bias-free o-projections; Dolphin: 6 layers at d 512, 27648
# columns) with 750 / 749 cross rows (an odd count), the tolerances of the
# Whisper tests above; and tiny sessions of both families, whose batch-1
# decode launches the fused step once a step and whose continuous serving
# launches the multi-slot step once a step.
FAMILIES = {"firered": (750, 512), "dolphin": (749, 301)}  # cross rows, and fewer valid


def _family_setup(name, tiny=False, seed=0):
    from asr_tpu_torch.layers.conformer import absolute_positions
    from asr_tpu_torch.models import dolphin, firered
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.quant.quantize import quantize_pytree

    mod = firered if name == "firered" else dolphin
    kw = {"enc_layers": 0} if not tiny else dict(
        vocab_size=300, d_model=256, enc_layers=1, enc_heads=4, dec_layers=2, dec_heads=4, dec_ffn=512,
        max_target_positions=32, **({} if name == "firered" else dict(
            enc_ffn=256, cgmlp_dim=512, sos_id=298, eos_id=299, language_token_start=200,
            language_token_end=250, region_token_start=250, region_token_end=290)))
    cfg = (firered.FireRedConfig if name == "firered" else dolphin.DolphinConfig)(**kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = mod.init_params(cfg, g)
    for p in params["decoder"]["blocks"]:  # random biases where the checkpoint has them
        for lin in (*p["attn"].values(), *p["cross"].values(), *p["mlp"].values()):
            if "b" in lin:
                lin["b"] = 0.1 * torch.randn(lin["b"].shape, generator=g, device="cuda")
    params = quantize_pytree(params, bits=8, block=128, quantize_embeddings=True,
                             **({"min_size": 0} if tiny else {}))
    geom = fs.AedGeom(cfg.d_model, cfg.dec_ffn, cfg.dec_heads)
    stacked = fs.stack_aed_step_params(params["decoder"], geom)
    assert stacked is not None
    table = absolute_positions(cfg.max_target_positions, cfg.d_model, torch.device("cuda"))

    def x_of(toks, pos):
        return (params["decoder"]["embed"][toks] * cfg.d_model ** 0.5 + table[pos]).float()

    return fs, mod, cfg, params, stacked, geom, x_of, g


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_fused_step_kernel_at_firered_and_dolphin_geometry(name, cache):
    _need_card()
    fs, mod, cfg, params, stacked, geom, x_of, g = _family_setup(name)
    nl, d, t, v = cfg.dec_layers, cfg.d_model, cfg.max_target_positions, cfg.vocab_size
    tc = FAMILIES[name][0]
    if name == "firered":  # no o bias: zeros in the stacked biases
        assert not stacked["ba"][:, 0, 3 * d : 4 * d].any() and not stacked["ba"][:, 0, 5 * d : 6 * d].any()
    ks, vs = (torch.randn((nl, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
    ck, cv = (torch.randn((nl, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
    for pos in (0, 3, t - 1):
        x = x_of(torch.tensor([7 + pos], device="cuda"), torch.tensor([pos], device="cuda"))
        for tc_valid in FAMILIES[name]:
            kk, vk, kp, vp = ks.clone(), vs.clone(), ks.clone(), vs.clone()
            got, _, _ = fs.fused_aed_step_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tc_valid)
            torch.cuda.synchronize()
            want, _, _ = fs.fused_aed_step_reference(stacked, geom, x, kp, vp, ck, cv, pos, tc_valid)
            assert (got[:, :v] - want[:, :v]).abs().max().item() <= 1e-2 * want[:, :v].abs().max().item()
            assert (got[:, v:] == 0).all()
            keep = torch.arange(t, device="cuda") != pos
            assert torch.equal(kk[:, keep], ks[:, keep]) and torch.equal(vk[:, keep], vs[:, keep])


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_multi_slots_bitwise_batch1_at_firered_and_dolphin_geometry(name, cache):
    _need_card()
    from asr_tpu_torch.ops import fused_aed_multi as fm

    fs, mod, cfg, params, stacked, geom, x_of, g = _family_setup(name, seed=1)
    nl, d, t, v = cfg.dec_layers, cfg.d_model, cfg.max_target_positions, cfg.vocab_size
    tc = FAMILIES[name][0]
    for bs in (2, 8):
        pos_l = [(3, 200, t - 1)[i % 3] for i in range(bs)]
        pos_l[bs // 2] = -1
        tc_l = [FAMILIES[name][i % 2] for i in range(bs)]
        x = x_of(torch.arange(bs, device="cuda") + 11, torch.tensor([max(p, 0) for p in pos_l], device="cuda"))
        ks, vs = (torch.randn((nl, bs, t, d), generator=g, device="cuda").to(cache) for _ in range(2))
        ck, cv = (torch.randn((nl, bs, tc, d), generator=g, device="cuda").to(cache) for _ in range(2))
        kk, vk = ks.clone(), vs.clone()
        got, _, _ = fm.fused_aed_step_multi_cuda(stacked, geom, x, kk, vk, ck, cv,
                                                 torch.tensor(pos_l, dtype=torch.int32, device="cuda"),
                                                 torch.tensor(tc_l, dtype=torch.int32, device="cuda"))
        for b, p in enumerate(pos_l):
            if p < 0:
                assert torch.equal(kk[:, b], ks[:, b]) and torch.equal(vk[:, b], vs[:, b])
                continue
            kb, vb = ks[:, b].contiguous(), vs[:, b].contiguous()
            one, _, _ = fs.fused_aed_step_cuda(stacked, geom, x[b : b + 1], kb, vb, ck[:, b].contiguous(),
                                               cv[:, b].contiguous(), p, tc_l[b])
            assert torch.equal(got[b : b + 1], one)
            assert torch.equal(kk[:, b], kb) and torch.equal(vk[:, b], vb)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_sessions_launch_the_fused_and_multi_steps_once_per_step(name):
    """A tiny q8 FireRed / Dolphin session in the bf16 mode stacks its
    decoder; one window launches the fused step once a decode step and the
    int8 kernel for the encoder, cross-KV and prefill only; two windows take
    the per-weight route; continuous serving launches the multi-slot step
    once a decode step and the batch-1 step never."""
    _need_card()
    import numpy as np

    from asr_tpu_torch.decode.ar import DecodeConfig
    from asr_tpu_torch.ops import fused_aed_multi as fm
    from asr_tpu_torch.parallel.aed_batcher import ContinuousAedBatcher
    from asr_tpu_torch.runtime import transducer_session as ts

    fs, mod, cfg, params, stacked, geom, x_of, g = _family_setup(name, tiny=True, seed=2)
    mm = qm._CONFIG["mm"]
    qm.set_quant_config(mm="bf16")
    try:
        cls = ts.FireRedSession if name == "firered" else ts.DolphinSession
        sess = cls(params, cfg, decode_cfg=DecodeConfig(max_new_tokens=10, eot_id=-1), window_seconds=0.5)
        assert sess.stacked is not None
        audio = np.random.default_rng(0).standard_normal(7000).astype(np.float32) * 2000
        before_f, before_q = fs.LAUNCHES, qm.LAUNCHES
        res = sess.transcribe(audio)
        assert fs.LAUNCHES - before_f == len(res.token_ids) - 1 == 10
        # one encoder layer's linears and the stem's (FireRed 11 + 1, Dolphin
        # 12 + 1), the cross-KV (Dolphin's twice: the probes' and the
        # prompt's), the prefill's passes (Dolphin: two probes and the prompt)
        enc, cross, passes = (12, 4, 1) if name == "firered" else (13, 8, 3)
        assert qm.LAUNCHES - before_q == enc + cross + passes * (8 * 2 + 1)
        before_f = fs.LAUNCHES
        sess.transcribe(np.concatenate([audio, audio]))  # 2 windows: the per-weight route
        assert fs.LAUNCHES == before_f
        bat = ContinuousAedBatcher(params, sess.aed_engine_spec(), sess.decode_cfg, n_slots=2,
                                   stacked=sess.stacked)
        before_m, steps = fm.LAUNCHES, 0
        for a in (audio, audio[:5000]):
            pre = sess.continuous_prefill(a)
            bat.try_submit(pre["state"], pre["p_len"], pre["logits0"], pre["tc_valid"])
        while bat.n_active:
            bat.step()
            steps += 1
        assert fm.LAUNCHES - before_m == steps > 0 and fs.LAUNCHES == before_f
    finally:
        qm._CONFIG["mm"] = mm


# Tiny Paraformer, Parakeet and Nemotron geometries whose linears all
# quantize (min_size 1024): int8 launches of one encoder pass.
OFFLINE = {
    "paraformer": dict(vocab_size=300, hidden=128, num_heads=4, head_dim=32, ffn_dim=256, num_encoders0=1,
                       num_encoders=2, num_decoders=2, num_decoder_ffn=1, fsmn_kernel=5),
    "parakeet": dict(vocab_size=300, blank_id=299, d_model=128, num_layers=2, num_heads=4, ffn_dim=256,
                     sub_channels=32, dec_hidden=64, lstm_layers=2),
    "nemotron": dict(vocab_size=299, d_model=128, num_layers=2, num_heads=4, ffn_dim=256, sub_channels=32,
                     pred_hidden=64, joint_hidden=64, prompt_hidden=64, lstm_layers=2, num_prompts=8),
}
OFFLINE_ENCODER_INT8 = {"paraformer": 4 * 3, "parakeet": 1 + 11 * 2 + 1, "nemotron": 1 + 11 * 2 + 2}


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(OFFLINE))
def test_offline_family_q8_forward_matches_plain_version(name, mm):
    """Each family's q8 encoder and its joint / decoder logits on the card
    (every linear through the int8 kernel) against the same code on the
    dequantized weights (plain matmuls) within 1e-3 of max|plain| (f32
    mode; 1e-2 in bf16 mode, the rounding of x); a forward launches the
    kernel once a linear: the encoder's, then 2 a greedy step (transducers)
    or the decoder's 5 a block, 2 an FFN block and the head (Paraformer)."""
    _need_card()
    from asr_tpu_torch.decode import tdt
    from asr_tpu_torch.models import nemotron as nm, paraformer as pf, parakeet as pk
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree

    mod = {"paraformer": pf, "parakeet": pk, "nemotron": nm}[name]
    cfg = {"paraformer": pf.ParaformerConfig, "parakeet": pk.ParakeetConfig,
           "nemotron": nm.NemotronConfig}[name](**OFFLINE[name])
    g = torch.Generator(device="cuda").manual_seed(13)
    params = quantize_pytree(mod.init_params(cfg, g), bits=8, block=128, min_size=1024)
    plain = dequantize_pytree(params)
    tol = 1e-3 if mm == "f32" else 1e-2
    prev = qm._CONFIG["mm"]
    qm.set_quant_config(mm=mm)

    def close(got, want):
        assert (got - want).abs().max().item() <= tol * want.abs().max().item()

    try:
        b, n = 2, 48000
        scale = 2000.0 if name == "paraformer" else 0.1
        audio = torch.randn((b, n), generator=g, device="cuda") * scale
        valid = torch.tensor([n, 30000], device="cuda")
        with torch.inference_mode():
            if name == "paraformer":
                _, feats, vl = pf.frontend_features(params, cfg, audio, valid)
                before = qm.LAUNCHES
                enc = pf.encode(params, cfg, feats, vl)
                assert qm.LAUNCHES - before == OFFLINE_ENCODER_INT8[name]
                close(enc, pf.encode(plain, cfg, feats, vl))
                emb, cnt = pf.cif_fire(pf.predict_alphas(params, cfg, enc, vl), enc, vl, 64)
                before = qm.LAUNCHES
                logits = pf.decode_tokens(params, cfg, emb, cnt, enc, vl)
                assert qm.LAUNCHES - before == 5 * 2 + 2 + 1
                close(logits, pf.decode_tokens(plain, cfg, emb, cnt, enc, vl))
                before = qm.LAUNCHES
                ids, counts = pf.forward(params, cfg, audio, valid, max_tokens=64)
                assert qm.LAUNCHES - before == OFFLINE_ENCODER_INT8[name] + 13 and int(counts.min()) > 0
                return
            pid = torch.tensor([1, 6], device="cuda")
            extra = (pid,) if name == "nemotron" else ()
            before = qm.LAUNCHES
            enc, ev = mod.encode(params, cfg, audio, valid, *extra)
            assert qm.LAUNCHES - before == OFFLINE_ENCODER_INT8[name]
            close(enc, mod.encode(plain, cfg, audio, valid, *extra)[0])
            hid = cfg.dec_hidden if name == "parakeet" else cfg.pred_hidden
            h = torch.randn((cfg.lstm_layers, b, hid), generator=g, device="cuda")
            tok = torch.tensor([5, cfg.blank_id], device="cuda")
            got = mod.joint_step(params, tok, h, h, enc[:, 3])
            want = mod.joint_step(plain, tok, h, h, enc[:, 3])
            close(got[0], want[0])
            before, syncs = qm.LAUNCHES, tdt.SYNCS
            ids, counts = mod.forward(params, cfg, audio, valid, *extra, max_tokens=32)
            steps = (qm.LAUNCHES - before - OFFLINE_ENCODER_INT8[name]) // 2
            assert qm.LAUNCHES - before == OFFLINE_ENCODER_INT8[name] + 2 * steps and steps > 0
            assert -(-steps // tdt.SYNC_EVERY) == tdt.SYNCS - syncs  # one host read a chunk of steps
            assert int(counts.min()) > 0
    finally:
        qm._CONFIG["mm"] = prev


# ── streaming (the int8 kernel at the streaming paths' row counts) ────────
# One stream is 1-16 rows a call (Zipformer 8, 4, 2, 1 by stack; Paraformer
# 13 encoder positions; Nemotron 14 query and 84 key/value rows; Dolphin
# 16), eight slots eight times as many; a weight of each family's widths.
STREAM_SHAPES = [(560, 1536, 560), (512, 8404, 128), (1024, 4096, 128), (640, 8193, 128),
                 (1024, 512, 128), (768, 2048, 128), (192, 384, 192)]
STREAM_M = (1, 2, 4, 8, 13, 14, 16, 84)


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("k,n,block", STREAM_SHAPES)
def test_int8_at_the_streaming_row_counts_rows_bitwise_alone(k, n, block, mm):
    """Against the plain version within 1e-4 of max|plain| at every
    streaming row count and its eight-slot multiple; each row of a call
    bitwise the row alone."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k * 3 + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 8, 128)
    assert leaf.block == block
    x = torch.randn((8 * max(STREAM_M), k), generator=g, device="cuda")
    alone = {}
    for m in sorted({*STREAM_M, *(8 * m for m in STREAM_M)}):
        args = (x[:m].contiguous(), leaf.q, leaf.scale, leaf.zero, block, mm)
        got = qm.quant_matmul_int8(*args)
        want = qm.quant_dense_reference(*args)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        for r in sorted({0, m // 2, m - 1}):
            if r not in alone:
                alone[r] = qm.quant_matmul_int8(x[r : r + 1].contiguous(), *args[1:])[0]
            assert torch.equal(alone[r], got[r]), (m, r)


def _stream_family(name, device, g):
    """A tiny q8 streaming family on ``device``: (session, a runner of 3
    slots, chunk samples, PCM scale)."""
    from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
    from asr_tpu_torch.models import dolphin as dp, nemotron as nm, paraformer as pf, zipformer as zf
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime import streaming_session as ss
    from asr_tpu_torch.streaming import dolphin_stream as ds, multistream as ms, nemotron_stream as ns
    from asr_tpu_torch.streaming import paraformer_online as po

    if name == "paraformer":
        cfg = po.ParaformerStreamConfig(base=pf.ParaformerConfig(
            vocab_size=300, hidden=256, num_heads=4, head_dim=64, ffn_dim=512, num_encoders0=1, num_encoders=2,
            num_decoders=2, fsmn_kernel=11))
        p = quantize_pytree(pf.init_params(cfg.base, g, "cpu"), min_size=1024)
        p = _to(p, device)
        return ss.ParaformerStreamingSession(p, cfg), ms.paraformer_multistream(p, cfg, 3), cfg.chunk_samples, 2000.0
    if name == "nemotron":
        cfg = ns.NemotronStreamConfig(base=nm.NemotronConfig(
            vocab_size=300, d_model=256, num_layers=2, num_heads=4, ffn_dim=512, sub_channels=32, pred_hidden=128,
            joint_hidden=128, prompt_hidden=128, lstm_layers=1, num_prompts=8, mel=NemoMelConfig(n_mels=128)))
        p = _to(quantize_pytree(nm.init_params(cfg.base, g, "cpu"), min_size=1024), device)
        return ss.NemotronStreamingSession(p, cfg), ms.nemotron_multistream(p, cfg, 3), cfg.window_samples, 0.1
    if name == "dolphin":
        cfg = ds.DolphinStreamConfig(base=dp.DolphinConfig(
            vocab_size=300, d_model=256, enc_layers=2, enc_heads=4, enc_ffn=512, cgmlp_dim=512, dec_layers=2,
            dec_heads=4, dec_ffn=512, sos_id=298, eos_id=299, max_target_positions=32), max_frames=64)
        p = _to(quantize_pytree(dp.init_params(cfg.base, g, "cpu"), min_size=1024), device)
        return ss.DolphinStreamingSession(p, cfg), ms.dolphin_multistream(p, cfg, 3), cfg.window_samples, 2000.0
    cfg = zf.ZipformerConfig(vocab_size=300, downsampling_factor=(1, 2, 4), num_encoder_layers=(1, 1, 1),
                             encoder_dim=(128, 192, 256), query_head_dim=(32,) * 3, pos_head_dim=(4,) * 3,
                             value_head_dim=(12,) * 3, num_heads=(4,) * 3, feedforward_dim=(256, 384, 512),
                             cnn_module_kernel=(15,) * 3, decoder_dim=128, joiner_dim=128, decoder_conv_groups=32)
    p = _to(quantize_pytree(zf.init_params(cfg, g, "cpu"), min_size=1024), device)
    return ss.XasrStreamingSession(p, cfg), ms.zipformer_multistream(p, cfg, 3), cfg.window_samples, 2000.0


def _to(tree, device):
    from asr_tpu_torch.runtime import artifact as art

    return art.params_from_flat(art.flatten_pytree(tree), device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["paraformer", "nemotron", "dolphin", "zipformer"])
def test_streaming_session_on_the_card_matches_the_cpu(name):
    """A tiny q8 streaming session (mm=f32) on the card against the same
    session on the CPU's plain path: the ids equal, each chunk's runner
    outputs equal, and the runner's float state within 1e-3 of max|CPU|;
    the card's runner launches the int8 kernel on every tick."""
    _need_card()
    import numpy as np

    from asr_tpu_torch.streaming import multistream as ms

    prev = qm._CONFIG["mm"]
    qm.set_quant_config(mm="f32")
    try:
        card = _stream_family(name, "cuda", torch.Generator().manual_seed(21))
        host = _stream_family(name, "cpu", torch.Generator().manual_seed(21))
        rng = np.random.default_rng(22)
        audio = (rng.standard_normal(4 * card[2]) * card[3]).astype(np.float32)
        assert card[0].transcribe(audio).token_ids == host[0].transcribe(audio).token_ids
        chunks = (rng.standard_normal((3, 3, card[2])) * card[3]).astype(np.float32)
        for t in range(3):
            active = np.array([True, t != 1, True])
            before = qm.LAUNCHES
            a, b = card[1].step(chunks[t], active), host[1].step(chunks[t], active)
            assert qm.LAUNCHES > before
            for key in a:
                np.testing.assert_array_equal(a[key][active], b[key][active])
        leaves = []
        ms.tree_map(lambda x, y: leaves.append((x.cpu(), y)), card[1].states, host[1].states)
        for x, y in leaves:
            if y.is_floating_point():
                assert (x - y).abs().max().item() <= 1e-3 * max(y.abs().max().item(), 1e-6)
            else:
                assert torch.equal(x, y)
    finally:
        qm._CONFIG["mm"] = prev


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16, 17])
@pytest.mark.parametrize("k,n", [(512, 25055), (560, 1536), (2048, 512)])
def test_dynamic_quant_dense_on_the_card_is_the_cpu_product(m, k, n):
    """The dynamic int8 product on the card (``torch._int_mm`` with rows
    padded to 17, K and N to multiples of 8) against the same function on the
    CPU (an exact f64 product): bitwise, at a decode row, at the padding
    edge and at the SenseVoice CTC head's N = 25055."""
    _need_card()
    from asr_tpu_torch.quant.quantize import QuantizedLinear, dynamic_quant_dense

    g = torch.Generator().manual_seed(m * 7 + n)
    w = torch.randn((k, n), generator=g) * 0.05
    x = torch.randn((m, k), generator=g) * 2
    x[0, :7] = 0.0
    leaf = quantize_linear(w, objective="dynamic")
    card = QuantizedLinear(leaf.q.cuda(), leaf.scale.cuda(), leaf.zero.cuda(), 8, k, dynamic=True)
    got = dynamic_quant_dense(x.cuda(), card).cpu()
    assert torch.equal(got, dynamic_quant_dense(x, leaf))
    got3 = dynamic_quant_dense(x.cuda().reshape(1, m, k), card).cpu()
    assert torch.equal(got3.reshape(m, n), got)
    assert card.int_mm_operand() is card.int_mm_operand()  # laid out once, kept with the leaf


@pytest.mark.gpu
@pytest.mark.parametrize("objective,bits", [("rtn", 8), ("kquant", 8), ("kquant", 4), ("hqq", 4),
                                            ("hqq", 8), ("dynamic", 8)])
def test_fits_on_the_card_are_the_cpu_fits(objective, bits):
    """Each fit on the card against the same fit on the CPU, at a
    SenseVoiceSmall FFN shape with refine 2: the two devices sum a block
    in different orders, so each block must be the same fit up to that
    rounding or one a rounding boundary moved on, at most
    ``chip_smoke.FIT_MOVED_MAX`` of them (``chip_smoke.fit_gap``, gate (b)
    of phase 43)."""
    _need_card()
    import numpy as np

    import chip_smoke

    g = torch.Generator().manual_seed(bits)
    w = torch.randn((2048, 512), generator=g) * 0.05
    cpu = quantize_linear(w, bits, 128, 2, objective=objective)
    card = quantize_linear(w.cuda(), bits, 128, 2, objective=objective)
    arrays = lambda leaf: {f: getattr(leaf, f).cpu().numpy() for f in ("q", "scale", "zero")} | {
        "bits": leaf.bits, "block": leaf.block, "packed": leaf.packed}
    gap = chip_smoke.fit_gap(np, w.numpy(), arrays(card), arrays(cpu), objective == "kquant")
    assert gap["moved"] + gap["picks"] <= chip_smoke.FIT_MOVED_MAX * gap["blocks"]

# ── training (parallel/train.py, rnnt_loss.py, checkpoint.py) ────────────


def _train_case(name):
    """(loss function, CPU params, config, numpy batch) at a tiny geometry."""
    import numpy as np

    from asr_tpu_torch.parallel import train

    rng = np.random.default_rng(17)
    g = torch.Generator().manual_seed(17)
    if name == "sensevoice":
        from asr_tpu_torch.models import sensevoice as sv

        cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=64,
                                  num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
        batch = ((rng.standard_normal((4, 4800)) * 2000).astype(np.float32),
                 np.array([4800, 4000, 4800, 3000], np.int32), np.array([0, 1, 2, 0], np.int32),
                 rng.integers(1, 64, (4, 6)).astype(np.int32), np.array([6, 4, 6, 3], np.int32))
        return train.sensevoice_ctc_loss, sv.init_params(cfg, g, "cpu"), cfg, batch
    if name == "whisper":
        from asr_tpu_torch.models import whisper as wh

        cfg = wh.WhisperConfig(vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1, num_heads=4,
                               n_mels=16, max_source_positions=20, max_target_positions=16, sot_id=1, eot_id=2,
                               first_language_id=10, num_languages=4, transcribe_id=20, translate_id=21,
                               no_timestamps_id=22, no_speech_id=30)
        batch = ((rng.standard_normal((4, 40, 16)) * 0.3).astype(np.float32),
                 rng.integers(3, 96, (4, 10)).astype(np.int32), np.array([10, 8, 10, 6], np.int32))
        return train.whisper_ce_loss, wh.init_params(cfg, g, "cpu"), cfg, batch
    from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
    from asr_tpu_torch.models import parakeet as pk

    cfg = pk.ParakeetConfig(vocab_size=24, blank_id=23, d_model=32, num_layers=1, num_heads=4, ffn_dim=48,
                            sub_channels=8, dec_hidden=16, lstm_layers=1, mel=NemoMelConfig(n_mels=40))
    batch = ((rng.standard_normal((2, 8000)) * 0.1).astype(np.float32), np.array([8000, 6000], np.int32),
             rng.integers(0, 23, (2, 5)).astype(np.int32), np.array([5, 3], np.int32))
    return train.transducer_loss, pk.init_params(cfg, g, "cpu"), cfg, batch


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sensevoice", "whisper", "parakeet"])
def test_train_step_on_the_card_matches_the_cpu(name):
    """A training step's loss and every leaf's gradient on the card against
    the CPU from the same weights (``chip_smoke.card_vs_cpu``, phases
    49-51's gate: loss within 1e-4, each leaf within 1e-3 of its own
    max|g| + 1e-6 of the tree's), then three steps of the entry point on
    the card with the loss falling and none of the seven kernels launched."""
    _need_card()
    import numpy as np

    import chip_smoke
    from asr_tpu_torch.ops import fused_aed_multi as fm
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.ops import fused_decode_multi as fdm
    from asr_tpu_torch.parallel import train

    loss_fn, params, cfg, batch = _train_case(name)
    same = chip_smoke.card_vs_cpu(torch, np, name, loss_fn, params, cfg, batch, "cuda")
    assert same["grad_worst"] <= 1.0
    step = {"sensevoice": train.train_step, "whisper": train.whisper_train_step,
            "parakeet": train.transducer_train_step}[name]
    params = chip_smoke.to_dev(torch, params, "cuda")
    opt = train.make_optimizer(lr=3e-3)
    state = opt.init(params)
    counters = (qm, fs, fm, fd, fdm)
    chip_smoke.zero_counts(*counters)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, cfg, opt, *(torch.as_tensor(b).cuda() for b in batch))
        losses.append(loss.item())
    assert not any(chip_smoke.kernel_counts(*counters).values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.gpu
def test_rnnt_and_tdt_losses_on_the_card_match_the_cpu():
    """NLL and the gradient w.r.t. the log-probs (and durations) within 1e-5
    of max|.| on a padded random lattice (phase 51's gate)."""
    _need_card()
    from asr_tpu_torch.parallel.rnnt_loss import rnnt_loss, tdt_loss

    g = torch.Generator().manual_seed(51)
    tok = torch.log_softmax(torch.randn((3, 19, 7, 30), generator=g), dim=-1)
    dur = torch.log_softmax(torch.randn((3, 19, 7, 5), generator=g), dim=-1)
    labels = torch.randint(1, 30, (3, 6), generator=g)
    tv, uv = torch.tensor([19, 11, 4]), torch.tensor([6, 3, 0])
    for name in ("rnnt", "tdt"):
        got = {}
        for dev in ("cpu", "cuda"):
            x, y = tok.to(dev).clone().requires_grad_(True), dur.to(dev).clone().requires_grad_(True)
            args = (labels.to(dev), tv.to(dev), uv.to(dev))
            nll = rnnt_loss(x, *args) if name == "rnnt" else tdt_loss(x, y, *args, durations=(0, 1, 2, 3, 4))
            nll.sum().backward()
            got[dev] = [nll.detach().cpu(), x.grad.cpu()] + ([y.grad.cpu()] if name == "tdt" else [])
        for want, have in zip(got["cpu"], got["cuda"]):
            assert (have - want).abs().max() <= 1e-5 * want.abs().max(), name


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card_is_bitwise(tmp_path):
    """Parameters and AdamW state after a step on the card, saved and
    restored onto the card: every leaf bitwise, on the template's device."""
    _need_card()
    import chip_smoke
    from asr_tpu_torch.parallel import checkpoint as ckpt
    from asr_tpu_torch.parallel import train

    _, params, cfg, batch = _train_case("sensevoice")
    params = chip_smoke.to_dev(torch, params, "cuda")
    opt = train.make_optimizer()
    params, state, _ = train.train_step(params, opt.init(params), cfg, opt, *batch)
    ckpt.save_train_state(tmp_path, params, state, 1)
    p2, o2, step = ckpt.restore_train_state(tmp_path, {"params": params, "opt_state": state})
    assert step == 1
    want = ckpt.named_leaves({"params": params, "opt_state": state})
    got = dict(ckpt.named_leaves({"params": p2, "opt_state": o2}))
    for name, t in want:
        assert got[name].device == t.device and torch.equal(got[name], t), name


# ── multi-device serving: shards, replicas, the per-device kernel attribute ──
# (full K, full N, block, spec, model-axis size T) of sharded SenseVoiceSmall
# q8 leaves (qkv by heads; out / ffn.w2 by rows at block boundaries; the
# 25055-column CTC head unevenly), Whisper q8 (q by heads) and Qwen3-ASR
# q4 (q|k|v by q and kv heads, gate|up); the shard pieces go through the
# kernels.
SHARDED_LEAVES = [
    ("qkv", 512, 1536, 128, 8, 2), ("out", 512, 512, 128, 8, 4), ("ffn/w2", 2048, 512, 128, 8, 2),
    ("ctc", 512, 25055, 128, 8, 2), ("attn/q", 1280, 1280, 128, 8, 2),
    ("attn/qkv", 1024, 4096, 128, 4, 2), ("mlp/gateup", 1024, 6144, 128, 4, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("name,k,n,block,bits,tp", SHARDED_LEAVES)
def test_sharded_int8_and_int4_pieces_match_plain(name, k, n, block, bits, tp, mm):
    """Every rank's piece through its kernel against the plain version,
    within 1e-4 * max|plain|."""
    _need_card()
    from asr_tpu_torch.parallel import mesh as pm

    g = torch.Generator(device="cuda").manual_seed(k + n + tp)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, bits, block,
                           pack=bits == 4)
    if name == "attn/qkv":  # the fused Qwen3 leaf's o sibling gives q's width
        tree = {"attn": {"qkv": {"w": leaf}, "o": {"w": quantize_linear(
            torch.randn((2048, 1024), generator=g, device="cuda"), 4, 128, pack=True)}}}
        specs = {"attn": {"qkv": {"w": pm.P(None, "model")}, "o": {"w": pm.P()}}}
        path = ("attn", "qkv", "w")
    else:
        spec = pm.P("model", None) if name in ("out", "ffn/w2") else pm.P(None, "model")
        tree, specs, path = {"x": {"w": leaf}}, {"x": {"w": spec}}, ("x", "w")
        if name == "ctc":
            tree, specs, path = {"ctc": {"w": leaf}}, {"ctc": {"w": spec}}, ("ctc", "w")
    lay = pm.shard_params(tree, pm.make_mesh(tp, tp, devices=["cuda"] * tp), specs)
    ref = qm.quant_dense_reference if bits == 8 else qm.quant_dense_p4_reference
    launch = qm.quant_matmul_int8 if bits == 8 else qm.quant_matmul_int4
    for r in range(tp):
        piece = lay.local(0, r)
        for key in path:
            piece = piece[key]
        kp = piece.scale.shape[0] * piece.block
        x = torch.randn((137, kp), generator=g, device="cuda")
        got = launch(x, piece.q, piece.scale, piece.zero, piece.block, mm)
        want = ref(x, piece.q, piece.scale, piece.zero, piece.block, mm)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), (name, r)


@pytest.mark.gpu
def test_data_parallel_server_on_a_repeated_card():
    """``data_parallel=2`` on [cuda:0] * 2: two replicas of a q4 Qwen session,
    each step one multi-slot launch, every request bitwise it alone through a
    replica's batcher, both replicas serving; a ``tensor_parallel=2`` server
    on the same card gives the unsharded rowwise batcher's ids."""
    _need_card()
    import numpy as np

    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.ops import fused_decode_multi as fdm
    from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher
    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=3000, hidden=512, num_layers=3, num_heads=4,
                             num_kv_heads=2, ffn_dim=1024)
    cfg = qa.QwenAsrConfig(tower_dim=256, tower_layers=2, tower_heads=4, tower_ffn=512,
                           output_dim=512, llm=lcfg, eot_id=-1)
    tower = quantize_pytree(qa.init_tower_params(cfg, torch.Generator(device="cuda").manual_seed(0)),
                            bits=8, min_size=0)
    llm, _ = _qwen_stacked(lcfg, 1)
    prev = qm._CONFIG["mm"]
    qm.set_quant_config(mm="bf16")
    rng = np.random.default_rng(0)
    clips = [(rng.standard_normal(n) * 0.03).astype(np.float32) for n in (20000, 9000, 30000, 12000)]
    try:
        sess = QwenAsrSession(tower, llm, cfg, template=QwenPromptTemplate((1, 2), (3,), (4, 5)),
                              max_new_tokens=10, max_seconds=4.0)
        assert sess.stacked is not None
        cards = [torch.device("cuda", 0)] * 2
        srv = ContinuousSessionServer(sess, n_slots=2, kv_dtype="bf16", data_parallel=2, devices=cards)
        try:
            before = fdm.LAUNCHES
            reqs = [srv.submit(c) for c in clips]
            for r in reqs:
                assert r.event.wait(300) and r.error is None
            st = srv.stats()
            served = [r.ids for r in reqs]
        finally:
            srv.close()
        assert st["replicas"] == 2 and st["step_kernel"] == "fused"
        assert fdm.LAUNCHES - before == st["decode_steps"] > 0
        for rep in srv.replicas:
            for c, ids in zip(clips, served):
                emb, valid = sess.prompt_embeds(c)
                slot = rep.batcher.try_submit(emb, valid)
                while rep.batcher.is_active(slot):
                    rep.batcher.step()
                assert rep.batcher.take_result(slot) == ids
        srv = ContinuousSessionServer(sess, n_slots=2, kv_dtype="bf16", tensor_parallel=2, devices=cards)
        try:
            reqs = [srv.submit(c) for c in clips]
            for r in reqs:
                assert r.event.wait(300) and r.error is None
            assert srv.stats()["step_kernel"] == "rowwise"
        finally:
            srv.close()
        rows = ContinuousLlmBatcher(sess.llm_params, lcfg, sess.decode_cfg, n_slots=2,
                                    t_max=srv.batcher.t_max, kv_dtype=torch.bfloat16)
        for c, r in zip(clips, reqs):
            emb, valid = sess.prompt_embeds(c)
            slot = rows.try_submit(emb, valid)
            while rows.is_active(slot):
                rows.step()
            assert rows.take_result(slot) == r.ids
    finally:
        qm._CONFIG["mm"] = prev


@pytest.mark.gpu
def test_shared_memory_limit_is_set_on_each_card():
    """The int8 and int4 kernels above 48 KiB of dynamic shared memory on
    cuda:0, then on cuda:1: the limit is set per device, so the second card
    launches too."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (the limit is kept per device)")
    for bits in (8, 4):
        leaf = quantize_linear(torch.randn((1024, 4096), device="cuda") * 1024 ** -0.5, bits, 128,
                               pack=bits == 4)
        for dev in ("cuda:0", "cuda:1"):
            x = torch.randn((432, 1024), device=dev)
            q, s, z = (t.to(dev) for t in (leaf.q, leaf.scale, leaf.zero))
            launch = qm.quant_matmul_int8 if bits == 8 else qm.quant_matmul_int4
            ref = qm.quant_dense_reference if bits == 8 else qm.quant_dense_p4_reference
            got, want = launch(x, q, s, z, 128, "bf16"), ref(x, q, s, z, 128, "bf16")
            torch.cuda.synchronize(dev)
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), (bits, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sensevoice", "whisper", "parakeet"])
def test_mesh_train_step_on_a_repeated_card_matches_the_cpu(name):
    """A tiny training step on ``[cuda:0] * 4`` (dp 2 x tp 2 by the family's
    spec tree; Parakeet dp 2, replicated) finishes inside the training
    grid's collective timeout, and its loss and every gathered gradient
    equal the same step on four CPU positions within phases 49-51's gate
    (loss 1e-4, each leaf 1e-3 of its own max|g| + 1e-6 of the tree's);
    after three steps every position's copy of a leaf is bitwise alike."""
    _need_card()
    import time

    import numpy as np

    import chip_smoke
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel import train

    loss_fn, params, cfg, batch = _train_case(name)
    dp, tp = (2, 1) if name == "parakeet" else (2, 2)
    specs = {"sensevoice": pm.sensevoice_param_specs, "whisper": pm.whisper_param_specs}.get(name)
    got = {}
    for dev in ("cpu", "cuda"):
        mesh = pm.make_mesh(dp * tp, model_parallel=tp, devices=[torch.device(dev, 0) if dev == "cuda"
                                                                  else torch.device(dev)] * (dp * tp))
        lay = pm.shard_params(params, mesh, specs(params) if specs and tp > 1 else None, own=True)
        t0 = time.perf_counter()
        loss, grads = train.value_and_grad(loss_fn, lay, cfg, *batch)
        got[dev] = (loss.item(), pm.gather_params(grads, "cpu"), time.perf_counter() - t0, lay)
    assert got["cuda"][2] < train.TRAIN_COLLECTIVE_TIMEOUT_S
    assert abs(got["cuda"][0] - got["cpu"][0]) <= 1e-4 * abs(got["cpu"][0])
    assert chip_smoke.grads_gap(torch, got["cpu"][1], got["cuda"][1])["worst"] <= 1.0
    lay = got["cuda"][3]
    step = {"sensevoice": train.train_step, "whisper": train.whisper_train_step,
            "parakeet": train.transducer_train_step}[name]
    opt = train.make_optimizer(lr=3e-3)
    state = opt.init(lay)
    losses = []
    for _ in range(3):
        lay, state, loss = step(lay, state, cfg, opt, *batch)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for tree in (lay, state["mu"], state["nu"]):
        chip_smoke.positions_agree(torch, pm, tree)
