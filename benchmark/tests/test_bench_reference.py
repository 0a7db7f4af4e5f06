"""The plain reference against the port at tiny widths on the CPU, its
quantizer against the port's, and the judge's two readings."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import frontend, judge, quant
from benchmark.reference import sensevoice as ref_sv
from benchmark.reference import whisper as ref_wh
from benchmark.tests.tiny import tiny_cell
from benchmark.models import sensevoice, whisper


@pytest.fixture
def f32_products():
    from asr_tpu_torch.ops import quant_matmul as qm

    old = qm._CONFIG["mm"]
    qm.set_quant_config(mm="f32")
    yield
    qm._CONFIG["mm"] = old


@pytest.mark.parametrize("k,bits", [(512, 8), (560, 8), (256, 4)])
def test_quantizer_matches_the_ports(k, bits):
    from asr_tpu_torch.quant.quantize import dequantize_weight, quantize_linear

    w = torch.randn(k, 96, generator=torch.Generator().manual_seed(k))
    ours = quant.fake_quant(w, bits, 128, refine=2)
    theirs = dequantize_weight(quantize_linear(w, bits, 128, refine_iters=2))
    assert torch.equal(ours, theirs)


def test_fbank_and_mel_match_the_ports():
    from asr_tpu_torch.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
    from asr_tpu_torch.frontend.whisper_mel import WhisperMelConfig, log_mel_spectrogram

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32))
    cfg = KaldiFbankConfig()
    ours = frontend.kaldi_fbank(x * 3000)
    theirs = log_mel_fbank(x * 3000, cfg, cfg.num_frames(16000))
    assert torch.allclose(ours, theirs, atol=2e-3, rtol=1e-4)
    ours = frontend.whisper_log_mel(x * 0.1)
    theirs = log_mel_spectrogram(x * 0.1, WhisperMelConfig())
    assert torch.allclose(ours, theirs, atol=2e-4)


def test_sensevoice_reference_matches_the_port(f32_products):
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.quant.quantize import quantize_pytree

    _, (_, cfg, _) = tiny_cell("sensevoice_small_q8.longform")
    params = sensevoice.make_weights(cfg, 3, "cpu")
    widths = {k: cfg[k] for k in ("vocab_size", "hidden", "num_heads", "head_dim", "ffn_dim",
                                  "num_encoders0", "num_encoders", "num_tp_encoders")}
    q = quantize_pytree(params, bits=8, block=128, refine_iters=2)
    audio = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 128000)).astype(np.float32)) * 3000
    valid = torch.tensor([128000, 70000])
    theirs, vs = sv.encode_logits(q, sv.SenseVoiceConfig(**widths), audio, valid,
                                  torch.zeros(2, dtype=torch.int64))
    rcfg = {k: cfg[k] for k in ("lfr_m", "lfr_n", "n_mels", "sample_rate", "num_heads", "head_dim")}
    ours, vs2 = ref_sv.ctc_logits(ref_sv.quantize_linears(params, 8, 128, 2), rcfg, audio, valid)
    assert torch.equal(vs, vs2)
    for i in range(2):
        n = int(vs[i])
        assert torch.allclose(ours[i, :n], theirs[i, :n], atol=2e-3 * float(theirs.abs().max()))


def test_whisper_reference_matches_the_port(f32_products):
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.quant.quantize import quantize_pytree

    _, (_, cfg, _) = tiny_cell("whisper_large_v3_turbo_q8.single_b1")
    params = whisper.make_weights(cfg, 4, "cpu")
    keys = ("vocab_size", "d_model", "encoder_layers", "decoder_layers", "num_heads", "ffn_dim")
    wcfg = wh.WhisperConfig(**{k: cfg[k] for k in keys})
    q = quantize_pytree(params, bits=8, block=128, refine_iters=2, quantize_embeddings=True)
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 480000)).astype(np.float32)) * 0.1
    mel = wh.mel_for_audio(wcfg, audio)
    enc = wh.encode(q, wcfg, mel)
    state = wh.make_state(q, wcfg, enc)
    toks = torch.tensor([[50258, 50260, 50360, 50364, 11, 12, 13]])
    theirs, _ = wh._decoder_pass(q, wcfg, state, toks, 0)
    rp = ref_wh.quantize(params, 8, 128, 2)
    renc = ref_wh.encode(rp, {"num_heads": cfg["num_heads"]}, frontend.whisper_log_mel(audio))
    ours = ref_wh.decoder_logits(rp, {"num_heads": cfg["num_heads"]}, renc, toks)
    assert torch.allclose(ours, theirs, atol=2e-3 * float(theirs.abs().max()))


def test_ar_gap():
    logits = torch.tensor([[0.0, 1.0, 0.5], [2.0, 0.0, 1.9], [0.0, 0.0, 3.0]])
    assert judge.ar_widest_gap(logits, 1, [2, 2]) == pytest.approx(0.1)
    assert judge.ar_widest_gap(logits, 0, [1, 0, 2]) == 0.0


def ctc_frames(rows):
    """One-hot-ish logits: each row's chosen id 1.0, the runner-up 0.9."""
    out = torch.zeros(len(rows), 5)
    for t, (best, second) in enumerate(rows):
        out[t, best] = 1.0
        out[t, second] = 0.9
    return out


def test_ctc_gap_follows_the_collapse():
    w = ctc_frames([(1, 0), (0, 1), (1, 0), (2, 1)])
    assert judge.ctc_widest_gap([w], [1, 1, 2], blank=0) == 0.0
    # one 1 only: frame 1 repeats the 1 (its runner-up) or frame 2 is blank
    assert judge.ctc_widest_gap([w], [1, 2], blank=0) == pytest.approx(0.1)
    # an id no frame favours: its logit is 0, a gap of 1 where it is emitted
    assert judge.ctc_widest_gap([w], [3], blank=0) == pytest.approx(1.0)
    # more ids than frames can give
    assert judge.ctc_widest_gap([w], [1, 2, 1, 2, 1], blank=0) == float("inf")


def test_ctc_windows_restart_the_collapse():
    a = ctc_frames([(1, 0), (1, 0)])
    b = ctc_frames([(1, 0), (0, 1)])
    # the same id at the end of one window and the start of the next is two ids
    assert judge.ctc_widest_gap([a, b], [1, 1], blank=0) == 0.0
    # one 1 in all: the next window's first frame must not give 1 again
    assert judge.ctc_widest_gap([a, b], [1], blank=0) == pytest.approx(0.1)
