"""The batch-1 fused AED decode loop (``ops/fused_aed_step.FusedAedDecoder``)
on the CPU: its greedy body on device-side state (what a card captures as
one CUDA graph a token) against ``decode/ar.ar_decode`` over the host-``pos``
step, on tiny random q8 Whisper, FireRed and Dolphin decoders (the plain
step on CPU tensors): tokens and counts equal with EOT as the first token,
EOT in mid-loop, the budget run out, a suppress list, Whisper's prompt of 4
and FireRed's / Dolphin's start positions 1 and 3; and the routing:
penalty and sampling reach ``ar_decode``, greedy decode does not. Imports
no JAX."""

import sys
import threading

import pytest
import torch

from asr_tpu_torch.decode import ar
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.models import dolphin as tdp
from asr_tpu_torch.models import firered as tfr
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import fused_aed_step as tfs
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import quantize_pytree

D, HEADS, FFN, NL, VOCAB, T_SELF, T_CROSS = 128, 2, 256, 2, 300, 24, 20
BUDGET = 12


@pytest.fixture(autouse=True)
def _threads():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="bf16")  # the mode in which the fused route applies
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def _q8(params):
    return quantize_pytree(params, bits=8, block=128, min_size=0, refine_iters=0,
                           quantize_embeddings=True)


@pytest.fixture(scope="module")
def decoders():
    """family -> (decoder, its prompt length, a config for the route tests)."""
    g = torch.Generator().manual_seed(0)
    wcfg = twh.WhisperConfig(vocab_size=VOCAB, d_model=D, encoder_layers=0, decoder_layers=NL,
                             num_heads=HEADS, ffn_dim=FFN, n_mels=16,
                             max_source_positions=T_CROSS, max_target_positions=T_SELF,
                             sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8,
                             num_languages=4, no_timestamps_id=7, transcribe_id=6, translate_id=5)
    wp = _q8(twh.init_params(wcfg, g))
    out = {"whisper": (twh.fused_decoder(wp, wcfg, tfs.stack_whisper_step_params(wp, wcfg)), 4),
           "whisper_model": (wp, wcfg)}
    fcfg = tfr.FireRedConfig(vocab_size=VOCAB, n_mels=16, d_model=D, enc_layers=1, enc_heads=HEADS,
                             conv_kernel=3, dec_layers=NL, dec_heads=HEADS, dec_ffn=FFN,
                             max_target_positions=T_SELF)
    dcfg = tdp.DolphinConfig(vocab_size=VOCAB, d_model=D, enc_layers=1, enc_heads=HEADS, enc_ffn=FFN,
                             cgmlp_dim=FFN, dec_layers=NL, dec_heads=HEADS, dec_ffn=FFN,
                             max_target_positions=T_SELF)
    for name, mod, cfg, start in (("firered", tfr, fcfg, 1), ("dolphin", tdp, dcfg, 3)):
        p = {"decoder": _q8(mod.init_params(cfg, g))["decoder"]}
        stacked = tfs.stack_aed_step_params(p["decoder"], tfs.AedGeom(D, FFN, HEADS))
        assert stacked is not None, name
        out[name] = (tfs.scaled_embed_decoder(p, cfg, stacked), start)
    return out


def _layers(seed, prompt_len, dtype=torch.float32):
    """Prefilled per-layer caches: random prompt rows, zeros after them."""
    g = torch.Generator().manual_seed(seed)
    layers = []
    for _ in range(NL):
        sk, sv = (torch.zeros((1, T_SELF, D)) for _ in range(2))
        sk[0, :prompt_len] = torch.randn((prompt_len, D), generator=g)
        sv[0, :prompt_len] = torch.randn((prompt_len, D), generator=g)
        ck, cv = (torch.randn((1, T_CROSS, D), generator=g) for _ in range(2))
        layers.append({"self_k": sk.to(dtype), "self_v": sv.to(dtype),
                       "cross_k": ck.to(dtype), "cross_v": cv.to(dtype)})
    return layers


def _buffer(prompt_len, budget=BUDGET):
    buf = torch.zeros((1, prompt_len + budget + 1), dtype=torch.int64)
    buf[0, :prompt_len] = torch.arange(5, 5 + prompt_len)
    return buf


def _both(decoder, layers, p_len, first, cfg, tc_valid=None):
    """(tokens, counts) of the greedy body and of ``ar_decode``."""
    buf = _buffer(p_len, cfg.max_new_tokens)
    first = torch.tensor([first])
    got = decoder.decode(layers, p_len, first, buf, cfg, tc_valid=tc_valid)
    want = decoder.host_loop(layers, p_len, first, buf, cfg, tc_valid=tc_valid)
    return got, want


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


@pytest.mark.parametrize("family", ["whisper", "firered", "dolphin"])
def test_greedy_body_equals_ar_decode(decoders, family):
    decoder, p_len = decoders[family]
    # to the budget (no EOT in the vocabulary's reach), on the first caches
    # whose run emits a new id after its second step (random decoders
    # repeat one id for long stretches)
    run_out = DecodeConfig(max_new_tokens=BUDGET, eot_id=-1)
    for seed in range(1, 9):
        layers = _layers(seed, p_len)
        got, want = _both(decoder, layers, p_len, 17, run_out)
        _assert_equal(got, want)
        assert int(got[1][0]) == BUDGET + 1
        seq = got[0][0, p_len : p_len + BUDGET + 1].tolist()
        k = next((i for i in range(2, len(seq)) if seq[i] not in seq[:i]), None)
        if k is not None:
            break
    # EOT in mid-loop: that id, at its first appearance
    mid = DecodeConfig(max_new_tokens=BUDGET, eot_id=seq[k])
    got, want = _both(decoder, layers, p_len, 17, mid)
    _assert_equal(got, want)
    assert int(got[1][0]) == k + 1 and got[0][0, p_len + k + 1 :].eq(0).all()
    # EOT as the first token: no step
    got, want = _both(decoder, layers, p_len, seq[k], mid)
    _assert_equal(got, want)
    assert int(got[1][0]) == 1
    # a suppress list (the run's tokens) moves the path; fewer valid cross rows
    sup = DecodeConfig(max_new_tokens=BUDGET, eot_id=-1, suppress_ids=tuple(sorted(set(seq[1:6]))))
    got, want = _both(decoder, layers, p_len, 17, sup, tc_valid=T_CROSS // 2)
    _assert_equal(got, want)
    assert not set(got[0][0, p_len + 1 :].tolist()) & set(sup.suppress_ids)


def test_static_buffers_are_reused_and_reset(decoders):
    """Two requests of one shape share one set of buffers: the second reads
    nothing the first left; bf16 caches take a buffer set of their own."""
    decoder, p_len = decoders["whisper"]
    cfg = DecodeConfig(max_new_tokens=BUDGET, eot_id=-1)
    first = _both(decoder, _layers(2, p_len), p_len, 9, cfg)
    n = len(decoder._statics)
    second = _both(decoder, _layers(3, p_len), p_len, 11, cfg)
    _assert_equal(*first)
    _assert_equal(*second)
    assert len(decoder._statics) == n
    again = decoder.decode(_layers(2, p_len), p_len, torch.tensor([9]), _buffer(p_len), cfg)
    _assert_equal(again, first[0])
    _assert_equal(*_both(decoder, _layers(2, p_len, torch.bfloat16), p_len, 9, cfg))
    assert len(decoder._statics) == n + 1
    assert tfs.GRAPH_CAPTURES == 0 and tfs.GRAPH_REPLAYS == 0  # the CPU captures nothing


def test_concurrent_calls_share_the_buffers_in_turn(decoders):
    """Six threads decode on one decoder at once (a short switch interval):
    each gets what it gets alone."""
    decoder, p_len = decoders["dolphin"]
    cfg = DecodeConfig(max_new_tokens=BUDGET, eot_id=-1)
    jobs = [(_layers(10 + i, p_len), 20 + i) for i in range(6)]
    alone = [decoder.decode(lay, p_len, torch.tensor([f]), _buffer(p_len), cfg) for lay, f in jobs]
    got = [None] * len(jobs)

    def work(i):
        lay, f = jobs[i]
        got[i] = decoder.decode(lay, p_len, torch.tensor([f]), _buffer(p_len), cfg)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for g, a in zip(got, alone):
        _assert_equal(g, a)


@pytest.fixture
def ar_calls(monkeypatch):
    """Calls of ``ar_decode`` through its module (the host-``pos`` loop)."""
    calls = []
    real = ar.ar_decode

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ar, "ar_decode", spy)
    return calls


@pytest.mark.parametrize("strategy", ["penalty", "sampling", "greedy", "greedy_past_the_cache"])
def test_routing(decoders, ar_calls, strategy):
    """Penalty and sampling (and a budget past the self cache) run
    ``ar_decode``; greedy decode on the fused route does not.
    ``fused_ar_decode`` takes the session's decoder object."""
    decoder, p_len = decoders["firered"]
    long = strategy == "greedy_past_the_cache"
    budget = T_SELF if long else BUDGET
    cfg = DecodeConfig(max_new_tokens=budget, eot_id=7 if long else -1,
                       strategy=strategy.split("_")[0], penalty=1.3, top_k=5)
    state = {"layers": _layers(4, p_len)}
    enc = torch.zeros((1, T_CROSS, D))
    first = torch.tensor([7 if long else 17])  # past the cache: EOT first, no step
    out = tfs.fused_ar_decode(None, None, state, enc, torch.tensor([T_CROSS]), first,
                              _buffer(p_len, budget), cfg, torch.Generator().manual_seed(5),
                              stacked=decoder, start_pos=p_len)
    assert out is not None and int(out[1][0]) == (1 if long else budget + 1)
    assert len(ar_calls) == (0 if strategy == "greedy" else 1)


def test_whisper_window_takes_the_decoder(decoders, ar_calls):
    """``transcribe_window`` with the session's decoder and with bare
    stacked weights (a decoder made for the call): the same tokens, no
    ``ar_decode`` on the greedy route."""
    wp, wcfg = decoders["whisper_model"]
    decoder, _ = decoders["whisper"]
    mel = torch.randn((1, 2 * T_CROSS, 16), generator=torch.Generator().manual_seed(6))
    prompt = torch.tensor([[wcfg.sot_id, wcfg.first_language_id, wcfg.transcribe_id,
                            wcfg.no_timestamps_id]])
    cfg = DecodeConfig(max_new_tokens=BUDGET, eot_id=-1)
    got = twh.transcribe_window(wp, wcfg, mel, prompt, cfg, stacked=decoder)
    bare = twh.transcribe_window(wp, wcfg, mel, prompt, cfg, stacked=decoder.stacked)
    assert not ar_calls
    assert torch.equal(got["tokens"], bare["tokens"]) and torch.equal(got["counts"], bare["counts"])
    assert int(got["counts"][0]) == BUDGET + 1
