"""PyTorch port: ``parallel/serve.DataParallelRunner`` and the sessions,
HTTP micro-batcher and command line built on it, against the JAX package's
runner on the 8 virtual CPU devices of ``tests/conftest.py`` and against the
unsharded port.

Data-parallel rows are bitwise the unsharded rows (a row's arithmetic does
not depend on the batch); tensor-parallel runs sum the row-parallel products
in another order, so their ids are held equal to the unsharded run's and,
where logits are compared, within 1e-4 * max|logit| (f32 on the CPU).
"""

import threading
import time
import wave

import jax
import numpy as np
import pytest
import torch

from asr_tpu.layers import qwen3 as jq3
from asr_tpu.models import parakeet as jpk
from asr_tpu.models import qwen_asr as jqa
from asr_tpu.models import sensevoice as jsv
from asr_tpu.models import whisper as jwh
from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.parallel import mesh as jmesh
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime.qwen_session import QwenAsrSession as JQwenSession
from asr_tpu.runtime.qwen_session import QwenPromptTemplate as JTemplate
from asr_tpu.runtime.session import SenseVoiceSession as JSenseVoiceSession
from asr_tpu.runtime.whisper_session import WhisperSession as JWhisperSession
from asr_tpu.runtime.whisper_session import WhisperSessionConfig as JWhisperSessionConfig
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.models import parakeet as tpk
from asr_tpu_torch.models import qwen_asr as tqa
from asr_tpu_torch.models import sensevoice as tsv
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import mesh as pm
from asr_tpu_torch.parallel.serve import DataParallelRunner
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate
from asr_tpu_torch.runtime.session import SenseVoiceSession
from asr_tpu_torch.runtime.transducer_session import ParakeetSession
from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig
from tests.test_torch_mesh import WH, close, cpu_mesh, to_port

CPU = torch.device("cpu")
SV = dict(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1,
          num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)


@pytest.fixture(autouse=True)
def _torch_mode():
    """Both packages' process-wide matmul modes (the JAX command line sets
    its own) and the port's thread count, restored afterwards."""
    prev, mm, jprev = torch.get_num_threads(), tqm._CONFIG["mm"], dict(jqm._CONFIG)
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = mm
    jqm._CONFIG.update(jprev)
    torch.set_num_threads(prev)


def _sv(seed):
    jp = jsv.init_params(jsv.SenseVoiceConfig(**SV), jax.random.PRNGKey(seed))
    return jp, to_port(jp)


def test_eight_positions_data_parallel_forward_is_bitwise():
    """8 data positions on the CPU: tokens, counts and logits bitwise the
    single-device forward (JAX: ``test_dp_forward_matches_single_device``)."""
    cfg = tsv.SenseVoiceConfig(**SV)
    _, params = _sv(0)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((8, 4800)) * 2000).astype(np.float32)
    valid = np.array([4800, 4000, 4800, 3000, 4800, 2500, 4800, 4100], np.int32)
    lang = np.zeros((8,), np.int64)
    with torch.inference_mode():
        args = (torch.from_numpy(audio), torch.from_numpy(valid), torch.from_numpy(lang))
        ref_t, ref_n = tsv.forward(params, cfg, *args)
        ref_l, _ = tsv.encode_logits(params, cfg, *args)
    runner = DataParallelRunner(cpu_mesh(8))
    sh = runner.shard_params(params)
    toks, counts = runner(lambda p, a, v, li: tsv.forward(p, cfg, a, v, li), sh, audio, valid, lang)
    logits, _ = runner(lambda p, a, v, li: tsv.encode_logits(p, cfg, a, v, li), sh, audio, valid, lang)
    assert torch.equal(counts, ref_n) and torch.equal(toks, ref_t) and torch.equal(logits, ref_l)


def test_runner_pads_to_the_data_axis_and_trims():
    """5 rows on 8 data positions: the batch pads with its last row, every
    position runs, the result is trimmed to 5 rows and equals the JAX
    runner's and the unsharded forward (JAX:
    ``test_data_parallel_runner_pads_and_matches``)."""
    from asr_tpu.parallel.serve import DataParallelRunner as JRunner

    jcfg, cfg = jsv.SenseVoiceConfig(**SV), tsv.SenseVoiceConfig(**SV)
    jp, params = _sv(5)
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((5, 4800)) * 2000).astype(np.float32)
    valid = np.full((5,), 4800, np.int32)
    lang = np.zeros((5,), np.int32)
    jr = JRunner(jmesh.make_mesh(8, model_parallel=1))
    jt, jn = jr(lambda p, a, v, li: jsv.forward(p, jcfg, a, v, li), jr.shard_params(jp), audio, valid, lang)
    runner = DataParallelRunner(cpu_mesh(8))
    seen = []

    def fn(p, a, v, li):
        seen.append(a.shape[0])
        return tsv.forward(p, cfg, a, v, li)

    toks, counts = runner(fn, runner.shard_params(params), audio, valid, lang)
    assert sorted(seen) == [1] * 8 and toks.shape[0] == 5
    with torch.inference_mode():
        rt, rn = tsv.forward(params, cfg, torch.from_numpy(audio), torch.from_numpy(valid),
                             torch.from_numpy(lang).to(torch.int64))
    assert torch.equal(toks, rt) and torch.equal(counts, rn)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    for i in range(5):
        n = int(counts[i])
        np.testing.assert_array_equal(toks[i, :n].numpy(), np.asarray(jt)[i, :n])


def _whisper_sessions(tp, dp, specs):
    jp = jwh.init_params(jwh.WhisperConfig(**WH), jax.random.PRNGKey(4))
    scfg = dict(max_new_tokens=6, no_speech_threshold=None)
    mesh = cpu_mesh(dp * tp, tp)
    port = WhisperSession(to_port(jp), twh.WhisperConfig(**WH), session_cfg=WhisperSessionConfig(**scfg),
                          window_seconds=0.8)
    sharded = WhisperSession(to_port(jp), twh.WhisperConfig(**WH), session_cfg=WhisperSessionConfig(**scfg),
                             window_seconds=0.8, mesh=mesh,
                             param_specs=pm.whisper_param_specs if specs else None)
    jsharded = JWhisperSession(jp, jwh.WhisperConfig(**WH), session_cfg=JWhisperSessionConfig(**scfg),
                               window_seconds=0.8, mesh=jmesh.make_mesh(dp * tp, model_parallel=tp),
                               param_specs=jmesh.whisper_param_specs if specs else None)
    return port, sharded, jsharded


@pytest.mark.parametrize("dp,tp", [(8, 1), (1, 2), (2, 2), (2, 4)])
def test_whisper_session_sharded_matches_single_and_jax(dp, tp):
    """~2.3 windows (3 real, bucketed to 4, padded to the data axis): the
    sharded session's ids equal the single-device port's and JAX's sharded
    session's (JAX: ``test_whisper_session_identical_one_vs_eight_devices``;
    tp: the encoder and the rowwise decode at local heads)."""
    port, sharded, jsharded = _whisper_sessions(tp, dp, tp > 1)
    assert sharded.stacked is None and sharded.runner is not None
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(2.3 * 0.8 * 16000)) * 0.05).astype(np.float32)
    want = port.transcribe(audio).token_ids
    assert sharded.transcribe(audio).token_ids == want
    assert jsharded.transcribe(audio).token_ids == want


def test_windowed_session_mesh_matches_single():
    """A Parakeet session with ``mesh=`` (8 data positions) transcribes as the
    single-device session and JAX's sharded one (JAX:
    ``test_windowed_session_mesh_matches_single``)."""
    from asr_tpu.frontend.nemo_mel import NemoMelConfig as JNemoMelConfig
    from asr_tpu.runtime.transducer_session import ParakeetSession as JParakeetSession

    kw = dict(vocab_size=40, blank_id=39, d_model=64, num_layers=1, num_heads=4, ffn_dim=96,
              conv_kernel=9, sub_channels=16, dec_hidden=32)
    jcfg = jpk.ParakeetConfig(**kw, mel=JNemoMelConfig(n_mels=80))
    jp = jpk.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = tpk.ParakeetConfig(**kw, mel=NemoMelConfig(n_mels=80))
    audio = (np.random.default_rng(1).standard_normal(16000) * 0.05).astype(np.float32)
    want = ParakeetSession(to_port(jp), cfg, window_seconds=0.4).transcribe(audio).token_ids
    sharded = ParakeetSession(to_port(jp), cfg, window_seconds=0.4, mesh=cpu_mesh(8))
    assert sharded.transcribe(audio).token_ids == want
    jwant = JParakeetSession(jp, jcfg, window_seconds=0.4,
                             mesh=jmesh.make_mesh(8, model_parallel=1)).transcribe(audio)
    assert jwant.token_ids == want


def _write_wavs(tmp_path, n, samples, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        pcm = (rng.standard_normal(samples) * 2000).astype(np.int16)
        p = tmp_path / f"a{i}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        paths.append(str(p))
    return paths


def test_sensevoice_transcribe_batch_uses_runner(tmp_path):
    """``transcribe_batch`` routes through the runner (3 files on 8 data
    positions) and matches the single-device results (JAX:
    ``test_sensevoice_transcribe_batch_uses_runner``)."""
    _, params = _sv(0)
    cfg = tsv.SenseVoiceConfig(**SV)
    paths = _write_wavs(tmp_path, 3, 4000, 3)
    single = SenseVoiceSession(params, cfg, window_seconds=0.3)
    sharded = SenseVoiceSession(params, cfg, window_seconds=0.3, mesh=cpu_mesh(8))
    calls = []
    orig = sharded.runner.__call__
    sharded.runner = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    r1, r8 = single.transcribe_batch(paths), sharded.transcribe_batch(paths)
    assert calls, "transcribe_batch bypassed the DataParallelRunner"
    assert [r.token_ids for r in r8] == [r.token_ids for r in r1]


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 2), (1, 4)])
def test_sensevoice_session_tp_matches_single_and_jax(dp, tp):
    """``param_specs=sensevoice_param_specs`` on a (dp, tp) mesh: ids equal
    the unsharded session's and JAX's sharded session's (JAX:
    ``test_sensevoice_session_tp_matches_single``)."""
    jp, params = _sv(2)
    cfg = tsv.SenseVoiceConfig(**SV)
    audio = (np.random.default_rng(5).standard_normal(9000) * 2000).astype(np.float32)
    want = SenseVoiceSession(params, cfg, window_seconds=0.3).transcribe(audio).token_ids
    got = SenseVoiceSession(params, cfg, window_seconds=0.3, mesh=cpu_mesh(dp * tp, tp),
                            param_specs=pm.sensevoice_param_specs).transcribe(audio).token_ids
    jgot = JSenseVoiceSession(jp, jsv.SenseVoiceConfig(**SV), window_seconds=0.3,
                              mesh=jmesh.make_mesh(dp * tp, model_parallel=tp),
                              param_specs=jmesh.sensevoice_param_specs).transcribe(audio).token_ids
    assert got == want == jgot
    with pytest.raises(ValueError, match="must divide num_heads"):
        SenseVoiceSession(params, cfg, mesh=cpu_mesh(8, 8), param_specs=pm.sensevoice_param_specs)


class _Tok:
    def decode(self, ids):
        return " ".join(map(str, ids))


QLLM = dict(vocab_size=120, hidden=48, num_layers=1, num_heads=4, num_kv_heads=2, head_dim=16,
            ffn_dim=64, rope_theta=1e4)
QTOWER = dict(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
              downsample_hidden=8, chunks_per_window=2, output_dim=48, eot_id=-1)


def test_qwen_session_tp_serving_matches_dp():
    """``QwenAsrSession`` batched transcribe gives the same ids unsharded, at
    dp 8, at dp 4 x tp 2 (the LLM sharded by qwen3_param_specs, the tower
    replicated) and as JAX's dp 4 x tp 2 session (JAX:
    ``test_qwen_session_tp_serving_matches_dp``)."""
    jcfg = jqa.QwenAsrConfig(**QTOWER, llm=jq3.Qwen3Config(**QLLM))
    jt = jqa.init_tower_params(jcfg, jax.random.PRNGKey(0))
    jl = jq3.init_params(jcfg.llm, jax.random.PRNGKey(1))
    cfg = tqa.QwenAsrConfig(**QTOWER, llm=tq3.Qwen3Config(**QLLM))
    rng = np.random.default_rng(7)
    audios = [(rng.standard_normal(6000) * 0.05).astype(np.float32) for _ in range(3)]

    def ids_of(mesh=None):
        sess = QwenAsrSession(to_port(jt), to_port(jl), cfg, tokenizer=_Tok(), max_new_tokens=4,
                              max_seconds=0.5, mesh=mesh,
                              template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,)))
        return [r.token_ids for r in sess.transcribe_batch(audios)]

    want = ids_of()
    assert ids_of(cpu_mesh(8)) == want
    assert ids_of(cpu_mesh(8, 2)) == want
    jsess = JQwenSession(jt, jl, jcfg, tokenizer=_Tok(), max_new_tokens=4, max_seconds=0.5,
                         template=JTemplate(head_ids=(1, 2), tail_ids=(4,)),
                         mesh=jmesh.make_mesh(8, model_parallel=2))
    assert [r.token_ids for r in jsess.transcribe_batch(audios)] == want


def test_http_micro_batcher_runs_through_the_runner():
    """``serve --data-parallel`` without ``--continuous``: the micro-batcher
    splits each batch over the session's runner; every request's ids equal
    the unsharded session's."""
    import io
    import json
    import urllib.request

    from asr_tpu_torch.parallel.http_server import start_background

    _, params = _sv(3)
    cfg = tsv.SenseVoiceConfig(**SV)
    single = SenseVoiceSession(params, cfg, window_seconds=0.3)
    sharded = SenseVoiceSession(params, cfg, window_seconds=0.3, mesh=cpu_mesh(4, 2),
                                param_specs=pm.sensevoice_param_specs)
    calls = []
    orig = sharded.runner.__call__
    sharded.runner = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    httpd, srv, _thread = start_background(sharded, port=0, max_batch=4, max_wait_ms=20.0)
    port = httpd.server_address[1]
    rng = np.random.default_rng(8)
    pcms = [(rng.standard_normal(4000) * 2000).astype(np.int16) for _ in range(3)]
    outs = [None] * 3

    def call(i):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcms[i].tobytes())
        req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            outs[i] = json.loads(resp.read())

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    assert calls
    for i in range(3):
        assert outs[i]["token_ids"] == single.transcribe(pcms[i].astype(np.float32)).token_ids, i


@pytest.mark.parametrize("family", ["sensevoice", "fun_asr_nano_llm"])
def test_cli_data_and_tensor_parallel_match_jax(tmp_path, capsys, family):
    """``transcribe --data-parallel 2 --tensor-parallel 2`` prints what the
    JAX command line prints with the same flags, and what the unsharded
    port prints."""
    from tests.test_torch_cli import _both, _fun_asr_nano, _sensevoice, _text_lines, _wav

    folder = (_sensevoice(tmp_path / "m") if family == "sensevoice"
              else _fun_asr_nano(tmp_path / "m", "llm"))
    wavs = [_wav(tmp_path / f"a{i}.wav", 9000 - 2000 * i, i) for i in range(2)]
    flags = ["--data-parallel", "2", "--tensor-parallel", "2"]
    got, want = _both(capsys, ["transcribe", "--model-dir", str(folder), *flags, *wavs])
    plain, _ = _both(capsys, ["transcribe", "--model-dir", str(folder), *wavs])
    assert _text_lines(got) == _text_lines(want) == _text_lines(plain)


def test_cli_refusals_match_jax(tmp_path):
    """--tensor-parallel on a family without specs, and a mesh given to a
    session without a runner, exit with the JAX command line's messages."""
    from asr_tpu_torch import cli
    from tests.test_torch_cli import _offline, _streaming, _wav

    wav = _wav(tmp_path / "a.wav", 8000, 0)
    pk = _offline(tmp_path / "pk", "parakeet")
    with pytest.raises(SystemExit, match="no sharding specs for family 'parakeet'"):
        cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(pk), "--tensor-parallel", "2",
                  wav])
    stream = _streaming(tmp_path / "ps", "paraformer_streaming")
    with pytest.raises(SystemExit, match="is not wired for"):
        cli.main(["--platform", "cpu", "transcribe", "--model-dir", str(stream), "--data-parallel",
                  "2", wav])


def test_rank_generators_are_copies():
    """Sampling in rank threads: each rank gets its own generator with the
    caller's state, so ranks draw the same numbers without sharing one."""
    g = torch.Generator().manual_seed(11)
    mesh = cpu_mesh(2, 2)
    out = pm.run_grid(mesh, lambda d, m: (pm.rank_generator(g), torch.rand(4, generator=pm.rank_generator(g))))[0]
    assert out[0][0] is not g and out[0][0] is not out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][1], torch.rand(4, generator=torch.Generator().manual_seed(11)))
    assert pm.rank_generator(None) is None
    t0 = time.perf_counter()
    assert pm.run_grid(cpu_mesh(1), lambda d, m: torch.is_inference_mode_enabled())[0][0]
    assert time.perf_counter() - t0 < 5
