"""The port stands alone: no module of ``asr_tpu_torch`` and neither
``chip_smoke.py`` nor ``chip_ab_step.py`` imports JAX or anything of the JAX
package ``asr_tpu``; the host modules the port keeps its own copies of (metadata, audio ingest, the
FLAC decoder, mel banks, window-text joining, RoPE tables, Qwen output
parsing, the tokenizers and the demo-audio registry) agree with the
originals on the same inputs; the stream server is the original with one
named divergence (``sync_latency_max_s``); the streaming sessions, runners
and server run without JAX; the loaders and the command line run on the
card unless the caller asks for the CPU, and the command line imports
neither JAX nor the JAX package.

Both packages' audio and FLAC paths prefer their native C++ layers (the
port keeps its own copy, ``asr_tpu_torch/native``); the comparisons of the
pure-Python paths here turn the native layer off in both packages
(``native.available`` -> False). ``tests/test_torch_readers.py`` compares
the native paths.
"""

import ast
import dataclasses
import inspect
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from asr_tpu import native
from asr_tpu.frontend import mel_banks as jmb
from asr_tpu.parallel import http_server as jhttp
from asr_tpu.runtime import audio as jaudio
from asr_tpu.runtime import flac as jflac
from asr_tpu.runtime import metadata as jmeta
from asr_tpu_torch import native as tnative
from asr_tpu_torch.frontend import mel_banks as tmb
from asr_tpu_torch.parallel import http_server as thttp
from asr_tpu_torch.runtime import audio as taudio
from asr_tpu_torch.runtime import flac as tflac
from asr_tpu_torch.runtime import metadata as tmeta

REPO = Path(__file__).resolve().parent.parent


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_module_imports_jax_or_the_jax_package():
    files = [REPO / "chip_smoke.py", REPO / "chip_ab_step.py",
             *sorted((REPO / "asr_tpu_torch").rglob("*.py"))]
    assert len(files) > 30
    for f in files:
        bad = _imported_roots(f) & {"asr_tpu", "jax", "jaxlib"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


_STANDALONE = """
import importlib, io, pkgutil, sys, wave
import numpy as np, torch
import asr_tpu_torch
for mod in pkgutil.walk_packages(asr_tpu_torch.__path__, "asr_tpu_torch."):
    importlib.import_module(mod.name)
from asr_tpu_torch.models import sensevoice as sv, whisper as wh
from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig
cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                          num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
params = quantize_pytree(sv.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), min_size=1024)
sv.forward(params, cfg, torch.zeros(1, 8000), torch.tensor([8000]), torch.tensor([0]))
wcfg = wh.WhisperConfig(vocab_size=64, d_model=256, encoder_layers=1, decoder_layers=1, num_heads=4,
                        ffn_dim=256, n_mels=16, max_source_positions=24, max_target_positions=16,
                        sot_id=1, eot_id=0, no_speech_id=2, first_language_id=8, num_languages=4,
                        no_timestamps_id=7, transcribe_id=6, translate_id=5)
wp = quantize_pytree(wh.init_params(wcfg, torch.Generator().manual_seed(0), "cpu"), min_size=0,
                     quantize_embeddings=True)
sess = WhisperSession(wp, wcfg, session_cfg=WhisperSessionConfig(max_new_tokens=4,
                      no_speech_threshold=None), window_seconds=0.48)
sess.transcribe(np.zeros(4000, np.float32))
srv = ContinuousSessionServer(sess, n_slots=2)
buf = io.BytesIO()
with wave.open(buf, "wb") as w:
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
    w.writeframes((np.random.default_rng(0).standard_normal(5000) * 900).astype(np.int16).tobytes())
out = srv.transcribe_bytes(buf.getvalue())
srv.close()
from asr_tpu_torch.layers import qwen3
from asr_tpu_torch.models import qwen_asr as qa
from asr_tpu_torch.ops import quant_matmul as qm
from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate
qm.set_quant_config(mm="bf16")
lcfg = qwen3.Qwen3Config(vocab_size=300, hidden=256, num_layers=1, num_heads=2, num_kv_heads=1,
                         ffn_dim=512)
qcfg = qa.QwenAsrConfig(n_mels=16, tower_dim=64, tower_layers=1, tower_heads=4, tower_ffn=128,
                        downsample_hidden=8, chunks_per_window=2, output_dim=256, llm=lcfg, eot_id=-1)
g = torch.Generator().manual_seed(0)
qtower = quantize_pytree(qa.init_tower_params(qcfg, g, "cpu"), min_size=0)
qllm = quantize_pytree(qwen3.init_params(lcfg, g, "cpu"), bits=4, pack=True, min_size=0,
                       quantize_embeddings=True)
qsess = QwenAsrSession(qtower, qllm, qcfg, template=QwenPromptTemplate((1, 2), (3,), (4,)),
                       max_new_tokens=3, max_seconds=1.0)
qout = qsess.transcribe(np.zeros(8000, np.float32))
assert len(qout.token_ids) == 4, qout
from asr_tpu_torch.quant.quantize import quantize_linear
leaf2 = quantize_linear(torch.randn(512, 128), bits=2, pack=True)
assert leaf2.packed and qm.quant_dense(torch.randn(3, 512), leaf2).shape == (3, 128)
from asr_tpu_torch.runtime import audio as taudio
assert taudio.resample(np.ones(4410, np.float32), 44100, 16000).shape == (1600,)
from asr_tpu_torch.models import forced_aligner as fa, fun_asr_nano as fn
from asr_tpu_torch.runtime.aligner_session import QwenAlignerSession
from asr_tpu_torch.runtime.qwen_session import FunAsrNanoLlmSession
from asr_tpu_torch.runtime.transducer_session import FunAsrNanoCtcSession
qm.set_quant_config(mm="f32")
fcfg = fn.FunAsrNanoConfig(hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1,
                           num_encoders=1, num_tp_encoders=1, fsmn_kernel=5, adaptor_hidden=256,
                           adaptor_blocks=1, adaptor_heads=4, adaptor_ffn=64, ctc_hidden=32,
                           ctc_blocks=1, ctc_heads=4, ctc_ffn=48, ctc_vocab=50, llm=lcfg, eot_id=-1)
fparams = quantize_pytree(fn.init_params(fcfg, g, "cpu"), min_size=1024)
assert FunAsrNanoCtcSession(fparams, fcfg, window_seconds=1.0).transcribe(np.ones(20000, np.float32))
fsess = FunAsrNanoLlmSession(fparams, qllm, fcfg, max_new_tokens=2, max_seconds=1.0)
assert len(fsess.transcribe(np.ones(9000, np.float32)).token_ids) == 3
acfg = fa.ForcedAlignerConfig(asr=qcfg, classify_num=25)
asess = QwenAlignerSession(qtower, qllm, {"w": torch.randn(256, 25)}, acfg,
                           type("T", (), {"encode": lambda self, t: [7, 8]})(),
                           {"timestamp": 10, "audio_start": 11, "audio_end": 12}, max_seconds=1.0)
assert [w["text"] for w in asess.align(np.zeros(8000, np.float32), "a b")] == ["a", "b"]
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.models import dolphin as dp, firered as fr
from asr_tpu_torch.runtime.transducer_session import DolphinSession, FireRedSession
frcfg = fr.FireRedConfig(vocab_size=64, d_model=256, enc_layers=1, enc_heads=4, conv_kernel=5,
                         dec_layers=1, dec_heads=4, dec_ffn=256, max_target_positions=16)
frp = quantize_pytree(fr.init_params(frcfg, g, "cpu"), min_size=4096, quantize_embeddings=True)
dc = DecodeConfig(max_new_tokens=3, eot_id=-1)
assert len(FireRedSession(frp, frcfg, decode_cfg=dc, window_seconds=0.5).transcribe(
    np.ones(9000, np.float32)).token_ids) == 8
dpcfg = dp.DolphinConfig(vocab_size=64, d_model=256, enc_layers=1, enc_heads=4, enc_ffn=256,
                         cgmlp_dim=256, csgu_kernel=5, dec_layers=1, dec_heads=4, dec_ffn=256,
                         sos_id=1, eos_id=2, language_token_start=40, language_token_end=44,
                         max_target_positions=16)
dsess = DolphinSession(quantize_pytree(dp.init_params(dpcfg, g, "cpu"), min_size=4096), dpcfg,
                       decode_cfg=dc, window_seconds=0.5)
assert len(dsess.transcribe(np.ones(5000, np.float32)).token_ids) == 4
assert 40 <= dsess.last_language < 44 and dsess.last_region is None
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
from asr_tpu_torch.models import nemotron as nm, paraformer as pf, parakeet as pk
from asr_tpu_torch.runtime.transducer_session import NemotronSession, ParaformerSession, ParakeetSession
pfcfg = pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48, num_encoders0=1,
                            num_encoders=1, num_decoders=1, fsmn_kernel=5)
pfs = ParaformerSession(quantize_pytree(pf.init_params(pfcfg, g, "cpu"), min_size=1024), pfcfg,
                        max_tokens=8, window_seconds=0.5)
assert pfs.transcribe(np.random.default_rng(1).standard_normal(9000).astype(np.float32) * 3000)
pkcfg = pk.ParakeetConfig(vocab_size=40, blank_id=39, d_model=32, num_layers=1, num_heads=4, ffn_dim=48,
                          sub_channels=8, dec_hidden=32, lstm_layers=1, mel=NemoMelConfig(n_mels=80))
pks = ParakeetSession(quantize_pytree(pk.init_params(pkcfg, g, "cpu"), min_size=1024), pkcfg,
                      window_seconds=0.5)
assert pks.transcribe(np.random.default_rng(2).standard_normal(9000).astype(np.float32) * 0.1).token_ids
nmcfg = nm.NemotronConfig(vocab_size=30, d_model=32, num_layers=1, num_heads=4, ffn_dim=48, sub_channels=8,
                          pred_hidden=32, joint_hidden=32, prompt_hidden=32, lstm_layers=1, num_prompts=8,
                          mel=NemoMelConfig(n_mels=80))
nms = NemotronSession(quantize_pytree(nm.init_params(nmcfg, g, "cpu"), min_size=1024), nmcfg, prompt_id=3,
                      window_seconds=0.5)
assert nms.transcribe(np.random.default_rng(3).standard_normal(9000).astype(np.float32) * 0.1).token_ids
from asr_tpu_torch import export
from asr_tpu_torch.quant.plan import OptimizerConfig, Plan, apply_plans
from asr_tpu_torch.quant.reorder import channel_reorder_pytree
assert export.dolphin_language_catalog(["<asr>", "<zh>", "<notimestamp>"])["languages"] == {"zh": 1}
svp, n_ffn = channel_reorder_pytree(sv.init_params(cfg, g, "cpu"))
assert n_ffn == 3
for obj in ("kquant", "hqq", "dynamic"):
    dq = quantize_pytree(svp, min_size=1024, objective=obj)
    sv.forward(dq, cfg, torch.zeros(1, 8000), torch.tensor([8000]), torch.tensor([0]))
apply_plans(svp, OptimizerConfig(plans={"p": Plan(method="q4", algorithm="hqq", block=32)}, assign=(("*", "p"),)))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "asr_tpu"))
assert not leaked, leaked
print("STANDALONE_OK", len(out["token_ids"]))
"""


def test_port_runs_without_jax_or_the_jax_package():
    """Every module imported, the SenseVoice forward, a Whisper
    transcription, the continuous server, a q4 Qwen3-ASR transcription, a
    packed-int2 product, a (native, where g++ builds it) resample, both
    Fun-ASR-Nano sessions, a forced alignment, the q8 FireRed and Dolphin
    sessions (Dolphin probing its language), the q8 Paraformer, Parakeet
    and Nemotron sessions, and the reorder, kquant / hqq / dynamic fits (a
    dynamic forward) and a serving plan, in a fresh process."""
    proc = subprocess.run([sys.executable, "-c", _STANDALONE], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "STANDALONE_OK" in proc.stdout


def test_loaders_default_to_the_card():
    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.runtime.artifact import load_model
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session
    from asr_tpu_torch.runtime.session import load_session
    from asr_tpu_torch.runtime.whisper_session import load_whisper_session

    for fn in (load_model, load_session, load_whisper_session, load_qwen_session, _build_session):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_cli_runs_without_jax_or_the_jax_package(tmp_path):
    """``python -m asr_tpu_torch --platform cpu`` in a fresh process: inspect
    and transcribe an artifact folder, with neither ``jax`` nor ``asr_tpu``
    imported."""
    import torch

    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model

    cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                              num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
    (tmp_path / "vocab.txt").write_text("".join(f"w{i}\n" for i in range(64)))
    save_model(tmp_path, sv.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
               ModelMetadata(family="sensevoice", tokenizer={"kind": "vocab_txt", "file": "vocab.txt"},
                             extra={"config": dataclasses.asdict(cfg)}))
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.default_rng(0).standard_normal(12000) * 2000).astype(np.int16).tobytes())
    script = ("import sys; from asr_tpu_torch.cli import main\n"
              f"main(['--platform', 'cpu', 'inspect', '--model-dir', {str(tmp_path)!r}])\n"
              f"main(['--platform', 'cpu', 'transcribe', '--model-dir', {str(tmp_path)!r}, {str(wav)!r}])\n"
              "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'asr_tpu'))\n"
              "assert not leaked, leaked\nprint('CLI_OK')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CLI_OK" in proc.stdout and '"family": "sensevoice"' in proc.stdout
    assert proc.stdout.splitlines()[-2].startswith("w")  # the decoded text line


def test_offline_family_clis_run_without_jax_or_the_jax_package(tmp_path):
    """``python -m asr_tpu_torch --platform cpu transcribe`` of a Paraformer,
    a Parakeet and a Nemotron artifact (Nemotron with ``--language``) in one
    fresh process, with neither ``jax`` nor ``asr_tpu`` imported."""
    import torch

    from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
    from asr_tpu_torch.models import nemotron as nm, paraformer as pf, parakeet as pk
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model
    from asr_tpu_torch.runtime.metadata import LanguageProfile

    mel = NemoMelConfig(n_mels=80)
    models = {
        "paraformer": (pf, pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                                               num_encoders0=1, num_encoders=1, num_decoders=1, fsmn_kernel=5)),
        "parakeet": (pk, pk.ParakeetConfig(vocab_size=40, blank_id=39, d_model=32, num_layers=1, num_heads=4,
                                           ffn_dim=48, sub_channels=8, dec_hidden=32, lstm_layers=1, mel=mel)),
        "nemotron": (nm, nm.NemotronConfig(vocab_size=30, d_model=32, num_layers=1, num_heads=4, ffn_dim=48,
                                           sub_channels=8, pred_hidden=32, joint_hidden=32, prompt_hidden=32,
                                           lstm_layers=1, num_prompts=8, mel=mel)),
    }
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.default_rng(1).standard_normal(12000) * 2000).astype(np.int16).tobytes())
    lines = ["import sys; from asr_tpu_torch.cli import main"]
    for family, (mod, cfg) in models.items():
        folder = tmp_path / family
        folder.mkdir()
        (folder / "vocab.txt").write_text("".join(f"w{i}\n" for i in range(64)))
        save_model(folder, mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                   ModelMetadata(family=family, tokenizer={"kind": "vocab_txt", "file": "vocab.txt"},
                                 supported_languages=[LanguageProfile("de", "German", index=5)],
                                 extra={"config": dataclasses.asdict(cfg)}))
        lang = ", '--language', 'de'" if family == "nemotron" else ""
        lines.append(f"main(['--platform', 'cpu', 'transcribe'{lang}, '--model-dir', {str(folder)!r}, "
                     f"{str(wav)!r}])")
    lines += ["leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'asr_tpu'))",
              "assert not leaked, leaked", "print('CLI_OK')"]
    proc = subprocess.run([sys.executable, "-c", "\n".join(lines)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.splitlines()
    assert out[-1] == "CLI_OK" and len(out) == 7
    assert all(text.startswith("w") for text in out[1:6:2])  # three decoded text lines


_STREAMING = """
import sys
import numpy as np, torch
from asr_tpu_torch.frontend.nemo_mel import NemoMelConfig
from asr_tpu_torch.models import dolphin as dp, nemotron as nm, paraformer as pf, zipformer as zf
from asr_tpu_torch.parallel import stream_server
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime import streaming_session as ss
from asr_tpu_torch.streaming import dolphin_stream as ds, multistream as ms, nemotron_stream as ns
from asr_tpu_torch.streaming import paraformer_online as po
g = torch.Generator().manual_seed(0)
rng = np.random.default_rng(0)
pcfg = po.ParaformerStreamConfig(base=pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4, head_dim=8,
                                 ffn_dim=48, num_encoders0=1, num_encoders=1, num_decoders=1, fsmn_kernel=5))
pp = quantize_pytree(pf.init_params(pcfg.base, g, "cpu"), min_size=1024)
ss.ParaformerStreamingSession(pp, pcfg).transcribe(rng.standard_normal(17000).astype(np.float32) * 2000)
ms.paraformer_multistream(pp, pcfg, 2).step_n(np.zeros((2, 2, 8000), np.float32), np.ones((2, 2), bool))
ncfg = ns.NemotronStreamConfig(base=nm.NemotronConfig(vocab_size=30, d_model=32, num_layers=1, num_heads=4,
                               ffn_dim=48, sub_channels=8, pred_hidden=32, joint_hidden=32, prompt_hidden=32,
                               lstm_layers=1, num_prompts=8, left_context=6, right_context=3,
                               mel=NemoMelConfig(n_mels=80)))
npar = quantize_pytree(nm.init_params(ncfg.base, g, "cpu"), min_size=1024)
assert ss.NemotronStreamingSession(npar, ncfg).transcribe(rng.standard_normal(9000).astype(np.float32) * 0.1)
ms.nemotron_multistream(npar, ncfg, 2).step(np.zeros((2, ncfg.window_samples), np.float32))
dcfg = ds.DolphinStreamConfig(base=dp.DolphinConfig(vocab_size=64, d_model=64, enc_layers=1, enc_heads=4,
                              enc_ffn=96, cgmlp_dim=96, csgu_kernel=5, dec_layers=1, dec_heads=4, dec_ffn=96,
                              sos_id=1, eos_id=2, max_target_positions=16), chunk_frames=8, max_frames=32)
dpar = quantize_pytree(dp.init_params(dcfg.base, g, "cpu"), min_size=1024)
ss.DolphinStreamingSession(dpar, dcfg).transcribe(rng.standard_normal(12000).astype(np.float32) * 2000)
ms.dolphin_multistream(dpar, dcfg, 2).step(np.zeros((2, dcfg.window_samples), np.float32))
zcfg = zf.ZipformerConfig(vocab_size=40, downsampling_factor=(1, 2), num_encoder_layers=(1, 1),
                          encoder_dim=(32, 48), query_head_dim=(8, 8), pos_head_dim=(4, 4),
                          value_head_dim=(8, 8), num_heads=(2, 2), feedforward_dim=(48, 64),
                          cnn_module_kernel=(7, 7), left_context_frames=16, sub_layer1=4, sub_layer2=8,
                          sub_layer3=16, decoder_dim=16, joiner_dim=16, decoder_conv_groups=4)
zpar = quantize_pytree(zf.init_params(zcfg, g, "cpu"), min_size=1024)
assert ss.XasrStreamingSession(zpar, zcfg).transcribe(rng.standard_normal(9000).astype(np.float32) * 2000)
runner = ms.zipformer_multistream(zpar, zcfg, 2)
httpd, srv, _ = stream_server.start_stream_background(runner, zcfg.window_samples, tick_wait_ms=5.0,
                                                      advance_samples=zcfg.advance_samples)
evs = stream_server.stream_pcm_over_http("127.0.0.1", httpd.server_address[1],
                                         (rng.standard_normal(9000) * 2000).astype(np.int16))
httpd.shutdown()
srv.close()
assert evs[-1].get("done"), evs
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "asr_tpu"))
assert not leaked, leaked
print("STREAMING_OK")
"""


def test_streaming_runs_without_jax_or_the_jax_package():
    """The four q8 streaming sessions, each family's multi-stream runner and
    the stream server answering one X-ASR stream, in a fresh process with
    neither ``jax`` nor ``asr_tpu`` imported."""
    proc = subprocess.run([sys.executable, "-c", _STREAMING], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "STREAMING_OK" in proc.stdout


_SYNC_LATENCY_LINES = (
    "+        self._sync_lat_max = 0.0",
    "+            # the raw per-sync maximum: what a client waits for a K-subtick burst",
    "+            self._sync_lat_max = max(self._sync_lat_max, dt)",
    '+            "sync_latency_max_s": round(self._sync_lat_max, 5),',
)


def test_stream_server_is_the_original_with_one_named_divergence():
    """``parallel/stream_server.py`` is the JAX package's host-only file with
    exactly one change: ``sync_latency_max_s``, the raw per-sync latency
    maximum, kept beside the per-subtick ``tick_latency_max_s`` in
    ``stats()`` (and so in ``/healthz``)."""
    import difflib

    want = (REPO / "asr_tpu" / "parallel" / "stream_server.py").read_text().splitlines()
    got = (REPO / "asr_tpu_torch" / "parallel" / "stream_server.py").read_text().splitlines()
    changed = [line for line in difflib.unified_diff(want, got, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert tuple(changed) == _SYNC_LATENCY_LINES, changed


_PORT_RULES = (
    ("    import jax\n\n    return jax.tree.map(jnp.asarray, params)", "    return tree_asarray(params)"),
    ("import jax.numpy as jnp\n", "from asr_tpu.loaders._common import asarray\n"),
    ("jnp.asarray(", "asarray("),
    ("from safetensors.numpy import load_file",
     "from asr_tpu.runtime.artifact import read_safetensors as load_file"),
    ("asr_tpu pytrees", "asr_tpu_torch pytrees"),
    ("asr_tpu.", "asr_tpu_torch."),
)


def port_rewrite(text: str) -> str:
    """A JAX-package loader or ``export.py`` as the port keeps it: arrays
    through the port's ``asarray`` (a tree map through ``tree_asarray``),
    safetensors through the port's reader, imports inside the port."""
    for a, b in _PORT_RULES:
        text = text.replace(a, b)
    if "tree_asarray(params)" in text:
        text = text.replace("import asarray\n", "import tree_asarray\n")
    return text


_LOADERS = ("funasr", "whisper_hf", "qwen3_hf", "qwen_asr_hf", "firered", "dolphin_espnet",
            "parakeet_hf", "nemotron_nemo", "zipformer_icefall")


@pytest.mark.parametrize("name", [f"loaders/{n}" for n in _LOADERS] + ["export"])
def test_loaders_and_export_are_the_originals(name):
    """The nine loaders and ``export.py`` are the JAX package's files under
    :func:`port_rewrite`, byte for byte; ``loaders/_common.py`` is the
    port's own (``asarray`` stands in for ``jnp.asarray``)."""
    got = (REPO / "asr_tpu_torch" / f"{name}.py").read_text()
    assert got == port_rewrite((REPO / "asr_tpu" / f"{name}.py").read_text())


@pytest.mark.parametrize("name", ["tokenizer", "examples"])
def test_host_copies_are_the_originals(name):
    """``runtime/tokenizer.py`` and ``runtime/examples.py`` are the JAX
    package's files, byte for byte apart from the package name in imports."""
    got = (REPO / "asr_tpu_torch" / "runtime" / f"{name}.py").read_text()
    want = (REPO / "asr_tpu" / "runtime" / f"{name}.py").read_text()
    assert got == want.replace("from asr_tpu.", "from asr_tpu_torch.")


def test_examples_registry_matches(tmp_path):
    from asr_tpu.runtime import examples as jex
    from asr_tpu_torch.runtime import examples as tex

    for rel in ("en/test_sample.wav", "zh/zh-Shanghai.wav", "ja/ja.mp3"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert tex.TEST_EXAMPLES_DIR == jex.TEST_EXAMPLES_DIR
    for family in ("sensevoice", "whisper", "dolphin", "fun_asr_nano", "forced_aligner", "none"):
        assert tex.model_audio_cases(family, tmp_path) == jex.model_audio_cases(family, tmp_path)
    assert tex.model_audio_cases("sensevoice", tmp_path)[0] == ("en", tmp_path / "en/test_sample.wav")


def _meta(mod):
    return mod.ModelMetadata(
        family="whisper", sample_rate=16000, audio_pcm_scale=1.0,
        special_token_ids={"eot": 2}, max_seq_len=448, tokenizer={"kind": "bpe", "file": "t.json"},
        supported_languages=[mod.LanguageProfile("en", "English", ("eng",), 50259, 0)],
        extra={"config": {"d_model": 32, "n_mels": 16}})


@pytest.mark.parametrize("writer,reader", [(jmeta, tmeta), (tmeta, jmeta)])
def test_metadata_round_trip_both_ways(tmp_path, writer, reader):
    _meta(writer).save(tmp_path)
    back = reader.ModelMetadata.load(tmp_path)
    assert dataclasses.asdict(back) == dataclasses.asdict(_meta(reader))
    assert back.resolve_language("ENG").code == "en"

    @dataclasses.dataclass(frozen=True)
    class Cfg:
        d_model: int = 8
        n_mels: int = 80
        ids: tuple = (1, 2)

    payload = {"d_model": 32, "ids": [3, 4], "unknown": 1}
    assert reader.config_from_dict(Cfg, payload) == writer.config_from_dict(Cfg, payload)


def test_iter_windows_matches():
    for n in (0, 1, 479, 480, 481, 1000, 4800, 12345):
        for window, stride in ((480, 480), (480, 160), (1000, 333)):
            assert taudio.iter_windows(n, window, stride) == jaudio.iter_windows(n, window, stride)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 2), (3, 1), (4, 2)])
def test_read_wav_matches(tmp_path, width, channels):
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, size=300 * width * channels, dtype=np.uint8).tobytes()
    p = tmp_path / "a.wav"
    with wave.open(str(p), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(8000)
        w.writeframes(raw)
    got, rate = taudio.read_wav(p)
    want, jrate = jaudio.read_wav(p)
    assert rate == jrate == 8000 and got.shape == want.shape == (channels, 300)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [(8000, 16000), (44100, 16000), (16000, 16000)])
def test_scipy_resample_matches(monkeypatch, src, dst):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    x = np.random.default_rng(src).standard_normal(3000).astype(np.float32) * 1000
    got, want = taudio.resample(x, src, dst), jaudio.resample(x, src, dst)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_flac_decoding_matches(tmp_path, monkeypatch):
    from test_flac import _encode  # the JAX package's in-test FLAC encoder

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    rng = np.random.default_rng(0)
    a = rng.integers(-3000, 3000, 64).astype(np.int64)
    b = np.cumsum(rng.integers(-40, 40, 64)).astype(np.int64) + 100
    c = np.full(64, -777, np.int64)
    mono = _encode([[("verbatim", a, 16)], [("fixed2", b, 16)], [("constant", c, 16)]])
    left, right = rng.integers(-2000, 2000, 48), rng.integers(-2000, 2000, 48)
    stereo = _encode([[("verbatim", left, 16), ("verbatim", left - right, 17)]], channels=2,
                     chan_code=8)
    for blob in (mono, stereo):
        p = tmp_path / "x.flac"
        p.write_bytes(blob)
        got, rate = tflac.read_flac(p)
        want, jrate = jflac.read_flac(p)
        assert rate == jrate == 16000
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 1], right.astype(np.float32))
    np.testing.assert_array_equal(thttp.decode_audio_bytes(mono, 16000),
                                  np.concatenate([a, b, c]).astype(np.float32))
    with pytest.raises(ValueError, match="fLaC"):
        tflac.read_flac_bytes(b"NOPE" + b"\x00" * 64)


def test_mel_banks_match():
    for fn in ("kaldi_mel_banks", "slaney_mel_banks", "htk_mel_banks"):
        for n_mels, n_fft in ((80, 400), (128, 400), (16, 512)):
            np.testing.assert_array_equal(getattr(tmb, fn)(n_mels, n_fft, 16000),
                                          getattr(jmb, fn)(n_mels, n_fft, 16000))


def test_join_window_texts_matches():
    cases = [[], ["a"], ["today", "The"], ["end.", "Next"], ["你好", "世界"], ["x", "", "y"],
             ["abc", "中文"], ["1", "2"]]
    for texts in cases:
        assert thttp._join_window_texts(texts) == jhttp._join_window_texts(texts)


def test_rope_tables_and_asr_output_parsing_match():
    from asr_tpu.layers import rope as jrope
    from asr_tpu.runtime import qwen_session as jqs
    from asr_tpu_torch.layers import rope as trope
    from asr_tpu_torch.runtime import qwen_session as tqs

    for args in ((8, 128, 5e6), (2048, 128, 5e6), (33, 64, 1e4)):
        np.testing.assert_array_equal(trope.rope_tables(*args), jrope.rope_tables(*args))
    for raw in ("language English<asr_text>hi there", "language <asr_text>x", "no tag", "",
                "LANGUAGE chinese<asr_text> 你好 "):
        for lang in (None, "en"):
            assert tqs.parse_asr_output(raw, lang) == jqs.parse_asr_output(raw, lang)


def test_native_source_is_the_reference_source():
    """The port's ``native/audio_dsp.cc`` is the JAX package's below the
    leading comment block."""
    def body(path):
        lines = path.read_text().splitlines()
        return lines[next(i for i, l in enumerate(lines) if not l.startswith("//")):]

    assert body(REPO / "asr_tpu_torch/native/audio_dsp.cc") == body(REPO / "asr_tpu/native/audio_dsp.cc")


@pytest.mark.parametrize("module,names", [
    ("runtime/probe", ("STAGE_ORDER", "summarize", "_drift", "compare_probes", "_pad_row",
                       "_load_samples", "_chunks_of", "_PROBES")),
])
def test_probe_and_profiling_host_parts_are_the_originals(module, names):
    """``runtime/probe.py``'s numpy part (the stage order, the snapshot, the
    comparison) with its host helpers is the JAX package's code under the
    port's rewrite of imports."""
    def defs(path: Path) -> dict:
        tree = ast.parse(path.read_text())
        out = {}
        for node in tree.body:
            targets = [t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)]
            for name in [getattr(node, "name", None), *targets]:
                if name in names:
                    out[name] = ast.get_source_segment(path.read_text(), node)
        return out

    got = defs(REPO / "asr_tpu_torch" / f"{module}.py")
    want = defs(REPO / "asr_tpu" / f"{module}.py")
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        assert got[name] == port_rewrite(want[name]), name


def test_new_modules_import_neither_jax_nor_the_jax_package():
    for rel in ("runtime/probe.py", "runtime/profiling.py", "frontend/stft.py", "cli.py",
                "runtime/artifact.py", "loaders/_common.py", "parallel/mesh.py", "parallel/serve.py"):
        bad = _imported_roots(REPO / "asr_tpu_torch" / rel) & {"asr_tpu", "jax", "jaxlib"}
        assert not bad, f"{rel} imports {sorted(bad)}"


def test_parity_runs_without_jax_or_the_jax_package(tmp_path):
    """``python -m asr_tpu_torch --platform cpu parity`` (capture, then a
    compare) and a profiled ``transcribe`` in a fresh process, with neither
    ``jax`` nor ``asr_tpu`` imported."""
    import torch

    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model
    from tests.test_torch_parity_cli import write_examples

    cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                              num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
    art = tmp_path / "art"
    save_model(art, sv.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
               ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(cfg)}))
    examples = write_examples(tmp_path / "examples")
    golden = tmp_path / "g.json"
    base = ["--platform", "cpu", "parity", "--model-dir", str(art), "--examples", str(examples)]
    script = ("import sys; from asr_tpu_torch.cli import main\n"
              f"assert main({base + ['--save-golden', str(golden)]!r}) == 0\n"
              f"assert main({base + ['--golden', str(golden)]!r}) == 0\n"
              f"assert main(['--platform', 'cpu', 'transcribe', '--profile', {str(tmp_path / 'p')!r}, "
              f"'--model-dir', {str(art)!r}, {str(examples / 'zh' / 'zh-Shanghai.wav')!r}]) == 0\n"
              "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'asr_tpu'))\n"
              "assert not leaked, leaked\nprint('PARITY_OK')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "PARITY OK: 2 fixtures token-for-token" in proc.stdout and "PARITY_OK" in proc.stdout
    assert "trace written to" in proc.stdout


_SHARDED = """
import sys
import numpy as np, torch
from asr_tpu_torch.decode.ar import DecodeConfig
from asr_tpu_torch.layers import qwen3
from asr_tpu_torch.models import sensevoice as sv
from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher
from asr_tpu_torch.parallel.mesh import make_mesh, sensevoice_param_specs
from asr_tpu_torch.quant.quantize import quantize_pytree
from asr_tpu_torch.runtime.session import SenseVoiceSession
cpu = torch.device("cpu")
cfg = sv.SenseVoiceConfig(vocab_size=63, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                          num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
params = quantize_pytree(sv.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), min_size=0,
                         block=16)
audio = (np.random.default_rng(0).standard_normal(12000) * 2000).astype(np.float32)
want = SenseVoiceSession(params, cfg, window_seconds=0.3).transcribe(audio).token_ids
got = SenseVoiceSession(params, cfg, window_seconds=0.3, mesh=make_mesh(4, 2, devices=[cpu] * 4),
                        param_specs=sensevoice_param_specs).transcribe(audio).token_ids
assert got == want, (got, want)
lcfg = qwen3.Qwen3Config(vocab_size=64, hidden=32, num_layers=1, num_heads=4, num_kv_heads=2,
                         head_dim=8, ffn_dim=48)
lp = qwen3.init_params(lcfg, torch.Generator().manual_seed(1))
bat = ContinuousLlmBatcher(lp, lcfg, DecodeConfig(max_new_tokens=4, eot_id=-1), n_slots=2, t_max=40,
                           mesh=make_mesh(2, 2, devices=[cpu] * 2))
slot = bat.try_submit(lp["embed"][torch.tensor([3, 4, 5])], 3)
while bat.is_active(slot):
    bat.step()
assert len(bat.take_result(slot)) == 5
assert not any(m == "jax" or m.startswith(("jax.", "asr_tpu.")) or m == "asr_tpu" for m in sys.modules)
print("SHARDED_OK")
"""


def test_sharded_serving_runs_without_jax_or_the_jax_package():
    """A q8 SenseVoice session at dp 2 x tp 2 (int8 row and column shards,
    the uneven CTC head) equal to the unsharded one, and a tensor-parallel
    continuous batcher, in a fresh process with neither ``jax`` nor
    ``asr_tpu`` imported."""
    proc = subprocess.run([sys.executable, "-c", _SHARDED], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "SHARDED_OK" in proc.stdout
