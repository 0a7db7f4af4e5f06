"""PyTorch port: SenseVoiceSmall end to end (logits, tokens, session,
artifact folders, HTTP serving) against the JAX package at a tiny geometry,
plus the check that the port never imports JAX or the JAX package."""

import dataclasses
import io
import json
import subprocess
import sys
import threading
import urllib.request
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.models import sensevoice as jsv
from asr_tpu.quant.quantize import quantize_pytree as jquantize_pytree
from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime.metadata import ModelMetadata, config_from_dict
from asr_tpu.runtime.session import SenseVoiceSession as JaxSession
from asr_tpu_torch.models import sensevoice as tsv
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant.quantize import QuantizedLinear
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.session import SenseVoiceSession, bucket_windows, load_session

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=300, hidden=64, num_heads=4, head_dim=16, ffn_dim=256,
            num_encoders0=1, num_encoders=2, num_tp_encoders=1, fsmn_kernel=5)
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    mm = tqm._CONFIG["mm"]
    tqm.set_quant_config(mm="f32")  # the JAX package's CPU route is the exact f32 product
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def _models(quantized: bool, seed: int = 0):
    jcfg, tcfg = jsv.SenseVoiceConfig(**TINY), tsv.SenseVoiceConfig(**TINY)
    jp = jsv.init_params(jcfg, jax.random.PRNGKey(seed))
    if quantized:
        jp = jquantize_pytree(jp, bits=8, block=64, min_size=4096)
    return jcfg, jp, tcfg, tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def _audio(seed, batch, samples):
    return (np.random.default_rng(seed).standard_normal((batch, samples)) * 2000).astype(np.float32)


def _assert_same_decode(jlogits, tlogits, valid_seq, jtok, jcnt, ttok, tcnt):
    """Framewise argmax equal wherever the top-2 margin exceeds MARGIN; with
    no frame under it, compacted tokens and counts are equal too."""
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    frames = np.arange(jlogits.shape[1])[None, :] < valid_seq[:, None]
    sure = frames & (margin > MARGIN)
    np.testing.assert_array_equal(tlogits.argmax(-1)[sure], jlogits.argmax(-1)[sure])
    assert sure.sum() == frames.sum(), "seed gives a frame under the margin; pick another"
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_array_equal(ttok, jtok)


def test_config_fields_and_tables_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jsv.SenseVoiceConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsv.SenseVoiceConfig)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    assert dataclasses.asdict(jsv.SenseVoiceConfig()) == dataclasses.asdict(tsv.SenseVoiceConfig())
    assert tsv.LANGUAGE_PROFILES == jsv.LANGUAGE_PROFILES
    np.testing.assert_array_equal(tsv.sinusoid_position_encoding(50, 560),
                                  jsv.sinusoid_position_encoding(50, 560))
    cfg = config_from_dict(tsv.SenseVoiceConfig, dataclasses.asdict(tsv.SenseVoiceConfig(**TINY)))
    assert cfg == tsv.SenseVoiceConfig(**TINY)


def test_init_params_layout_matches_jax():
    jcfg, tcfg = jsv.SenseVoiceConfig(**TINY), tsv.SenseVoiceConfig(**TINY)
    jflat = jart.flatten_pytree(jsv.init_params(jcfg, jax.random.PRNGKey(0)))
    tflat = tart.flatten_pytree(tsv.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: v.shape for k, v in tflat.items()}
    assert all(v.dtype == np.float32 for v in tflat.values())


@pytest.mark.parametrize("quantized", [False, True])
def test_encode_logits_and_forward_match_jax(quantized):
    jcfg, jp, tcfg, tp = _models(quantized, seed=1)  # seeds with every top-2 margin > MARGIN
    audio = _audio(1, 2, 16000)
    valid = np.array([16000, 11000], np.int32)
    lang = np.array([0, 2], np.int32)
    jl, jv = jsv.encode_logits(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid), jnp.asarray(lang))
    jt, jn = jsv.forward(jp, jcfg, jnp.asarray(audio), jnp.asarray(valid), jnp.asarray(lang))
    ta, tv_, tl_ = torch.from_numpy(audio), torch.from_numpy(valid), torch.from_numpy(lang)
    tl, tv = tsv.encode_logits(tp, tcfg, ta, tv_, tl_)
    tt, tn = tsv.forward(tp, tcfg, ta, tv_, tl_)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.abs(tl.numpy() - jl).max() <= 1e-3 * np.abs(jl).max()
    _assert_same_decode(jl, tl.numpy(), np.asarray(jv), np.asarray(jt), np.asarray(jn),
                        tt.numpy(), tn.numpy())
    if quantized:
        assert sum(isinstance(b["qkv"]["w"], QuantizedLinear) for b in tp["encoders"]) == 2


def test_padded_batch_equals_exact_length_runs():
    _, _, tcfg, tp = _models(False, seed=3)
    audio = _audio(2, 3, 12000)
    valid = np.array([12000, 7000, 3000], np.int32)
    lang = torch.tensor([0, 1, 2])
    bt, bn = tsv.forward(tp, tcfg, torch.from_numpy(audio), torch.from_numpy(valid), lang)
    for i in range(3):
        one = torch.from_numpy(audio[i : i + 1, : valid[i]].copy())
        t1, n1 = tsv.forward(tp, tcfg, one, torch.from_numpy(valid[i : i + 1]), lang[i : i + 1])
        assert int(n1[0]) == int(bn[i])
        np.testing.assert_array_equal(t1[0, : n1[0]].numpy(), bt[i, : bn[i]].numpy())


def test_session_transcribe_matches_jax_session():
    jcfg, jp, tcfg, tp = _models(True, seed=0)
    audio = _audio(5, 1, 21000)[0]  # 3 windows of 0.5 s -> bucket 4
    want = JaxSession(jp, jcfg, window_seconds=0.5).transcribe(audio)
    got = SenseVoiceSession(tp, tcfg, window_seconds=0.5).transcribe(audio)
    assert bucket_windows(3) == 4
    assert got.token_ids == want.token_ids
    assert got.audio_seconds == want.audio_seconds


def test_artifact_written_by_jax_loads_in_port(tmp_path):
    jcfg, jp, tcfg, _ = _models(True)
    meta = ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(jcfg)})
    jart.save_model(tmp_path / "jax", jp, meta)
    assert meta.extra["weight_aliases"]  # zero biases dedup to one stored tensor
    params, meta2 = tart.load_model(tmp_path / "jax", "cpu")
    assert config_from_dict(tsv.SenseVoiceConfig, meta2.extra["config"]) == tcfg
    want = jart.flatten_pytree(jp)
    got = tart.flatten_pytree(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # Aliased keys share one tensor.
    alias, canon = next(iter(meta2.extra["weight_aliases"].items()))
    node_a, node_c = params, params
    for part in alias.split("/"):
        node_a = node_a[int(part)] if isinstance(node_a, list) else node_a[part]
    for part in canon.split("/"):
        node_c = node_c[int(part)] if isinstance(node_c, list) else node_c[part]
    assert node_a is node_c


def test_load_session_from_jax_artifact(tmp_path):
    jcfg, jp, _, _ = _models(True, seed=0)
    jart.save_model(tmp_path, jp, ModelMetadata(family="sensevoice",
                                                extra={"config": dataclasses.asdict(jcfg)}))
    sess = load_session(tmp_path, "cpu", window_seconds=0.5)
    assert sess.cfg == tsv.SenseVoiceConfig(**TINY)
    audio = _audio(7, 1, 9000)[0]
    want = JaxSession(jp, jcfg, window_seconds=0.5).transcribe(audio)
    assert sess.transcribe(audio).token_ids == want.token_ids
    jart.save_model(tmp_path / "other", jp, ModelMetadata(family="whisper"))
    with pytest.raises(ValueError):
        load_session(tmp_path / "other", "cpu")


def test_artifact_written_by_port_round_trips(tmp_path):
    from safetensors.numpy import load_file

    _, _, tcfg, tp = _models(True, seed=2)
    meta = ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(tcfg)})
    tart.save_model(tmp_path / "port", tp, meta)
    want = tart.flatten_pytree(tp)
    back, _ = tart.load_model(tmp_path / "port", "cpu")
    got = tart.flatten_pytree(back)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # The file is standard safetensors, and the JAX package reads the folder.
    stored = load_file(str(tmp_path / "port" / tart.WEIGHTS_FILENAME))
    for k, v in stored.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    jparams, _ = jart.load_model(tmp_path / "port")
    jflat = jart.flatten_pytree(jparams)
    assert sorted(jflat) == sorted(want)


def _wav_bytes(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


def test_http_server_matches_session():
    from asr_tpu_torch.parallel.http_server import start_background

    _, _, tcfg, tp = _models(True, seed=4)
    sess = SenseVoiceSession(tp, tcfg, window_seconds=0.5)
    httpd, srv, thread = start_background(sess, port=0, max_batch=4, max_wait_ms=20.0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        rng = np.random.default_rng(6)
        clips = [np.round(rng.standard_normal(n) * 2000).astype(np.int16) for n in (4000, 6500, 8000, 19000)]
        want = [sess.transcribe(c.astype(np.float32)).token_ids for c in clips]
        results = [None] * len(clips)

        def post(i):
            req = urllib.request.Request(base + "/transcribe", data=_wav_bytes(clips[i]), method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                results[i] = (resp.status, json.loads(resp.read()))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for (status, payload), ids in zip(results, want):
            assert status == 200
            assert payload["token_ids"] == ids
        assert results[-1][1]["windows"] == 3
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["requests_served"] == 1 + 3 + 3  # warmup + 3 clips + 3 windows
        assert health["batches_dispatched"] >= 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=10)


_NO_JAX = """
import importlib, pkgutil, sys
import torch
import asr_tpu_torch
for mod in pkgutil.walk_packages(asr_tpu_torch.__path__, "asr_tpu_torch."):
    importlib.import_module(mod.name)
from asr_tpu_torch.models import sensevoice as sv
from asr_tpu_torch.quant.quantize import quantize_pytree
cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                          num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
params = quantize_pytree(sv.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), min_size=1024)
toks, counts = sv.forward(params, cfg, torch.zeros(1, 8000), torch.tensor([8000]), torch.tensor([0]))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "asr_tpu"))
assert not leaked, leaked
print("NO_JAX_OK", tuple(toks.shape))
"""


def test_port_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
