"""Stage-activation probes for the parity harness (``python -m asr_tpu_torch parity``).

Counterpart of ``asr_tpu/runtime/probe.py``, with the same snapshots, so
goldens move between the two packages. A transcript mismatch alone does not
say WHERE the drift is. These probes snapshot the pipeline stage by stage
for the FIRST window of each fixture — front-end features, encoder output,
and first-decode-step logits — alongside the golden transcripts. On
compare, the first drifting stage localizes a mismatch to front-end vs
encoder vs decode without a manual bisect.

Snapshots are compact (shape + mean/std + the first ``head`` flattened
values + ``spread`` values strided over the whole tensor) so goldens stay
reviewable JSON; comparisons are rtol-based. Each probe computes on the
session's device and summarizes on the host in f32. ``STAGE_ORDER``,
:func:`summarize`, :func:`compare_probes` and the host helpers are the JAX
package's code; the streaming families' steps take a leading stream axis
here, so their probes run one stream and summarize stream 0.
"""

from __future__ import annotations

import numpy as np
import torch

# Compare (and report) stages in pipeline order: the FIRST drifting stage
# is the localization.
STAGE_ORDER = ("frontend", "encoder", "logits")


def summarize(arr, head: int = 48, spread: int = 48) -> dict:
    """Compact JSON-able snapshot of one activation tensor.

    ``head`` covers the leading values; ``spread`` samples ``spread``
    values STRIDED across the whole flattened tensor so a drift confined
    to late elements (long-audio frames, high vocab ids) cannot hide
    behind a clean head + global mean/std."""
    a = np.asarray(arr, np.float32)
    flat = a.reshape(-1)
    out = {
        "shape": [int(s) for s in a.shape],
        "mean": float(flat.mean()) if flat.size else 0.0,
        "std": float(flat.std()) if flat.size else 0.0,
        "head": [float(x) for x in flat[:head]],
    }
    if flat.size > head:
        idx = np.linspace(0, flat.size - 1, min(spread, flat.size)).astype(np.int64)
        out["spread"] = [float(x) for x in flat[idx]]
    return out


def _drift(got: dict, want: dict, rtol: float, atol: float) -> str | None:
    if list(got["shape"]) != list(want["shape"]):
        return f"shape {got['shape']} != {want['shape']}"
    scale = max(abs(want["mean"]) + want["std"], 1e-6)
    # "head" = leading values; "spread" = values strided across the whole
    # tensor (late-element drift localizes here). Old goldens without a
    # spread field still compare on head + stats.
    for field in ("head", "spread"):
        if field not in want or field not in got:
            continue
        g = np.asarray(got[field], np.float64)
        w = np.asarray(want[field], np.float64)
        n = min(len(g), len(w))
        if not np.allclose(g[:n], w[:n], rtol=rtol, atol=atol * scale):
            i = int(np.argmax(np.abs(g[:n] - w[:n])))
            return f"{field}[{i}] {g[i]:.6g} != {w[i]:.6g}"
    for k in ("mean", "std"):
        if not np.isclose(got[k], want[k], rtol=rtol, atol=atol * scale):
            return f"{k} {got[k]:.6g} != {want[k]:.6g}"
    return None


def compare_probes(got: dict | None, want: dict | None,
                   rtol: float = 2e-3, atol: float = 1e-4) -> list[str]:
    """Ordered stage comparison -> list of drift messages (empty = clean).

    Only the FIRST drifting stage is reported — downstream stages drift as
    a consequence and would bury the signal.
    """
    if not want:
        return []
    if not got:
        return ["probe missing from run (family has no probe support?)"]
    for stage in STAGE_ORDER:
        if stage not in want:
            continue
        if stage not in got:
            return [f"stage {stage!r} missing from run"]
        msg = _drift(got[stage], want[stage], rtol, atol)
        if msg is not None:
            return [f"first drift at stage {stage!r}: {msg}"]
    return []


# ── per-family capture ────────────────────────────────────────────────────


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host f32 array (what :func:`summarize` takes)."""
    return t.detach().to(torch.float32).cpu().numpy()


def _pad_row(samples: np.ndarray, width: int):
    """Clip to ``width`` and right-pad into a (1, width) f32 row; returns
    (row, clipped samples)."""
    samples = samples[:width]
    buf = np.zeros((1, width), np.float32)
    buf[0, : len(samples)] = samples
    return buf, samples


def _first_window(sess, audio, pcm_scale: float):
    """The first window as a (1, window) tensor on the session's device and
    its valid count as a (1,) tensor there."""
    buf, clipped = _pad_row(_load_samples(sess, audio, pcm_scale),
                            sess.window_samples)
    return (torch.from_numpy(buf).to(sess.device),
            torch.tensor([len(clipped)], dtype=torch.int64, device=sess.device))


def _cross_bias(enc_valid: torch.Tensor, t: int) -> torch.Tensor:
    from asr_tpu_torch.layers.attention import NEG_INF, length_mask

    zero = torch.zeros((), dtype=torch.float32, device=enc_valid.device)
    return torch.where(length_mask(enc_valid, t), zero, zero + NEG_INF)[:, None, None, :]


def _probe_sensevoice(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
    from asr_tpu_torch.models import sensevoice as sv

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    fb = cfg.fbank
    mel = log_mel_fbank(buf, fb, fb.num_frames(buf.shape[-1]))
    logits, valid_seq = sv.encode_logits(
        sess.params, cfg, buf, valid, torch.zeros((1,), dtype=torch.int64, device=sess.device))
    t = int(valid_seq[0])
    return {"frontend": summarize(_host(mel[0, : max(t, 1)])),
            "logits": summarize(_host(logits[0, : max(t, 1)]))}


def _probe_firered(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
    from asr_tpu_torch.models import firered as fr

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    fb = cfg.fbank
    mel = log_mel_fbank(buf, fb, fb.num_frames(buf.shape[-1]))
    enc, enc_valid = fr.encode(sess.params, cfg, buf, valid)
    t = int(enc_valid[0])
    state = fr.make_state(sess.params, cfg, enc)
    prompt = torch.full((1, 1), cfg.sos_id, dtype=torch.int64, device=sess.device)
    logits, _ = fr._decoder_pass(sess.params, cfg, state, prompt, 0,
                                 _cross_bias(enc_valid, enc.shape[1]))
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0, : max(t, 1)])),
            "logits": summarize(_host(logits[0, -1]))}


def _probe_whisper(sess, audio) -> dict:
    from asr_tpu_torch.models import whisper as wh

    buf, _valid = _first_window(sess, audio, 1.0)
    cfg = sess.cfg
    mel = wh.mel_for_audio(cfg, buf)
    enc = wh.encode(sess.params, cfg, mel)
    state = wh.make_state(sess.params, cfg, enc)
    prompt = torch.full((1, 1), cfg.sot_id, dtype=torch.int64, device=sess.device)
    logits, _state = wh.prefill(sess.params, cfg, state, prompt)
    # prefill gives the last position's (B, V) logits, so [0, -1] is the last
    # vocabulary entry's: the JAX probe's snapshot, kept for shared goldens
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0])),
            "logits": summarize(_host(logits[0, -1]))}


def _probe_paraformer(sess, audio) -> dict:
    from asr_tpu_torch.decode.cif import cif_fire
    from asr_tpu_torch.models import paraformer as pf

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    params = sess.params
    mel, feats, valid_lfr = pf.frontend_features(params, cfg, buf, valid)
    enc = pf.encode(params, cfg, feats.to(params["output"]["b"].dtype), valid_lfr)
    alphas = pf.predict_alphas(params, cfg, enc, valid_lfr)
    embeds, counts = cif_fire(alphas, enc, valid_lfr, 64, cfg.tail_threshold)
    logits = pf.decode_tokens(params, cfg, embeds.to(enc.dtype), counts, enc, valid_lfr)
    t = int(valid_lfr[0])
    c = int(counts[0])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0, : max(t, 1)])),
            "logits": summarize(_host(logits[0, : max(c, 1)]))}


def _probe_dolphin(sess, audio) -> dict:
    from asr_tpu_torch.models import dolphin as dp

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    mel = dp.log_mel(buf, cfg.mel)
    enc, enc_valid = dp.encode(sess.params, cfg, buf, valid)
    t = int(enc_valid[0])
    state = dp.make_state(sess.params, cfg, enc)
    prompt = torch.full((1, 1), cfg.sos_id, dtype=torch.int64, device=sess.device)
    logits, _ = dp._decoder_pass(sess.params, cfg, state, prompt, 0,
                                 _cross_bias(enc_valid, enc.shape[1]))
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0, : max(t, 1)])),
            "logits": summarize(_host(logits[0, -1]))}


def _probe_parakeet(sess, audio) -> dict:
    from asr_tpu_torch.frontend.nemo_mel import log_mel
    from asr_tpu_torch.models import parakeet as pk

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    mel = log_mel(buf, cfg.mel)
    enc, enc_valid = pk.encode(sess.params, cfg, buf, valid)
    t = int(enc_valid[0])
    h0 = torch.zeros((cfg.lstm_layers, 1, cfg.dec_hidden), dtype=enc.dtype, device=sess.device)
    # a blank id past the embedding table reads its last row, as a JAX gather clamps
    blank = min(cfg.blank_id, sess.params["decoder"]["embed"].shape[0] - 1)
    tok_logits, _dur, _h, _c = pk.joint_step(
        sess.params, torch.full((1,), blank, dtype=torch.int64, device=sess.device),
        h0, h0.clone(), enc[:, 0])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0, : max(t, 1)])),
            "logits": summarize(_host(tok_logits[0]))}


def _probe_nemotron(sess, audio) -> dict:
    from asr_tpu_torch.frontend.nemo_mel import log_mel
    from asr_tpu_torch.models import nemotron as nm

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    mel = log_mel(buf, cfg.mel)
    pid = torch.full((1,), sess.prompt_id, dtype=torch.int64, device=sess.device)
    enc, enc_valid = nm.encode(sess.params, cfg, buf, valid, pid)
    t = int(enc_valid[0])
    h0 = torch.zeros((cfg.lstm_layers, 1, cfg.pred_hidden), dtype=enc.dtype, device=sess.device)
    logits, _h, _c = nm.joint_step(
        sess.params, torch.full((1,), cfg.blank_id, dtype=torch.int64, device=sess.device),
        h0, h0.clone(), enc[:, 0])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0, : max(t, 1)])),
            "logits": summarize(_host(logits[0]))}


def _probe_funasr_ctc(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
    from asr_tpu_torch.models import fun_asr_nano as fn

    buf, valid = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    fb = cfg.fbank
    mel = log_mel_fbank(buf, fb, fb.num_frames(buf.shape[-1]))
    enc, valid_lfr, _ = fn.encode(sess.params, cfg, buf, valid)
    logits = fn.ctc_logits(sess.params, cfg, enc, valid_lfr)
    t = int(valid_lfr[0])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0, : max(t, 1)])),
            "logits": summarize(_host(logits[0, : max(t, 1)]))}


def _llm_first_logits(llm_params, lcfg, embeds, valid: int):
    """First decode-step logits of a Qwen3-decoder prompt: the prefill's
    logits at the last valid position (exactly what the lockstep decode and
    the continuous batcher's prefill select the first token from)."""
    from asr_tpu_torch.layers import qwen3

    if embeds.ndim == 2:
        embeds = embeds[None]
    lf = embeds.shape[1]
    state = qwen3.make_kv_state(lcfg, 1, lf, embeds.dtype, embeds.device)
    bias = qwen3.causal_prefill_bias(torch.tensor([valid], device=embeds.device), lf, lf)
    hidden, _ = qwen3.decoder_pass(llm_params, lcfg, embeds, state, 0, bias)
    h_last = hidden[0, max(valid - 1, 0)]
    return qwen3.logits_from_hidden(llm_params, lcfg, h_last[None])


def _load_samples(sess, audio, pcm_scale: float) -> np.ndarray:
    from asr_tpu_torch.runtime import audio as audio_io

    if isinstance(audio, (str, bytes)) or hasattr(audio, "__fspath__"):
        audio = audio_io.load_audio(audio, getattr(sess, "sample_rate", 16000),
                                    pcm_scale=pcm_scale)
    return np.asarray(audio, np.float32)


def _probe_qwen_asr(sess, audio) -> dict:
    from asr_tpu_torch.frontend.whisper_mel import log_mel_spectrogram

    buf, samples = _pad_row(_load_samples(sess, audio, 1.0), sess.max_samples)
    mel = log_mel_spectrogram(torch.from_numpy(buf).to(sess.device), sess.cfg.mel_config())
    embeds, valid = sess.prompt_embeds(samples)
    logits = _llm_first_logits(sess.llm_params, sess.llm_cfg, embeds, valid)
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(embeds[: max(valid, 1)])),
            "logits": summarize(_host(logits[0]))}


def _probe_funasr_llm(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank

    buf, samples = _pad_row(_load_samples(sess, audio, sess.pcm_scale),
                            sess.max_samples)
    fb = sess.cfg.fbank
    mel = log_mel_fbank(torch.from_numpy(buf).to(sess.device), fb, fb.num_frames(buf.shape[-1]))
    embeds, valid = sess.prompt_embeds(samples)
    logits = _llm_first_logits(sess.llm_params, sess.llm_cfg, embeds, valid)
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(embeds[: max(valid, 1)])),
            "logits": summarize(_host(logits[0]))}


def _probe_qwen_aligner(sess, audio) -> dict:
    """Aligner: frontend mel, assembled prompt embeds, and the timestamp-
    head logits at a single ``<timestamp>`` position (no tokenizer needed —
    the probe prompt is text-free: one timestamp slot)."""
    from asr_tpu_torch.models import forced_aligner as fa

    dev = sess.device
    buf, samples = _pad_row(_load_samples(sess, audio, 1.0), sess.max_samples)
    text_ids = torch.tensor([[sess.timestamp_id]], device=dev)
    mel, embeds, valid_len = fa.prompt_for(
        sess.tower_params, sess.llm_params, sess.cfg, torch.from_numpy(buf).to(dev),
        torch.tensor([len(samples)], device=dev),
        sess._embed(sess.audio_start_id), sess._embed(sess.audio_end_id),
        text_ids)
    logits = fa.align_logits(sess.llm_params, sess.head, sess.cfg, embeds, valid_len)
    vl = int(valid_len[0])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(embeds[0, : max(vl, 1)])),
            "logits": summarize(_host(logits[0, max(vl - 1, 0)]))}


# ── streaming families: first-chunk features + first-chunk encoder state +
#    first emitted-token logits ──────────────────────────────────────────────


def _chunks_of(sess, audio, pcm_scale: float, size: int, advance: int,
               limit: int = 16) -> list[np.ndarray]:
    samples = _load_samples(sess, audio, pcm_scale)
    out = []
    pos = 0
    while (pos == 0 or pos + 1 <= len(samples)) and len(out) < limit:
        chunk = np.zeros(size, np.float32)
        part = samples[pos: pos + size]
        chunk[: len(part)] = part
        out.append(chunk)
        pos += advance
    return out


def _probe_paraformer_streaming(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
    from asr_tpu_torch.streaming import paraformer_online as po

    cfg = sess.cfg
    dev = sess.device
    chunks = _chunks_of(sess, audio, 32768.0, cfg.chunk_samples,
                        cfg.chunk_samples)
    fb = cfg.base.fbank
    out = {"frontend": summarize(_host(
        log_mel_fbank(torch.from_numpy(chunks[0]).to(dev)[None], fb,
                      fb.num_frames(cfg.chunk_samples))[0]))}
    state = po.init_state(cfg, sess.params, 1, dev)
    for i, chunk in enumerate(chunks):
        state, fired, count, enc_out = po.encoder_step(
            sess.params, cfg, state, torch.from_numpy(chunk).to(dev)[None])
        if i == 0:
            out["encoder"] = summarize(_host(enc_out[0]))
        n_fired = int(count[0])
        if n_fired > 0:
            _state, logits, _count = po.decoder_step(
                sess.params, cfg, state, enc_out, fired, count,
                return_logits=True)
            out["logits"] = summarize(_host(logits[0, : n_fired]))
            break
    return out


def _probe_xasr_streaming(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
    from asr_tpu_torch.layers.transformer import dense
    from asr_tpu_torch.runtime.streaming_session import snip_edges_false_pad

    zf, cfg = sess.zf, sess.cfg
    dev = sess.device
    samples = _load_samples(sess, audio, 32768.0)
    fbk = cfg.fbank
    padded = snip_edges_false_pad(samples, fbk.win_length, fbk.hop_length)
    window = np.zeros(cfg.window_samples, np.float32)
    part = padded[: cfg.window_samples]
    window[: len(part)] = part
    win = torch.from_numpy(window).to(dev)[None]
    mel = log_mel_fbank(win, fbk, cfg.mel_per_chunk)
    state = zf.init_state(cfg, 1, dev)
    context0 = state["context"]
    state, enc = zf.encoder_step(sess.params, cfg, state, win)
    d = zf.decoder_out(sess.params, cfg, context0)
    logits = dense(torch.tanh(enc[0, 0] + d[0]), sess.params["joiner"]["out"])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc[0])),
            "logits": summarize(_host(logits))}


def _probe_nemotron_streaming(sess, audio) -> dict:
    from asr_tpu_torch.models import nemotron as nm
    from asr_tpu_torch.streaming import nemotron_stream as ns

    cfg = sess.cfg
    dev = sess.device
    chunks = _chunks_of(sess, audio, 1.0, cfg.window_samples,
                        cfg.window_samples, limit=1)
    chunk = torch.from_numpy(chunks[0]).to(dev)[None]
    mel = ns._stream_mel(cfg, chunk)
    blank = cfg.base.blank_id
    state = ns.init_state(cfg, 1, dev)
    state["token"] = torch.full_like(state["token"], blank)
    pid = torch.full((1,), sess.prompt_id, dtype=torch.int64, device=dev)
    state, enc_proj = ns.encoder_step(sess.params, cfg, state, chunk, pid)
    logits, _h, _c = nm.joint_step(
        sess.params, torch.full((1,), blank, dtype=torch.int64, device=dev),
        state["h"][0], state["c"][0], enc_proj[:, 0])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc_proj[0])),
            "logits": summarize(_host(logits[0]))}


def _probe_dolphin_streaming(sess, audio) -> dict:
    from asr_tpu_torch.frontend.kaldi_fbank import log_mel_fbank
    from asr_tpu_torch.layers.transformer import dense

    ds, cfg = sess.ds, sess.cfg
    dev = sess.device
    chunks = _chunks_of(sess, audio, 32768.0, cfg.window_samples,
                        cfg.advance_samples, limit=1)
    window = torch.from_numpy(chunks[0]).to(dev)[None]
    mel = log_mel_fbank(window, cfg.fbank, cfg.window_mel)
    state = ds.init_state(cfg, 1, dev)
    _state, _ctc_ids, enc_out = ds.encoder_step(sess.params, cfg, state, window)
    logits = dense(enc_out, sess.params["ctc"])
    return {"frontend": summarize(_host(mel[0])),
            "encoder": summarize(_host(enc_out[0])),
            "logits": summarize(_host(logits[0]))}


_PROBES = {
    "SenseVoiceSession": _probe_sensevoice,
    "FireRedSession": _probe_firered,
    "WhisperSession": _probe_whisper,
    "ParaformerSession": _probe_paraformer,
    "DolphinSession": _probe_dolphin,
    "ParakeetSession": _probe_parakeet,
    "NemotronSession": _probe_nemotron,
    "FunAsrNanoCtcSession": _probe_funasr_ctc,
    "QwenAsrSession": _probe_qwen_asr,
    "FunAsrNanoLlmSession": _probe_funasr_llm,
    "QwenAlignerSession": _probe_qwen_aligner,
    "ParaformerStreamingSession": _probe_paraformer_streaming,
    "XasrStreamingSession": _probe_xasr_streaming,
    "NemotronStreamingSession": _probe_nemotron_streaming,
    "DolphinStreamingSession": _probe_dolphin_streaming,
}


def capture_probe(sess, audio) -> dict | None:
    """First-window stage snapshots for ``sess``, or None when the family
    has no probe hook (the golden then carries transcripts only)."""
    fn = _PROBES.get(type(sess).__name__)
    if fn is None:
        return None
    with torch.inference_mode():
        out = fn(sess, audio)
    return {k: out[k] for k in STAGE_ORDER if k in out}
