"""Whisper: AR encoder-decoder with a fixed-shape KV-cache decode.

Counterpart of ``asr_tpu/models/whisper.py``: log-mel front end, encoder
(two convs + pre-LN attention stack), decoder with per-layer self-KV caches
and precomputed cross-KV, language detection and the no-speech probe from
the [SOT] step, suppress / begin-suppress biasing, and greedy / penalty /
sampling decode.

Parameters are the JAX package's pytree as nested dicts and lists of
tensors with the same keys; linear weights are ``(in, out)`` and may be
``QuantizedLinear`` leaves, and the tied ``decoder/embed`` may be a
``QuantizedEmbedding``. Positions (``pos``) are Python ints on the per-weight route: the decode
loop runs on the host and the caches are written in place.

At batch 1, ``transcribe_window(stacked=...)`` decodes through the
session's ``ops.fused_aed_step.FusedAedDecoder`` (:func:`fused_decoder`),
every step one call of the hand-written CUDA step kernel on a card (its
plain version on the CPU). Greedy decode there keeps the position on the
device and replays one CUDA graph a token; penalty and sampling run
``ar_decode`` over the step with the position on the host.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.ar import DecodeConfig, ar_decode, select_token
from asr_tpu_torch.decode.strategies import suppress_tokens
from asr_tpu_torch.frontend.whisper_mel import WhisperMelConfig, log_mel_spectrogram
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.transformer import cross_kv, decoder_block, encoder_block
from asr_tpu_torch.quant.quantize import embedding_logits
from asr_tpu_torch.runtime.profiling import annotate


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51866          # large-v3 / turbo
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 4          # turbo; 32 for large-v3
    num_heads: int = 20
    ffn_dim: int = 5120
    n_mels: int = 128
    max_source_positions: int = 1500
    max_target_positions: int = 448
    sample_rate: int = 16000
    # Special token ids (large-v3 family defaults).
    sot_id: int = 50258
    eot_id: int = 50257
    no_speech_id: int = 50363
    no_timestamps_id: int = 50364
    transcribe_id: int = 50360
    translate_id: int = 50359
    first_language_id: int = 50259
    num_languages: int = 100
    # KV-cache STORAGE dtype: None = the encoder's dtype; "bfloat16" halves
    # the caches while compute stays f32.
    kv_dtype: str | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def mel_config(self) -> WhisperMelConfig:
        return WhisperMelConfig(n_mels=self.n_mels, sample_rate=self.sample_rate)


def init_params(cfg: WhisperConfig, generator: torch.Generator, device=None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameters with the checkpoint's layout and the JAX
    package's scales, drawn from ``generator`` on its own device and placed
    on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    d, f = cfg.d_model, cfg.ffn_dim

    def normal(*shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device) * std
        return t.to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=dtype)

    def lin(i, o, bias=True):
        p = {"w": normal(i, o, std=i ** -0.5)}
        if bias:
            p["b"] = zeros(o)
        return p

    def ln():
        return {"scale": torch.ones((d,), device=device, dtype=dtype), "bias": zeros(d)}

    def attn():
        return {"q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d), "o": lin(d, d)}

    def mlp():
        return {"fc1": lin(d, f), "fc2": lin(f, d)}

    def enc_block():
        return {"ln1": ln(), "attn": attn(), "ln2": ln(), "mlp": mlp()}

    def dec_block():
        return {"ln1": ln(), "attn": attn(), "ln_cross": ln(), "cross": attn(), "ln2": ln(),
                "mlp": mlp()}

    return {
        "encoder": {
            "conv1": {"w": normal(3, cfg.n_mels, d, std=0.02), "b": zeros(d)},
            "conv2": {"w": normal(3, d, d, std=0.02), "b": zeros(d)},
            "pos": normal(cfg.max_source_positions, d, std=0.02),
            "blocks": [enc_block() for _ in range(cfg.encoder_layers)],
            "ln_post": ln(),
        },
        "decoder": {
            "embed": normal(cfg.vocab_size, d, std=0.02),
            "pos": normal(cfg.max_target_positions, d, std=0.02),
            "blocks": [dec_block() for _ in range(cfg.decoder_layers)],
            "ln": ln(),
        },
    }


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, T, Cin) conv with kernel (K, Cin, Cout) and padding 1 -- JAX's
    NHC / HIO layout at the boundary, ``F.conv1d`` inside."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=1)
    return y.transpose(1, 2) + b


def encode(params: dict, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) -> encoder states (B, T // 2, d_model)."""
    e = params["encoder"]
    with annotate("asr.whisper.encode"):
        mel = mel.to(e["conv1"]["w"].dtype)
        x = F.gelu(conv1d(mel, e["conv1"]["w"], e["conv1"]["b"], 1), approximate="none")
        x = F.gelu(conv1d(x, e["conv2"]["w"], e["conv2"]["b"], 2), approximate="none")
        x = x + e["pos"][: x.shape[1]]
        for p in e["blocks"]:
            x = encoder_block(x, p, cfg.num_heads)
        return layer_norm(x, e["ln_post"]["scale"], e["ln_post"]["bias"])


def _cache_dtype(cfg: WhisperConfig, enc: torch.Tensor) -> torch.dtype:
    return getattr(torch, cfg.kv_dtype) if cfg.kv_dtype else enc.dtype


def make_state(params: dict, cfg: WhisperConfig, enc: torch.Tensor) -> dict:
    """Decode state: precomputed cross-KV + zeroed self-KV caches
    ``(B, T_max, H, Dh)``, stored in ``cfg.kv_dtype`` (compute stays f32).
    On a tensor-parallel rank H is the rank's heads (those of its cross-KV)."""
    b = enc.shape[0]
    dtype = _cache_dtype(cfg, enc)
    layers = []
    for p in params["decoder"]["blocks"]:
        ck, cv = cross_kv(enc, p, cfg.num_heads)
        shape = (b, cfg.max_target_positions, ck.shape[2], cfg.head_dim)
        layers.append({
            "cross_k": ck.to(dtype), "cross_v": cv.to(dtype),
            "self_k": torch.zeros(shape, dtype=dtype, device=enc.device),
            "self_v": torch.zeros(shape, dtype=dtype, device=enc.device),
        })
    return {"layers": tuple(layers)}


def _decoder_pass(params: dict, cfg: WhisperConfig, state: dict, tokens: torch.Tensor,
                  pos: int) -> tuple[torch.Tensor, dict]:
    """Run S tokens through every decoder block at ``pos``; the caches in
    ``state`` take the new rows in place. Returns (logits (B, S, V), state)."""
    dec = params["decoder"]
    s = tokens.shape[1]
    x = (dec["embed"][tokens] + dec["pos"][pos : pos + s]).to(dec["embed"].dtype)
    for p, ls in zip(dec["blocks"], state["layers"]):
        x, _, _ = decoder_block(x, p, cfg.num_heads, ls["self_k"], ls["self_v"], pos,
                                ls["cross_k"], ls["cross_v"])
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    return embedding_logits(dec["embed"], x), state


def prefill(params: dict, cfg: WhisperConfig, state: dict,
            tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Prefill the prompt. tokens (B, P) -> (last-position logits (B, V), state)."""
    logits, state = _decoder_pass(params, cfg, state, tokens, 0)
    return logits[:, -1], state


def step(params: dict, cfg: WhisperConfig, state: dict, token: torch.Tensor, pos: int):
    logits, state = _decoder_pass(params, cfg, state, token, pos)
    return logits[:, -1], state


def detect_language(logits_sot: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Language id: argmax over the language-token block of the [SOT] logits."""
    block = logits_sot[..., cfg.first_language_id : cfg.first_language_id + cfg.num_languages]
    return torch.argmax(block, dim=-1) + cfg.first_language_id


def no_speech_prob(logits_sot: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """P(<|nospeech|>) from the un-suppressed [SOT] logits."""
    return torch.softmax(logits_sot.to(torch.float32), dim=-1)[..., cfg.no_speech_id]


def prefill_window(params: dict, cfg: WhisperConfig, mel: torch.Tensor, prompt: torch.Tensor,
                   decode_cfg: DecodeConfig, begin_suppress_ids: tuple[int, ...] = ()) -> dict:
    """Encoder + [SOT] probe + prompt prefill for one window.

    Returns dict: ``state`` (prefilled), ``logits0`` (B, V) suppressed and
    begin-suppressed prefill logits, ``language`` (B,), ``no_speech_prob``
    (B,) and ``prompt`` (a lang slot of -1 replaced by the detected id)."""
    enc = encode(params, cfg, mel)
    b = prompt.shape[0]
    with annotate("asr.whisper.probe"):
        probe_state = make_state(params, cfg, enc)
        sot = torch.full((b, 1), cfg.sot_id, dtype=torch.int64, device=enc.device)
        probe_logits, _ = prefill(params, cfg, probe_state, sot)
        del probe_state
        language = detect_language(probe_logits, cfg)
        nsp = no_speech_prob(probe_logits, cfg)
    with annotate("asr.whisper.prompt"):
        prompt = torch.where(prompt == -1, language[:, None], prompt.to(torch.int64))
        state = make_state(params, cfg, enc)
        logits0, state = prefill(params, cfg, state, prompt)
        logits0 = suppress_tokens(logits0.to(torch.float32), decode_cfg.suppress_ids)
        logits0 = suppress_tokens(logits0, begin_suppress_ids)
    return {"state": state, "logits0": logits0, "language": language,
            "no_speech_prob": nsp, "prompt": prompt}


def transcribe_window(
    params: dict,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    prompt: torch.Tensor,
    decode_cfg: DecodeConfig,
    begin_suppress_ids: tuple[int, ...] = (),
    generator: torch.Generator | None = None,
    stacked=None,
) -> dict:
    """Full window pipeline: encode -> probe([SOT]) -> prefill -> decode loop.

    Args:
      mel: (B, T, n_mels) log-mel features.
      prompt: (B, P) full prompt, e.g. [SOT, lang, task, notimestamps]; a
        lang slot of -1 is replaced by the detected language.
      stacked: the session's ``ops.fused_aed_step.FusedAedDecoder``
        (:func:`fused_decoder`), or stacked weights from
        ``ops.fused_aed_step.stack_whisper_step_params`` (a decoder is made
        for this call). With it, batch-1 decode runs on the fused step
        (greedy: one CUDA graph replay a token on a card); otherwise every
        step runs the per-weight ``step``.
      generator: the sampling strategy's randomness.

    Returns dict: tokens (B, T_total), counts (B,), language (B,),
    no_speech_prob (B,).
    """
    b, p_len = prompt.shape
    pre = prefill_window(params, cfg, mel, prompt, decode_cfg, begin_suppress_ids)
    state, logits0, prompt = pre["state"], pre["logits0"], pre["prompt"]
    language, nsp = pre["language"], pre["no_speech_prob"]
    del pre
    t_total = p_len + decode_cfg.max_new_tokens + 1
    buf = torch.zeros((b, t_total), dtype=torch.int64, device=logits0.device)
    buf[:, :p_len] = prompt
    first = select_token(logits0, buf, p_len, decode_cfg, generator, history_start=p_len)

    if stacked is not None and b == 1:
        from asr_tpu_torch.ops.fused_aed_step import FusedAedDecoder

        decoder = stacked if isinstance(stacked, FusedAedDecoder) else fused_decoder(params, cfg, stacked)
        tokens, counts = decoder.decode(state["layers"], p_len, first, buf, decode_cfg, generator)
    else:
        def step_fn(st, token, pos):
            return step(params, cfg, st, token, pos)

        tokens, counts = ar_decode(step_fn, state, p_len, first, buf, decode_cfg, generator)
    return {"tokens": tokens, "counts": counts, "language": language, "no_speech_prob": nsp}


def fused_decoder(params: dict, cfg: WhisperConfig, stacked: dict):
    """The ``ops.fused_aed_step.FusedAedDecoder`` of Whisper's stacked q8
    decoder: input row ``embed[token] + pos[pos]`` (unscaled embedding,
    learned positions)."""
    from asr_tpu_torch.ops.fused_aed_step import AedGeom, FusedAedDecoder, position_rows

    dec = params["decoder"]

    def input_row(token, pos):
        return dec["embed"][token] + position_rows(dec["pos"], pos)

    return FusedAedDecoder(stacked, AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads), cfg.vocab_size,
                           input_row, span="asr.whisper.stack")


def mel_for_audio(cfg: WhisperConfig, audio: torch.Tensor) -> torch.Tensor:
    """(B, 480000) [-1, 1] audio -> (B, 3000, n_mels)."""
    with annotate("asr.whisper.mel"):
        return log_mel_spectrogram(audio, cfg.mel_config())
