"""Qwen3-ASR: chunk-windowed audio tower + Qwen3 LLM decoder.

Counterpart of ``asr_tpu/models/qwen_asr.py``: Whisper-style 128-bin
log-mel, an audio tower that convolves each 100-frame mel chunk down to 13
tokens (three stride-2 3x3 convs), windowed self-attention over 8-chunk
(104-token) windows with per-window valid-count key masks (bias -128.0, as
the JAX package has it), projection into the LLM embedding space, the
prompt [head | query | suffix | audio | tail] compacted into a static
buffer with padding at the end, and the Qwen3 decoder with greedy /
penalty / sampling decode.

Parameters are the JAX package's pytree as nested dicts and lists of
tensors with the same keys and layouts (conv kernels HWIO, linears
``(in, out)``). The decode loop runs on the host and writes the KV caches
in place. At batch 1, with stacked q4 weights and the ``bf16`` matmul mode,
each decode step is one call of ``ops.fused_decode.fused_decode_step`` (the
hand-written CUDA kernel on CUDA tensors, its plain version on CPU tensors).
Every other LLM (a q2 LLM, whose packed 2-bit leaves do not stack, q8, or
f32) decodes on the per-weight route, each linear one ``quant_dense`` call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from asr_tpu_torch.decode.ar import DecodeConfig, ar_decode, select_token
from asr_tpu_torch.decode.strategies import suppress_tokens
from asr_tpu_torch.frontend.whisper_mel import WhisperMelConfig, log_mel_spectrogram
from asr_tpu_torch.layers import qwen3
from asr_tpu_torch.layers.norms import layer_norm
from asr_tpu_torch.layers.rope import rope_tables
from asr_tpu_torch.layers.transformer import dense, encoder_block
from asr_tpu_torch.models.sensevoice import sinusoid_position_encoding
from asr_tpu_torch.ops.fused_decode import fused_decode_step
from asr_tpu_torch.ops.quant_matmul import _resolve_mm


@dataclasses.dataclass(frozen=True)
class QwenAsrConfig:
    # Audio tower (Qwen3-ASR-0.6B geometry).
    n_mels: int = 128
    tower_dim: int = 1280
    tower_layers: int = 32
    tower_heads: int = 20
    tower_ffn: int = 5120
    downsample_hidden: int = 480
    chunk_frames: int = 100          # mel frames per conv chunk
    tokens_per_chunk: int = 13
    chunks_per_window: int = 8
    output_dim: int = 1024           # LLM hidden
    llm: qwen3.Qwen3Config = qwen3.Qwen3Config()
    eot_id: int = 151645             # <|im_end|>
    sample_rate: int = 16000

    @property
    def tokens_per_window(self) -> int:
        return self.chunks_per_window * self.tokens_per_chunk

    def mel_config(self) -> WhisperMelConfig:
        return WhisperMelConfig(n_mels=self.n_mels, sample_rate=self.sample_rate)


def feat_output_len(frames, chunk: int = 100) -> torch.Tensor:
    """Audio-token count for ``frames`` mel frames (three stride-2 convs per
    ``chunk``-frame chunk, 13 tokens a full chunk)."""
    frames = torch.as_tensor(frames)
    leave = frames % chunk
    f1 = (torch.clamp(leave - 1, min=0) // 2 + 1) * (leave > 0)
    f2 = (torch.clamp(f1 - 1, min=0) // 2 + 1) * (f1 > 0)
    f3 = (torch.clamp(f2 - 1, min=0) // 2 + 1) * (f2 > 0)
    return f3 + (frames // chunk) * 13


def init_tower_params(cfg: QwenAsrConfig, generator: torch.Generator, device=None,
                      dtype: torch.dtype = torch.float32) -> dict:
    """Random-init tower parameters with the JAX package's layout and scales,
    drawn from ``generator`` on its own device and placed on ``device``."""
    device = torch.device(device) if device is not None else generator.device
    d, c = cfg.tower_dim, cfg.downsample_hidden

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

    def norm():
        return {"scale": torch.ones((d,), device=device, dtype=dtype), "bias": zeros(d)}

    def block():
        return {"ln1": norm(), "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                                        "o": lin(d, d)},
                "ln2": norm(), "mlp": {"fc1": lin(d, cfg.tower_ffn), "fc2": lin(cfg.tower_ffn, d)}}

    freq_out = cfg.n_mels
    for _ in range(3):
        freq_out = (freq_out + 1) // 2
    return {
        "conv1": {"w": normal(3, 3, 1, c, std=0.05), "b": zeros(c)},
        "conv2": {"w": normal(3, 3, c, c, std=0.05), "b": zeros(c)},
        "conv3": {"w": normal(3, 3, c, c, std=0.05), "b": zeros(c)},
        "conv_out": lin(c * freq_out, d, bias=False),
        "blocks": [block() for _ in range(cfg.tower_layers)],
        "ln_post": norm(),
        "proj1": lin(d, d),
        "proj2": lin(d, cfg.output_dim),
    }


def _conv2d_s2(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Stride-2, pad-1 3x3 conv on NCHW with the JAX package's HWIO kernel."""
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), stride=2, padding=1)
    return y + p["b"][None, :, None, None]


def encode_audio(tower: dict, cfg: QwenAsrConfig, mel: torch.Tensor,
                 valid_frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mel (B, T, n_mels) -> (audio tokens (B, A_max, output_dim), valid (B,)).

    T must be a multiple of chunk_frames * chunks_per_window; invalid mel
    frames are zeroed. The B utterances become B x num_windows independent
    windows."""
    b, t = mel.shape[0], mel.shape[1]
    dev = mel.device
    chunk = cfg.chunk_frames
    num_chunks = t // chunk
    keep = torch.arange(t, device=dev)[None, :] < valid_frames[:, None]
    mel = torch.where(keep[..., None], mel, torch.zeros((), dtype=mel.dtype, device=dev))

    # (B, T, M) -> chunks (N, 1, M, chunk): NCHW with H = mel bins, W = time
    x = mel.reshape(b * num_chunks, chunk, cfg.n_mels).transpose(1, 2)[:, None]
    for name in ("conv1", "conv2", "conv3"):
        x = F.gelu(_conv2d_s2(x, tower[name]), approximate="none")  # -> (N, C, 16, 13)
    n, c, f, tt = x.shape
    x = x.permute(0, 3, 1, 2).reshape(n, tt, c * f)  # channel-major (C, mel), as JAX flattens
    x = dense(x, tower["conv_out"])
    pe = torch.from_numpy(sinusoid_position_encoding(cfg.tokens_per_chunk, cfg.tower_dim, start=0))
    x = x + pe.to(dev)[None]

    chunk_starts = torch.arange(num_chunks, device=dev) * chunk
    raw_lens = torch.clamp(valid_frames[:, None] - chunk_starts[None, :], 0, chunk)
    aftercnn = feat_output_len(raw_lens, chunk)  # (B, num_chunks)
    cpw = cfg.chunks_per_window
    num_windows = num_chunks // cpw
    tw = cfg.tokens_per_window
    h = x.reshape(b * num_windows, tw, cfg.tower_dim)
    valid_counts = aftercnn.reshape(b * num_windows, cpw).sum(dim=1)
    kpos = torch.arange(tw, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(kpos < valid_counts[:, None], zero, -128.0)[:, None, None, :]
    for p in tower["blocks"]:
        h = encoder_block(h, p, cfg.tower_heads, attn_bias=bias)
    h = layer_norm(h, tower["ln_post"]["scale"], tower["ln_post"]["bias"])
    h = dense(F.gelu(dense(h, tower["proj1"]), approximate="none"), tower["proj2"])
    return h.reshape(b, num_windows * tw, cfg.output_dim), aftercnn.sum(dim=1)


def assemble_prompt(head: torch.Tensor, query: torch.Tensor, suffix: torch.Tensor,
                    audio: torch.Tensor, audio_valid: torch.Tensor,
                    tail: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-compact [head|query|suffix|audio_valid|tail] into a static
    buffer with padding at the END. All inputs (B, L_i, H); per-sample
    ``audio_valid`` (B,) compacts each row independently."""
    base = head.shape[1] + query.shape[1] + suffix.shape[1]
    a_max = audio.shape[1]
    full = torch.cat([head, query, suffix, audio, tail], dim=1)
    lf = full.shape[1]
    a = audio_valid.to(torch.int64)[:, None]
    idx = torch.arange(lf, device=full.device)[None, :]
    src = torch.where(idx < base + a, idx, torch.clamp(idx + (a_max - a), max=lf - 1))
    embeds = torch.gather(full, 1, src[..., None].expand(-1, -1, full.shape[2]))
    valid = base + audio_valid.to(torch.int64) + tail.shape[1]
    return embeds, valid


def left_prefill(llm_params: dict, cfg: QwenAsrConfig, embeds: torch.Tensor,
                 valid_len: torch.Tensor, max_new_tokens: int):
    """Re-pack END-padded prompt embeds (B, L, H) LEFT-padded and prefill
    them: each row's valid tokens end at slot L, so rows of unequal length
    decode in lockstep from one scalar position; the RoPE row of a slot is
    that of its logical position (slot - shift), and pad slots are masked
    out of every attention.

    Returns (state, shift (B,), t_max, logits (B, V) of slot L - 1): the KV
    caches hold t_max = ceil8(L + max_new_tokens + 1) rows.
    """
    lcfg = cfg.llm
    b, lf, hdim = embeds.shape
    dev = embeds.device
    shift = lf - valid_len.to(device=dev, dtype=torch.int64)
    idx = torch.arange(lf, device=dev)[None, :]
    src = torch.clamp(idx - shift[:, None], 0, lf - 1)
    embeds = torch.gather(embeds, 1, src[..., None].expand(-1, -1, hdim))
    t_max = -(-(lf + max_new_tokens + 1) // 8) * 8
    state = qwen3.make_kv_state(lcfg, b, t_max, embeds.dtype, dev)
    bias = qwen3.left_prefill_bias(shift, lf, t_max)
    hidden, state = qwen3.decoder_pass(llm_params, lcfg, embeds, state, 0, bias, pos_offset=shift)
    return state, shift, t_max, qwen3.logits_from_hidden(llm_params, lcfg, hidden[:, -1])


def transcribe_embeds(llm_params: dict, cfg: QwenAsrConfig, embeds: torch.Tensor,
                      valid_len: torch.Tensor, decode_cfg: DecodeConfig,
                      generator: torch.Generator | None = None, stacked: dict | None = None):
    """Prompt embeds (B, L, H) (valid prefix + END padding, as
    :func:`assemble_prompt` gives them) + valid lengths -> generated ids,
    decoded after :func:`left_prefill`. Generated ids land at slots
    ``[L, L + counts)``.

    The fused route (one ``fused_decode_step`` call a step, bf16 caches)
    runs at batch 1 with f32 embeds, stacked weights and the ``bf16`` matmul
    mode; with the head in the stacked weights the step returns the logits,
    otherwise the final-normalized hidden goes through the tied head
    (``logits_from_normalized``).

    Returns (tokens (B, L + max_new + 1), counts (B,), prompt_start (B,),
    always L).
    """
    lcfg = cfg.llm
    b, lf = embeds.shape[:2]
    dev = embeds.device
    state, shift, t_max, logits0 = left_prefill(llm_params, cfg, embeds, valid_len,
                                                decode_cfg.max_new_tokens)
    use_fused = (stacked is not None and b == 1 and embeds.dtype == torch.float32
                 and _resolve_mm(None) == "bf16")
    logits0 = suppress_tokens(logits0.to(torch.float32), decode_cfg.suppress_ids)
    buf = torch.zeros((b, lf + decode_cfg.max_new_tokens + 1), dtype=torch.int64, device=dev)
    first = select_token(logits0, buf, lf, decode_cfg, generator, history_start=lf)
    starts = torch.full((b,), lf, dtype=torch.int64, device=dev)
    embed = llm_params["embed"]

    if use_fused:
        kvw = lcfg.num_kv_heads * lcfg.head_dim
        # (NL, T, kvw) bf16 stacks, made once; the step writes row pos in place.
        kc = torch.stack([ls["k"][0].reshape(t_max, kvw) for ls in state["layers"]]).to(torch.bfloat16)
        vc = torch.stack([ls["v"][0].reshape(t_max, kvw) for ls in state["layers"]]).to(torch.bfloat16)
        del state
        cs = torch.from_numpy(rope_tables(t_max, lcfg.head_dim, lcfg.rope_theta)).to(dev)
        sh0 = int(shift[0])

        def fused_step(st, token, pos):
            x = embed[token[:, 0]].to(torch.float32)
            logical = min(max(pos - sh0, 0), t_max - 1)
            h1, lg, _, _ = fused_decode_step(stacked, lcfg, x, kc, vc, pos, sh0,
                                             cs[0, logical][None], cs[1, logical][None])
            if lg is not None:
                return lg[:, : lcfg.vocab_size], st  # the head ran in the kernel
            return qwen3.logits_from_normalized(llm_params, lcfg, h1), st

        tokens, counts = ar_decode(fused_step, None, lf, first, buf, decode_cfg, generator)
        return tokens, counts, starts

    def step(st, token, pos):
        emb = embed[token].to(embeds.dtype)
        sbias = qwen3.left_step_bias(shift, pos, t_max)
        h, st = qwen3.decoder_pass(llm_params, lcfg, emb, st, pos, sbias, pos_offset=shift)
        return qwen3.logits_from_hidden(llm_params, lcfg, h[:, -1]), st

    tokens, counts = ar_decode(step, state, lf, first, buf, decode_cfg, generator)
    return tokens, counts, starts


def prompt_embeds(tower_params: dict, llm_params: dict, cfg: QwenAsrConfig, audio: torch.Tensor,
                  valid_samples: torch.Tensor, prompt_ids: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw audio (B, S) in [-1, 1] + prompt id tensors -> compacted prompt
    embeds (B, L, H) + valid lengths (B,) in the :func:`assemble_prompt`
    layout."""
    mel_cfg = cfg.mel_config()
    mel = log_mel_spectrogram(audio, mel_cfg)
    window_frames = cfg.chunk_frames * cfg.chunks_per_window
    pad = (-mel.shape[1]) % window_frames
    if pad:
        mel = F.pad(mel, (0, 0, 0, pad))
    valid_frames = torch.div(valid_samples, mel_cfg.hop_length, rounding_mode="floor")
    audio_tokens, audio_valid = encode_audio(tower_params, cfg, mel, valid_frames.to(torch.int64))

    def emb(ids):
        return llm_params["embed"][ids.to(audio_tokens.device)].to(audio_tokens.dtype)

    return assemble_prompt(emb(prompt_ids["head"]), emb(prompt_ids["query"]),
                           emb(prompt_ids["suffix"]), audio_tokens, audio_valid,
                           emb(prompt_ids["tail"]))


def forward(tower_params: dict, llm_params: dict, cfg: QwenAsrConfig, audio: torch.Tensor,
            valid_samples: torch.Tensor, prompt_ids: dict, decode_cfg: DecodeConfig,
            generator: torch.Generator | None = None, stacked: dict | None = None):
    """Raw audio (B, S) in [-1, 1] + prompt id tensors {"head", "query",
    "suffix", "tail"} (each (B, L_i)) -> (tokens, counts, prompt_start), as
    :func:`transcribe_embeds` returns them."""
    embeds, valid_len = prompt_embeds(tower_params, llm_params, cfg, audio, valid_samples,
                                      prompt_ids)
    return transcribe_embeds(llm_params, cfg, embeds, valid_len, decode_cfg, generator,
                             stacked=stacked)
