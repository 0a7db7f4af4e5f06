"""Whisper-Large-v3-Turbo through the port's ``WhisperSession``, alone
(``transcribe``: batch 1, the fused step) or behind its
``ContinuousSessionServer`` (``submit``: the multi-slot step).

Weights are drawn on the device from the seed (one generator draw, the
checkpoint's layout and the port's init scales, small random biases and
LayerNorm parameters so that each reaches the comparison), quantized by the
port's ``quantize_pytree`` with the tied embedding, as the serving route
builds them, and handed to the session in memory; the session stacks the
q8 decoder for the step kernels itself.

The reference gets the same f32 weights (drawn again from the seed after
the window) and the same audio, works out its own quantized weights,
detects the language and teacher-forces the served tokens
(``reference/judge.ar_widest_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.kernels import aed_step
from benchmark.models import Done, StampedEvent, done, own, seeded_normal, sync

N_PROMPT = 4  # [SOT, language, task, notimestamps]


def weight_shapes(cfg: dict) -> dict[str, tuple]:
    d, f, m = cfg["d_model"], cfg["ffn_dim"], cfg["n_mels"]

    def attn(p):
        return {p + "q.w": (d, d), p + "q.b": (d,), p + "k.w": (d, d), p + "v.w": (d, d),
                p + "v.b": (d,), p + "o.w": (d, d), p + "o.b": (d,)}

    def ln(p):
        return {p + "scale": (d,), p + "bias": (d,)}

    def mlp(p):
        return {p + "fc1.w": (d, f), p + "fc1.b": (f,), p + "fc2.w": (f, d), p + "fc2.b": (d,)}

    s = {"encoder.conv1.w": (3, m, d), "encoder.conv1.b": (d,), "encoder.conv2.w": (3, d, d),
         "encoder.conv2.b": (d,), "encoder.pos": (cfg["max_source_positions"], d)}
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.blocks.{i}."
        s.update({**ln(p + "ln1."), **attn(p + "attn."), **ln(p + "ln2."), **mlp(p + "mlp.")})
    s.update(ln("encoder.ln_post."))
    s.update({"decoder.embed": (cfg["vocab_size"], d), "decoder.pos": (cfg["max_target_positions"], d)})
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.blocks.{i}."
        s.update({**ln(p + "ln1."), **attn(p + "attn."), **ln(p + "ln_cross."),
                  **attn(p + "cross."), **ln(p + "ln2."), **mlp(p + "mlp.")})
    s.update(ln("decoder.ln."))
    return s


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The f32 tree (the port's layout) from the seed, on ``device``."""
    flat = seeded_normal(seed, device, weight_shapes(cfg))
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        if leaf == "w" and path[-1] in ("conv1", "conv2"):
            t.mul_(0.02)
        elif leaf == "w":
            t.mul_(t.shape[0] ** -0.5)
        elif leaf in ("embed", "pos"):
            t.mul_(0.02)
        elif leaf == "scale":
            t.mul_(0.05).add_(1.0)
        else:  # biases
            t.mul_(0.02)
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = t
    for part in ("encoder", "decoder"):
        blocks = tree[part]["blocks"]
        tree[part]["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


def geometry(cfg: dict) -> dict:
    return {"d": cfg["d_model"], "f": cfg["ffn_dim"], "nl": cfg["decoder_layers"],
            "v": cfg["vocab_size"]}


def token_flops(cfg: dict, self_rows: int) -> float:
    return aed_step.cost(slots=[(self_rows, cfg["max_source_positions"])], **geometry(cfg))[1]


def window_flops(cfg: dict) -> float:
    """The encoder of one 30 s window and its cross k, v."""
    d, f, t = cfg["d_model"], cfg["ffn_dim"], cfg["max_source_positions"]
    conv = 2.0 * 2 * t * 3 * cfg["n_mels"] * d + 2.0 * t * 3 * d * d
    enc = cfg["encoder_layers"] * (2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d)
    return conv + enc + cfg["decoder_layers"] * 2 * 2.0 * t * d * d


def request_flops(cfg: dict, n_tokens: int) -> float:
    """A window, its [SOT] probe, the prompt and ``n_tokens`` decoded."""
    steps = max(n_tokens, 0)
    flops = window_flops(cfg) + token_flops(cfg, 1)
    flops += sum(token_flops(cfg, r) for r in range(1, N_PROMPT + 1))
    return flops + sum(token_flops(cfg, N_PROMPT + 1 + j) for j in range(steps))


def prefill_int8_calls(cfg: dict, block: int) -> list[tuple]:
    """The int8 calls of one ``continuous_prefill`` / window prefill: the
    encoder, cross k and v (for the probe's state and the prompt's), the
    [SOT] probe at M = 1 and the prompt at M = 4 (each 8 linears a layer
    and the tied head)."""
    d, f, t, v = cfg["d_model"], cfg["ffn_dim"], cfg["max_source_positions"], cfg["vocab_size"]
    el, dl = cfg["encoder_layers"], cfg["decoder_layers"]
    calls = [(t, d, d, block, 4 * el), (t, d, f, block, el), (t, f, d, block, el),
             (t, d, d, block, 2 * 2 * dl)]
    for m in (1, N_PROMPT):
        calls += [(m, d, d, block, 6 * dl), (m, d, f, block, dl), (m, f, d, block, dl),
                  (m, d, v, block, 1)]
    return calls


class _Served:
    """The handle of a request submitted to the continuous server."""

    def __init__(self, req, notify=None):
        self.req = req
        old = req.event
        req.event = StampedEvent()
        if notify is not None:
            req.event.notify = lambda _event: notify(self)
        if old.is_set():
            req.event.set()

    def wait(self, timeout=None) -> bool:
        return self.req.event.wait(timeout)

    @property
    def t_done(self) -> float:
        return self.req.event.t_set

    @property
    def ok(self) -> bool:
        return self.req.event.is_set() and self.req.error is None

    @property
    def error(self):
        return self.req.error

    @property
    def out(self) -> dict:
        return {"ids": self.req.ids, "queue_wait": self.req.t_admit - self.req.t_enqueue}


class Target:
    """A ``WhisperSession`` on the card and, for the ``continuous`` entry,
    its ``ContinuousSessionServer``."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        from asr_tpu_torch.models.whisper import WhisperConfig
        from asr_tpu_torch.ops import fused_aed_multi as fm
        from asr_tpu_torch.ops import fused_aed_step as fs
        from asr_tpu_torch.ops import quant_matmul as qm
        from asr_tpu_torch.quant.quantize import quantize_pytree
        from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig

        self.cfg, self.mix, self.seed, self.device, self.spans = cfg, mix, seed, device, spans
        self.qm, self.fs, self.fm = qm, fs, fm
        q, sess = cfg["quant"], cfg["session"]
        qm.set_quant_config(mm=q["mm"])
        keys = ("vocab_size", "d_model", "encoder_layers", "decoder_layers", "num_heads", "ffn_dim",
                "n_mels", "max_source_positions", "max_target_positions", "sample_rate", "sot_id",
                "eot_id", "no_speech_id", "no_timestamps_id", "transcribe_id", "translate_id",
                "first_language_id", "num_languages")
        wcfg = WhisperConfig(**{k: cfg[k] for k in keys})
        params = make_weights(cfg, seed, device)
        params = own(quantize_pytree(params, bits=q["bits"], block=q["block"],
                                     refine_iters=q["refine"], quantize_embeddings=True))
        self.budget = int(mix["max_new_tokens"])
        scfg = WhisperSessionConfig(
            language=sess["language"], max_new_tokens=self.budget,
            no_speech_threshold=sess["no_speech_threshold"],
            suppress_ids=tuple(sess["suppress_ids"]),
            begin_suppress_ids=tuple(sess["begin_suppress_ids"]))
        self.session = WhisperSession(params, wcfg, session_cfg=scfg)
        self.sample_rate = cfg["sample_rate"]
        self.scale = 0.1  # [-1, 1] PCM: noise at a tenth of full scale
        self.entry = mix["entry"]
        # the server's driver thread launches its device work: it starts and
        # stops the profile itself (tracing.Profiler)
        self.profile_in_worker = self.entry == "continuous"
        self.server = None
        if spans.enabled:
            self._instrument()
        if self.entry == "continuous":
            from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer

            srv = mix["server"]
            self.server = ContinuousSessionServer(self.session, n_slots=srv["n_slots"],
                                                  kv_dtype=srv["kv_dtype"], warmup=True)

    # ── benchmark-side spans around the program's entries (traced runs) ──
    def _instrument(self) -> None:
        calls = prefill_int8_calls(self.cfg, self.cfg["quant"]["block"])
        real = self.session.continuous_prefill
        qm, spans, dev = self.qm, self.spans, self.device

        def prefill(samples, language=None):
            with spans.span("prefill", sync=lambda: sync(dev), int8_calls=calls) as rec:
                l0 = qm.LAUNCHES
                out = real(samples, language=language)
                rec["int8_launches"] = qm.LAUNCHES - l0
            return out

        self.session.continuous_prefill = prefill

    def _instrument_batcher(self) -> None:
        from asr_tpu_torch.parallel import aed_batcher

        real = aed_batcher.fused_aed_step_multi
        batcher, spans, fm = self.server.batcher, self.spans, self.fm
        tc = self.cfg["max_source_positions"]

        def step(*args, **kw):
            slots = [(N_PROMPT + len(batcher._gen_host[i]), tc)
                     for i in range(batcher.n_slots) if batcher._active_host[i]]
            with spans.span("aed_multi", slots=slots) as rec:
                l0 = fm.LAUNCHES
                out = real(*args, **kw)
                rec["launches"] = fm.LAUNCHES - l0
            return out

        aed_batcher.fused_aed_step_multi = step
        self._restore = (aed_batcher, real)

    def warmup(self, traffic) -> None:
        """The cell's shapes: two requests end to end (a 30 s window each;
        the step at every position of the budget)."""
        for _ in range(2):
            h = self.submit(traffic.next())
            h.wait(None)
            if not h.ok:
                raise RuntimeError(f"warm-up request failed: {h.error!r}")
        sync(self.device)
        if self.server is not None and self.spans.enabled:
            self._instrument_batcher()

    def submit(self, req, notify=None):
        if self.server is not None:
            try:
                return _Served(self.server.submit(req.samples), notify)
            except Exception as exc:  # the server refused it: a failed request
                return done(Done(error=exc), notify)
        try:
            with self.spans.span("request") as rec:
                s0 = self.fs.LAUNCHES
                res = self.session.transcribe(req.samples)
                rec["step_launches"] = self.fs.LAUNCHES - s0
                steps = min(len(res.token_ids), self.budget)
                rec["steps"] = [[(N_PROMPT + 1 + j, self.cfg["max_source_positions"])]
                                for j in range(steps)]
            return done(Done({"ids": res.token_ids, "elapsed": res.elapsed_seconds}), notify)
        except Exception as exc:  # a failed request: counted, and no answer
            return done(Done(error=exc), notify)

    def work_flops(self, out: dict) -> float:
        return request_flops(self.cfg, min(len(out["ids"]), self.budget))

    def counters(self) -> dict:
        c = {"int8_launches": self.qm.LAUNCHES, "step_launches": self.fs.LAUNCHES,
             "multi_launches": self.fm.LAUNCHES}
        if self.server is not None:
            srv = self.server
            with srv._stats_lock:
                c.update(steps=srv._steps, step_time=srv._step_time, tokens=srv._tokens_generated,
                         served=srv._requests_served)
        return c

    def close(self) -> None:
        if getattr(self, "_restore", None):
            mod, real = self._restore
            mod.fused_aed_step_multi = real
        if self.server is not None:
            self.server.close()
        self.server = None
        self.session = None

    # ── the comparison with the reference ────────────────────────────────
    def judge(self, requests: list, outs: list, bits_control: int | None = None) -> list[dict]:
        """Readings of the served tokens of ``requests`` against the
        reference at the configuration's bit width; with ``bits_control``,
        the widest gap of the tokens the reference at that width puts first
        at the same positions."""
        from benchmark.reference import frontend, judge, whisper as ref

        cfg, q = self.cfg, self.cfg["quant"]
        f32 = make_weights(cfg, self.seed, self.device)
        refp = ref.quantize(f32, q["bits"], q["block"], q["refine"])
        ctl = ref.quantize(f32, bits_control, q["block"], q["refine"]) if bits_control else None
        del f32
        rcfg = {"num_heads": cfg["num_heads"]}
        cap = self.budget + 1
        lang0 = cfg["first_language_id"]
        window = int(30 * cfg["sample_rate"])
        readings = []
        with torch.inference_mode():
            for req, out in zip(requests, outs):
                buf = np.zeros((1, window), np.float32)
                s = req.samples[:window]
                buf[0, : len(s)] = s
                mel = frontend.whisper_log_mel(torch.from_numpy(buf).to(self.device),
                                               n_mels=cfg["n_mels"])
                enc = ref.encode(refp, rcfg, mel)
                sot = torch.tensor([[cfg["sot_id"]]], device=self.device)
                probe = ref.decoder_logits(refp, rcfg, enc, sot)[0, 0]
                block = probe[lang0 : lang0 + cfg["num_languages"]]
                lang_gap = block.max() - block
                served = list(out["ids"]) + ([cfg["eot_id"]] if len(out["ids"]) < cap else [])
                best = None
                for c in torch.argsort(lang_gap)[:3].tolist():
                    g_lang = float(lang_gap[c])
                    if best is not None and g_lang >= best[0]:
                        break
                    toks = [cfg["sot_id"], lang0 + c, cfg["transcribe_id"], cfg["no_timestamps_id"]]
                    seq = torch.tensor([toks + list(out["ids"])], device=self.device)
                    logits = ref.decoder_logits(refp, rcfg, enc, seq)[0]
                    gap = max(g_lang, judge.ar_widest_gap(logits, N_PROMPT - 1, served))
                    if best is None or gap < best[0]:
                        best = (gap, seq, logits)
                got = {"widest_gap": best[0], "tokens": len(out["ids"]),
                       "audio_s": req.audio_seconds}
                if ctl is not None:
                    enc_c = ref.encode(ctl, rcfg, mel)
                    probe_c = ref.decoder_logits(ctl, rcfg, enc_c, sot)[0, 0]
                    c_lang = int(probe_c[lang0 : lang0 + cfg["num_languages"]].argmax())
                    seq, logits = best[1], best[2]
                    lc = ref.decoder_logits(ctl, rcfg, enc_c, seq)[0]
                    rows = slice(N_PROMPT - 1, N_PROMPT - 1 + len(served))
                    picks = lc[rows].argmax(-1).tolist()
                    got["control_gap"] = max(float(lang_gap[c_lang]),
                                             judge.ar_widest_gap(logits, N_PROMPT - 1, picks))
                readings.append(got)
        return readings


def build(cfg: dict, mix: dict, seed: int, device, spans) -> Target:
    return Target(cfg, mix, seed, device, spans)
