"""SenseVoiceSmall through the port's ``SenseVoiceSession``.

Weights are drawn on the device from the seed (one generator draw, the
checkpoint's layout and init scales, small random biases, LayerNorm and
CMVN parameters so that each reaches the comparison), quantized by the
port's ``quantize_pytree`` as its serving route does, and handed to the
session in memory. Each request is one ``transcribe`` call: the recording
cut into windows, padded to a power-of-two batch, one forward.

The reference gets the same f32 weights (drawn again from the seed after
the window) and the same audio, works out its own quantized weights, and
judges the served ids (``reference/judge.ctc_widest_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.models import Done, done, own, seeded_normal, sync

WIN, HOP = 400, 160
N_PROMPT = 4
N_LANGUAGES, N_SYSTEM = 7, 3


def rows_per_window(cfg: dict) -> int:
    frames = (int(cfg["session"]["window_seconds"] * cfg["sample_rate"]) - WIN) // HOP + 1
    return -(-frames // cfg["lfr_n"]) + N_PROMPT


def linears(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of every linear of one forward, in order."""
    h, f, feat = cfg["hidden"], cfg["ffn_dim"], cfg["n_mels"] * cfg["lfr_m"]
    n_blocks = cfg["num_encoders0"] + cfg["num_encoders"] + cfg["num_tp_encoders"]
    out = []
    for i in range(n_blocks):
        out += [(feat if i < cfg["num_encoders0"] else h, 3 * h), (h, h), (h, f), (f, h)]
    return out + [(h, cfg["vocab_size"])]


def window_flops(cfg: dict) -> float:
    """Operations of one window: the linears and attention's scores and P.V."""
    r = rows_per_window(cfg)
    n_blocks = cfg["num_encoders0"] + cfg["num_encoders"] + cfg["num_tp_encoders"]
    return (2.0 * r * sum(k * n for k, n in linears(cfg))
            + n_blocks * 4.0 * r * r * cfg["hidden"])


def weight_shapes(cfg: dict) -> dict[str, tuple]:
    h, f, feat = cfg["hidden"], cfg["ffn_dim"], cfg["n_mels"] * cfg["lfr_m"]
    shapes = {"language_embed": (N_LANGUAGES, feat), "system_embed": (N_SYSTEM, feat),
              "cmvn_means": (feat,), "cmvn_istd": (feat,), "ctc.w": (h, cfg["vocab_size"]),
              "ctc.b": (cfg["vocab_size"],)}
    for norm in ("after_norm", "tp_norm"):
        shapes[f"{norm}.scale"] = shapes[f"{norm}.bias"] = (h,)
    for stack in ("encoders0", "encoders", "tp_encoders"):
        for i in range(cfg[f"num_{stack}"]):
            k = feat if stack == "encoders0" else h
            p = f"{stack}.{i}."
            shapes.update({p + "norm1.scale": (k,), p + "norm1.bias": (k,),
                           p + "qkv.w": (k, 3 * h), p + "qkv.b": (3 * h,),
                           p + "fsmn_w": (cfg["fsmn_kernel"], h),
                           p + "out.w": (h, h), p + "out.b": (h,),
                           p + "norm2.scale": (h,), p + "norm2.bias": (h,),
                           p + "ffn.w1": (h, f), p + "ffn.b1": (f,),
                           p + "ffn.w2": (f, h), p + "ffn.b2": (h,)})
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The f32 tree (the port's layout) from the seed, on ``device``."""
    flat = seeded_normal(seed, device, weight_shapes(cfg))
    for name, t in flat.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w", "w1", "w2"):
            t.mul_(t.shape[0] ** -0.5)
        elif leaf == "fsmn_w":
            t.mul_(0.1)
        elif leaf == "scale":
            t.mul_(0.05).add_(1.0)
        elif leaf == "cmvn_istd":
            t.mul_(0.1).add_(1.0)
        elif name in ("cmvn_means",):
            t.mul_(0.5)
        else:  # biases and the prompt embeddings
            t.mul_(0.02)

    def node(prefix):
        keys = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        tree: dict = {}
        for k, v in keys.items():
            *path, leaf = k.split(".")
            d = tree
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
        return tree

    tree = node("")
    for stack in ("encoders0", "encoders", "tp_encoders"):
        tree[stack] = [tree[stack][str(i)] for i in range(cfg[f"num_{stack}"])]
    return tree


class Target:
    """One ``SenseVoiceSession`` on the card."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        from asr_tpu_torch.models.sensevoice import SenseVoiceConfig
        from asr_tpu_torch.ops import quant_matmul as qm
        from asr_tpu_torch.quant.quantize import quantize_pytree
        from asr_tpu_torch.runtime.session import SenseVoiceSession

        self.cfg, self.mix, self.seed, self.device, self.spans = cfg, mix, seed, device, spans
        self.qm = qm
        q = cfg["quant"]
        qm.set_quant_config(mm=q["mm"])
        widths = {k: cfg[k] for k in ("vocab_size", "hidden", "num_heads", "head_dim", "ffn_dim",
                                      "num_encoders0", "num_encoders", "num_tp_encoders",
                                      "fsmn_kernel", "n_mels", "lfr_m", "lfr_n", "blank_id",
                                      "sample_rate")}
        params = make_weights(cfg, seed, device)
        params = own(quantize_pytree(params, bits=q["bits"], block=q["block"],
                                     refine_iters=q["refine"]))
        self.session = SenseVoiceSession(params, SenseVoiceConfig(**widths),
                                         window_seconds=cfg["session"]["window_seconds"])
        self.window = self.session.window_samples
        self.rows = rows_per_window(cfg)
        self.sample_rate = cfg["sample_rate"]
        self.scale = 3277.0  # int16 range: noise at a tenth of full scale

    def windows(self, n_samples: int) -> int:
        w = self.window
        return max(1, -(-max(n_samples - w, 0) // w) + 1) if n_samples > w else 1

    def padded(self, n_samples: int) -> int:
        return 1 << (self.windows(n_samples) - 1).bit_length()

    def warmup(self, traffic) -> None:
        """Every padded batch the mix's sizes give, once."""
        lo, hi = self.mix["audio_seconds"]["low"], self.mix["audio_seconds"]["high"]
        sizes = sorted({self.padded(int(s * self.sample_rate))
                        for s in np.linspace(lo, hi, 256)})
        for p in sizes:
            n = p * self.window
            self.session.transcribe(traffic.audio[:n])
        sync(self.device)

    def submit(self, req, notify=None) -> Done:
        n = len(req.samples)
        calls = [(self.padded(n) * self.rows, k, nn, self.cfg["quant"]["block"], 1)
                 for k, nn in linears(self.cfg)]
        try:
            with self.spans.span("request", int8_calls=calls) as rec:
                l0 = self.qm.LAUNCHES
                res = self.session.transcribe(req.samples)
                rec["int8_launches"] = self.qm.LAUNCHES - l0
            return done(Done({"ids": res.token_ids, "elapsed": res.elapsed_seconds,
                              "windows": self.windows(n), "padded": self.padded(n)}), notify)
        except Exception as exc:  # a failed request: counted, and no answer
            return done(Done(error=exc), notify)

    def work_flops(self, out: dict) -> float:
        return out["windows"] * window_flops(self.cfg)

    def counters(self) -> dict:
        return {"int8_launches": self.qm.LAUNCHES}

    def close(self) -> None:
        self.session = None

    # ── the comparison with the reference ────────────────────────────────
    def judge(self, requests: list, outs: list, bits_control: int | None = None) -> list[dict]:
        """Readings of the served ids of ``requests`` against the reference
        at the configuration's bit width; with ``bits_control``, the same
        reading of the reference itself run at that width in the program's
        place."""
        from benchmark.reference import judge, sensevoice as ref

        cfg, q = self.cfg, self.cfg["quant"]
        f32 = make_weights(cfg, self.seed, self.device)
        rcfg = {k: cfg[k] for k in ("lfr_m", "lfr_n", "n_mels", "sample_rate", "num_heads",
                                    "head_dim")}
        refp = ref.quantize_linears(f32, q["bits"], q["block"], q["refine"])
        ctl = (ref.quantize_linears(f32, bits_control, q["block"], q["refine"])
               if bits_control else None)
        del f32
        readings = []
        for req, out in zip(requests, outs):
            logits, logits_c = self._windows_logits(ref, refp, rcfg, req.samples, ctl)
            got = {"widest_gap": judge.ctc_widest_gap(logits, out["ids"], cfg["blank_id"]),
                   "tokens": len(out["ids"]), "audio_s": req.audio_seconds}
            if ctl is not None:
                ids_c = []
                for lc in logits_c:
                    a = lc.argmax(-1)
                    keep = (a != cfg["blank_id"]) & torch.cat([a.new_ones(1, dtype=torch.bool),
                                                               a[1:] != a[:-1]])
                    ids_c += a[keep].tolist()
                got["control_gap"] = judge.ctc_widest_gap(logits, ids_c, cfg["blank_id"])
            readings.append(got)
        return readings

    @torch.inference_mode()
    def _windows_logits(self, ref, refp, rcfg, samples, ctl, chunk: int = 16):
        w = self.window
        n = len(samples)
        starts = [i * w for i in range(self.windows(n))]
        buf = np.zeros((len(starts), w), np.float32)
        valid = np.zeros(len(starts), np.int64)
        for i, s in enumerate(starts):
            c = samples[s : s + w]
            buf[i, : len(c)] = c
            valid[i] = len(c)
        out, out_c = [], []
        for a in range(0, len(starts), chunk):
            x = torch.from_numpy(buf[a : a + chunk]).to(self.device)
            v = torch.from_numpy(valid[a : a + chunk]).to(self.device)
            lg, vs = ref.ctc_logits(refp, rcfg, x, v)
            out += [lg[i, : int(vs[i])] for i in range(lg.shape[0])]
            if ctl is not None:
                lg, vs = ref.ctc_logits(ctl, rcfg, x, v)
                out_c += [lg[i, : int(vs[i])] for i in range(lg.shape[0])]
        return out, out_c


def build(cfg: dict, mix: dict, seed: int, device, spans) -> Target:
    return Target(cfg, mix, seed, device, spans)

