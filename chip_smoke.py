#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one CUDA card and check it.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases: (1) the card; (2) build the int8 dequant-matmul kernel from
``asr_tpu_torch/csrc`` with nvcc; (3) the kernel against its plain PyTorch
version at every SenseVoiceSmall q8 shape, timed in turns; (4) SenseVoiceSmall
at its full published geometry with random weights from a seed, quantized to
q8, saved as an artifact folder and loaded back, transcribing 20 s of audio
through ``SenseVoiceSession``; (5) the same session behind the HTTP
micro-batching server; (6) RTF and peak memory at batch 8 x 8 s; then the
logits of the q8 forward against the same forward on the dequantized weights
with plain matmuls. The kernel's launch count is reset just before phase 4
and read after phase 5: every q8 forward of the main path must launch it
281 times (70 blocks x 4 linears + the CTC head).

Any failed check raises, so the script exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Every distinct (K, N, block) of the SenseVoiceSmall q8 forward, and how
# many of the forward's 281 calls have that shape.
SLICE_SHAPES = {(560, 1536, 560): 1, (512, 1536, 128): 69, (512, 512, 128): 70,
                (512, 2048, 128): 70, (2048, 512, 128): 70, (512, 25055, 128): 1}
LINEARS_PER_FORWARD = 281  # 70 SANM blocks x (qkv, out, ffn w1, ffn w2) + the CTC head
DEV = "cuda"
BATCH, WINDOW_S = 8, 8.0
ROWS = 137  # SANM rows of one 8 s window: 133 LFR frames + 4 prompt rows
MARGIN = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"CHECK FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain)
    k1 = time_ms(kernel)
    k2 = time_ms(kernel)
    p2 = time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def wav_bytes(samples) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


def phase_device(torch) -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"[1 device] nvidia-smi: {card}")
    print(f"[1 device] torch: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


def phase_build(qm) -> None:
    t0 = time.perf_counter()
    lib, log = qm.build()
    print(f"[2 build] {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(qm.NVCC_FLAGS)})")
    for line in log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
            print(f"[2 build] ptxas: {line.strip()}")


def phase_kernel_vs_plain(torch, qm, quantize_linear, card: str) -> dict:
    g = torch.Generator(device=DEV).manual_seed(1234)
    rows = []
    worst = 0.0
    for (k, n, block), _count in SLICE_SHAPES.items():
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, 8, 128)
        check(leaf.block == block, f"block {leaf.block} != {block} at K={k}")
        for m in (BATCH * ROWS, ROWS):
            x = torch.randn((m, k), generator=g, device=DEV)
            for mm in ("f32", "bf16"):
                args = (x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
                got = qm.quant_matmul_int8(*args)
                torch.cuda.synchronize()
                want = qm.quant_dense_reference(*args)
                err = (got - want).abs().max().item()
                ref = want.abs().max().item()
                check(err <= 1e-4 * ref, f"kernel vs plain at M={m} K={k} N={n} {mm}: {err} > 1e-4 * {ref}")
                worst = max(worst, err)
                k_ms, p_ms = in_turns(lambda: qm.quant_dense_reference(*args),
                                      lambda: qm.quant_matmul_int8(*args))
                gflops = 2 * m * k * n / (k_ms * 1e6)
                rows.append({"m": m, "k": k, "n": n, "block": block, "mm": mm,
                             "ms": k_ms, "plain_ms": p_ms, "max_abs_err": err})
                print(f"[3 kernel] M={m:5d} K={k:5d} N={n:5d} block={block:3d} mm={mm:4s} "
                      f"kernel {k_ms:.4f} ms ({gflops:.0f} GFLOP/s)  plain {p_ms:.4f} ms  "
                      f"err {err:.3e} (max|plain| {ref:.3e})  [{card}]")
    per_fwd = {mm: [sum(SLICE_SHAPES[(r['k'], r['n'], r['block'])] * r[key] for r in rows
                        if r["m"] == BATCH * ROWS and r["mm"] == mm) for key in ("ms", "plain_ms")]
               for mm in ("f32", "bf16")}
    for mm, (k_ms, p_ms) in per_fwd.items():
        print(f"[3 kernel] one batch-8 forward's 281 calls, mm={mm}: kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms  [{card}]")
    return {"rows": rows, "max_abs_err": worst, "per_forward": per_fwd}


def logits_margin(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def main() -> int:
    if not (ROOT / "asr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible: chip_smoke.py runs only on one", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.ops import quant_matmul as qm
    from asr_tpu_torch.parallel.http_server import start_background
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_linear, quantize_pytree
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model
    from asr_tpu_torch.runtime.session import bucket_windows, load_session

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build(qm)
    kern = phase_kernel_vs_plain(torch, qm, quantize_linear, card)

    # ── 4. model: full geometry, q8, artifact round trip, session ─────────
    cfg = sv.SenseVoiceConfig()
    n_lin = LINEARS_PER_FORWARD
    check(4 * cfg.num_blocks + 1 == n_lin, f"SenseVoiceSmall has {n_lin} quantized linears")
    t0 = time.perf_counter()
    params32 = sv.init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    q8 = quantize_pytree(params32, bits=8, block=128)
    with tempfile.TemporaryDirectory() as tmp:
        save_model(tmp, q8, ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(cfg)}))
        size_mb = (Path(tmp) / "weights.safetensors").stat().st_size / 1e6
        session = load_session(tmp, DEV, window_seconds=WINDOW_S)
    del q8
    params, cfg = session.params, session.cfg
    qm.set_quant_config(mm="f32")
    print(f"[4 model] SenseVoiceSmall q8: init + quantize + artifact ({size_mb:.1f} MB) round trip "
          f"in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(0)
    audio20 = (rng.standard_normal(20 * 16000) * 2000).astype(np.float32)
    session.warmup()
    torch.cuda.synchronize()

    qm.LAUNCHES = 0  # the main path starts here
    res = session.transcribe(audio20)
    check(qm.LAUNCHES == n_lin, f"one q8 forward launched the kernel {qm.LAUNCHES} times, not {n_lin}")
    print(f"[4 model] 20 s -> {len(res.token_ids)} tokens in {res.elapsed_seconds * 1e3:.1f} ms "
          f"(3 windows, bucket {bucket_windows(3)}), kernel launches {n_lin} per forward")

    # ── 5. serve ─────────────────────────────────────────────────────────
    lengths = rng.integers(16000, 8 * 16000 + 1, size=8)
    clips = [np.round(rng.standard_normal(n) * 2000).astype(np.int16) for n in lengths]
    clips.append(np.round(audio20).astype(np.int16))
    httpd, srv, thread = start_background(session, max_batch=8)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    latency = [0.0] * len(clips)

    def post(i):
        req = urllib.request.Request(base + "/transcribe", data=wav_bytes(clips[i]), method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            results[i] = (resp.status, json.loads(resp.read()))
        latency[i] = time.perf_counter() - t

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "an HTTP request did not finish")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=60)
    launches = qm.LAUNCHES  # the main path ends here
    forwards = 1 + health["batches_dispatched"]  # session.transcribe + the server's batches
    check(launches == n_lin * forwards, f"{launches} launches over {forwards} forwards, not {n_lin} each")
    check(health["requests_served"] == 1 + 8 + 3, f"healthz: {health}")
    mismatched = 0
    for i, clip in enumerate(clips):
        check(results[i] is not None and results[i][0] == 200, f"request {i}: {results[i]}")
        want = session.transcribe(clip.astype(np.float32)).token_ids
        got = results[i][1]["token_ids"]
        print(f"[5 serve] request {i}: {len(clip) / 16000:5.2f} s, {len(got)} tokens, "
              f"latency {latency[i] * 1e3:.1f} ms  [{card}]")
        if got != want:
            mismatched += 1
            buf = torch.zeros((1, len(clip)), device=DEV)
            buf[0] = torch.from_numpy(clip.astype(np.float32)).to(DEV)
            with torch.inference_mode():
                logits, _ = sv.encode_logits(params, cfg, buf, torch.tensor([len(clip)], device=DEV),
                                             torch.zeros(1, dtype=torch.int64, device=DEV))
            low = logits_margin(logits).min().item()
            print(f"[5 serve] request {i}: token ids differ from session.transcribe; "
                  f"smallest top-2 logit margin {low:.3e}")
            check(low <= MARGIN, f"request {i} differs with every top-2 margin above {MARGIN}")
    print(f"[5 serve] {len(clips)} requests, healthz {json.dumps(health)}, "
          f"{mismatched} differing from the session, {launches} kernel launches over {forwards} forwards")

    # ── 6. numbers: RTF at batch 8 x 8 s, peak memory ────────────────────
    samples = int(WINDOW_S * cfg.sample_rate)
    audio = torch.from_numpy((rng.standard_normal((BATCH, samples)) * 2000).astype(np.float32)).to(DEV)
    valid = torch.full((BATCH,), samples, dtype=torch.int64, device=DEV)
    lang = torch.zeros(BATCH, dtype=torch.int64, device=DEV)
    iters = 5

    def rtf(p, mm):
        qm.set_quant_config(mm=mm)
        with torch.inference_mode():
            sv.forward(p, cfg, audio, valid, lang)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(iters):
                toks, _ = sv.forward(p, cfg, audio, valid, lang)
            toks.cpu()
            dt = time.perf_counter() - t
        return dt / (iters * BATCH * WINDOW_S), torch.cuda.max_memory_allocated() / 2**20

    for label, p, mm in (("f32 (plain torch)", params32, "f32"), ("q8 mm=f32", params, "f32"),
                         ("q8 mm=bf16", params, "bf16")):
        r, peak = rtf(p, mm)
        print(f"[6 numbers] RTF batch {BATCH} x {WINDOW_S:.0f} s, {label}: {r:.6f} "
              f"({r * 1e3 * WINDOW_S:.2f} ms per window, {iters} forwards), "
              f"peak memory during the timed forwards {peak:.0f} MiB  [{card}]")
    for mm, (k_ms, p_ms) in kern["per_forward"].items():
        print(f"[6 numbers] kernel time per batch-8 forward, mm={mm}: {k_ms:.3f} ms "
              f"(plain dequant + cuBLAS f32: {p_ms:.3f} ms)  [{card}]")

    # ── 4b. q8 logits against plain matmuls on the dequantized weights ───
    qm.set_quant_config(mm="f32")
    w = session.window_samples
    buf = np.zeros((bucket_windows(3), w), np.float32)
    vbuf = np.zeros(bucket_windows(3), np.int64)
    for i, s in enumerate((0, w, 2 * w)):
        chunk = audio20[s : s + w]
        buf[i, : len(chunk)] = chunk
        vbuf[i] = len(chunk)
    a, v = torch.from_numpy(buf).to(DEV), torch.from_numpy(vbuf).to(DEV)
    li = torch.zeros(len(buf), dtype=torch.int64, device=DEV)
    dense = dequantize_pytree(params)
    with torch.inference_mode():
        before = qm.LAUNCHES
        lq, vs = sv.encode_logits(params, cfg, a, v, li)
        check(qm.LAUNCHES - before == n_lin, f"the checked forward did not launch the kernel {n_lin} times")
        lp, _ = sv.encode_logits(dense, cfg, a, v, li)
    check(qm.LAUNCHES - before == n_lin, "the plain forward launched the kernel")
    diff = (lq - lp).abs().max().item()
    scale = lp.abs().max().item()
    check(bool(torch.isfinite(lq).all()), "non-finite logits")
    check(diff <= 1e-3 * scale, f"q8 logits vs plain: {diff} > 1e-3 * {scale}")
    frames = torch.arange(lq.shape[1], device=DEV)[None, :] < vs[:, None]
    sure = frames & (logits_margin(lp) > MARGIN)
    same = (lq.argmax(-1) == lp.argmax(-1))[sure].all().item()
    check(same, "framewise argmax differs on a frame with top-2 margin above 1e-3")
    under = int((frames & ~sure).sum().item())
    if under == 0:
        from asr_tpu_torch.decode.ctc import ctc_greedy_collapse

        tq, nq = ctc_greedy_collapse(lq.argmax(-1), vs, cfg.blank_id)
        tp, np_ = ctc_greedy_collapse(lp.argmax(-1), vs, cfg.blank_id)
        check(torch.equal(nq, np_) and torch.equal(tq, tp), "compacted tokens differ")
        ids = [int(t) for i in range(3) for t in tq[i, : nq[i]].tolist()]
        check(ids == res.token_ids, "session tokens differ from the checked forward")
    print(f"[4 check] q8 mm=f32 logits vs plain f32: max diff {diff:.3e} (max|logit| {scale:.3e}), "
          f"argmax equal on {int(sure.sum())} frames, {under} frames under the {MARGIN} margin")

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    worst = max(r["max_abs_err"] for r in kern["rows"])
    k_ms, p_ms = kern["per_forward"]["bf16"]
    print(json.dumps({"kernels": [{
        "name": "quant_matmul_int8",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/quant_matmul_int8.cu",
        "replaces": "asr_tpu/ops/quant_matmul.py:115",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "timing": "sum over one batch-8 x 8 s forward's 281 calls (M=1096), mm=bf16, CUDA events",
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
