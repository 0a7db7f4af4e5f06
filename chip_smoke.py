#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths on one CUDA card and check them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases: (1) the card; (2) build the three kernels from
``asr_tpu_torch/csrc`` with nvcc, one process per source, at once; (3)
the int8 dequant-matmul kernel against its plain PyTorch version at every
SenseVoiceSmall q8 shape, timed in turns; (4) SenseVoiceSmall at its full published geometry
with random weights from a seed, quantized to q8, saved as an artifact
folder and loaded back, transcribing 20 s of audio through
``SenseVoiceSession``; (5) the same session behind the HTTP micro-batching
server; (6) RTF and peak memory at batch 8 x 8 s, then the q8 logits
against the same forward on the dequantized weights with plain matmuls;
(8) the fused AED decode-step kernel against its plain version at the
Whisper-Large-v3-Turbo decoder geometry (f32 and bf16 caches, three
positions, two cross lengths), timed in turns; (9) Whisper-Large-v3-Turbo
q8 at its full geometry through an artifact folder and
``load_whisper_session``: 20 s of audio (one window, the fused route), a
teacher-forced replay of its ids through the per-weight step, and 45 s
(two windows, the per-weight route); (10) encoder time, decode time per
token on both routes, the host sync's share, RTF of one 30 s window and
peak memory; (11) the multi-slot AED decode-step kernel against its plain
version and, slot by slot, against the batch-1 kernel at turbo geometry
(B = 2 and 8, f32 and bf16 caches, mixed positions with one parked slot,
mixed cross lengths); (12) its time at B = 2, 4, 8 against the plain
version's, in turns, with its bound and a profile at B = 8; (13)
continuous serving of phase 9's artifact over HTTP: 17 concurrent
requests (18 windows) with staggered starts on 8 slots, every decode step
through the multi-slot kernel, the ids against ``session.transcribe``, the
serving numbers, and two requests on the rowwise route.

Each path's launch counts are reset just before it and read just after:
every q8 SenseVoice forward launches the int8 kernel 281 times (70 blocks
x 4 linears + the CTC head); one Whisper window launches it for the
encoder, the cross-KV and the two prefills, and the fused kernel once per
decode step; continuous serving launches the multi-slot kernel once per
decode step and never the batch-1 kernel.

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


def in_turns(plain, kernel, plain_iters: int = 20) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, plain_iters, min(3, plain_iters))
    k1 = time_ms(kernel)
    k2 = time_ms(kernel)
    p2 = time_ms(plain, plain_iters, min(3, plain_iters))
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


def phase_build(kernels) -> None:
    """Build every kernel's library at once, one nvcc per source."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(mod):
        t0 = time.perf_counter()
        lib, log = mod.build()
        return lib, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(kernels)) as pool:
        built = list(pool.map(timed, kernels))
    for mod, (lib, log, secs) in zip(kernels, built):
        print(f"[2 build] {lib.relative_to(ROOT)} in {secs:.2f} s (nvcc {' '.join(mod.NVCC_FLAGS)})")
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


# ── Whisper-Large-v3-Turbo q8 and the fused decode-step kernel ──────────────
FUSED_POS = (3, 200, 447)
FUSED_TC = (1500, 750)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The plain version rounds every matvec input to bf16, as the kernel does. A
# last-bit f32 difference from another summation order can flip one such
# rounding (2^-9 relative), and a flip moves every later layer a little, so
# after four layers the two agree to a bf16 step, not to f32 rounding. The
# first layer's k/v row sits behind one rounding only (its LayerNorm output):
# at most one flipped input moves it by 2^-8 x |y| x |w| < 1e-3 of max|row|,
# and a bf16 cache adds its own rounding, 2^-8 of the value.
FUSED_LOGIT_TOL = 1e-2
ROW0_TOL = {"float32": 1e-3, "bfloat16": 1e-3 + 2.0**-8}
TEACHER_TOL = 3e-2  # tests/test_fused_aed_step.py: fused step vs per-weight step


def int8_per_window(cfg) -> int:
    """int8-kernel calls of one window's encoder (6 linears a layer), the
    cross-KV (2 a decoder layer) of the probe and the prompt, and the two
    prefills (8 linears a decoder layer + the tied head)."""
    return 6 * cfg.encoder_layers + 2 * 2 * cfg.decoder_layers + 2 * int8_per_step(cfg)


def int8_per_step(cfg) -> int:
    """int8-kernel calls of one per-weight decode step."""
    return 8 * cfg.decoder_layers + 1


def step_bytes(stacked: dict, nl: int, d: int, pos: int, tc_valid: int, itemsize: int) -> int:
    """Bytes one step must read: weights, scales, biases, the attended cache rows."""
    weights = sum(t.numel() * t.element_size() for t in stacked.values())
    return weights + 2 * nl * (tc_valid + pos) * d * itemsize


def phase_fused_vs_plain(torch, fs, wh, quantize_pytree, card: str) -> dict:
    """The fused-step kernel against its plain version at turbo geometry."""
    cfg = wh.WhisperConfig(encoder_layers=0)  # the decoder at full width
    g = torch.Generator(device=DEV).manual_seed(7)
    params = quantize_pytree(wh.init_params(cfg, g), bits=8, block=128, quantize_embeddings=True)
    stacked = fs.stack_whisper_step_params(params, cfg)
    check(stacked is not None, "turbo q8 decoder did not stack")
    # Random biases and LayerNorm parameters (the init has zeros and ones), so
    # that each of them reaches the comparison.
    for key in ("ba", "bb", "ln1_b", "lnc_b", "ln2_b", "lnf_b"):
        stacked[key] = 0.1 * torch.randn(stacked[key].shape, generator=g, device=DEV)
    for key in ("ln1_s", "lnc_s", "ln2_s", "lnf_s"):
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device=DEV)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc, v = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, \
        cfg.max_source_positions, cfg.vocab_size
    dec = params["decoder"]
    rows, worst, times = [], 0.0, {}
    for cdt in (torch.float32, torch.bfloat16):
        ks = torch.randn((nl, t, d), generator=g, device=DEV).to(cdt)
        vs = torch.randn((nl, t, d), generator=g, device=DEV).to(cdt)
        ck = torch.randn((nl, tc, d), generator=g, device=DEV).to(cdt)
        cv = torch.randn((nl, tc, d), generator=g, device=DEV).to(cdt)
        for pos in FUSED_POS:
            x = (dec["embed"][torch.tensor([1000 + pos], device=DEV)] + dec["pos"][pos : pos + 1]).float()
            for tcv in FUSED_TC:
                kk, vk, kp, vp = ks.clone(), vs.clone(), ks.clone(), vs.clone()
                got, _, _ = fs.fused_aed_step_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tcv)
                torch.cuda.synchronize()
                want, _, _ = fs.fused_aed_step_reference(stacked, geom, x, kp, vp, ck, cv, pos, tcv)
                err = (got[:, :v] - want[:, :v]).abs().max().item()
                ref = want[:, :v].abs().max().item()
                check(bool(torch.isfinite(got).all()), f"non-finite logits at pos {pos}")
                check(bool((got[:, v:] == 0).all()), "pad logits are not exactly 0")
                others = torch.arange(t, device=DEV) != pos
                check(torch.equal(kk[:, others], ks[:, others]) and torch.equal(vk[:, others], vs[:, others]),
                      f"rows other than pos {pos} changed")
                row_err = max((kk[:, pos].float() - kp[:, pos].float()).abs().max().item(),
                              (vk[:, pos].float() - vp[:, pos].float()).abs().max().item())
                row_ref = max(kp[:, pos].float().abs().max().item(), vp[:, pos].float().abs().max().item())
                row0 = max((kk[0, pos].float() - kp[0, pos].float()).abs().max().item(),
                           (vk[0, pos].float() - vp[0, pos].float()).abs().max().item())
                rows.append({"cache": str(cdt).split(".")[-1], "pos": pos, "tc_valid": tcv,
                             "max_abs_err": err, "max_abs_plain": ref, "row_err": row_err,
                             "row0_err": row0})
                print(f"[8 fused] cache={rows[-1]['cache']:8s} pos={pos:3d} tc_valid={tcv:4d}: "
                      f"logits err {err:.3e} (max|plain| {ref:.3e}, {err / ref:.2e} of it); "
                      f"written row err {row_err:.3e} (layer 0: {row0:.3e}, max|row| {row_ref:.3e})")
                worst = max(worst, err)
                check(err <= FUSED_LOGIT_TOL * ref, f"fused logits vs plain: {err} > {FUSED_LOGIT_TOL} * {ref}")
                tol0 = ROW0_TOL[rows[-1]["cache"]]
                check(row0 <= tol0 * row_ref, f"layer-0 row vs plain: {row0} > {tol0} * {row_ref}")
        pos, tcv = FUSED_POS[-1], FUSED_TC[0]
        # The plain version on the host CPU against the plain version on the
        # card: the same rounding points, other summation orders. How far
        # they drift apart is what bf16 rounding alone allows.
        host = {k: a.cpu() for k, a in stacked.items()}
        on_host, _, _ = fs.fused_aed_step_reference(host, geom, x.cpu(), ks.cpu(), vs.cpu(), ck.cpu(),
                                                    cv.cpu(), pos, tcv)
        kk, vk = ks.clone(), vs.clone()
        on_card, _, _ = fs.fused_aed_step_reference(stacked, geom, x, kk, vk, ck, cv, pos, tcv)
        drift = (on_host[:, :v] - on_card[:, :v].cpu()).abs().max().item()
        rows[-1]["plain_host_vs_card"] = drift
        print(f"[8 fused] cache={rows[-1]['cache']} pos={pos} tc_valid={tcv}: plain version on the host "
              f"vs on the card: {drift:.3e} ({drift / on_card.abs().max().item():.2e} of max|logit|)")
        del host, on_host
        k_ms, p_ms = in_turns(
            lambda: fs.fused_aed_step_reference(stacked, geom, x, kk, vk, ck, cv, pos, tcv),
            lambda: fs.fused_aed_step_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tcv))
        nbytes = step_bytes(stacked, nl, d, pos, tcv, ks.element_size())
        rate = nbytes / (k_ms * 1e-3)
        times[rows[-1]["cache"]] = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes, "bytes_per_s": rate,
                                    "flops": step_flops(stacked, nl, d, [(pos, tcv)])}
        print(f"[8 fused] cache={rows[-1]['cache']} pos={pos} tc_valid={tcv}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms; {nbytes / 1e6:.1f} MB per step, {rate / 1e9:.0f} GB/s, "
              f"{rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s  [{card}]")
    del params, stacked
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst, "times": times}


def synced(torch, fn):
    """(result, seconds) of fn() on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_whisper(torch, np, qm, fs, folder: str, card: str) -> dict:
    """Whisper-Large-v3-Turbo q8 through an artifact folder (saved into
    ``folder``, which phase 13 loads again) and WhisperSession."""
    from asr_tpu_torch.decode.ar import select_token
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model
    from asr_tpu_torch.runtime.whisper_session import load_whisper_session

    qm.set_quant_config(mm="bf16")  # the serving mode; the session stacks for the fused step
    cfg = wh.WhisperConfig()
    t0 = time.perf_counter()
    q8 = quantize_pytree(wh.init_params(cfg, torch.Generator(device=DEV).manual_seed(0)),
                         bits=8, block=128, quantize_embeddings=True)
    save_model(folder, q8, ModelMetadata(family="whisper", extra={"config": dataclasses.asdict(cfg)}))
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del q8
    session = load_whisper_session(folder, DEV)
    params = session.params
    check(session.stacked is not None, "the session did not stack the q8 decoder for the fused step")
    print(f"[9 whisper] Whisper-Large-v3-Turbo q8: init + quantize + artifact ({size_mb:.1f} MB) "
          f"round trip in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(1)
    audio20 = (rng.standard_normal(20 * 16000) * 0.1).astype(np.float32)
    session.transcribe(audio20[: 16000])  # warm-up: cuBLAS, the kernels' first launches
    torch.cuda.synchronize()

    qm.LAUNCHES = fs.LAUNCHES = 0  # the Whisper path starts here
    res = session.transcribe(audio20)
    int8, fused = qm.LAUNCHES, fs.LAUNCHES  # and ends here
    ids = res.token_ids
    max_new = session.scfg.max_new_tokens
    counts = len(ids) if len(ids) == max_new + 1 else len(ids) + 1  # + the EOT the session drops
    check(fused == counts - 1 and fused > 0, f"{fused} fused launches for {counts} generated tokens")
    check(int8 == int8_per_window(cfg), f"{int8} int8 launches, not {int8_per_window(cfg)} "
          "(encoder, cross-KV and prefill of one window)")
    print(f"[9 whisper] 20 s (1 window) -> {len(ids)} tokens in {res.elapsed_seconds * 1e3:.1f} ms; "
          f"fused-step launches {fused} (= counts - 1), int8 launches {int8}  [{card}]")

    # Teacher-forced: replay the generated ids through the per-weight step.
    w = session.window_samples
    buf = np.zeros((1, w), np.float32)
    buf[0, : len(audio20)] = audio20
    prompt = torch.from_numpy(session._prompt(1)).to(DEV)
    dcfg = session.decode_cfg
    with torch.inference_mode():
        mel = wh.mel_for_audio(cfg, torch.from_numpy(buf).to(DEV))
        pre = wh.prefill_window(params, cfg, mel, prompt, dcfg)
        state, p_len = pre["state"], prompt.shape[1]
        check(int(select_token(pre["logits0"], prompt, p_len, dcfg)[0]) == ids[0],
              "the first token differs from the session's")
        layers = state["layers"]
        d, t_max, tc = cfg.d_model, cfg.max_target_positions, layers[0]["cross_k"].shape[1]
        kc = torch.stack([ls["self_k"][0].reshape(t_max, d) for ls in layers])
        vc = torch.stack([ls["self_v"][0].reshape(t_max, d) for ls in layers])
        ck = torch.stack([ls["cross_k"][0].reshape(tc, d) for ls in layers])
        cv = torch.stack([ls["cross_v"][0].reshape(tc, d) for ls in layers])
        dec = params["decoder"]
        worst_rel, under, same_as_run = 0.0, 0, 0
        for i, tok in enumerate(ids[:-1]):
            pos = p_len + i
            t = torch.tensor([[tok]], device=DEV)
            want, state = wh.step(params, cfg, state, t, pos)
            x = (dec["embed"][t[:, 0]] + dec["pos"][pos : pos + 1]).float()
            got, _, _ = fs.fused_whisper_step(session.stacked, cfg, x, kc, vc, ck, cv, pos, tc_valid=tc)
            got = got[:, : cfg.vocab_size]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            worst_rel = max(worst_rel, err / scale)
            check(err <= TEACHER_TOL * scale, f"step {i}: fused vs per-weight {err} > {TEACHER_TOL} * {scale}")
            if logits_margin(want).item() > TEACHER_TOL * scale:
                check(int(got.argmax()) == int(want.argmax()), f"step {i}: argmax differs above the margin")
            else:
                under += 1
            same_as_run += int(got.argmax()) == ids[i + 1]
    steps = len(ids) - 1
    print(f"[9 whisper] teacher-forced over {steps} steps: fused vs per-weight max err "
          f"{worst_rel:.3e} of max|logit| (bound {TEACHER_TOL}); {under} steps under the top-2 margin; "
          f"fused argmax = generated id at {same_as_run}/{steps} steps")

    # Two windows: batched per-weight decode through the int8 kernel only.
    audio45 = (rng.standard_normal(45 * 16000) * 0.1).astype(np.float32)
    before_q, before_f = qm.LAUNCHES, fs.LAUNCHES
    res45 = session.transcribe(audio45)
    dq = qm.LAUNCHES - before_q
    check(fs.LAUNCHES == before_f, "the 2-window run launched the fused kernel")
    per_win, per_step = int8_per_window(cfg), int8_per_step(cfg)
    check(dq > per_win and (dq - per_win) % per_step == 0,
          f"2-window run: {dq} int8 launches is not {per_win} + {per_step} per step")
    print(f"[9 whisper] 45 s (2 windows) -> {len(res45.token_ids)} tokens in "
          f"{res45.elapsed_seconds * 1e3:.1f} ms; int8 launches {dq} "
          f"({(dq - per_win) // per_step} per-weight steps), fused launches 0  [{card}]")
    return {"int8": int8, "fused": fused, "session": session, "params": params, "mel": mel,
            "prompt": prompt}


def phase_whisper_numbers(torch, np, qm, fs, wh_run: dict, card: str) -> dict:
    """Encoder time, decode time per token on both routes, the host sync's
    share, RTF of one 30 s window and peak memory."""
    from asr_tpu_torch.decode.ar import select_token
    from asr_tpu_torch.models import whisper as wh

    session, params, mel, prompt = (wh_run[k] for k in ("session", "params", "mel", "prompt"))
    cfg, dcfg = session.cfg, session.decode_cfg
    out = {}
    with torch.inference_mode():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        wh.encode(params, cfg, mel)
        start.record()
        for _ in range(3):
            wh.encode(params, cfg, mel)
        end.record()
        torch.cuda.synchronize()
        out["encoder_ms"] = start.elapsed_time(end) / 3
        _, t_pre = synced(torch, lambda: wh.prefill_window(params, cfg, mel, prompt, dcfg))
        for route, stacked in (("fused", session.stacked), ("per-weight", None)):
            res, t_all = synced(torch, lambda: wh.transcribe_window(params, cfg, mel, prompt, dcfg,
                                                                     stacked=stacked))
            steps = int(res["counts"].max()) - 1
            out[f"{route}_ms_per_token"] = (t_all - t_pre) * 1e3 / max(steps, 1)
            out[f"{route}_steps"] = steps
        # The host sync: the same fused steps with and without a stop test each step.
        pre = wh.prefill_window(params, cfg, mel, prompt, dcfg)
        layers = pre["state"]["layers"]
        d, t_max, tc = cfg.d_model, cfg.max_target_positions, layers[0]["cross_k"].shape[1]
        kc = torch.stack([ls["self_k"][0].reshape(t_max, d) for ls in layers])
        vc = torch.stack([ls["self_v"][0].reshape(t_max, d) for ls in layers])
        ck = torch.stack([ls["cross_k"][0].reshape(tc, d) for ls in layers])
        cv = torch.stack([ls["cross_v"][0].reshape(tc, d) for ls in layers])
        dec, p_len = params["decoder"], prompt.shape[1]
        n = min(128, t_max - p_len)

        def loop(sync: bool):
            tok = torch.full((1, 1), cfg.sot_id, device=DEV)
            for i in range(n):
                pos = p_len + i
                x = (dec["embed"][tok[:, 0]] + dec["pos"][pos : pos + 1]).float()
                lg, _, _ = fs.fused_whisper_step(session.stacked, cfg, x, kc, vc, ck, cv, pos, tc_valid=tc)
                tok = select_token(lg[:, : cfg.vocab_size], prompt, p_len, dcfg)[:, None]
                if sync:
                    bool((tok == cfg.eot_id).all())

        loop(False)
        t_sync = min(synced(torch, lambda: loop(True))[1] for _ in range(2))
        t_free = min(synced(torch, lambda: loop(False))[1] for _ in range(2))
    out["sync_share"] = (t_sync - t_free) / t_sync
    out["fused_loop_ms_per_token"] = t_sync * 1e3 / n
    audio30 = (np.random.default_rng(2).standard_normal(30 * 16000) * 0.1).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    res = session.transcribe(audio30)
    out["rtf_30s"] = res.rtf
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[10 numbers] encoder ({cfg.encoder_layers} layers, one 30 s window): {out['encoder_ms']:.2f} ms  [{card}]")
    for route in ("fused", "per-weight"):
        print(f"[10 numbers] decode {route} route (mm=bf16): {out[route + '_ms_per_token']:.3f} ms per token "
              f"over {out[route + '_steps']} steps  [{card}]")
    print(f"[10 numbers] host sync per step (finished.all()): {out['sync_share']:.1%} of the fused "
          f"route's {out['fused_loop_ms_per_token']:.3f} ms per token  [{card}]")
    print(f"[10 numbers] RTF one 30 s window: {out['rtf_30s']:.5f} ({res.elapsed_seconds * 1e3:.1f} ms, "
          f"{len(res.token_ids)} tokens), peak memory {out['peak_mib']:.0f} MiB  [{card}]")
    return out


# ── 11-13. the multi-slot AED decode-step kernel, continuous serving ────────
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
MULTI_B = (2, 8)
MULTI_TIMED_B = (2, 4, 8)
SERVE_SLOTS = 8
SERVE_SECONDS = (5.0, 30.0)  # 16 requests of one window each, lengths drawn from this range
SERVE_LONG = 45.0  # and one of two windows
ROWWISE_BUDGET = 64  # new tokens a window on the rowwise route


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the bytes over the
    HBM rate against the operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def step_flops(stacked: dict, nl: int, d: int, slots: list) -> float:
    """Operations of one step: 2 per int8 weight element and slot, and the
    attention's scores and P.V over each slot's (pos, tc_valid) rows."""
    weights = sum(stacked[k].numel() for k in ("wa_all", "wb_all", "wh"))
    return float(sum(2 * weights + 4 * nl * (p + tc) * d for p, tc in slots))


def int8_forward_bound() -> tuple[float, str, float, float]:
    """The int8 kernel's bound over one batch-8 SenseVoiceSmall forward (281
    calls at M = 1096): each call's bytes (x f32 read, the int8 weight, its
    f32 scales and zeros, the f32 output written) and operations (2 M K N at
    the bf16 peak), each call's larger time, summed."""
    m = BATCH * ROWS
    total, nbytes, flops = 0.0, 0.0, 0.0
    for (k, n, block), count in SLICE_SHAPES.items():
        b = 4 * m * k + k * n + 2 * 4 * (k // block) * n + 4 * m * n
        f = 2.0 * m * k * n
        total += count * bound(b, f)[0]
        nbytes += count * b
        flops += count * f
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_BF16_FLOPS else "operations"
    return total, by, nbytes, flops


def profile_steps(torch, fn, steps: int = 20) -> tuple[float, float, dict]:
    """torch.profiler over ``steps`` calls of ``fn``: (host ms a step, kernel
    ms a step, {kernel name: ms a step})."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # "void (anonymous namespace)::attn_pv_multi<float, false>(...)" -> "attn_pv_multi"
        name = re.sub(r"^void ", "", e.key.replace("(anonymous namespace)::", ""))
        name = re.sub(r"[(<].*", "", name).split("::")[-1].strip()
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3 / steps
    return wall * 1e3 / steps, sum(by_name.values()), by_name


def phase_multi(torch, fs, fm, wh, quantize_pytree, fused: dict, card: str) -> dict:
    """[11] The multi-slot kernel against its plain version and against the
    batch-1 kernel slot by slot, at turbo geometry; [12] its time against
    the plain version's, in turns, at B in {2, 4, 8}."""
    cfg = wh.WhisperConfig(encoder_layers=0)  # the decoder at full width
    g = torch.Generator(device=DEV).manual_seed(11)
    params = quantize_pytree(wh.init_params(cfg, g), bits=8, block=128, quantize_embeddings=True)
    stacked = fs.stack_whisper_step_params(params, cfg)
    check(stacked is not None, "turbo q8 decoder did not stack")
    for key in ("ba", "bb", "ln1_b", "lnc_b", "ln2_b", "lnf_b"):
        stacked[key] = 0.1 * torch.randn(stacked[key].shape, generator=g, device=DEV)
    for key in ("ln1_s", "lnc_s", "ln2_s", "lnf_s"):
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device=DEV)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc, v = (cfg.decoder_layers, cfg.d_model, cfg.max_target_positions,
                       cfg.max_source_positions, cfg.vocab_size)
    dec = params["decoder"]
    worst, rows = 0.0, []

    def planes(bs, cdt):
        return [torch.randn((nl, bs, n, d), generator=g, device=DEV).to(cdt) for n in (t, t, tc, tc)]

    for bs in MULTI_B:
        pos_l = [FUSED_POS[i % 3] for i in range(bs)]
        pos_l[bs // 2] = -1  # one parked slot
        tc_l = [FUSED_TC[i % 2] for i in range(bs)]
        toks = torch.tensor([(1000 + 7 * i) % v for i in range(bs)], device=DEV)
        x = (dec["embed"][toks] + dec["pos"][torch.tensor([max(p, 0) for p in pos_l], device=DEV)]).float()
        pos = torch.tensor(pos_l, dtype=torch.int32, device=DEV)
        tcv = torch.tensor(tc_l, dtype=torch.int32, device=DEV)
        for cdt in (torch.float32, torch.bfloat16):
            cache = str(cdt).split(".")[-1]
            ks, vs, ck, cv = planes(bs, cdt)
            kk, vk, kp, vp = ks.clone(), vs.clone(), ks.clone(), vs.clone()
            got, _, _ = fm.fused_aed_step_multi_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tcv)
            torch.cuda.synchronize()
            want, _, _ = fm.fused_aed_step_multi_reference(stacked, geom, x, kp, vp, ck, cv, pos, tcv)
            check(bool(torch.isfinite(got).all()), f"B={bs} {cache}: non-finite logits")
            check(bool((got[:, v:] == 0).all()), f"B={bs} {cache}: pad logits are not exactly 0")
            err = (got[:, :v] - want[:, :v]).abs().max().item()
            ref = want[:, :v].abs().max().item()
            check(err <= FUSED_LOGIT_TOL * ref, f"B={bs} {cache}: multi vs plain {err} > "
                  f"{FUSED_LOGIT_TOL} * {ref}")
            worst = max(worst, err)
            row0, vs1 = 0.0, 0.0
            for b, p in enumerate(pos_l):
                others = torch.arange(t, device=DEV) != p
                check(torch.equal(kk[:, b, others], ks[:, b, others])
                      and torch.equal(vk[:, b, others], vs[:, b, others]),
                      f"B={bs} {cache}: slot {b} rows other than pos {p} changed")
                if p < 0:
                    continue
                r_err = max((kk[0, b, p].float() - kp[0, b, p].float()).abs().max().item(),
                            (vk[0, b, p].float() - vp[0, b, p].float()).abs().max().item())
                r_ref = max(kp[0, b, p].float().abs().max().item(), vp[0, b, p].float().abs().max().item())
                tol0 = ROW0_TOL[cache]
                check(r_err <= tol0 * r_ref, f"B={bs} {cache}: slot {b} layer-0 row {r_err} > {tol0} * {r_ref}")
                row0 = max(row0, r_err / r_ref)
                one, _, _ = fs.fused_aed_step_cuda(
                    stacked, geom, x[b : b + 1], *(c[:, b].clone(memory_format=torch.contiguous_format)
                                                   for c in (ks, vs, ck, cv)), p, tc_l[b])
                s_err = (got[b, :v] - one[0, :v]).abs().max().item()
                s_ref = one[0, :v].abs().max().item()
                check(s_err <= FUSED_LOGIT_TOL * s_ref, f"B={bs} {cache}: slot {b} vs the batch-1 kernel "
                      f"{s_err} > {FUSED_LOGIT_TOL} * {s_ref}")
                vs1 = max(vs1, s_err / s_ref)
            rows.append({"b": bs, "cache": cache, "max_abs_err": err, "max_abs_plain": ref,
                         "row0_rel": row0, "vs_batch1_rel": vs1})
            print(f"[11 multi] B={bs} cache={cache:8s} pos={pos_l} tc_valid={tc_l}: logits err "
                  f"{err:.3e} ({err / ref:.2e} of max|plain|); layer-0 rows within {row0:.2e} of "
                  f"max|row|; slots vs the batch-1 kernel within {vs1:.2e} of max|logit|; other "
                  f"rows and the parked slot bitwise unchanged")
    torch.cuda.synchronize()

    times = {}
    pos_t, tc_t = FUSED_POS[-1], FUSED_TC[0]
    for cdt in (torch.float32, torch.bfloat16):
        cache = str(cdt).split(".")[-1]
        one_ms = fused["times"][cache]["ms"]
        for bs in MULTI_TIMED_B:
            ks, vs, ck, cv = planes(bs, cdt)
            x = torch.randn((bs, d), generator=g, device=DEV) * 0.05
            pos = torch.full((bs,), pos_t, dtype=torch.int32, device=DEV)
            tcv = torch.full((bs,), tc_t, dtype=torch.int32, device=DEV)
            k_ms, p_ms = in_turns(
                lambda: fm.fused_aed_step_multi_reference(stacked, geom, x, ks, vs, ck, cv, pos, tcv),
                lambda: fm.fused_aed_step_multi_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tcv),
                plain_iters=3)
            weights = sum(a.numel() * a.element_size() for a in stacked.values())
            nbytes = weights + bs * 2 * nl * (tc_t + pos_t) * d * ks.element_size()
            b_ms, b_by = bound(nbytes, step_flops(stacked, nl, d, [(pos_t, tc_t)] * bs))
            rate = nbytes / (k_ms * 1e-3)
            times[(bs, cache)] = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes, "bound_ms": b_ms,
                                  "bound_by": b_by, "batch1_ms": one_ms}
            print(f"[12 multi] B={bs} cache={cache:8s} pos={pos_t} tc_valid={tc_t}: kernel {k_ms:.4f} ms a "
                  f"step, {k_ms * 1e3 / bs:.1f} us a token (B x batch-1 kernel: {bs * one_ms:.4f} ms); "
                  f"plain {p_ms:.2f} ms; {nbytes / 1e6:.1f} MB a step, {rate / 1e9:.0f} GB/s, "
                  f"{rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound {b_ms:.4f} ms ({b_by})  [{card}]")
            if bs == MULTI_TIMED_B[-1]:
                host_ms, dev_ms, by_name = profile_steps(
                    torch, lambda: fm.fused_aed_step_multi_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tcv))
                parts = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
                print(f"[12 profile] B={bs} cache={cache}: {dev_ms * 1e3:.1f} us of kernels in a "
                      f"{host_ms * 1e3:.1f} us step (idle share {1 - dev_ms / host_ms:.3f}); us a step: "
                      f"{parts}  [{card}]")
    del params, stacked
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst, "times": times}


def post_clip(base: str, clip, delay: float, out: list, i: int) -> None:
    """POST one clip after ``delay`` seconds; out[i] = (status, reply, seconds)."""
    time.sleep(delay)
    req = urllib.request.Request(base + "/transcribe", data=wav_bytes(clip), method="POST")
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        out[i] = (resp.status, json.loads(resp.read()), time.perf_counter() - t)


def replay_window(torch, fs, fm, wh, session, chunk, ids: list, acc: dict, label: str) -> int:
    """Teacher-force one window's server ids (``ids`` starts at its first
    token) through the per-weight step and the multi-slot kernel (this
    window in slot 0, slot 1 parked), step by step: logits within
    TEACHER_TOL of max|logit|, argmax equal above the top-2 margin. The
    window ends where the kernel picks EOT (the server drops it) or at the
    budget. Returns how many of ``ids`` the window holds."""
    from asr_tpu_torch.decode.ar import select_token

    cfg, params, dcfg = session.cfg, session.params, session.decode_cfg
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    dec = params["decoder"]
    with torch.inference_mode():
        pre = session.continuous_prefill(chunk)
        state, p_len = pre["state"], pre["p_len"]
        first = int(select_token(pre["logits0"], torch.zeros((1, 1), dtype=torch.int64, device=DEV),
                                 0, dcfg)[0])
        if first == cfg.eot_id:  # an empty window
            return 0
        check(bool(ids) and ids[0] == first, f"{label}: the first token differs")
        layers = state["layers"]
        d, t_max, tc = cfg.d_model, cfg.max_target_positions, layers[0]["cross_k"].shape[1]
        kc, vc = (torch.zeros((cfg.decoder_layers, 2, t_max, d), device=DEV) for _ in range(2))
        ck, cv = (torch.zeros((cfg.decoder_layers, 2, tc, d), device=DEV) for _ in range(2))
        for l, ls in enumerate(layers):
            for plane, key in ((kc, "self_k"), (vc, "self_v"), (ck, "cross_k"), (cv, "cross_v")):
                plane[l, 0] = ls[key][0].reshape(-1, d)
        tcv = torch.tensor([tc, tc], dtype=torch.int32, device=DEV)
        j, ended = 0, False
        while j < dcfg.max_new_tokens and not ended:
            pos = p_len + j
            tok = torch.tensor([[ids[j]]], device=DEV)
            want, state = wh.step(params, cfg, state, tok, pos)
            x = torch.zeros((2, d), device=DEV)
            x[0] = (dec["embed"][tok[0]] + dec["pos"][pos : pos + 1])[0].float()
            got, _, _ = fm.fused_aed_step_multi(session.stacked, geom, x, kc, vc, ck, cv,
                                                torch.tensor([pos, -1], dtype=torch.int32, device=DEV),
                                                tcv)
            got = got[:1, : cfg.vocab_size]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            acc["worst_rel"] = max(acc["worst_rel"], err / scale)
            check(err <= TEACHER_TOL * scale, f"{label} step {j}: multi vs per-weight {err} > "
                  f"{TEACHER_TOL} * {scale}")
            if logits_margin(want).item() > TEACHER_TOL * scale:
                check(int(got.argmax()) == int(want.argmax()), f"{label} step {j}: argmax differs "
                      "above the margin")
            else:
                acc["under"] += 1
            acc["steps"] += 1
            nxt = int(got.argmax())
            j += 1
            ended = nxt == cfg.eot_id  # the server drops the EOT
            if not ended:
                check(j < len(ids), f"{label}: the server's ids end before the kernel's EOT")
                acc["same"] += ids[j] == nxt
    return j if ended else j + 1  # at the budget the window holds max_new + 1 ids


def phase_continuous(torch, np, qm, fs, fm, folder: str, numbers: dict, card: str) -> dict:
    """[13] Continuous Whisper-Large-v3-Turbo q8 serving over HTTP, every
    decode step through the multi-slot kernel."""
    import copy

    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer, start_background_continuous
    from asr_tpu_torch.runtime.audio import iter_windows
    from asr_tpu_torch.runtime.whisper_session import load_whisper_session

    session = load_whisper_session(folder, DEV)  # phase 9's artifact
    check(session.stacked is not None, "the session did not stack the q8 decoder")
    cfg, params = session.cfg, session.params
    rng = np.random.default_rng(13)
    seconds = list(rng.uniform(*SERVE_SECONDS, size=16)) + [SERVE_LONG]
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16) for s in seconds]
    delays = rng.uniform(0.0, 0.2, size=len(clips))
    w = session.window_samples
    windows = sum(len(iter_windows(len(c), w, w)) for c in clips)
    httpd, srv, thread = start_background_continuous(session, n_slots=SERVE_SLOTS, kv_dtype="f32")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qm.LAUNCHES = fs.LAUNCHES = fm.LAUNCHES = 0  # the serving path starts here
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post_clip, args=(base, c, float(delays[i]), results, i))
                   for i, c in enumerate(clips)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "an HTTP request did not finish")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        int8, fused, multi = qm.LAUNCHES, fs.LAUNCHES, fm.LAUNCHES  # and ends here
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=60)
    check(health["ok"] and health["step_kernel"] == "fused", f"healthz: {health}")
    check(health["requests_served"] == windows, f"served {health['requests_served']} windows, "
          f"not {windows}")
    check(health["slots_active"] == 0 and health["queue_depth"] == 0, f"healthz: {health}")
    check(multi == health["decode_steps"] > 0, f"{multi} multi-slot launches for "
          f"{health['decode_steps']} decode steps")
    check(fused == 0, f"the batch-1 kernel was launched {fused} times")
    check(int8 == windows * int8_per_window(cfg), f"{int8} int8 launches, not {windows} windows x "
          f"{int8_per_window(cfg)}")
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
    lat = np.array([r[2] for r in results])

    # Each request's ids against session.transcribe on the same audio.
    equal, replayed = 0, []
    for i, clip in enumerate(clips):
        got = results[i][1]["token_ids"]
        res = session.transcribe(clip.astype(np.float32) / 32768.0)
        if got == res.token_ids:
            equal += 1
        else:
            replayed.append(i)
    # Where they differ, replay the server's ids teacher-forced, window by
    # window, through the per-weight step and the multi-slot kernel.
    replay = {"steps": 0, "worst_rel": 0.0, "under": 0, "same": 0}
    for i in replayed:
        audio = clips[i].astype(np.float32) / 32768.0
        ids, start = results[i][1]["token_ids"], 0
        for s0 in iter_windows(len(audio), w, w):
            start += replay_window(torch, fs, fm, wh, session, audio[s0 : s0 + w], ids[start:],
                                   replay, f"request {i}")
        check(start == len(ids), f"request {i}: the replay consumed {start} of {len(ids)} ids")
    print(f"[13 serve] {len(clips)} requests ({windows} windows, {SERVE_SLOTS} slots, f32 caches, "
          f"starts staggered 0-200 ms) in {wall:.2f} s; healthz {json.dumps(health)}")
    print(f"[13 serve] launches: multi-slot {multi} (= decode_steps {health['decode_steps']}), "
          f"batch-1 {fused}, int8 {int8} ({windows} windows x {int8_per_window(cfg)})")
    print(f"[13 serve] ids equal to session.transcribe (batch-1 kernel; per-weight for 2 windows) "
          f"for {equal}/{len(clips)} requests; replayed {len(replayed)} teacher-forced over "
          f"{replay['steps']} steps: multi vs per-weight within {replay['worst_rel']:.3e} of "
          f"max|logit| (bound {TEACHER_TOL}), {replay['under']} steps under the top-2 margin, "
          f"multi argmax = server id at {replay['same']}/{replay['steps']}")
    toks = health["tokens_generated"]
    step_s = health["step_latency_avg_s"]
    agg = toks / (health["decode_steps"] * step_s) if step_s else 0.0
    one = 1e3 / numbers["fused_ms_per_token"]
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    out = {"launches": multi, "int8": int8, "tokens": toks, "agg_tok_s": agg, "e2e_tok_s": toks / wall,
           "batch1_tok_s": one, "step_ms": step_s * 1e3, "p50_s": p50, "p95_s": p95,
           "queue_wait_s": health["queue_wait_avg_s"], "peak_mib": peak, "equal": equal}
    print(f"[13 numbers] decode {toks} tokens: {agg:.0f} tokens/s over step time ({toks / wall:.0f} "
          f"end to end) vs {one:.0f} tokens/s on the batch-1 fused route (phase 10); average step "
          f"{step_s * 1e3:.3f} ms; completion p50 {p50:.2f} s, p95 {p95:.2f} s (client side); "
          f"average queue wait {health['queue_wait_avg_s']:.3f} s; peak memory {peak:.0f} MiB  [{card}]")

    # Two requests on the rowwise route: a session without stacked weights.
    rows_sess = copy.copy(session)
    rows_sess.stacked = None
    rows_sess.scfg = dataclasses.replace(session.scfg, max_new_tokens=ROWWISE_BUDGET)
    srv2 = ContinuousSessionServer(rows_sess, n_slots=SERVE_SLOTS, kv_dtype="f32")
    try:
        before_m = fm.LAUNCHES
        pair = clips[:2]
        outs: list = [None, None]
        ths = [threading.Thread(target=lambda i=i: outs.__setitem__(i, srv2.transcribe_bytes(
            wav_bytes(pair[i])))) for i in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        st2 = srv2.stats()
    finally:
        srv2.close()
    check(st2["step_kernel"] == "rowwise" and fm.LAUNCHES == before_m,
          "the rowwise route launched the multi-slot kernel")
    for i in range(2):
        solo = rows_sess.transcribe(pair[i].astype(np.float32) / 32768.0).token_ids
        check(outs[i] is not None and outs[i]["token_ids"] == solo,
              f"rowwise request {i}: ids differ from the per-weight solo path")
    print(f"[13 serve] rowwise route (no stacked weights, {ROWWISE_BUDGET}-token budget): 2 requests, "
          f"ids equal to the per-weight solo path, {st2['decode_steps']} steps at "
          f"{st2['step_latency_avg_s'] * 1e3:.2f} ms, no multi-slot launch  [{card}]")
    del session, rows_sess, srv, srv2
    torch.cuda.empty_cache()
    return out


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
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.ops import fused_aed_multi as fm
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.ops import quant_matmul as qm
    from asr_tpu_torch.parallel.http_server import start_background
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_linear, quantize_pytree
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model
    from asr_tpu_torch.runtime.session import bucket_windows, load_session

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build((qm, fs, fm))
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

    del dense, lq, lp, session, params, params32
    torch.cuda.empty_cache()

    # ── 8-10. Whisper-Large-v3-Turbo q8, the fused decode-step kernel ─────
    fused = phase_fused_vs_plain(torch, fs, wh, quantize_pytree, card)
    with tempfile.TemporaryDirectory() as whisper_dir:
        wrun = phase_whisper(torch, np, qm, fs, whisper_dir, card)
        wnum = phase_whisper_numbers(torch, np, qm, fs, wrun, card)
        wrun_int8, wrun_fused = wrun["int8"], wrun["fused"]
        del wrun
        torch.cuda.empty_cache()
        # ── 11-13. the multi-slot decode-step kernel, continuous serving ──
        multi = phase_multi(torch, fs, fm, wh, quantize_pytree, fused, card)
        serve = phase_continuous(torch, np, qm, fs, fm, whisper_dir, wnum, card)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    worst = max(r["max_abs_err"] for r in kern["rows"])
    k_ms, p_ms = kern["per_forward"]["bf16"]
    i_bound, i_by, _, _ = int8_forward_bound()
    f_t = fused["times"]["float32"]
    f_bound, f_by = bound(f_t["bytes"], f_t["flops"])
    m_t = multi["times"][(MULTI_TIMED_B[-1], "float32")]
    print(json.dumps({"kernels": [{
        "name": "quant_matmul_int8",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/quant_matmul_int8.cu",
        "replaces": "asr_tpu/ops/quant_matmul.py:115",
        "launches": launches + wrun_int8 + serve["int8"],
        "launches_by_path": {"sensevoice": launches, "whisper": wrun_int8, "continuous": serve["int8"]},
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": i_bound,
        "bound_by": i_by,
        "library_ms": None,
        "timing": "sum over one batch-8 x 8 s forward's 281 calls (M=1096), mm=bf16, CUDA events",
    }, {
        "name": "fused_aed_step",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/fused_aed_step.cu",
        "replaces": "asr_tpu/ops/fused_aed_step.py:302",
        "launches": wrun_fused,
        "max_abs_err": fused["max_abs_err"],
        "ms": f_t["ms"],
        "plain_ms": f_t["plain_ms"],
        "bound_ms": f_bound,
        "bound_by": f_by,
        "library_ms": None,
        "timing": "one turbo q8 step, f32 caches, pos 447, 1500 cross rows, CUDA events",
    }, {
        "name": "fused_aed_multi",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/fused_aed_multi.cu",
        "replaces": "asr_tpu/ops/fused_aed_multi.py:90",
        "launches": serve["launches"],
        "max_abs_err": multi["max_abs_err"],
        "ms": m_t["ms"],
        "plain_ms": m_t["plain_ms"],
        "bound_ms": m_t["bound_ms"],
        "bound_by": m_t["bound_by"],
        "library_ms": None,
        "timing": f"one turbo q8 step of {MULTI_TIMED_B[-1]} slots, f32 caches, pos 447, 1500 cross "
                  "rows, CUDA events",
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
