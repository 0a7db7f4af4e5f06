#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths on one CUDA card and check them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases: (1) the card; (2) build the seven kernels from
``asr_tpu_torch/csrc`` with nvcc, one process per source, at once; (3)
the int8 dequant-matmul kernel against its plain PyTorch version at every
int8 shape of the main paths (SenseVoiceSmall at M = 1096 and 137, the
Whisper encoder and cross-KV at M = 1500, Whisper's per-weight step and
head at M = 1 and 2, the Qwen3-ASR tower at a 30 s window's rows with
``conv_out`` at K = 7680, the q2 head at M = 1, 4 and 8, the FireRed and
Dolphin encoders at a 30 s window's rows with their rel-pos projections at
2T - 1 rows, Dolphin's CTC head, both decoders' steps), both modes, rows
of every batched call bitwise equal to the row alone, device time from a
CUDA graph beside the host-launched time, the plain version's, the bound
and a cuBLAS bf16 yardstick; then, for one weight of each split count, rows
bitwise equal to the row alone at M = 1 .. 1500 across the plan's schedule
switches and every tile of the kernel bitwise equal, and the sums per
path; (4) SenseVoiceSmall at its full published geometry
with random weights from a seed, quantized to q8, saved as an artifact
folder and loaded back, transcribing 20 s of audio through
``SenseVoiceSession``; (5) the same session behind the HTTP micro-batching
server; (6) RTF and peak memory at batch 8 x 8 s, then the q8 logits
against the same forward on the dequantized weights with plain matmuls;
(8) the fused AED decode-step kernel against its plain version at the
Whisper-Large-v3-Turbo decoder geometry (f32 and bf16 caches, three
positions, two cross lengths), timed in turns, with its bound and, for
each cache type, its device busy time and idle share, a profile by part
(matvec, attention, LayerNorm epilogues) and its launches a step with the
launches unchained, and the device time of a CUDA graph of steps; (9) Whisper-Large-v3-Turbo
q8 at its full geometry through an artifact folder and
``load_whisper_session``: 20 s of audio (one window, the fused route), a
teacher-forced replay of its ids through the per-weight step, and 45 s
(two windows, the per-weight route); (10) encoder time, decode time per
token on both routes, the host sync's share, RTF of one 30 s window and
peak memory; (11) the multi-slot AED decode-step kernel against its plain
version and, slot by slot, bitwise against the batch-1 kernel (logits and
written cache rows) at turbo geometry (B = 2, 5, 8, 17 and 32, f32 and
bf16 caches, mixed positions with one parked slot, mixed cross lengths);
(12) its time at B = 2, 4, 8 against the plain version's, in turns, with
its bound and, for each B and cache type, a profile as phase 8's; (12b)
the two AED steps' shared tensor-core int8 matvec alone at the seven
turbo shapes, B = 1 and 8, against its plain version, rows bitwise alone,
device time of a CUDA graph beside its bound, and the plan's
shared-memory formulas against the kernels'; (13) continuous serving of
phase 9's artifact over HTTP: 9 concurrent requests (10 windows) with
staggered starts on 8 slots, every decode step through the multi-slot
kernel, each request's ids bitwise equal to it alone through the batcher
and against ``session.transcribe`` (a teacher-forced replay where they
differ), the serving numbers, and two requests on the rowwise route; (14) the
packed-int4 kernel against its plain version at every Qwen3-ASR-0.6B q4
shape (q|k|v, o, gate|up, down, the tied head) at M = 1, 8 and a 30 s
prefill's rows, both modes, timed in turns, and PyTorch's int4 call
(``torch._weight_int4pack_mm``) as a yardstick; (15) the fused Qwen3 decode
step against its plain version at full width (f32 and bf16 caches, three
positions with a left shift, the head in the kernel and separate), its time
at pos 440 in turns, its device busy time and idle share, a profile by part
(matvec, attention, epilogues) and its launches a step with the launches
unchained, and the device time of a CUDA graph of steps; (15b) the
two Qwen3 steps' shared tensor-core matvec alone at the five Qwen3-ASR-0.6B
shapes, B = 1 and 8, against its plain version, rows bitwise alone, device
time of a CUDA graph beside its bound; (16) Qwen3-ASR-0.6B (q8 tower, q4 LLM
and packed tied head) through an artifact folder and ``load_qwen_session``:
20 s on the fused route, a teacher-forced replay through the per-weight
step, one 30 s window's tower, prefill and per-token times, RTF and peak
memory, and the q4 logits against plain matmuls on dequantized weights;
(17) the same session behind the HTTP micro-batcher, 4 concurrent requests
in a batch of 4 (the per-weight route, int4 kernel at M = 4), each
request's ids against the per-weight route alone; (18) the multi-slot Qwen3
decode step against its plain version at full width (B = 2 and 8, f32 and
bf16 caches, the head in the kernel and separate, mixed positions up to 700
and one parked slot; phase 15's limits) and, slot by slot, bitwise against
the batch-1 kernel; (19) its time at B = 2, 4, 8 against the plain
version's, in turns, with its bound and, for each B and cache type, a
profile by part, launches a step and graph device time; (20)
continuous serving of phase 16's artifact over HTTP: 9 concurrent requests
of 5-30 s (a 96-token budget) with staggered starts on 8 slots, every decode step through the
multi-slot kernel, each request's ids against the same request alone
through the batcher (bitwise) and against ``session.transcribe`` (a
teacher-forced replay where they differ), the serving numbers, and two
requests on the rowwise route; (21) the packed-int2 kernel against its
plain version at every Qwen3-ASR-0.6B q2 shape at M = 1, 4, 8 and a 30 s
prefill's rows, both modes, rows of a batched call bitwise equal to the row
alone, timed in turns; (22) Qwen3-ASR-0.6B with a q8 tower, a packed-q2 LLM
and a 2-bit tied head through an artifact folder and ``load_qwen_session``
(the per-weight route): 20 s with its launch counts and its ids against a
replay with plain matmuls on the dequantized weights, one 30 s window's
numbers (a 48-token budget), and the q2 logits against plain matmuls; (23) the q2 session
behind the HTTP micro-batcher, 4 requests in a batch of 4 (the int2 kernel
at M = 4); (24) continuous serving of the q2 artifact on the rowwise route,
2 concurrent requests on 8 slots with a 48-token budget, each request's ids
bitwise equal to it alone through the batcher and against
``session.transcribe``; (25) the int8, int4 and int2 sources each built under
two cache keys and both libraries loaded in this process, a bf16 call
through each at a decode and a prefill shape, outputs bitwise equal; (26)
``python -m asr_tpu_torch inspect`` and ``transcribe`` in subprocesses on
phase 4's artifact folder with a vocab_txt tokenizer file: each file's
printed text the decode of ``session.transcribe``'s ids, and two files at
once (``transcribe_batch``) each with the ids of the file alone, or a top-2
margin below 1e-3 of max|logit| where not; (27) Fun-ASR-Nano with its LLM
head at full width (q8 encoder and adaptor, packed-q4 Qwen3-0.6B, 4-bit tied
head) through an artifact folder and the command line's ``_build_session``:
20 s on the fused route (text the decode of the ids), a replay with plain
matmuls on the dequantized weights, the prefill logits against plain, a 30
s window's numbers, and ``transcribe_batch`` of 4 on the lockstep route;
(28) its CTC head on a 45 s file through a ``fun_asr_nano`` artifact, and
9 concurrent requests to the continuous server on 8 slots (bf16 caches, a
48-token budget), each bitwise equal to it alone through the batcher; (29)
Qwen3-ForcedAligner-0.6B (q8 tower, packed-q4 LLM, f32 class head) aligning
a 12-word text to 20 s: monotone timestamps, buckets against a replay with
plain matmuls on the dequantized weights, ms per call; (30) the fused and
multi-slot AED kernels at FireRedASR-AED-L's decoder geometry (16 layers
at d 1280, a head of 8192 columns, 750 cross rows, bias-free
o-projections) and Dolphin's (6 layers at d 512, 27648 columns, 749 cross
rows), with phases 8 and 11's gates: f32 and bf16 caches, three
positions, all and fewer valid cross rows, slots bitwise the batch-1
kernel at B = 2 and 8, times beside their bounds and profiles; (31)
FireRedASR-AED-L q8 at full width through an artifact folder with a
firered_dict file and the command line's ``_build_session``: 20 s on the
fused route, its ids against a teacher-forced replay with plain matmuls on
the dequantized decoder, 45 s on the per-weight route, a 30 s window's
numbers; (32) Dolphin the same, with both probes inside its vocabulary, a
language forced by name through its catalog and its CTC head's RTF; (33)
each of the two served continuously over HTTP, 9 requests on 8 slots with
f32 caches, each request's ids bitwise equal to it alone through the
batcher and checked against ``session.transcribe``; (34) Paraformer-large,
(35) Parakeet-TDT-0.6B and (36) Nemotron-0.6B q8 at full width through an
artifact folder and ``_build_session``: in mm=f32 the encoder output and
every greedy step's joint logits (Paraformer: the decoder's over the fired
embeddings) against plain matmuls on the dequantized weights within 1e-3
of max|plain| and the ids the plain argmax above the margin; RTF of a
batch of 8 x 8 s in f32 and q8; one window (30 / 24 / 30 s) through the
session in the serving mode with its encoder, decode (tokens, steps, host
syncs, ms a step; Paraformer's CIF scan) timed apart, RTF and peak memory;
and, as part of (26), ``python -m asr_tpu_torch transcribe`` on each
artifact (Nemotron with ``--language``), its text the decode of
``session.transcribe``'s ids; (37) streaming Paraformer, (38) Nemotron,
(39) Dolphin and (40) X-ASR Zipformer2 q8 at full width
(``ParaformerStreamConfig()``, ``NemotronStreamConfig()``,
``DolphinStreamConfig()``, ``ZipformerConfig()``) through an artifact
folder and ``_build_session``: in mm=f32, the first 32 windows of 30 s
(Dolphin 32 s, X-ASR 8 s) chunk by chunk from the session's state, each window's
encoder output and every decision's logits against
plain matmuls on the dequantized weights within 1e-3 of max|plain| and the
ids the plain argmax above the margin, a window's int8 calls recorded
against ``stream_int8_calls``; in the serving mode the main path's
launches over 30 s (Dolphin's 32 s past its 752-frame history,
Paraformer's 60 chunks past its position table, X-ASR's 8 s), per-chunk latency p50 /
p95 against the chunk's duration, RTF and peak memory, and the first 10 s
with f32 weights; (41) each family's
runner at 8 slots: staggered starts and a reset, every slot's ids against
the session alone (bitwise, or the state rule), inactive slots bitwise
untouched, ``step_n`` at K = 4 = K = 1, the tick latency at N = 1 and 8
(Dolphin also with f32 weights); (42) ``serve-stream`` through the command
line: a ninth connection 503, 8 concurrent chunked-HTTP connections of
4-5 s, each bitwise its windows replayed in its slot and against the
session, ``/healthz``'s ``tick_latency_max_s`` and ``sync_latency_max_s``;
(43) SenseVoiceSmall from a FunASR checkpoint folder (``model.pt`` in
FunASR names, ``am.mvn``, a SentencePiece file the port reads) through
``python -m asr_tpu_torch build``, then six quantized artifacts made at
once, each by its own process on the card: ``quantize --algorithm rtn``,
``kquant``, ``hqq --bits 4 --pack``, ``dynamic``, ``optimize --plan``
(encoder q8 kquant, the CTC head q8 rtn) and ``quantize --reorder
absmean --algorithm kquant``; the built tree bitwise the checkpoint under
the FunASR layout, sampled leaves of every shape class bitwise the same
fit made on the card and, block by block, the CPU's fit up to rounding
boundaries (``fit_gap``), each artifact's batch-8 x 8 s forward through
``load_session`` against plain matmuls on its dequantized weights (a
dynamic artifact's every product against the plain dynamic route on its
rows), its launches, and ``transcribe``'s text the decode of the
session's ids; (44)
Whisper-Large-v3-Turbo from an HF snapshot in F16 through ``build`` and
``quantize --algorithm kquant --quantize-embeddings``: the fused route of
``load_whisper_session``, its ids on a 30 s window bitwise a session from
the same quantization made in memory, the metadata's tables; (45)
``parity`` through ``cli.main`` with a seeded ``--examples`` folder on
phase 9's Whisper, phase 16's Qwen3-ASR, phase 4's SenseVoiceSmall and
phase 40's X-ASR artifact folders (Qwen3-ASR and X-ASR on one fixture): ``--save-golden``, ``--golden`` on the
same file (rc 0: the card run repeats itself), a moved stage snapshot (rc
1 naming the stage), the matmul mode given back, and a SenseVoice golden
captured by ``--platform cpu`` (the plain versions) held on the card;
(46) ``transcribe --profile`` on phase 4's folder: the Chrome trace holds
CUDA kernel events, one forward's 281 int8 kernels; (47) 8 chunks of one
stream of each streaming family under ``runtime/profiling.trace``: kernel
launches and device busy time a chunk, the device's idle share, beside
the chunk p50; (48) a BF16 Qwen3-ASR HF snapshot at the published widths
(2 tower and 2 LLM layers) through ``build``: every leaf on the card
bitwise the snapshot's, a window transcribed with the serving cast
``float32``, ``optimize`` with a ``bf16`` plan reloading bitwise; (49)
SenseVoiceSmall CTC fine-tuning at full width (``SenseVoiceConfig()``, 920
f32 leaves) through ``parallel/train.fit`` and ``train_step``: batch 8 x
8 s, labels of 24-48 ids, mixed language rows, 5 AdamW steps on one
batch, the losses finite and falling, ms a step, the AdamW update's share,
peak memory, kernel launches a step under ``runtime/profiling.trace``, and
at 1 + 2 + 1 blocks and batch 2 the loss and every leaf's gradient on the
card against the CPU's; (50) Whisper-Large-v3-Turbo teacher-forced
cross-entropy at full width (B = 2 x 30 s of mel, 64-token targets,
label smoothing 0.1, 3 steps; card = CPU at 1 + 1 layers and 400 mel
frames); (51) Parakeet-TDT-0.6B RNN-T at full width (B = 4 x 8 s, 32
labels, 3 steps; card = CPU at one conformer block) and ``rnnt_loss`` /
``tdt_loss`` on a random lattice of the joint's shape, card against CPU in
NLL and gradient, the wavefront's time, launches and peak memory; (52)
``save_train_state`` / ``restore_train_state`` of phase 49's parameters
and AdamW state, bitwise on the card, and ``fit``'s resume (2 steps +
checkpoint + restore into fresh tensors + 2 against 4 straight).

Then multi-device serving on meshes of card positions (``card_positions``:
the visible cards in turn, so one card holds several): (53) phase 4's q8
SenseVoiceSmall, batch 8 x 8 s, through ``DataParallelRunner`` at dp 2 x
tp 2, tp 4 and dp 4 against the unsharded forward (mm=f32: tp logits
within 1e-3 of max|logit| and the framewise argmax equal above the margin,
dp rows bitwise), every position's 281 int8 launches, a column and two
row shard calls against their plain version, the forwards timed in bf16;
(57) ``transcribe --data-parallel 2 --tensor-parallel 2`` through
``cli.main`` on phase 4's artifact against the unsharded command; (58)
``__graft_entry__.dryrun_multichip`` at its tiny widths on a dp 4 x tp 2
mesh: its SenseVoice CTC train step on the positions' own leaves (loss
and gathered gradients against the unsharded step), then the serving half
(a Whisper tp x dp encode, a Qwen3 prefill and step, a continuous tp step)
against the unsharded runs; (59) the int8 and int4 kernels on a
second card (only where there is one); (54) phase 9's Whisper at tp 2,
one 30 s window on the rowwise decode against the unsharded rowwise run,
ms a token; (56) its continuous server at ``data_parallel=2``, each
request bitwise it alone on either replica; (55) phase 16's Qwen3-ASR
through ``ContinuousSessionServer`` at ``tensor_parallel=2`` (ids against
the unsharded rowwise batcher, a replay where they differ) and at
``data_parallel=2`` (each request bitwise it alone on either replica).
Then training over meshes of card positions at full width, each against
the unsharded port on the same weights and batch (the loss within JAX's
bound, every gathered gradient within the card gradient gate or twice the
unsharded port's own spread under last-bit changes; three ``fit`` steps
falling; every position's copies of a leaf and its moments bitwise
alike; ms a step, peak memory, launches of a traced step, the gradient
reduction's and AdamW's shares): (60) SenseVoiceSmall CTC, phase 49's
batch, at dp 2 x tp 2 and tp 4; (61) Whisper-Large-v3-Turbo, phase 50's
batch (slices of 63 and 39 target positions), at dp 2 x tp 2; (62)
Parakeet-TDT-0.6B, phase 51's batch, at dp 2; (63) ``fit`` with a
checkpoint on a dp 2 x tp 2 mesh at phase 52's cut depth, the file read
into the unsharded layout bitwise, resumed on a fresh layout against the
uninterrupted run and resumed in the unsharded layout.
Positions that share a card take turns on it (``parallel/mesh.device_lock``),
so their times are no speed result.

Each path's launch counts are reset just before it and read just after:
every q8 SenseVoice forward launches the int8 kernel 281 times (70 blocks
x 4 linears + the CTC head); one Whisper window launches it for the
encoder, the cross-KV and the two prefills, and the fused kernel once per
decode step; continuous serving launches the multi-slot kernel once per
decode step and never the batch-1 kernel; one Qwen3-ASR window launches
the int8 kernel 195 times (the tower), the int4 kernel 113 times (the
prefill's 28 x 4 linears and the first logits) and the fused Qwen3 step
once per decode step; continuous Qwen3-ASR serving launches the multi-slot
Qwen3 step once per decode step, the int4 kernel 113 times a prefill and
never the batch-1 step; every LLM pass of the q2 model (a prefill, a
per-weight step, a rowwise step of all slots) launches the int2 kernel 112
times (28 x 4 linears) and the int8 kernel once (the 2-bit tied head), and
neither the int4 kernel nor a fused step; one Fun-ASR-Nano LLM window
launches the int8 kernel 290 times (280 encoder + 10 adaptor linears), the
int4 kernel 113 times and the fused Qwen3 step once per decode step, its
CTC forward the int8 kernel 291 times (280 + 11 head linears), its
continuous serving the multi-slot step once per decode step; one aligner
pass launches the int8 kernel 195 times (the tower) and the int4 kernel 196
times (28 x 7 unfused linears); one FireRed window launches the int8 kernel
338 times (the encoder's 177, the cross-KV's 32, the [SOS] prefill's 129)
and the fused step once per decode step; one Dolphin window 316 times (the
encoder's 145, two cross-KVs' 24, the two probes' and the prompt's 3 x 49)
and the fused step once per decode step, its CTC head 146 (the encoder and
the head); their continuous serving launches the multi-slot step once per
decode step, the int8 kernel as often as the windows' prefills, and never
the batch-1 step. One Paraformer window launches the int8 kernel 283
times (the encoder's 200, the decoder's 83), a Parakeet window 266 (the
encoder) + 2 a greedy step, a Nemotron window 267 + 2 a greedy step; the
transducer loops read ``all(done)`` on the host once every 8 steps.
A streaming chunk launches it as ``stream_int8_calls`` counts: Paraformer
200 (+ 83 on a fire), Nemotron 243 + 2 a greedy step, Dolphin 146 (+ 48 a
rescoring pass), X-ASR 261 (257 encoder calls and 4 decoder projections).
A built q8 SenseVoice artifact's forward launches the int8 kernel 281
times, the hqq 4-bit one the int4 kernel 280 times and the int8 kernel
once (the first block's K = 560 leaf does not pack), the dynamic one
neither. Training (49-52, 58's step, 60-63) launches none of the seven
kernels: its leaves are f32 and never reach ``quant_dense``. A sharded SenseVoice forward
launches the int8 kernel 281 times at every mesh position.

Any failed check raises, so the script exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
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
GRAPH_CALLS = 50  # back-to-back calls in one CUDA graph, for device times without launch cost


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


def phase_build(sources, salted=()) -> None:
    """Build every kernel's library at once, one nvcc per source, and the
    second libraries of ``salted`` (sources built under the cache key of
    :data:`LINKAGE_SALT`, for phase 25) beside them."""
    from concurrent.futures import ThreadPoolExecutor

    from asr_tpu_torch.ops import nvcc_build

    def timed(job):
        source, salt = job
        t0 = time.perf_counter()
        lib, log = nvcc_build.build(source, salt=salt)
        return lib, log, time.perf_counter() - t0

    jobs = [(source, "") for source in sources] + [(source, LINKAGE_SALT) for source in salted]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(timed, jobs))
    for lib, log, secs in built:
        print(f"[2 build] {lib.relative_to(ROOT)} in {secs:.2f} s (nvcc {' '.join(nvcc_build.NVCC_FLAGS)})")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"[2 build] ptxas: {line.strip()}")
        if lib.name.startswith(("libquant_matmul_int8", "libquant_matmul_int4", "libquant_matmul_int2")):
            spills = [ln.strip() for ln in log.splitlines()
                      if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
            check(not spills, f"{lib.name} spills registers: {spills}")


# ── 25. linkage: two libraries of one kernel source in one process ────────
LINKAGE_SALT = "linkage"
# (source attribute of quant_matmul, packed parts or 0 for int8, K, N, decode M, prefill M)
LINKAGE_CASES = (("SOURCE", 0, 1280, 5120, 1, 1500), ("SOURCE_INT4", 2, 1024, 6144, 1, 432),
                 ("SOURCE_INT2", 4, 1024, 6144, 1, 432))


def phase_linkage(torch, qm, quantize_linear, card: str) -> dict:
    """[25] The int8, int4 and int2 sources each built under two cache keys
    (the wrapper's library and a salted second one), both loaded in this
    process: a bf16 call through each at a decode and a prefill shape must
    launch and give bitwise equal outputs. With the kernels' launch helpers
    externally visible, the second library shared the first's "attribute
    already set" static and its bf16 launch failed (CUDA error 1)."""
    g = torch.Generator(device=DEV).manual_seed(25)
    out = {}
    for attr, parts, k, n, m_dec, m_pre in LINKAGE_CASES:
        source = getattr(qm, attr)
        second = qm.load_library(source, LINKAGE_SALT)
        bits = {0: 8, 2: 4, 4: 2}[parts]
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, bits, 128,
                               pack=parts > 0)
        for m in (m_dec, m_pre):
            x = torch.randn((m, k), generator=g, device=DEV)
            args = (x, leaf.q, leaf.scale, leaf.zero, 128, "bf16")
            if parts:
                name = source.stem
                first = qm._packed_launch(name, parts, *args)
                other = qm._packed_launch(name, parts, *args, lib=second)
            else:
                first = qm._int8_launch(*args)
                other = qm._int8_launch(*args, lib=second)
            torch.cuda.synchronize()
            check(torch.equal(first, other), f"{source.name} at M={m} K={k} N={n}: the two libraries' "
                  "bf16 outputs differ")
            out[(source.stem, m)] = True
        print(f"[25 linkage] {source.name}: the wrapper's library and a second build ({LINKAGE_SALT!r}) "
              f"in one process, bf16 at M={m_dec} and M={m_pre} (K={k}, N={n}): both launch, outputs "
              f"bitwise equal  [{card}]")
    return out


def int8_paths() -> dict:
    """The int8 kernel's calls on each main path: path -> {(M, K, N, block):
    calls}. SenseVoiceSmall q8: one batch-8 x 8 s forward (M = 1096) and one
    request (M = 137); Whisper-Large-v3-Turbo: one 30 s window's encoder (6
    linears a layer) and cross-KV (2 a decoder layer) at M = 1500, and one
    per-weight decode step (8 linears a decoder layer and the head, V padded
    to 512) at M = 1 and 2; Qwen3-ASR-0.6B: one 30 s window's tower (conv_out,
    6 linears a layer, the two projections) at its rows; the q2 model's
    2-bit tied head at M = 1, 4 and 8 (one call an LLM pass)."""
    from asr_tpu_torch.models.qwen_asr import QwenAsrConfig
    from asr_tpu_torch.models.whisper import WhisperConfig

    w, q = WhisperConfig(), QwenAsrConfig()
    d, f, pad = w.d_model, w.ffn_dim, lambda v: -(-v // 512) * 512
    enc = 4 * w.encoder_layers + 2 * w.decoder_layers
    paths = {"sensevoice_b8": {(BATCH * ROWS, k, n, b): c for (k, n, b), c in SLICE_SHAPES.items()},
             "sensevoice_b1": {(ROWS, k, n, b): c for (k, n, b), c in SLICE_SHAPES.items()},
             "whisper_encoder": {(w.max_source_positions, d, d, 128): enc,
                                 (w.max_source_positions, d, f, 128): w.encoder_layers,
                                 (w.max_source_positions, f, d, 128): w.encoder_layers}}
    for m in (1, 2):
        paths[f"whisper_step_m{m}"] = {(m, d, d, 128): 6 * w.decoder_layers,
                                       (m, d, f, 128): w.decoder_layers, (m, f, d, 128): w.decoder_layers,
                                       (m, d, pad(w.vocab_size), 128): 1}
    rows, t, tf = qwen_tower_rows(q), q.tower_dim, q.tower_ffn
    c_in = q.downsample_hidden * -(-q.n_mels // 8)  # conv_out: channels x mel bins after three stride-2 convs
    paths["qwen_tower"] = {(rows, c_in, t, 128): 1, (rows, t, t, 128): 4 * q.tower_layers + 1,
                           (rows, t, tf, 128): q.tower_layers, (rows, tf, t, 128): q.tower_layers,
                           (rows, t, q.output_dim, 128): 1}
    for m in (1, 4, 8):
        paths[f"q2_head_m{m}"] = {(m, q.llm.hidden, pad(q.llm.vocab_size), 128): 1}
    # Fun-ASR-Nano q8: the SANM encoder (SenseVoiceSmall's blocks without its
    # CTC head) at a 30 s window's LFR rows, then the adaptor (LLM path: one
    # window, and the lockstep batch of FUN_BATCH) or the CTC head (the two
    # windows of a 45 s file in one forward). The aligner's q8 tower is the
    # Qwen3-ASR tower at the same rows (qwen_tower).
    from asr_tpu_torch.models.fun_asr_nano import FunAsrNanoConfig

    fc = FunAsrNanoConfig()
    enc = {kn: c for kn, c in SLICE_SHAPES.items() if kn[1] != 25055}
    def head(d_in, d, ffn, blocks, *extra):  # linear1, linear2, the MHA blocks' four linears
        return [(d_in, d, 1), (d, d, 1), *[(d, n, blocks) for n in (3 * d, d, ffn)], (ffn, d, blocks), *extra]

    adaptor = head(fc.hidden, fc.adaptor_hidden, fc.adaptor_ffn, fc.adaptor_blocks)
    ctc = head(fc.hidden, fc.ctc_hidden, fc.ctc_ffn, fc.ctc_blocks, (fc.ctc_hidden, fc.ctc_vocab, 1))
    rows = fun_lfr_rows(fc)
    for name, m, top in (("fun_llm", rows, adaptor), (f"fun_llm_b{FUN_BATCH}", FUN_BATCH * rows, adaptor),
                         ("fun_ctc_45s", 2 * rows, ctc)):
        calls = {}
        for k, n, b, c in [*((k, n, b, c) for (k, n, b), c in enc.items()), *((k, n, 128, c) for k, n, c in top)]:
            calls[(m, k, n, b)] = calls.get((m, k, n, b), 0) + c
        paths[name] = calls
    paths.update(aed_family_int8_paths())
    paths.update(offline_int8_paths())
    paths.update(stream_int8_paths())
    return paths


def fun_lfr_rows(cfg) -> int:
    """LFR rows of one 30 s Fun-ASR-Nano window (the sessions pad to it)."""
    return -(-cfg.fbank.num_frames(30 * cfg.sample_rate) // cfg.lfr_n)


def qwen_tower_rows(cfg) -> int:
    """Rows of every tower linear in one 30 s window: the windows' tokens."""
    frames = 30 * cfg.sample_rate // cfg.mel_config().hop_length
    per_window = cfg.chunk_frames * cfg.chunks_per_window
    return -(-frames // per_window) * cfg.tokens_per_window


def int8_cost(m: int, k: int, n: int, block: int) -> tuple[int, float]:
    """Bytes (x f32 read, the int8 weight, its f32 scales and zeros, the f32
    output written) and operations (2 M K N) of one int8 call."""
    return 4 * m * k + k * n + 2 * 4 * (k // block) * n + 4 * m * n, 2.0 * m * k * n


def int8_path_bound(calls: dict) -> tuple[float, str, float, float]:
    """The int8 kernel's bound over a path's calls ({(M, K, N, block):
    count}): each call's larger time (:func:`bound`), summed; what bounds the
    sum; its bytes and operations."""
    total, nbytes, flops = 0.0, 0.0, 0.0
    for (m, k, n, block), count in calls.items():
        b, f = int8_cost(m, k, n, block)
        total += count * bound(b, f)[0]
        nbytes += count * b
        flops += count * f
    return total, bound(nbytes, flops)[1], nbytes, flops


# Rows at which a batched int8 call is held bitwise to the row alone, across
# every schedule switch of the plan (cluster at M <= 16 and at mid M, a
# walking tile above), for one weight of each split count.
INT8_ROW_M = (1, 4, 8, 16, 17, 137, 1096, 1500)
INT8_ROW_SHAPES = ((512, 512, 128), (560, 1536, 560), (512, 25055, 128), (1280, 1280, 128),
                   (5120, 1280, 128), (7680, 1280, 128))
INT8_GRAPH_CALLS = {"bf16": GRAPH_CALLS, "f32": 10}  # the f32 CUDA-core kernel is slow at M = 1500


def int8_tiles(qm) -> list:
    """Every (V-free) schedule the bf16 kernel has: (BN, BM, walk)."""
    return ([(bn, bm, False) for bm, bn in qm.INT8_CLUSTER_TILES]
            + [(bn, bm, True) for bm, bn in qm.INT8_WALK_TILES])


def phase_kernel_vs_plain(torch, qm, quantize_linear, card: str) -> dict:
    """[3] The int8 kernel at every shape of the main paths (:func:`int8_paths`),
    both modes: against the plain version within 1e-4 of max|plain|, rows of
    every batched call bitwise equal to the row alone; device time from a
    CUDA graph of back-to-back calls beside the host-launched time, the plain
    version's (CUDA events), the bound and a cuBLAS bf16 yardstick (bf16 x
    times the bf16 dequantized weight: not the same function, never called
    by the port). Then, for one weight of each split count, rows bitwise
    equal to the row alone at every M of INT8_ROW_M and every schedule the
    kernel has bitwise equal to the plan's. Sums per path."""
    paths = int8_paths()
    shapes: dict = {}
    for calls in paths.values():
        for (m, k, n, block) in calls:
            shapes.setdefault((k, n, block), set()).add(m)
    g = torch.Generator(device=DEV).manual_seed(1234)
    rows, worst, by_key = [], 0.0, {}
    for (k, n, block), ms in shapes.items():
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, 8, 128)
        check(leaf.block == block, f"block {leaf.block} != {block} at K={k}")
        w16 = qm.dequantize_weight({"q": leaf.q, "scale": leaf.scale, "zero": leaf.zero,
                                    "block": block}).to(torch.bfloat16)
        for m in sorted(ms):
            x = torch.randn((m, k), generator=g, device=DEV)
            plan = qm.int8_plan(m, k, n, block)
            for mm in ("f32", "bf16"):
                args = (x, leaf.q, leaf.scale, leaf.zero, block, mm)
                got = qm.quant_matmul_int8(*args)
                torch.cuda.synchronize()
                want = qm.quant_dense_reference(*args)
                err = (got - want).abs().max().item()
                ref = want.abs().max().item()
                check(err <= 1e-4 * ref, f"kernel vs plain at M={m} K={k} N={n} {mm}: {err} > 1e-4 * {ref}")
                worst = max(worst, err)
                for r in sorted({0, m // 2, m - 1}) if m > 1 else ():
                    one = qm.quant_matmul_int8(x[r : r + 1].contiguous(), *args[1:])
                    check(torch.equal(one[0], got[r]), f"int8 at M={m} K={k} N={n} {mm}: row {r} differs "
                          "from the same row alone")
                calls = INT8_GRAPH_CALLS[mm]
                p1 = time_ms(lambda: qm.quant_dense_reference(*args), 5, 2)
                k1 = graph_ms(torch, lambda: qm.quant_matmul_int8(*args), calls, 3)
                k2 = graph_ms(torch, lambda: qm.quant_matmul_int8(*args), calls, 3)
                p2 = time_ms(lambda: qm.quant_dense_reference(*args), 5, 2)
                host_ms = time_ms(lambda: qm.quant_matmul_int8(*args), 10, 2)
                yard = None
                if mm == "bf16":
                    xb = x.to(torch.bfloat16)
                    yard = graph_ms(torch, lambda: torch.matmul(xb, w16), GRAPH_CALLS, 3)
                nbytes, ops = int8_cost(m, k, n, block)
                b_ms, b_by = bound(nbytes, ops)
                row = {"m": m, "k": k, "n": n, "block": block, "mm": mm, "ms": (k1 + k2) / 2,
                       "plain_ms": (p1 + p2) / 2, "host_ms": host_ms, "yardstick_ms": yard, "bound_ms": b_ms,
                       "bound_by": b_by, "max_abs_err": err, "plan": plan if mm == "bf16" else None}
                rows.append(row)
                by_key[(m, k, n, block, mm)] = row
                yard_txt = f"  cuBLAS bf16 yardstick {yard:.4f} ms" if yard is not None else ""
                plan_txt = (f"plan V={plan[0]} BN={plan[1]} BM={plan[2]} {'walk' if plan[3] else 'cluster'} "
                            if mm == "bf16" else "")
                print(f"[3 int8] M={m:5d} K={k:5d} N={n:6d} block={block:3d} mm={mm:4s} {plan_txt}"
                      f"kernel {row['ms']:.4f} ms ({ops / (row['ms'] * 1e9):.1f} TFLOP/s; host-launched "
                      f"{host_ms:.4f} ms){yard_txt}  plain {row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms "
                      f"({b_by})  err {err:.3e} (max|plain| {ref:.3e})  [{card}]")
        del w16

    for k, n, block in INT8_ROW_SHAPES:
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, 8, 128)
        x = torch.randn((max(INT8_ROW_M), k), generator=g, device=DEV)
        v = qm.int8_split(k, n, block)[0]
        alone = {}
        for m in INT8_ROW_M:
            got = qm.quant_matmul_int8(x[:m].contiguous(), leaf.q, leaf.scale, leaf.zero, block, "bf16")
            for r in sorted({0, m // 2, m - 1}):
                if r not in alone:
                    alone[r] = qm.quant_matmul_int8(x[r : r + 1].contiguous(), leaf.q, leaf.scale, leaf.zero,
                                                    block, "bf16")[0]
                check(torch.equal(alone[r], got[r]), f"int8 at M={m} K={k} N={n} plan "
                      f"{qm.int8_plan(m, k, n, block)}: row {r} differs from the same row alone")
            if m == 137:  # every tile and schedule the kernel has, on the same split
                for bn, bm, walk in int8_tiles(qm):
                    other = qm.quant_matmul_int8(x[:m].contiguous(), leaf.q, leaf.scale, leaf.zero, block,
                                                 "bf16", plan=(v, bn, bm, walk))
                    check(torch.equal(other, got), f"int8 at M={m} K={k} N={n}: schedule BN={bn} BM={bm} "
                          f"walk={walk} differs from the plan's {qm.int8_plan(m, k, n, block)}")
        torch.cuda.synchronize()
        print(f"[3 int8] K={k} N={n} block={block} V={v}: rows bitwise = the row alone at M = "
              f"{', '.join(map(str, INT8_ROW_M))} (schedules "
              f"{sorted({qm.int8_plan(m, k, n, block)[1:] for m in INT8_ROW_M})}), and all "
              f"{len(int8_tiles(qm))} schedules bitwise equal at M = 137  [{card}]")

    per_path = {}
    for name, calls in paths.items():
        tot = {}
        for mm in ("bf16", "f32"):
            t = {key: 0.0 for key in ("ms", "plain_ms", "host_ms", "yardstick_ms")}
            for (m, k, n, block), count in calls.items():
                r = by_key[(m, k, n, block, mm)]
                for key in t:
                    t[key] = None if t[key] is None or r[key] is None else t[key] + count * r[key]
            tot[mm] = t
        b_ms, b_by, nbytes, ops = int8_path_bound(calls)
        per_path[name] = {"calls": sum(calls.values()), "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
                          "bytes": nbytes,
                          **{f"{mm}_{key}": v for mm, t in tot.items() for key, v in t.items()}}
        pp = per_path[name]
        print(f"[3 int8] {name}: {pp['calls']} calls, bf16 kernel {pp['bf16_ms']:.3f} ms "
              f"({ops / (pp['bf16_ms'] * 1e9):.1f} TFLOP/s; host-launched {pp['bf16_host_ms']:.3f}), "
              f"f32 kernel {pp['f32_ms']:.3f} ms, plain {pp['bf16_plain_ms']:.3f} / "
              f"{pp['f32_plain_ms']:.3f} ms (bf16 / f32), bound {b_ms:.4f} ms ({b_by}), cuBLAS bf16 yardstick "
              f"{pp['bf16_yardstick_ms']:.3f} ms  [{card}]")
    sv = per_path["sensevoice_b8"]
    per_fwd = {mm: [sv[f"{mm}_ms"], sv[f"{mm}_plain_ms"]] for mm in ("f32", "bf16")}
    return {"rows": rows, "max_abs_err": worst, "per_forward": per_fwd, "per_path": per_path}


def logits_margin(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


# ── Whisper-Large-v3-Turbo q8 and the fused decode-step kernel ──────────────
FUSED_POS = (3, 200, 447)
FUSED_TC = (1500, 750)
AED_GEOMETRY = (1280, 5120, 52224, 448, 1500)  # turbo's D, F, V_pad, self and cross rows
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
    dec = params["decoder"]

    def x_of(pos):
        return (dec["embed"][torch.tensor([1000 + pos], device=DEV)] + dec["pos"][pos : pos + 1]).float()

    out = fused_vs_plain(torch, fs, stacked, geom, cfg.decoder_layers, cfg.max_target_positions,
                         cfg.max_source_positions, cfg.vocab_size, x_of, FUSED_TC, g, "8", card)
    del params, stacked
    torch.cuda.empty_cache()
    return out


def fused_vs_plain(torch, fs, stacked, geom, nl: int, t: int, tc: int, v: int, x_of, tcs, g,
                   label: str, card: str) -> dict:
    """The fused-step kernel against its plain version on ``stacked``: f32
    and bf16 caches of ``t`` self and ``tc`` cross rows, the positions of
    FUSED_POS, ``tcs`` valid cross rows (``x_of(pos)``: the input row);
    then, at the last position and ``tcs[0]``, the plain version on the host
    against the card, the kernel's time in turns with its bound, and its
    profile."""
    d = geom.d_model
    rows, worst, times = [], 0.0, {}
    for cdt in (torch.float32, torch.bfloat16):
        ks = torch.randn((nl, t, d), generator=g, device=DEV).to(cdt)
        vs = torch.randn((nl, t, d), generator=g, device=DEV).to(cdt)
        ck = torch.randn((nl, tc, d), generator=g, device=DEV).to(cdt)
        cv = torch.randn((nl, tc, d), generator=g, device=DEV).to(cdt)
        for pos in FUSED_POS:
            x = x_of(pos)
            for tcv in tcs:
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
                print(f"[{label} fused] cache={rows[-1]['cache']:8s} pos={pos:3d} tc_valid={tcv:4d}: "
                      f"logits err {err:.3e} (max|plain| {ref:.3e}, {err / ref:.2e} of it); "
                      f"written row err {row_err:.3e} (layer 0: {row0:.3e}, max|row| {row_ref:.3e})")
                worst = max(worst, err)
                check(err <= FUSED_LOGIT_TOL * ref, f"fused logits vs plain: {err} > {FUSED_LOGIT_TOL} * {ref}")
                tol0 = ROW0_TOL[rows[-1]["cache"]]
                check(row0 <= tol0 * row_ref, f"layer-0 row vs plain: {row0} > {tol0} * {row_ref}")
        pos, tcv = FUSED_POS[-1], tcs[0]
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
        print(f"[{label} fused] cache={rows[-1]['cache']} pos={pos} tc_valid={tcv}: plain version on the host "
              f"vs on the card: {drift:.3e} ({drift / on_card.abs().max().item():.2e} of max|logit|)")
        del host, on_host
        k_ms, p_ms = in_turns(
            lambda: fs.fused_aed_step_reference(stacked, geom, x, kk, vk, ck, cv, pos, tcv),
            lambda: fs.fused_aed_step_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tcv))
        nbytes = step_bytes(stacked, nl, d, pos, tcv, ks.element_size())
        rate = nbytes / (k_ms * 1e-3)
        flops = step_flops(stacked, nl, d, [(pos, tcv)])
        b_ms, b_by = bound(nbytes, flops)
        times[rows[-1]["cache"]] = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes, "bytes_per_s": rate,
                                    "flops": flops, "bound_ms": b_ms, "bound_by": b_by}
        print(f"[{label} fused] cache={rows[-1]['cache']} pos={pos} tc_valid={tcv}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms; {nbytes / 1e6:.1f} MB per step, {rate / 1e9:.0f} GB/s, "
              f"{rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound {b_ms:.4f} ms ({b_by})  [{card}]")
        unchained = fs.aed_plan(d, geom.ffn_dim, stacked["wh"].shape[1], t, tc, pdl=False)
        prof = step_profile(
            torch, lambda: fs.fused_aed_step_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tcv),
            lambda: fs.fused_aed_step_cuda(stacked, geom, x, kk, vk, ck, cv, pos, tcv, plan=unchained))
        times[rows[-1]["cache"]]["profile"] = prof
        print_step_profile(label, f"cache={rows[-1]['cache']} pos={pos} tc_valid={tcv}", prof, card)
    return {"rows": rows, "max_abs_err": worst, "times": times}


def synced(torch, fn):
    """(result, seconds) of fn() on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def graphed_vs_eager(torch, fs, decoder, layers, p_len: int, first, buf, dcfg, tc_valid,
                     label: str, card: str) -> dict:
    """Greedy decode of one prefilled window on a session's
    ``FusedAedDecoder``: one CUDA graph replay a token against the eager
    loop (``ar_decode``, the position on the host), tokens and counts
    bitwise; one ``LAUNCHES`` a step on both; ``GRAPH_REPLAYS`` every
    graphed step but the eager first step of a shape's first request; ms a
    token of each (host clock, the cache copy included)."""
    def run(graphed: bool):
        l0, r0, c0 = fs.LAUNCHES, fs.GRAPH_REPLAYS, fs.GRAPH_CAPTURES
        loop = decoder.decode if graphed else decoder.host_loop
        (toks, counts), t = synced(torch, lambda: loop(layers, p_len, first, buf, dcfg, tc_valid=tc_valid))
        steps = int(counts[0]) - 1
        check(fs.LAUNCHES - l0 == steps, f"{fs.LAUNCHES - l0} step launches for {steps} steps")
        replays, captures = fs.GRAPH_REPLAYS - r0, fs.GRAPH_CAPTURES - c0
        want = steps - captures if graphed else 0
        check(replays == want, f"{replays} graph replays for {steps} steps ({captures} captures)")
        return toks, counts, t * 1e3 / max(steps, 1), steps

    run(True)  # the shape's graph, if this is its first request
    eager, graphed = run(False), run(True)
    check(torch.equal(eager[0], graphed[0]) and torch.equal(eager[1], graphed[1]),
          "graphed greedy tokens differ from the eager loop's")
    print(f"[{label}] graphed vs eager greedy decode: tokens and counts bitwise equal over {eager[3]} "
          f"steps; {graphed[2]:.3f} ms a token graphed, {eager[2]:.3f} eager  [{card}]")
    return {"graphed_ms_per_token": graphed[2], "eager_ms_per_token": eager[2], "graphed_steps": eager[3]}


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
        for route, stacked in (("fused", session.decoder), ("per-weight", None)):
            res, t_all = synced(torch, lambda: wh.transcribe_window(params, cfg, mel, prompt, dcfg,
                                                                     stacked=stacked))
            steps = int(res["counts"].max()) - 1
            out[f"{route}_ms_per_token"] = (t_all - t_pre) * 1e3 / max(steps, 1)
            out[f"{route}_steps"] = steps
        pre = wh.prefill_window(params, cfg, mel, prompt, dcfg)
        p_len = prompt.shape[1]
        buf = torch.zeros((1, p_len + dcfg.max_new_tokens + 1), dtype=torch.int64, device=DEV)
        buf[:, :p_len] = pre["prompt"]
        first = select_token(pre["logits0"], buf, p_len, dcfg)
        out.update(graphed_vs_eager(torch, fs, session.decoder, pre["state"]["layers"], p_len, first,
                                    buf, dcfg, None, "10 numbers", card))
        # The host sync: the same fused steps with and without a stop test each step.
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
MULTI_B = (2, 5, 8, 17, 32)  # one and two m16 tiles of the matvec
MULTI_TIMED_B = (2, 4, 8)
SERVE_SLOTS = 8
SERVE_SECONDS = (5.0, 30.0)  # SERVE_WINDOWED requests of one window each, lengths drawn from this range
SERVE_WINDOWED = 8  # the run-time limit: 8 slots still see 10 windows join and leave
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
        # "void aedstep::(anonymous namespace)::attn_aed<float, false>(...)" -> "attn_aed"
        name = re.sub(r"^void ", "", e.key.replace("(anonymous namespace)::", ""))
        name = re.sub(r"[(<].*", "", name).split("::")[-1].strip()
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3 / steps
    return wall * 1e3 / steps, sum(by_name.values()), by_name


# The fused steps' kernels by part: the Qwen3 steps' (csrc/qwen_common.cuh)
# and the AED steps' (csrc/aed_step.cuh).
STEP_PARTS = {"nibble_matvec": "matvec", "attn_step": "attention", "rms_stage": "epilogue",
              "q8_matvec": "matvec", "attn_aed": "attention", "ln_stage": "epilogue"}


def step_profile(torch, chained, unchained, steps: int = 20) -> dict:
    """One Qwen3 step kernel (``chained``: its launches chained by
    programmatic dependent launch, as it runs; ``unchained``: the same step
    with every launch waiting for the one before): the host wall time a
    step and the device's busy time (the union of kernel intervals, so
    overlapping chained kernels count once) and idle share of the chained
    step; the device time by part (matvec, attention, the residual + RMSNorm
    epilogues) and the kernels launched a step, from the unchained step,
    whose kernels do not overlap; and the device time of a CUDA graph of 10
    chained steps (no host launch cost)."""
    from torch.profiler import ProfilerActivity, profile

    def run(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return wall * 1e3 / steps, kernels

    host_ms, kernels = run(chained)
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy, end = busy + max(0.0, hi - lo), max(end, hi)
    _, kernels = run(unchained)
    parts = {}
    for e in kernels:
        part = next((v for k, v in STEP_PARTS.items() if k in e.name), "other")
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy_ms = busy / 1e3 / steps
    return {"host_ms": host_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / host_ms,
            "parts_ms": parts, "unchained_kernel_ms": sum(parts.values()),
            "launches_per_step": len(kernels) / steps, "graph_ms": graph_ms(torch, chained, 10, 3)}


def print_step_profile(label: str, what: str, prof: dict, card: str) -> None:
    parts = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(prof["parts_ms"].items(), key=lambda kv: -kv[1]))
    print(f"[{label} profile] {what}: device busy {prof['busy_ms'] * 1e3:.1f} us in a {prof['host_ms'] * 1e3:.1f} "
          f"us step (idle share {prof['idle_share']:.3f}); unchained, us a step by part: {parts} "
          f"(sum {prof['unchained_kernel_ms'] * 1e3:.1f}); {prof['launches_per_step']:.1f} launches a step; "
          f"a CUDA graph of 10 steps: {prof['graph_ms']:.4f} ms a step  [{card}]")


def phase_step_matvec(torch, fd, card: str) -> dict:
    """[15b] The two Qwen3 steps' shared tensor-core matvec alone at the five
    Qwen3-ASR-0.6B shapes, B = 1 and 8: against the plain ``_dot`` (1e-4 of
    max|plain|), each row bitwise the row alone, and its device time from a
    CUDA graph (the input staging kernel included) beside its bound. The
    plan's shared-memory formula must give the kernel's for each tile."""
    from asr_tpu_torch.quant.quantize import quantize_linear

    g = torch.Generator(device=DEV).manual_seed(151)
    out = {}
    lib = fd._load()
    for name, (k, n) in QWEN_STEP_MATVECS.items():
        bn, parts = fd.matvec_plan(k, n, name == "gate|up")
        for rows in range(1, fd.MAX_ROWS + 1):
            want = lib.qwen_matvec_smem(bn, parts, k, rows)
            check(fd.matvec_smem(bn, parts, k, rows) == want,
                  f"matvec {name} rows={rows}: the plan's shared memory {fd.matvec_smem(bn, parts, k, rows)} "
                  f"is not the kernel's {want}")
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, 4, 128, pack=True)
        s = leaf.scale.reshape(2, k // 256, n).contiguous()
        zs = (leaf.zero * leaf.scale).reshape(2, k // 256, n).contiguous()
        vals = fd._nibbles(leaf.q)
        nbytes = leaf.q.numel() + 2 * s.numel() * 4
        for b in QWEN_STEP_MATVEC_B:
            x = torch.randn((b, k), generator=g, device=DEV)
            got = fd.nibble_matvec_cuda(x, leaf.q, s, zs)
            want = torch.cat([fd._dot(x[i : i + 1], vals, s, zs) for i in range(b)])
            err = (got - want).abs().max().item()
            check(err <= 1e-4 * want.abs().max().item(), f"matvec {name} B={b}: {err}")
            check(all(torch.equal(got[i], fd.nibble_matvec_cuda(x[i : i + 1].contiguous(), leaf.q, s, zs)[0])
                      for i in range(b)), f"matvec {name} B={b}: a row differs from the row alone")
            ms = graph_ms(torch, lambda: fd.nibble_matvec_cuda(x, leaf.q, s, zs))
            b_ms, b_by = bound(nbytes + 4 * b * (k + n), 2.0 * b * k * n)
            out[f"{name} B={b}"] = {"k": k, "n": n, "tile": fd.matvec_plan(k, n, name == "gate|up"), "ms": ms,
                                    "gb_s": nbytes / (ms * 1e-3) / 1e9, "bound_ms": b_ms, "bound_by": b_by,
                                    "max_abs_err": err}
            print(f"[15b matvec] {name:6s} K={k} N={n:6d} B={b}: tile (BN, parts) {out[f'{name} B={b}']['tile']}, "
                  f"{ms * 1e3:.2f} us (staging included; CUDA graph of {GRAPH_CALLS}), "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, bound {b_ms * 1e3:.2f} us ({b_by}); vs plain "
                  f"{err:.2e}, rows bitwise = alone  [{card}]")
        del leaf, vals
    torch.cuda.empty_cache()
    return out


# The Whisper-Large-v3-Turbo matvecs of the AED steps (csrc/aed_step.cuh):
# q|k|v, self-o, cross-q, cross-o, fc1, fc2, the tied head.
AED_STEP_MATVECS = {"q|k|v": (1280, 3840), "self-o": (1280, 1280), "cross-q": (1280, 1280),
                    "cross-o": (1280, 1280), "fc1": (1280, 5120), "fc2": (5120, 1280),
                    "head": (1280, 52224)}
AED_STEP_MATVEC_B = (1, 8)


def phase_aed_matvec(torch, fs, card: str) -> dict:
    """[12b] The two AED steps' shared tensor-core int8 matvec alone at the
    seven Whisper-Large-v3-Turbo shapes, B = 1 and 8: against the plain
    ``_matvec`` (1e-4 of max|plain|), each row bitwise the row alone, and its
    device time from a CUDA graph (the input staging kernel included)
    beside its byte bound. The plan's shared-memory formulas must give the
    kernel's for each tile and attention."""
    from asr_tpu_torch.quant.quantize import quantize_linear

    g = torch.Generator(device=DEV).manual_seed(121)
    out = {}
    lib = fs._load()
    plan = fs.aed_plan(*AED_GEOMETRY)
    for cap, srows in ((plan.self_cap, plan.self_srows), (plan.cross_cap, plan.cross_srows)):
        for itemsize in (2, 4):
            check(fs.attn_smem(cap, srows, itemsize) == lib.aed_attn_smem(cap, srows, itemsize),
                  f"attention cap={cap}: the plan's shared memory is not the kernel's")
    for name, (k, n) in AED_STEP_MATVECS.items():
        bn, parts = fs.matvec_plan(k, n)
        for rows in range(1, fs.MAX_ROWS + 1):
            want = lib.aed_matvec_smem(bn, parts, k, rows)
            check(fs.matvec_smem(bn, parts, k, rows) == want,
                  f"matvec {name} rows={rows}: the plan's shared memory {fs.matvec_smem(bn, parts, k, rows)} "
                  f"is not the kernel's {want}")
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, 8, 128)
        s, zs = leaf.scale.contiguous(), (leaf.zero * leaf.scale).contiguous()
        nbytes = leaf.q.numel() + 2 * s.numel() * 4
        for b in AED_STEP_MATVEC_B:
            x = torch.randn((b, k), generator=g, device=DEV)
            got = fs.aed_matvec_cuda(x, leaf.q, s, zs)
            want = torch.cat([fs._matvec(x[i : i + 1], leaf.q, s, zs) for i in range(b)])
            err = (got - want).abs().max().item()
            check(err <= 1e-4 * want.abs().max().item(), f"matvec {name} B={b}: {err}")
            check(all(torch.equal(got[i], fs.aed_matvec_cuda(x[i : i + 1].contiguous(), leaf.q, s, zs)[0])
                      for i in range(b)), f"matvec {name} B={b}: a row differs from the row alone")
            ms = graph_ms(torch, lambda: fs.aed_matvec_cuda(x, leaf.q, s, zs))
            b_ms, b_by = bound(nbytes + 4 * b * (k + n), 2.0 * b * k * n)
            out[f"{name} B={b}"] = {"k": k, "n": n, "tile": (bn, parts), "ms": ms,
                                    "gb_s": nbytes / (ms * 1e-3) / 1e9, "bound_ms": b_ms, "bound_by": b_by,
                                    "max_abs_err": err}
            print(f"[12b matvec] {name:7s} K={k} N={n:5d} B={b}: tile (BN, parts) {(bn, parts)}, "
                  f"{ms * 1e3:.2f} us (staging included; CUDA graph of {GRAPH_CALLS}), "
                  f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, bound {b_ms * 1e3:.2f} us ({b_by}); vs plain "
                  f"{err:.2e}, rows bitwise = alone  [{card}]")
        del leaf
    torch.cuda.empty_cache()
    return out


def phase_multi(torch, fs, fm, wh, quantize_pytree, fused: dict, card: str) -> dict:
    """[11] The multi-slot kernel against its plain version and, slot by
    slot, bitwise against the batch-1 kernel (logits and written rows), at
    turbo geometry, B = 2 .. 32; [12] its time against the plain version's,
    in turns, at B in {2, 4, 8}, each with a profile (busy time, idle share,
    device time by part from an unchained step, launches a step, a CUDA
    graph of 10 steps)."""
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
    dec = params["decoder"]

    def x_of(toks, pos_l):
        return (dec["embed"][toks] + dec["pos"][torch.tensor([max(p, 0) for p in pos_l], device=DEV)]).float()

    dims = (cfg.decoder_layers, cfg.max_target_positions, cfg.max_source_positions, cfg.vocab_size)
    rows, worst = multi_vs_plain(torch, fs, fm, stacked, geom, *dims, x_of, FUSED_TC, g, MULTI_B, "11")
    times = multi_times(torch, fs, fm, stacked, geom, *dims[:3], FUSED_TC[0],
                        {c: fused["times"][c]["ms"] for c in fused["times"]}, g, MULTI_TIMED_B, "12", card)
    del params, stacked
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst, "times": times}


def multi_planes(torch, g, nl: int, bs: int, t: int, tc: int, d: int, cdt):
    """Random (NL, B, rows, D) self k, self v, cross k and cross v planes."""
    return [torch.randn((nl, bs, n, d), generator=g, device=DEV).to(cdt) for n in (t, t, tc, tc)]


def multi_vs_plain(torch, fs, fm, stacked, geom, nl: int, t: int, tc: int, v: int, x_of, tcs, g,
                   batches, label: str) -> tuple[list, float]:
    """The multi-slot kernel against its plain version and, slot by slot,
    bitwise against the batch-1 kernel (logits and written rows) at each B
    of ``batches``, f32 and bf16 caches: positions from FUSED_POS with one
    parked slot, valid cross rows from ``tcs`` (``x_of(tokens, positions)``:
    the input rows). Returns (rows, the largest logits error)."""
    d = geom.d_model
    worst, rows = 0.0, []
    for bs in batches:
        pos_l = [FUSED_POS[i % 3] for i in range(bs)]
        pos_l[bs // 2] = -1  # one parked slot
        tc_l = [tcs[i % len(tcs)] for i in range(bs)]
        toks = torch.tensor([(1000 + 7 * i) % v for i in range(bs)], device=DEV)
        x = x_of(toks, pos_l)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=DEV)
        tcv = torch.tensor(tc_l, dtype=torch.int32, device=DEV)
        for cdt in (torch.float32, torch.bfloat16):
            cache = str(cdt).split(".")[-1]
            ks, vs, ck, cv = multi_planes(torch, g, nl, bs, t, tc, d, cdt)
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
            row0 = 0.0
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
                # the batch-1 kernel on this slot alone: bitwise its logits and written rows
                kb, vb = ks[:, b].contiguous(), vs[:, b].contiguous()
                one, _, _ = fs.fused_aed_step_cuda(stacked, geom, x[b : b + 1], kb, vb, ck[:, b].contiguous(),
                                                   cv[:, b].contiguous(), p, tc_l[b])
                check(torch.equal(got[b : b + 1], one), f"B={bs} {cache}: slot {b}'s logits are not "
                      "bitwise the batch-1 kernel's")
                check(torch.equal(kk[:, b], kb) and torch.equal(vk[:, b], vb), f"B={bs} {cache}: slot {b}'s "
                      "caches are not bitwise the batch-1 kernel's")
            rows.append({"b": bs, "cache": cache, "max_abs_err": err, "max_abs_plain": ref,
                         "row0_rel": row0, "slots_bitwise_batch1": True})
            print(f"[{label} multi] B={bs} cache={cache:8s} pos={pos_l} tc_valid={tc_l}: logits err "
                  f"{err:.3e} ({err / ref:.2e} of max|plain|); layer-0 rows within {row0:.2e} of "
                  f"max|row|; every live slot bitwise the batch-1 kernel (logits and caches); other "
                  f"rows and the parked slot bitwise unchanged")
    torch.cuda.synchronize()
    return rows, worst


def multi_times(torch, fs, fm, stacked, geom, nl: int, t: int, tc: int, tc_t: int, one_ms: dict, g,
                batches, label: str, card: str) -> dict:
    """The multi-slot kernel's time against its plain version's, in turns,
    at each B of ``batches`` (every slot at FUSED_POS[-1] with ``tc_t``
    valid cross rows), f32 and bf16 caches, beside its bound and B times
    the batch-1 kernel's ``one_ms[cache]``, each with a profile."""
    d = geom.d_model
    times = {}
    pos_t = FUSED_POS[-1]
    for cdt in (torch.float32, torch.bfloat16):
        cache = str(cdt).split(".")[-1]
        unchained = fs.aed_plan(d, geom.ffn_dim, stacked["wh"].shape[1], t, tc, pdl=False)
        for bs in batches:
            ks, vs, ck, cv = multi_planes(torch, g, nl, bs, t, tc, d, cdt)
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
                                  "bound_by": b_by, "batch1_ms": one_ms[cache]}
            print(f"[{label} multi] B={bs} cache={cache:8s} pos={pos_t} tc_valid={tc_t}: kernel {k_ms:.4f} ms a "
                  f"step, {k_ms * 1e3 / bs:.1f} us a token (B x batch-1 kernel: {bs * one_ms[cache]:.4f} ms); "
                  f"plain {p_ms:.2f} ms; {nbytes / 1e6:.1f} MB a step, {rate / 1e9:.0f} GB/s, "
                  f"{rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound {b_ms:.4f} ms ({b_by})  [{card}]")
            prof = step_profile(
                torch, lambda: fm.fused_aed_step_multi_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tcv),
                lambda: fm.fused_aed_step_multi_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tcv,
                                                     plan=unchained))
            times[(bs, cache)]["profile"] = prof
            print_step_profile(label, f"B={bs} cache={cache} pos={pos_t} tc_valid={tc_t}", prof, card)
    return times


def post_clip(base: str, clip, delay: float, out: list, i: int) -> None:
    """POST one clip after ``delay`` seconds; out[i] = (status, reply, seconds)."""
    time.sleep(delay)
    req = urllib.request.Request(base + "/transcribe", data=wav_bytes(clip), method="POST")
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        out[i] = (resp.status, json.loads(resp.read()), time.perf_counter() - t)


def aed_adapter(torch, fs, session, mod=None):
    """What a replay needs of an AED session: its decoder layers, step
    geometry, end id, vocabulary, input row ``x_row(token (1, 1), pos)`` and
    per-weight step ``step(state, token, pos, tc_valid) -> (logits, state)``.
    ``mod``: None for Whisper (learned positions), else ``models.firered`` or
    ``models.dolphin`` (sqrt(d)-scaled embeddings + sinusoid positions)."""
    from types import SimpleNamespace

    cfg, params = session.cfg, session.params
    dec = params["decoder"]
    if mod is None:
        from asr_tpu_torch.models import whisper as wh

        return SimpleNamespace(
            nl=cfg.decoder_layers, geom=fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads),
            eot=cfg.eot_id, vocab=cfg.vocab_size,
            x_row=lambda tok, pos: (dec["embed"][tok[0]] + dec["pos"][pos : pos + 1]).float(),
            step=lambda st, tok, pos, tcv: wh.step(params, cfg, st, tok, pos))
    from asr_tpu_torch.layers.attention import attention_bias_from_lengths
    from asr_tpu_torch.layers.conformer import absolute_positions

    table = absolute_positions(cfg.max_target_positions, cfg.d_model, DEV)

    def step(st, tok, pos, tcv):
        tc = st["layers"][0]["cross_k"].shape[1]
        bias = attention_bias_from_lengths(torch.tensor([tcv], device=DEV), tc)
        logits, st = mod._decoder_pass(params, cfg, st, tok, pos, bias)
        return logits[:, -1], st

    return SimpleNamespace(
        nl=cfg.dec_layers, geom=fs.AedGeom(cfg.d_model, cfg.dec_ffn, cfg.dec_heads), eot=cfg.eos_id,
        vocab=cfg.vocab_size, step=step,
        x_row=lambda tok, pos: (dec["embed"][tok[0]] * cfg.d_model ** 0.5 + table[pos : pos + 1]).float())


def replay_window(torch, fs, fm, session, fam, chunk, ids: list, acc: dict, label: str) -> int:
    """Teacher-force one window's server ids (``ids`` starts at its first
    token) through the per-weight step and the multi-slot kernel (this
    window in slot 0, slot 1 parked), step by step: logits within
    TEACHER_TOL of max|logit|, argmax equal above the top-2 margin. The
    window ends where the kernel picks the end id (the server drops it) or at
    the budget. ``fam``: :func:`aed_adapter`'s. Returns how many of ``ids``
    the window holds."""
    from asr_tpu_torch.decode.ar import select_token

    cfg, dcfg = session.cfg, session.decode_cfg
    with torch.inference_mode():
        pre = session.continuous_prefill(chunk)
        state, p_len = pre["state"], pre["p_len"]
        first = int(select_token(pre["logits0"], torch.zeros((1, 1), dtype=torch.int64, device=DEV),
                                 0, dcfg)[0])
        if first == fam.eot:  # an empty window
            return 0
        check(bool(ids) and ids[0] == first, f"{label}: the first token differs")
        layers = state["layers"]
        d, t_max, tc = cfg.d_model, cfg.max_target_positions, layers[0]["cross_k"].shape[1]
        kc, vc = (torch.zeros((fam.nl, 2, t_max, d), device=DEV) for _ in range(2))
        ck, cv = (torch.zeros((fam.nl, 2, tc, d), device=DEV) for _ in range(2))
        for l, ls in enumerate(layers):
            for plane, key in ((kc, "self_k"), (vc, "self_v"), (ck, "cross_k"), (cv, "cross_v")):
                plane[l, 0] = ls[key][0].reshape(-1, d)
        tc_valid = min(max(pre["tc_valid"], 1), tc)
        tcv = torch.tensor([tc_valid, tc_valid], dtype=torch.int32, device=DEV)
        j, ended = 0, False
        while j < dcfg.max_new_tokens and not ended:
            pos = p_len + j
            tok = torch.tensor([[ids[j]]], device=DEV)
            want, state = fam.step(state, tok, pos, pre["tc_valid"])
            x = torch.zeros((2, d), device=DEV)
            x[0] = fam.x_row(tok, pos)[0]
            got, _, _ = fm.fused_aed_step_multi(session.stacked, fam.geom, x, kc, vc, ck, cv,
                                                torch.tensor([pos, -1], dtype=torch.int32, device=DEV),
                                                tcv)
            got = got[:1, : fam.vocab]
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
            ended = nxt == fam.eot  # the server drops the end id
            if not ended:
                check(j < len(ids), f"{label}: the server's ids end before the kernel's end id")
                acc["same"] += ids[j] == nxt
    return j if ended else j + 1  # at the budget the window holds max_new + 1 ids


def phase_continuous(torch, np, qm, fs, fm, folder: str, numbers: dict, card: str) -> dict:
    """[13] Continuous Whisper-Large-v3-Turbo q8 serving over HTTP, every
    decode step through the multi-slot kernel."""
    import copy

    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer, start_background_continuous
    from asr_tpu_torch.runtime.audio import iter_windows
    from asr_tpu_torch.runtime.whisper_session import load_whisper_session

    session = load_whisper_session(folder, DEV)  # phase 9's artifact
    check(session.stacked is not None, "the session did not stack the q8 decoder")
    cfg, params = session.cfg, session.params
    rng = np.random.default_rng(13)
    seconds = list(rng.uniform(*SERVE_SECONDS, size=SERVE_WINDOWED)) + [SERVE_LONG]
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

    # Each request alone through the same batcher, window by window as the
    # server submits it: bitwise its served ids.
    from asr_tpu_torch.parallel.http_server import decode_audio_bytes

    bat, eot = srv.batcher, cfg.eot_id
    with torch.inference_mode():
        for i, clip in enumerate(clips):
            samples = decode_audio_bytes(wav_bytes(clip), 16000) * np.float32(session.pcm_scale / 32768.0)
            alone = []
            for s0 in iter_windows(len(samples), w, w):
                pre = session.continuous_prefill(samples[s0 : s0 + w])
                if pre["skip"]:
                    continue
                slot = bat.try_submit(pre["state"], pre["p_len"], pre["logits0"], pre["tc_valid"])
                while bat.is_active(slot):
                    bat.step()
                alone += [t for t in bat.take_result(slot) if t != eot]
            check(alone == results[i][1]["token_ids"], f"request {i}: the served ids differ from the "
                  "request run alone through the batcher")

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
    replay, fam = {"steps": 0, "worst_rel": 0.0, "under": 0, "same": 0}, aed_adapter(torch, fs, session)
    for i in replayed:
        audio = clips[i].astype(np.float32) / 32768.0
        ids, start = results[i][1]["token_ids"], 0
        for s0 in iter_windows(len(audio), w, w):
            start += replay_window(torch, fs, fm, session, fam, audio[s0 : s0 + w], ids[start:],
                                   replay, f"request {i}")
        check(start == len(ids), f"request {i}: the replay consumed {start} of {len(ids)} ids")
    print(f"[13 serve] {len(clips)} requests ({windows} windows, {SERVE_SLOTS} slots, f32 caches, "
          f"starts staggered 0-200 ms) in {wall:.2f} s; healthz {json.dumps(health)}")
    print(f"[13 serve] launches: multi-slot {multi} (= decode_steps {health['decode_steps']}), "
          f"batch-1 {fused}, int8 {int8} ({windows} windows x {int8_per_window(cfg)}); every request's "
          "ids bitwise equal to it alone through the batcher")
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
           "queue_wait_s": health["queue_wait_avg_s"], "peak_mib": peak, "equal": equal, "wall_s": wall}
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


# ── 14-17. Qwen3-ASR-0.6B q4: the packed-int4 matmul, the fused Qwen3 step ──
# Every distinct (K, N) of the q4 LLM and how many of one prefill's 113
# calls have it: q|k|v, o, gate|up and down in each of the 28 layers, and the
# packed tied head once (the first logits, at M = 1).
QWEN_P4_SHAPES = {(1024, 4096): 28, (2048, 1024): 28, (1024, 6144): 28, (3072, 1024): 28,
                  (1024, 153600): 1}
QWEN_HEAD = (9, 1, 6)  # prompt ids before the audio, between, after (chat-template sized)
QWEN_DECODE_POS = ((5, 0), (200, 3), (440, 17))  # (pos, shift) of the step checks
QWEN_SERVE_SECONDS = (5.0, 20.0)
QWEN_SERVE_REQUESTS = 4  # one batch of QWEN_SERVE_BATCH (the run-time limit)
QWEN_SERVE_BATCH = 4
QWEN_SERVE_BUDGET = 48  # new tokens a window on the served, per-weight route (96 before PR 18)
# The step rounds every matvec input to bf16, and a last-bit difference can
# flip one such rounding. One layer of the kernel agrees with its plain
# version to a bf16 step (QWEN_ONE_LAYER_TOL). Over the 28 random layers the
# flips add up. The run measures that noise as the plain version's spread
# under last-bit changes: host vs card, and the card run again with every
# input element moved by one f32 ulp (QWEN_ULP_DRAWS draws). The full-depth
# step is held to twice that spread, or to QWEN_STEP_TOL where that is
# larger; planted faults that the one-layer check cannot see (layers 1-27
# reading the previous layer's weights, or its caches) must land beyond that
# bound in the same run. The first layer's written row sits behind one
# rounding only.
QWEN_STEP_MATVECS = {"q|k|v": (1024, 4096), "o": (2048, 1024), "gate|up": (1024, 6144),
                     "down": (3072, 1024), "head": (1024, 153600)}  # (K, N) of Qwen3-ASR-0.6B's step
QWEN_STEP_MATVEC_B = (1, 8)
QWEN_ONE_LAYER_TOL = 1e-2
QWEN_STEP_TOL = 3e-2
QWEN_ULP_DRAWS = 3
# Teacher-forced, the fused route and the per-weight step (f32 caches and
# attention) differ by up to 5.4e-3 of max|logit| (NVIDIA H100 80GB HBM3,
# 700 W), so a top-2 margin below twice that may flip without a fault.
QWEN_REPLAY_MARGIN = 1e-2
QWEN_ROW0_TOL = {"float32": 1e-3, "bfloat16": 1e-3 + 2.0**-8}


def qwen_prefill_rows(cfg) -> int:
    """Rows of one 30 s window's prefill: the prompt ids and the audio
    tokens of the padded tower windows (assemble_prompt's static buffer)."""
    return sum(QWEN_HEAD) + qwen_tower_rows(cfg)


def packed_cost(bits: int, m: int, k: int, n: int) -> tuple[int, float]:
    """Bytes (x read, packed weight, f32 scale and zero, output written) and
    operations (2 M K N) of one int4 / int2 call at block 128."""
    return 4 * m * k + k * n * bits // 8 + 2 * 4 * (k // 128) * n + 4 * m * n, 2.0 * m * k * n


# The yardstick for the packed rows: PyTorch's one call for a group-wise
# int4 product (bf16 x, weights packed by _convert_weight_to_int4pack,
# per-group bf16 scale and zero in its (q - 8) * s + z' form), given the
# leaf's raw values: the nibbles, or the 2-bit values widened to nibbles
# around the nibble midpoint (u + 6 against zero + 6: the same function,
# and its bf16 (8 - zero) * scale term stays small). Its bf16 scales and
# output keep ~3 significant digits, so it is held to the plain version
# only loosely (LIBRARY_INT4_TOL of max|plain|); the port never calls it.
LIBRARY_INT4_TOL = 2e-2
LIBRARY_INNER_K_TILES = 8
# Rows of the packed calls: decode steps (1), the micro-batchers (2, 4), the
# continuous servers' slots (8), one m16 tile and one row past it (16, 17),
# then the prefill's rows. Timed at the rows the main paths run.
PACKED_CHECK_M = (1, 2, 4, 8, 16, 17)
PACKED_TIMED_M = (1, 4, 8)


def graph_ms(torch, fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``calls`` back-to-back calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def packed_library_call(torch, u, scale, zero, x):
    """A zero-argument call of torch._weight_int4pack_mm computing
    x @ ((u - zero) * scale) (group 128) in bf16, for raw values u (K, N)
    below 16, with the weight converted once here."""
    ut = u.to(torch.int32).t().contiguous()  # (N, K)
    packed = torch._convert_weight_to_int4pack((ut[:, ::2] << 4 | ut[:, 1::2]).to(torch.uint8),
                                               LIBRARY_INNER_K_TILES)
    # (u - z) * s = (u - 8) * s + (8 - z) * s
    sz = torch.stack([scale, (8.0 - zero) * scale], dim=-1).to(torch.bfloat16).contiguous()
    xb = x.to(torch.bfloat16)
    return lambda: torch._weight_int4pack_mm(xb, packed, 128, sz)


def phase_packed(torch, qm, quantize_linear, bits: int, m_prefill: int, card: str,
                 m_more: tuple = ()) -> dict:
    """[14] the packed-int4 kernel at every shape of the q4 path, [21] the
    packed-int2 kernel at every shape of the q2 path: against the plain
    version at M = 1, 2, 4, 8, 16, 17, the prefill's rows and ``m_more``
    (other paths' prefill rows), both modes; rows of every batched call
    bitwise equal to the row alone; at M = 1, 4, 8 and the prefill's rows,
    device time (CUDA graph) in turns with the plain version, and PyTorch's
    int4 call as the yardstick in bf16."""
    from asr_tpu_torch.quant.quantize import unpack2_quarters, unpack4_halves

    if bits == 4:
        tag, shapes, launch, plain = "14 int4", QWEN_P4_SHAPES, qm.quant_matmul_int4, qm.quant_dense_p4_reference
        unpack = unpack4_halves
    else:
        tag, shapes, launch, plain = "21 int2", QWEN_P2_SHAPES, qm.quant_matmul_int2, qm.quant_dense_p2_reference
        unpack = unpack2_quarters
    g = torch.Generator(device=DEV).manual_seed(14 if bits == 4 else 21)
    rows, worst, library_note = [], 0.0, None
    for (k, n), _count in shapes.items():
        leaf = quantize_linear(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5, bits, 128,
                               pack=True)
        check(leaf.packed and tuple(leaf.q.shape) == (k * bits // 8, n), f"K={k} N={n} did not pack")
        off = 0 if bits == 4 else 6  # 2-bit values 0..3 -> nibbles 6..9
        u, zero = unpack(leaf.q) + off, leaf.zero + off
        for m in (*PACKED_CHECK_M, m_prefill, *m_more):
            x = torch.randn((m, k), generator=g, device=DEV)
            for mm in ("f32", "bf16"):
                args = (x, leaf.q, leaf.scale, leaf.zero, 128, mm)
                got = launch(*args)
                torch.cuda.synchronize()
                want = plain(*args)
                err = (got - want).abs().max().item()
                ref = want.abs().max().item()
                check(err <= 1e-4 * ref, f"int{bits} kernel vs plain at M={m} K={k} N={n} {mm}: "
                      f"{err} > 1e-4 * {ref}")
                worst = max(worst, err)
                for r in sorted({0, m // 2, m - 1}) if m > 1 else ():
                    one = launch(x[r : r + 1].contiguous(), *args[1:])
                    check(torch.equal(one[0], got[r]), f"int{bits} at M={m} K={k} N={n} {mm}: row {r} "
                          "differs from the same row alone")
                if m not in (*PACKED_TIMED_M, m_prefill):
                    continue
                p1 = time_ms(lambda: plain(*args), 5, 3)
                k1 = graph_ms(torch, lambda: launch(*args))
                k2 = graph_ms(torch, lambda: launch(*args))
                p2 = time_ms(lambda: plain(*args), 5, 3)
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                host_ms = time_ms(lambda: launch(*args))
                nbytes, ops = packed_cost(bits, m, k, n)
                b_ms, b_by = bound(nbytes, ops)
                lib_ms = None
                if mm == "bf16" and library_note is None:
                    try:
                        call = packed_library_call(torch, u, leaf.scale, zero, x)
                        lib = call().float()
                        torch.cuda.synchronize()
                        lerr = (lib - want).abs().max().item()
                        check(lerr <= LIBRARY_INT4_TOL * ref, f"torch._weight_int4pack_mm vs plain at "
                              f"M={m} K={k} N={n}: {lerr:.3e} > {LIBRARY_INT4_TOL} * {ref:.3e}")
                        lib_ms = graph_ms(torch, call)
                    except (AttributeError, RuntimeError, TypeError) as exc:  # a yardstick only
                        library_note = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
                rows.append({"m": m, "k": k, "n": n, "mm": mm, "ms": k_ms, "plain_ms": p_ms,
                             "host_ms": host_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "bytes": nbytes, "ops": ops, "max_abs_err": err})
                lib_txt = f"  library {lib_ms:.4f} ms" if lib_ms is not None else ""
                print(f"[{tag}] M={m:4d} K={k:4d} N={n:6d} mm={mm:4s} kernel {k_ms:.4f} ms "
                      f"({ops / (k_ms * 1e9):.1f} TFLOP/s, {nbytes / (k_ms * 1e6):.0f} GB/s; host-launched "
                      f"{host_ms:.4f} ms){lib_txt}  plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
                      f"err {err:.3e} (max|plain| {ref:.3e})  [{card}]")
    if library_note is not None:
        print(f"[{tag}] torch._weight_int4pack_mm not timed: {library_note}")

    def pass_total(mm: str, m: int, m_head: int) -> dict:
        """One LLM pass: every linear at M = m, the tied head (int4) at m_head."""
        tot = {"ms": 0.0, "plain_ms": 0.0, "host_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes": 0.0, "ops": 0.0}
        for r in rows:
            if r["mm"] == mm and r["m"] == (m_head if r["n"] == 153600 else m):
                for key in tot:
                    tot[key] = None if tot[key] is None or r[key] is None else tot[key] + (
                        shapes[(r["k"], r["n"])] * r[key])
        tot["bound_by"] = bound(tot["bytes"], tot["ops"])[1]
        return tot

    calls = sum(shapes.values())
    per_prefill = {mm: pass_total(mm, m_prefill, 1) for mm in ("bf16", "f32")}
    per_pass = {m: pass_total("bf16", m, m) for m in PACKED_TIMED_M}
    for label, tot in [(f"prefill (M={m_prefill}{', the head at M=1' if bits == 4 else ''}), mm={mm}",
                        per_prefill[mm]) for mm in ("bf16", "f32")] + [
                           (f"M={m}, mm=bf16", per_pass[m]) for m in PACKED_TIMED_M]:
        lib = tot["library_ms"]
        print(f"[{tag}] one LLM pass's {calls} calls at {label}: kernel {tot['ms']:.3f} ms "
              f"(host-launched {tot['host_ms']:.3f}), plain {tot['plain_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms ({tot['bound_by']}), torch._weight_int4pack_mm "
              f"{'not timed' if lib is None or 'f32' in label else f'{lib:.3f} ms'}  [{card}]")
    return {"rows": rows, "max_abs_err": worst, "per_prefill": per_prefill, "per_pass": per_pass,
            "library_note": library_note}


def qwen_step_bytes(stacked: dict, nl: int, kvw: int, rows: list, itemsize: int) -> tuple[int, float]:
    """(bytes, operations) of one step of len(rows) slots: every stacked
    array read once for all slots, and per slot its attended cache rows of k
    and v and the written row; 2 operations per int4 weight and slot, and
    each slot's scores and P.V over its rows."""
    weights = sum(t.numel() * t.element_size() for t in stacked.values())
    nibbles = 2 * sum(stacked[k].numel() for k in ("wq", "wo", "wgu", "wd", "wh") if k in stacked)
    nbytes = weights + sum(2 * nl * (r + 1) * kvw * itemsize for r in rows)
    return nbytes, float(sum(2.0 * nibbles + 2 * 2 * nl * (r + 1) * 2 * kvw for r in rows))


def phase_decode_vs_plain(torch, fd, qwen3, quantize_pytree, card: str) -> dict:
    """[15] The fused Qwen3 step against its plain version at full width:
    f32 and bf16 caches, three positions with shift > 0, the head in the
    kernel and separate, the first layer alone and all 28; the plain
    version's own host/card drift; its time at pos 440 in turns."""
    from asr_tpu_torch.layers.rope import rope_tables

    cfg = qwen3.Qwen3Config()
    g = torch.Generator(device=DEV).manual_seed(15)
    params = qwen3.fuse_params(quantize_pytree(qwen3.init_params(cfg, g), bits=4, pack=True,
                                               refine_iters=0, quantize_embeddings=True), cfg)
    stacked = fd.stack_decode_params(params, cfg)
    check(stacked is not None and "wh" in stacked, "the q4 LLM did not stack with its head")
    del params
    for key in ("in_s", "post_s", "qn_s", "kn_s", "fn_s"):  # the init has ones
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device=DEV)
    nl, kvw, v, t = cfg.num_layers, cfg.num_kv_heads * 128, cfg.vocab_size, 464
    one_cfg = dataclasses.replace(cfg, num_layers=1)
    one = {k: (a[:1].contiguous() if a.shape[0] == nl and k != "fn_s" else a) for k, a in stacked.items()}
    host = {k: a.cpu() for k, a in stacked.items()}
    cs = torch.from_numpy(rope_tables(t, 128, cfg.rope_theta)).to(DEV)
    x = torch.randn((1, cfg.hidden), generator=g, device=DEV) * 0.05
    g_ulp = torch.Generator(device=DEV).manual_seed(151)
    inf = torch.tensor(float("inf"), device=DEV)
    layered = [k for k, a in stacked.items() if a.shape[0] == nl and k != "fn_s"]
    rows, worst, times, failures, controls = [], 0.0, {}, [], {}

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    for cdt in (torch.float32, torch.bfloat16):
        cache = str(cdt).split(".")[-1]
        # rows of unit RMS, as RMSNorm + RoPE leave k
        kc = torch.randn((nl, t, kvw), generator=g, device=DEV).to(cdt)
        vc = torch.randn((nl, t, kvw), generator=g, device=DEV).to(cdt)
        for pos, shift in QWEN_DECODE_POS:
            cos, sin = cs[0, pos - shift][None], cs[1, pos - shift][None]
            hh, lh, _, _ = fd.fused_decode_step_reference(host, cfg, x.cpu(), kc.cpu(), vc.cpu(), pos,
                                                          shift, cos.cpu(), sin.cpu())
            hc, lc, _, _ = fd.fused_decode_step_reference(stacked, cfg, x, kc.clone(), vc.clone(), pos,
                                                          shift, cos, sin)
            drift = max(rel(lh[:, :v], lc[:, :v].cpu()), rel(hh, hc.cpu()))
            for _ in range(QWEN_ULP_DRAWS):
                away = torch.where(torch.rand(x.shape, generator=g_ulp, device=DEV) < 0.5, -inf, inf)
                hu, lu, _, _ = fd.fused_decode_step_reference(stacked, cfg, torch.nextafter(x, away),
                                                              kc.clone(), vc.clone(), pos, shift, cos, sin)
                drift = max(drift, rel(lu[:, :v], lc[:, :v]), rel(hu, hc))
            tol = max(QWEN_STEP_TOL, 2 * drift)
            for head in ("in", "separate"):
                sel = (lambda d: d) if head == "in" else (
                    lambda d: {k: a for k, a in d.items() if k not in ("wh", "h_s", "h_zs")})
                errs = {}
                for depth, c, stk in (("one", one_cfg, sel(one)), ("all", cfg, sel(stacked))):
                    n = c.num_layers
                    kk, vk, kp, vp = (a[:n].clone() for a in (kc, vc, kc, vc))
                    h, lg, _, _ = fd.fused_decode_step_cuda(stk, c, x, kk, vk, pos, shift, cos, sin)
                    torch.cuda.synchronize()
                    hr, lr, _, _ = fd.fused_decode_step_reference(stk, c, x, kp, vp, pos, shift, cos, sin)
                    check(bool(torch.isfinite(h).all()), f"non-finite hidden at pos {pos}")
                    e = rel(h, hr)
                    if head == "in":
                        check(bool((lg[:, v:] == 0).all()), "pad logits are not exactly 0")
                        e = max(e, rel(lg[:, :v], lr[:, :v]))
                        if depth == "all":
                            worst = max(worst, (lg[:, :v] - lr[:, :v]).abs().max().item())
                    else:
                        check(lg is None and lr is None, "a head-less step returned logits")
                    errs[depth] = e
                    others = torch.arange(t, device=DEV) != pos
                    check(torch.equal(kk[:, others], kc[:n, others]) and torch.equal(vk[:, others], vc[:n, others]),
                          f"rows other than pos {pos} changed")
                    row0 = max((kk[0, pos].float() - kp[0, pos].float()).abs().max().item(),
                               (vk[0, pos].float() - vp[0, pos].float()).abs().max().item())
                    row_ref = max(kp[0, pos].float().abs().max().item(), vp[0, pos].float().abs().max().item())
                    check(row0 <= QWEN_ROW0_TOL[cache] * row_ref, f"layer-0 row vs plain: {row0} > "
                          f"{QWEN_ROW0_TOL[cache]} * {row_ref}")
                rows.append({"cache": cache, "pos": pos, "shift": shift, "head": head,
                             "one_layer_rel": errs["one"], "all_layers_rel": errs["all"],
                             "plain_drift": drift, "row0_rel": row0 / row_ref})
                print(f"[15 decode] cache={cache:8s} pos={pos:3d} shift={shift:2d} head={head:8s}: kernel vs "
                      f"plain, max of hidden and logits, one layer {errs['one']:.2e}, {nl} layers "
                      f"{errs['all']:.2e} (plain's own spread {drift:.2e}, bound {tol:.2e}); layer-0 row "
                      f"{row0 / row_ref:.2e} of max|row|; other rows bitwise unchanged")
                if errs["one"] > QWEN_ONE_LAYER_TOL:
                    failures.append(f"one layer, {cache} pos {pos} head {head}: {errs['one']}")
                if errs["all"] > tol:
                    failures.append(f"{nl} layers, {cache} pos {pos} head {head}: {errs['all']} > {tol}")
        pos, shift = QWEN_DECODE_POS[-1]
        cos, sin = cs[0, pos - shift][None], cs[1, pos - shift][None]
        controls[cache] = planted_faults(torch, fd, cfg, stacked, one, layered, x, kc, vc, pos, shift,
                                         cos, sin, tol, failures)
        kk, vk = kc.clone(), vc.clone()
        k_ms, p_ms = in_turns(
            lambda: fd.fused_decode_step_reference(stacked, cfg, x, kk, vk, pos, shift, cos, sin),
            lambda: fd.fused_decode_step_cuda(stacked, cfg, x, kk, vk, pos, shift, cos, sin),
            plain_iters=3)
        nbytes, ops = qwen_step_bytes(stacked, nl, kvw, [pos - shift], kc.element_size())
        b_ms, b_by = bound(nbytes, ops)
        times[cache] = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by}
        print(f"[15 decode] cache={cache} pos={pos} shift={shift}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms; "
              f"{nbytes / 1e6:.1f} MB a step, {nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s; bound "
              f"{b_ms:.4f} ms ({b_by})  [{card}]")
        unchained = fd.decode_plan(cfg, t, stacked["wh"].shape[1], pdl=False)
        prof = step_profile(
            torch, lambda: fd.fused_decode_step_cuda(stacked, cfg, x, kk, vk, pos, shift, cos, sin),
            lambda: fd.fused_decode_step_cuda(stacked, cfg, x, kk, vk, pos, shift, cos, sin, plan=unchained))
        times[cache]["profile"] = prof
        print_step_profile("15", f"cache={cache} pos={pos}", prof, card)
    check(not failures, "fused step vs plain: " + "; ".join(failures))
    del stacked, one, host
    torch.cuda.empty_cache()
    return {"rows": rows, "max_abs_err": worst, "times": times, "controls": controls}


def planted_faults(torch, fd, cfg, stacked, one, layered, x, kc, vc, pos, shift, cos, sin,
                   tol, failures) -> dict:
    """How far from the plain version a faulty kernel lands, at one layer
    and all 28. Two faults are run in the kernel: layers 1-27 read the
    previous layer's weights, or its caches; each must exceed the full-depth
    bound ``tol``. Two are planted in the plain version and only reported:
    the left shift off by one, and every bf16 rounding left out."""
    nl, v = cfg.num_layers, cfg.vocab_size
    one_cfg = dataclasses.replace(cfg, num_layers=1)

    def prev(a):
        return torch.cat([a[:1], a[:-1]])

    def dist(h, lg, hr, lr):
        return max(((h - hr).abs().max() / hr.abs().max()).item(),
                   ((lg[:, :v] - lr[:, :v]).abs().max() / lr[:, :v].abs().max()).item())

    def plain(stk, c, sh=shift):
        n = c.num_layers
        return fd.fused_decode_step_reference(stk, c, x, kc[:n].clone(), vc[:n].clone(), pos, sh, cos, sin)

    out = {}
    hr, lr, _, _ = plain(stacked, cfg)
    for name, stk, kf, vf in (
            ("weights of layer l-1", {k: prev(a) if k in layered else a for k, a in stacked.items()},
             kc.clone(), vc.clone()),
            ("caches of layer l-1", stacked, prev(kc), prev(vc))):
        h, lg, _, _ = fd.fused_decode_step_cuda(stk, cfg, x, kf, vf, pos, shift, cos, sin)
        out[name] = {"all": dist(h, lg, hr, lr)}
        if out[name]["all"] <= tol:
            failures.append(f"the planted fault '{name}' lands within the bound: {out[name]['all']} <= {tol}")
    kernel = {c.num_layers: fd.fused_decode_step_cuda(stk, c, x, kc[:c.num_layers].clone(),
                                                      vc[:c.num_layers].clone(), pos, shift, cos, sin)[:2]
              for c, stk in ((one_cfg, one), (cfg, stacked))}
    bf16 = fd._bf16
    for name in ("shift + 1", "no bf16 rounding"):
        out[name] = {}
        try:
            if name == "no bf16 rounding":
                fd._bf16 = lambda t: t.float()
            for depth, c, stk in (("one", one_cfg, one), ("all", cfg, stacked)):
                hp, lp, _, _ = plain(stk, c, shift + 1 if name == "shift + 1" else shift)
                out[name][depth] = dist(*kernel[c.num_layers], hp, lp)
        finally:
            fd._bf16 = bf16
    cache = str(kc.dtype).split(".")[-1]
    print(f"[15 control] cache={cache} pos={pos}: kernel vs plain, max of hidden and logits, with a "
          f"planted fault (bound {tol:.2e} at {nl} layers, {QWEN_ONE_LAYER_TOL:.0e} at one): "
          + "; ".join(f"{k}: " + ", ".join(f"{d} {e:.2e}" for d, e in r.items()) for k, r in out.items()))
    return out


def qwen_counts(session, ids: list) -> int:
    """Generated tokens of one window, the EOT the session drops included."""
    return len(ids) if len(ids) == session.decode_cfg.max_new_tokens + 1 else len(ids) + 1


def qwen_prefill(torch, session, audio):
    """The prefill of one utterance, as transcribe_embeds runs it:
    (state, shift, lf, t_max, first-token logits)."""
    from asr_tpu_torch.models import qwen_asr as qa

    buf = torch.zeros((1, session.window_samples), device=DEV)
    buf[0, : len(audio)] = torch.from_numpy(audio).to(DEV)
    ids = session._batch_ids(session._prompt_ids(""), 1)
    embeds, valid = qa.prompt_embeds(session.tower_params, session.llm_params, session.cfg, buf,
                                     torch.tensor([len(audio)], device=DEV), ids)
    state, shift, t_max, logits = qa.left_prefill(session.llm_params, session.cfg, embeds, valid,
                                                  session.decode_cfg.max_new_tokens)
    return state, shift, embeds.shape[1], t_max, logits


def qwen_metadata(cfg):
    """The artifact metadata of a Qwen3-ASR folder: the config and a
    chat-template-sized prompt around the audio."""
    from asr_tpu_torch.runtime.artifact import ModelMetadata

    head, suffix, tail = QWEN_HEAD
    special = cfg.llm.vocab_size - 292  # <|im_start|> = 151644 in the 151936-token vocab
    return ModelMetadata(family="qwen_asr", audio_pcm_scale=1.0, extra={
        "config": dataclasses.asdict(cfg), "prompt_head_ids": list(range(special, special + head)),
        "prompt_suffix_ids": list(range(special + 25, special + 25 + suffix)),
        "prompt_tail_ids": list(range(special + 26, special + 26 + tail)),
        "language_prompt_ids": {"en": [special - 100, special - 99]}})


def qwen_window_numbers(torch, np, session, label: str, route: str, card: str) -> dict:
    """One 30 s window through ``session``: tower and prefill times (CUDA
    events and a synchronized host clock), RTF, decode ms per token (host
    wall, sync included) and peak memory."""
    from asr_tpu_torch.models import qwen_asr as qa

    cfg = session.cfg
    out = {}
    audio30 = (np.random.default_rng(17).standard_normal(30 * 16000) * 0.1).astype(np.float32)
    a30 = torch.from_numpy(audio30).to(DEV)[None]
    v30 = torch.tensor([len(audio30)], device=DEV)
    with torch.inference_mode():
        mel = qa.log_mel_spectrogram(a30, cfg.mel_config())
        mel = torch.nn.functional.pad(mel, (0, 0, 0, (-mel.shape[1]) % 800))
        vf = torch.div(v30, 160, rounding_mode="floor")
        qa.encode_audio(session.tower_params, cfg, mel, vf)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            qa.encode_audio(session.tower_params, cfg, mel, vf)
        end.record()
        torch.cuda.synchronize()
        out["tower_ms"] = start.elapsed_time(end) / 3
        _, t_pre = synced(torch, lambda: qwen_prefill(torch, session, audio30))
        out["prefill_ms"] = t_pre * 1e3 - out["tower_ms"]
    gc.collect()  # earlier phases' sessions sit in reference cycles; the peak is this session's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res30 = session.transcribe(audio30)
    out["rtf_30s"] = res30.rtf
    out["window_ms"] = res30.elapsed_seconds * 1e3
    out["steps_30s"] = qwen_counts(session, res30.token_ids) - 1
    out["ms_per_token"] = (res30.elapsed_seconds * 1e3 - t_pre * 1e3) / max(out["steps_30s"], 1)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[{label} numbers] one 30 s window: {out['window_ms']:.1f} ms, RTF {out['rtf_30s']:.5f}; tower "
          f"{out['tower_ms']:.2f} ms ({cfg.tower_layers} layers, {mel.shape[1] // 100 * 13} audio rows), "
          f"prefill {out['prefill_ms']:.2f} ms ({qwen_prefill_rows(cfg)} rows), {out['steps_30s']} decode "
          f"steps at {out['ms_per_token']:.3f} ms per token ({route} route, host wall); peak memory "
          f"{out['peak_mib']:.0f} MiB  [{card}]")
    return out


def qwen_logits_vs_plain(torch, session, audio, label: str, what: str) -> float:
    """The quantized model's prefill logits (mm=f32) against plain f32
    matmuls on its dequantized weights, on 8 s of ``audio``: checked within
    1e-3 of max|logit|; returns the share."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.ops import quant_matmul as qm
    from asr_tpu_torch.quant.quantize import dequantize_pytree

    qm.set_quant_config(mm="f32")
    cfg, lcfg = session.cfg, session.cfg.llm
    a = torch.from_numpy(audio[: 8 * 16000]).to(DEV)[None]
    va = torch.tensor([8 * 16000], device=DEV)
    pids = session._batch_ids(session._prompt_ids(""), 1)
    dense_tower, dense_llm = dequantize_pytree(session.tower_params), dequantize_pytree(session.llm_params)

    def prefill_logits(tower_p, llm_p):
        embeds, valid = qa.prompt_embeds(tower_p, llm_p, cfg, a, va, pids)
        lf = embeds.shape[1]
        t_m = -(-(lf + 1) // 8) * 8
        st = qwen3.make_kv_state(lcfg, 1, t_m, torch.float32, DEV)
        h, _ = qwen3.decoder_pass(llm_p, lcfg, embeds, st, 0,
                                  qwen3.causal_prefill_bias(valid, lf, t_m))
        return qwen3.logits_from_hidden(llm_p, lcfg, h[:, int(valid[0]) - 1])

    with torch.inference_mode():
        lq = prefill_logits(session.tower_params, session.llm_params)
        lp = prefill_logits(dense_tower, dense_llm)
    del dense_tower, dense_llm
    diff, scale = (lq - lp).abs().max().item(), lp.abs().max().item()
    check(bool(torch.isfinite(lq).all()), f"non-finite {what} logits")
    check(diff <= 1e-3 * scale, f"{what} logits vs plain: {diff} > 1e-3 * {scale}")
    print(f"[{label} check] {what} mm=f32 prefill logits (8 s) vs plain f32 matmuls on the dequantized "
          f"weights: max diff {diff:.3e} (max|logit| {scale:.3e}, {diff / scale:.2e} of it)")
    qm.set_quant_config(mm="bf16")
    torch.cuda.empty_cache()
    return diff / scale


def phase_qwen(torch, np, qm, fd, folder: str, card: str) -> dict:
    """[16] Qwen3-ASR-0.6B (q8 tower, q4 LLM and tied head) through an
    artifact folder and load_qwen_session: 20 s on the fused route, a
    teacher-forced replay through the per-weight step, one 30 s window's
    numbers, and the q4 logits against plain matmuls on dequantized weights."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.layers.rope import rope_tables
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session

    qm.set_quant_config(mm="bf16")  # the serving mode; the session stacks for the fused step
    cfg = qa.QwenAsrConfig()
    lcfg = cfg.llm
    t0 = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(16)
    tower = quantize_pytree(qa.init_tower_params(cfg, g), bits=8)
    llm = quantize_pytree(qwen3.init_params(lcfg, g), bits=4, pack=True, quantize_embeddings=True)
    save_model(folder, {"tower": tower, "llm": llm}, qwen_metadata(cfg))
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del tower, llm
    torch.cuda.empty_cache()
    session = load_qwen_session(folder, DEV)
    check(session.stacked is not None and "wh" in session.stacked,
          "the session did not stack the q4 LLM and its head for the fused step")
    print(f"[16 qwen] Qwen3-ASR-0.6B (q8 tower, q4 LLM + packed tied head): init + quantize + artifact "
          f"({size_mb:.1f} MB) round trip in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(16)
    audio20 = (rng.standard_normal(20 * 16000) * 0.1).astype(np.float32)
    session.transcribe(audio20[:16000])  # warm-up: cuBLAS, cuDNN, the kernels' first launches
    torch.cuda.synchronize()

    qm.LAUNCHES = qm.LAUNCHES_INT4 = fd.LAUNCHES = 0  # the Qwen path starts here
    res = session.transcribe(audio20)
    int8, int4, fused = qm.LAUNCHES, qm.LAUNCHES_INT4, fd.LAUNCHES  # and ends here
    ids = res.token_ids
    counts = qwen_counts(session, ids)
    n_tower = 6 * cfg.tower_layers + 3
    check(fused == counts - 1 and fused > 0, f"{fused} fused launches for {counts} generated tokens")
    check(int4 == 4 * lcfg.num_layers + 1, f"{int4} int4 launches, not {4 * lcfg.num_layers + 1} "
          "(the prefill's linears and the first logits)")
    check(int8 == n_tower, f"{int8} int8 launches, not the tower's {n_tower}")
    print(f"[16 qwen] 20 s -> {len(ids)} tokens in {res.elapsed_seconds * 1e3:.1f} ms; fused launches "
          f"{fused} (= counts - 1), int4 {int4} ({lcfg.num_layers} x 4 + the first logits), int8 {int8} (the tower)  "
          f"[{card}]")

    # Teacher-forced: the generated ids through the per-weight step and the kernel.
    dcfg = session.decode_cfg
    with torch.inference_mode():
        state, shift, lf, t_max, logits0 = qwen_prefill(torch, session, audio20)
        check(int(logits0[:, : lcfg.vocab_size].argmax()) == ids[0], "the first token differs from the session's")
        kvw = lcfg.num_kv_heads * lcfg.head_dim
        kc = torch.stack([ls["k"][0].reshape(t_max, kvw) for ls in state["layers"]]).to(torch.bfloat16)
        vc = torch.stack([ls["v"][0].reshape(t_max, kvw) for ls in state["layers"]]).to(torch.bfloat16)
        cs = torch.from_numpy(rope_tables(t_max, lcfg.head_dim, lcfg.rope_theta)).to(DEV)
        sh0 = int(shift[0])
        embed = session.llm_params["embed"]
        worst_rel, under, same, flips, flips_1e3, over = 0.0, 0, 0, 0, 0, []
        for i, tok in enumerate(ids[:-1]):
            pos = lf + i
            tk = torch.tensor([[tok]], device=DEV)
            h, state = qwen3.decoder_pass(session.llm_params, lcfg, embed[tk], state, pos,
                                          qwen3.left_step_bias(shift, pos, t_max), pos_offset=shift)
            want = qwen3.logits_from_hidden(session.llm_params, lcfg, h[:, -1])
            logical = pos - sh0
            _, got, _, _ = fd.fused_decode_step(session.stacked, lcfg, embed[tk[:, 0]].float(), kc, vc,
                                                pos, sh0, cs[0, logical][None], cs[1, logical][None])
            got = got[:, : lcfg.vocab_size]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            worst_rel = max(worst_rel, err / scale)
            if err > TEACHER_TOL * scale:
                over.append(i)
            margin, differ = logits_margin(want).item(), int(got.argmax()) != int(want.argmax())
            if margin > QWEN_REPLAY_MARGIN * scale:
                flips += differ
            else:
                under += 1
            flips_1e3 += differ and margin > MARGIN * scale
            same += int(got.argmax()) == ids[i + 1]
        del state
    steps = len(ids) - 1
    print(f"[16 qwen] teacher-forced over {steps} steps: fused vs per-weight max err {worst_rel:.3e} of "
          f"max|logit| (bound {TEACHER_TOL}, {len(over)} steps over it); {under} steps under the "
          f"{QWEN_REPLAY_MARGIN} top-2 margin, {flips} argmax differences above it ({flips_1e3} above a "
          f"{MARGIN} margin); fused argmax = generated id at {same}/{steps} steps")
    check(not over, f"fused vs per-weight above {TEACHER_TOL} of max|logit| at steps {over[:10]}")
    check(flips == 0, f"{flips} argmax differences above the {QWEN_REPLAY_MARGIN} top-2 margin")
    # The session and this replay ran the same kernel on the same caches.
    check(same == steps, f"the fused argmax is the session's id at only {same}/{steps} steps")

    # One 30 s window: tower, prefill, ms per token, RTF, peak memory.
    out = {"int8": int8, "int4": int4, "fused": fused, "steps": steps}
    out.update(qwen_window_numbers(torch, np, session, "16", "fused", card))
    # The q4 logits (mm=f32) against plain matmuls on the dequantized weights.
    qwen_logits_vs_plain(torch, session, audio20, "16", "q4")
    return out


def qwen_pass_launches(session) -> tuple[str, int, int]:
    """(the packed kernel's name, its launches a prefill or per-weight step,
    int8 launches a pass for the tied head) of a Qwen session: a q4 LLM's 4
    linears a layer and its packed head run through the int4 kernel; a q2
    LLM's linears run through the int2 kernel and its centered 2-bit head
    through the int8 kernel."""
    lin = session.llm_params["layers"][0]["attn"]["qkv"]["w"]
    per_pass = 4 * session.cfg.llm.num_layers
    if lin.packed and lin.bits == 2:
        return "int2", per_pass, 1
    check(lin.packed and lin.bits == 4 and session.llm_params["embed"].q_t_packed,
          "expected a q4 LLM with its packed head, or a q2 LLM")
    return "int4", per_pass + 1, 0


def phase_qwen_serve(torch, np, qm, fd, folder: str, card: str, label: str = "17") -> dict:
    """[17] The Qwen session behind the micro-batched HTTP server: 4
    concurrent requests of 5-20 s in a batch of 4 (p4 at M = 4 on the
    per-weight route); each request's ids against the per-weight route for
    that request alone, with a teacher-forced replay where they differ.
    [23] The same for the q2 artifact (p2 at M = 4, the 2-bit head through
    the int8 kernel)."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.parallel.http_server import start_background
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session

    qm.set_quant_config(mm="bf16")
    session = load_qwen_session(folder, DEV, max_new_tokens=QWEN_SERVE_BUDGET)
    cfg, lcfg, dcfg = session.cfg, session.cfg.llm, session.decode_cfg
    rng = np.random.default_rng(17)
    seconds = rng.uniform(*QWEN_SERVE_SECONDS, size=QWEN_SERVE_REQUESTS)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16) for s in seconds]
    packed_kernel, per_step, head_int8 = qwen_pass_launches(session)
    httpd, srv, thread = start_background(session, max_batch=QWEN_SERVE_BATCH, max_wait_ms=200.0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    try:
        torch.cuda.synchronize()
        qm.LAUNCHES = qm.LAUNCHES_INT4 = qm.LAUNCHES_INT2 = fd.LAUNCHES = 0  # the serving path starts here
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post_clip, args=(base, c, 0.0, results, i))
                   for i, c in enumerate(clips)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "an HTTP request did not finish")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        int8, int4, int2, fused = qm.LAUNCHES, qm.LAUNCHES_INT4, qm.LAUNCHES_INT2, fd.LAUNCHES  # and ends here
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=60)
    batches = health["batches_dispatched"] - 1  # the warm-up batch came before the counts
    packed, other = (int4, int2) if packed_kernel == "int4" else (int2, int4)
    check(health["requests_served"] == 1 + len(clips), f"healthz: {health}")
    check(fused == 0, f"the batch-{QWEN_SERVE_BATCH} route launched the fused kernel {fused} times")
    check(other == 0, f"the {packed_kernel} LLM launched the other packed kernel {other} times")
    check(packed > 0 and packed % per_step == 0, f"{packed} {packed_kernel} launches is not a multiple "
          f"of {per_step}")
    passes = packed // per_step
    check(int8 == batches * (6 * cfg.tower_layers + 3) + passes * head_int8,
          f"{int8} int8 launches for {batches} batches and {passes} LLM passes")
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")

    # Each request alone on the per-weight route (batch 1, no stacked weights).
    equal, replay = 0, {"steps": 0, "worst_gap": 0.0}
    for i, clip in enumerate(clips):
        audio = clip.astype(np.float32) / 32768.0
        got = results[i][1]["token_ids"]
        with torch.inference_mode():
            buf = torch.zeros((1, session.window_samples), device=DEV)
            buf[0, : len(audio)] = torch.from_numpy(audio).to(DEV)
            tokens, counts, starts = qa.forward(session.tower_params, session.llm_params, cfg, buf,
                                                torch.tensor([len(audio)], device=DEV),
                                                session._batch_ids(session._prompt_ids(""), 1), dcfg)
        v, c = int(starts[0]), int(counts[0])
        alone = [int(t) for t in tokens[0, v : v + c].tolist() if t != cfg.eot_id]
        if alone == got:
            equal += 1
            continue
        # A rounding flip: every server id must be within 1e-3 of max|logit| of
        # the best logit of the per-weight step teacher-forced on the server's ids.
        with torch.inference_mode():
            state, shift, lf, t_max, logits = qwen_prefill(torch, session, audio)
            embed = session.llm_params["embed"]
            for j, tok in enumerate(got):
                lg = logits[0, : lcfg.vocab_size]
                gap = (lg.max() - lg[tok]).item() / lg.abs().max().item()
                replay["worst_gap"] = max(replay["worst_gap"], gap)
                replay["steps"] += 1
                check(gap <= MARGIN, f"request {i} token {j}: the server's id is {gap:.2e} of "
                      f"max|logit| below the per-weight step's best")
                pos = lf + j
                tk = torch.tensor([[tok]], device=DEV)
                h, state = qwen3.decoder_pass(session.llm_params, lcfg, embed[tk], state, pos,
                                              qwen3.left_step_bias(shift, pos, t_max), pos_offset=shift)
                logits = qwen3.logits_from_hidden(session.llm_params, lcfg, h[:, -1])
    print(f"[{label} serve] {len(clips)} requests ({', '.join(f'{s:.1f}' for s in seconds)} s) in batches "
          f"of {QWEN_SERVE_BATCH} ({batches} batches, {QWEN_SERVE_BUDGET}-token budget) in {wall:.2f} s; "
          f"healthz {json.dumps(health)}")
    print(f"[{label} serve] launches: {packed_kernel} {packed} ({passes} x {per_step}: prefills + "
          f"per-weight steps at M = {QWEN_SERVE_BATCH}), int8 {int8}, fused {fused}; ids equal to the "
          f"per-weight route alone for {equal}/{len(clips)} requests, {replay['steps']} replayed ids "
          f"within {replay['worst_gap']:.2e} of max|logit| of the best  [{card}]")
    del session
    torch.cuda.empty_cache()
    return {"int8": int8, "int4": int4, "int2": int2, "wall_s": wall, "equal": equal}


# ── 18-20. the multi-slot Qwen3 step, continuous Qwen3-ASR serving ────────
# Slot positions of the step checks (one parked, -1) and the cache rows.
QWEN_MULTI_POS = {2: (700, -1), 8: (0, 5, 64, 200, 440, -1, 650, 700)}
QWEN_MULTI_T = 712
QWEN_MULTI_TIMED_B = (2, 4, 8)
QWEN_MULTI_TIMED_POS = 440
QWEN_CONT_SLOTS = 8
QWEN_CONT_SECONDS = (5.0, 30.0)  # QWEN_CONT_REQUESTS requests of one window each, lengths drawn from this range
QWEN_CONT_REQUESTS = 9  # the run-time limit: more requests than slots
QWEN_CONT_BUDGET = 96  # new tokens a window on the continuous server (the run-time limit: each
#                        request differing from session.transcribe is replayed on the per-weight route)
HEAD_KEYS = ("wh", "h_s", "h_zs")


def phase_decode_multi_vs_plain(torch, fd, fdm, qwen3, quantize_pytree, card: str) -> dict:
    """[18] The multi-slot Qwen3 step against its plain version at full
    width (B = 2 and 8, f32 and bf16 caches, the head in the kernel and
    separate, mixed positions up to 700 and one parked slot), with phase
    15's limits, and slot by slot bitwise against the batch-1 kernel at
    shift 0. Returns the stacked weights for phase 19."""
    from asr_tpu_torch.layers.rope import rope_tables

    cfg = qwen3.Qwen3Config()
    g = torch.Generator(device=DEV).manual_seed(18)
    params = qwen3.fuse_params(quantize_pytree(qwen3.init_params(cfg, g), bits=4, pack=True,
                                               refine_iters=0, quantize_embeddings=True), cfg)
    stacked = fd.stack_decode_params(params, cfg)
    check(stacked is not None and "wh" in stacked, "the q4 LLM did not stack with its head")
    del params
    for key in ("in_s", "post_s", "qn_s", "kn_s", "fn_s"):  # the init has ones
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device=DEV)
    nl, kvw, v, t = cfg.num_layers, cfg.num_kv_heads * 128, cfg.vocab_size, QWEN_MULTI_T
    one_cfg = dataclasses.replace(cfg, num_layers=1)
    one = {k: (a[:1].contiguous() if a.shape[0] == nl and k != "fn_s" else a) for k, a in stacked.items()}
    host = {k: a.cpu() for k, a in stacked.items()}
    cs = torch.from_numpy(rope_tables(t, 128, cfg.rope_theta)).to(DEV)
    g_ulp = torch.Generator(device=DEV).manual_seed(181)
    inf = torch.tensor(float("inf"), device=DEV)
    rows, worst, failures, bitwise = [], 0.0, [], 0

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    def dist(h, lg, hr, lr, b):
        e = rel(h[b], hr[b])
        return e if lg is None else max(e, rel(lg[b, :v], lr[b, :v]))

    for bs, pos_l in QWEN_MULTI_POS.items():
        pos = torch.tensor(pos_l, dtype=torch.int32, device=DEV)
        logical = pos.clamp(min=0).long()
        cos, sin = cs[0][logical], cs[1][logical]
        x = torch.randn((bs, cfg.hidden), generator=g, device=DEV) * 0.05
        live = [b for b, p in enumerate(pos_l) if p >= 0]
        for cdt in (torch.float32, torch.bfloat16):
            cache = str(cdt).split(".")[-1]
            kc = torch.randn((nl, bs, t, kvw), generator=g, device=DEV).to(cdt)
            vc = torch.randn((nl, bs, t, kvw), generator=g, device=DEV).to(cdt)
            # the plain version's own spread, slot by slot: host vs card, and
            # the card again with every element of x moved by one f32 ulp
            hc, lc, _, _ = fdm.fused_decode_step_multi_reference(stacked, cfg, x, kc.clone(), vc.clone(),
                                                                  pos, cos, sin)
            hh, lh, _, _ = fdm.fused_decode_step_multi_reference(host, cfg, x.cpu(), kc.cpu(), vc.cpu(),
                                                                 pos.cpu(), cos.cpu(), sin.cpu())
            drift = [dist(hh, lh, hc.cpu(), lc.cpu(), b) for b in range(bs)]
            for _ in range(QWEN_ULP_DRAWS):
                away = torch.where(torch.rand(x.shape, generator=g_ulp, device=DEV) < 0.5, -inf, inf)
                hu, lu, _, _ = fdm.fused_decode_step_multi_reference(
                    stacked, cfg, torch.nextafter(x, away), kc.clone(), vc.clone(), pos, cos, sin)
                drift = [max(drift[b], dist(hu, lu, hc, lc, b)) for b in range(bs)]
            for head in ("in", "separate"):
                sel = (lambda d: d) if head == "in" else (
                    lambda d: {k: a for k, a in d.items() if k not in HEAD_KEYS})
                errs = {}
                for depth, c, stk in (("one", one_cfg, sel(one)), ("all", cfg, sel(stacked))):
                    n = c.num_layers
                    kk, vk, kp, vp = (a[:n].clone() for a in (kc, vc, kc, vc))
                    h, lg, _, _ = fdm.fused_decode_step_multi_cuda(stk, c, x, kk, vk, pos, cos, sin)
                    torch.cuda.synchronize()
                    hr, lr, _, _ = fdm.fused_decode_step_multi_reference(stk, c, x, kp, vp, pos, cos, sin)
                    check(bool(torch.isfinite(h).all()), f"B={bs} {cache}: non-finite hidden")
                    if head == "in":
                        check(bool(torch.isfinite(lg).all()) and bool((lg[:, v:] == 0).all()),
                              f"B={bs} {cache}: non-finite logits or pad logits not exactly 0")
                        if depth == "all":
                            worst = max(worst, (lg[live, :v] - lr[live, :v]).abs().max().item())
                    else:
                        check(lg is None and lr is None, "a head-less step returned logits")
                    errs[depth] = max(dist(h, lg, hr, lr, b) for b in live)
                    row0 = 0.0
                    for b, p in enumerate(pos_l):
                        if p < 0:
                            check(torch.equal(kk[:, b], kc[:n, b]) and torch.equal(vk[:, b], vc[:n, b]),
                                  f"B={bs} {cache}: the parked slot's planes changed")
                            continue
                        e = dist(h, lg, hr, lr, b)
                        tol = QWEN_ONE_LAYER_TOL if depth == "one" else max(QWEN_STEP_TOL, 2 * drift[b])
                        if e > tol:
                            failures.append(f"B={bs} {cache} head {head} {depth} slot {b}: {e} > {tol}")
                        others = torch.arange(t, device=DEV) != p
                        check(torch.equal(kk[:, b, others], kc[:n, b, others])
                              and torch.equal(vk[:, b, others], vc[:n, b, others]),
                              f"B={bs} {cache}: slot {b} rows other than pos {p} changed")
                        r_err = max((kk[0, b, p].float() - kp[0, b, p].float()).abs().max().item(),
                                    (vk[0, b, p].float() - vp[0, b, p].float()).abs().max().item())
                        r_ref = max(kp[0, b, p].float().abs().max().item(),
                                    vp[0, b, p].float().abs().max().item())
                        check(r_err <= QWEN_ROW0_TOL[cache] * r_ref,
                              f"B={bs} {cache}: slot {b} layer-0 row {r_err} > {QWEN_ROW0_TOL[cache]} * {r_ref}")
                        row0 = max(row0, r_err / r_ref)
                        # the batch-1 kernel at shift 0 on this slot alone
                        kb, vb = kc[:n, b].contiguous(), vc[:n, b].contiguous()
                        hb, lb, _, _ = fd.fused_decode_step_cuda(stk, c, x[b : b + 1], kb, vb, p, 0,
                                                                 cos[b : b + 1], sin[b : b + 1])
                        same = (torch.equal(h[b : b + 1], hb) and (lg is None or torch.equal(lg[b : b + 1], lb))
                                and torch.equal(kk[:, b], kb) and torch.equal(vk[:, b], vb))
                        check(same, f"B={bs} {cache} head {head} {depth}: slot {b} differs from the "
                              "batch-1 kernel")
                        bitwise += 1
                rows.append({"b": bs, "cache": cache, "head": head, "one_layer_rel": errs["one"],
                             "all_layers_rel": errs["all"], "plain_drift": max(drift[b] for b in live),
                             "row0_rel": row0})
                print(f"[18 multi] B={bs} cache={cache:8s} head={head:8s} pos={list(pos_l)}: kernel vs plain, "
                      f"worst slot's max of hidden and logits, one layer {errs['one']:.2e}, {nl} layers "
                      f"{errs['all']:.2e} (plain's own spread up to {max(drift[b] for b in live):.2e}); "
                      f"layer-0 rows within {row0:.2e}; every live slot bitwise = the batch-1 kernel at "
                      f"shift 0; other rows and the parked slot bitwise unchanged")
    torch.cuda.synchronize()
    check(not failures, "multi-slot step vs plain: " + "; ".join(failures))
    print(f"[18 multi] {bitwise} slot results bitwise equal to fused_decode.cu  [{card}]")
    del one, host
    return {"rows": rows, "max_abs_err": worst, "bitwise_slots": bitwise, "stacked": stacked, "cfg": cfg}


def phase_decode_multi_times(torch, fd, fdm, stacked: dict, cfg, one_ms: dict, card: str) -> dict:
    """[19] The multi-slot step's time at B = 2, 4, 8 (all slots at pos
    440), f32 and bf16 caches, in turns with the plain version, beside its
    bound, each with a profile by part, launches a step and the device time
    of a CUDA graph of steps."""
    from asr_tpu_torch.layers.rope import rope_tables

    nl, kvw, pos_t, t = cfg.num_layers, cfg.num_kv_heads * 128, QWEN_MULTI_TIMED_POS, 464
    g = torch.Generator(device=DEV).manual_seed(19)
    cs = torch.from_numpy(rope_tables(t, 128, cfg.rope_theta)).to(DEV)
    times = {}
    for cdt in (torch.float32, torch.bfloat16):
        cache = str(cdt).split(".")[-1]
        for bs in QWEN_MULTI_TIMED_B:
            kc = torch.randn((nl, bs, t, kvw), generator=g, device=DEV).to(cdt)
            vc = torch.randn((nl, bs, t, kvw), generator=g, device=DEV).to(cdt)
            x = torch.randn((bs, cfg.hidden), generator=g, device=DEV) * 0.05
            pos = torch.full((bs,), pos_t, dtype=torch.int32, device=DEV)
            cos, sin = cs[0, pos_t].expand(bs, -1).contiguous(), cs[1, pos_t].expand(bs, -1).contiguous()
            k_ms, p_ms = in_turns(
                lambda: fdm.fused_decode_step_multi_reference(stacked, cfg, x, kc, vc, pos, cos, sin),
                lambda: fdm.fused_decode_step_multi_cuda(stacked, cfg, x, kc, vc, pos, cos, sin),
                plain_iters=1)
            nbytes, ops = qwen_step_bytes(stacked, nl, kvw, [pos_t] * bs, kc.element_size())
            b_ms, b_by = bound(nbytes, ops)
            times[(bs, cache)] = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes, "bound_ms": b_ms,
                                  "bound_by": b_by, "batch1_ms": one_ms[cache]}
            print(f"[19 multi] B={bs} cache={cache:8s} pos={pos_t}: kernel {k_ms:.4f} ms a step, "
                  f"{k_ms * 1e3 / bs:.1f} us a token (B x batch-1 kernel: {bs * one_ms[cache]:.4f} ms); "
                  f"plain {p_ms:.2f} ms; {nbytes / 1e6:.1f} MB a step, {nbytes / (k_ms * 1e-3) / 1e9:.0f} "
                  f"GB/s; bound {b_ms:.4f} ms ({b_by})  [{card}]")
            unchained = fd.decode_plan(cfg, t, stacked["wh"].shape[1], pdl=False)
            prof = step_profile(
                torch, lambda: fdm.fused_decode_step_multi_cuda(stacked, cfg, x, kc, vc, pos, cos, sin),
                lambda: fdm.fused_decode_step_multi_cuda(stacked, cfg, x, kc, vc, pos, cos, sin, plan=unchained))
            times[(bs, cache)]["profile"] = prof
            print_step_profile("19", f"B={bs} cache={cache} pos={pos_t}", prof, card)
            del kc, vc
    torch.cuda.empty_cache()
    return times


def qwen_replay_gap(torch, session, audio, ids: list) -> float:
    """Teacher-force one window's ids through the per-weight route (the
    session's left-padded prefill, f32 caches): the largest gap, over the
    ids, between the best logit and the id's, as a share of max|logit|."""
    from asr_tpu_torch.layers import qwen3

    lcfg = session.cfg.llm
    worst = 0.0
    with torch.inference_mode():
        state, shift, lf, t_max, logits = qwen_prefill(torch, session, audio)
        embed = session.llm_params["embed"]
        for j, tok in enumerate(ids):
            lg = logits[0, : lcfg.vocab_size]
            worst = max(worst, (lg.max() - lg[tok]).item() / lg.abs().max().item())
            if j + 1 == len(ids):
                break
            pos = lf + j
            tk = torch.tensor([[tok]], device=DEV)
            h, state = qwen3.decoder_pass(session.llm_params, lcfg, embed[tk], state, pos,
                                          qwen3.left_step_bias(shift, pos, t_max), pos_offset=shift)
            logits = qwen3.logits_from_hidden(session.llm_params, lcfg, h[:, -1])
    return worst


def phase_qwen_continuous(torch, np, qm, fd, fdm, folder: str, numbers: dict, card: str) -> dict:
    """[20] Continuous Qwen3-ASR-0.6B q4 serving over HTTP (phase 16's
    artifact, 8 slots, bf16 caches, a QWEN_CONT_BUDGET-token budget): 9 concurrent
    requests of 5-30 s with staggered starts, every decode step of every
    slot one multi-slot kernel launch; then two requests on the rowwise
    route."""
    import copy

    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer, start_background_continuous
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session

    qm.set_quant_config(mm="bf16")
    session = load_qwen_session(folder, DEV, max_new_tokens=QWEN_CONT_BUDGET)  # phase 16's artifact
    check(session.stacked is not None, "the session did not stack the q4 LLM")
    cfg = session.cfg
    rng = np.random.default_rng(20)
    seconds = rng.uniform(*QWEN_CONT_SECONDS, size=QWEN_CONT_REQUESTS)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16) for s in seconds]
    delays = rng.uniform(0.0, 0.2, size=len(clips))
    httpd, srv, thread = start_background_continuous(session, n_slots=QWEN_CONT_SLOTS, kv_dtype="bf16")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qm.LAUNCHES = qm.LAUNCHES_INT4 = fd.LAUNCHES = fdm.LAUNCHES = 0  # the serving path starts here
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
        int8, int4, fused, multi = qm.LAUNCHES, qm.LAUNCHES_INT4, fd.LAUNCHES, fdm.LAUNCHES  # and ends here
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=60)
    n_tower = 6 * cfg.tower_layers + 3
    n_prefill = 4 * cfg.llm.num_layers + 1
    check(health["ok"] and health["step_kernel"] == "fused" and health["decoder"] == "llm",
          f"healthz: {health}")
    check(health["requests_served"] == len(clips), f"served {health['requests_served']} windows")
    check(health["slots_active"] == 0 and health["queue_depth"] == 0, f"healthz: {health}")
    check(multi == health["decode_steps"] > 0, f"{multi} multi-slot launches for "
          f"{health['decode_steps']} decode steps")
    check(fused == 0, f"the batch-1 kernel was launched {fused} times")
    check(int8 == len(clips) * n_tower, f"{int8} int8 launches, not {len(clips)} x {n_tower}")
    check(int4 == len(clips) * n_prefill, f"{int4} int4 launches, not {len(clips)} prefills x {n_prefill}")
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
    lat = np.array([r[2] for r in results])
    t_max = srv.batcher.t_max

    # Each request alone through the same batcher: bitwise its served ids.
    bat, eot = srv.batcher, cfg.eot_id
    with torch.inference_mode():
        for i, clip in enumerate(clips):
            emb, valid = session.prompt_embeds(clip.astype(np.float32) / 32768.0)
            slot = bat.try_submit(emb, valid)
            while bat.is_active(slot):
                bat.step()
            alone = [t for t in bat.take_result(slot) if t != eot]
            check(alone == results[i][1]["token_ids"], f"request {i}: the served ids differ from the "
                  "request run alone through the batcher")
    # Against session.transcribe (the batch-1 kernel); where they differ, every
    # served id within the replay margin of the per-weight route's best logit.
    equal, gaps = 0, []
    for i, clip in enumerate(clips):
        audio = clip.astype(np.float32) / 32768.0
        got = results[i][1]["token_ids"]
        if session.transcribe(audio).token_ids == got:
            equal += 1
            continue
        gaps.append(qwen_replay_gap(torch, session, audio, got))
        check(gaps[-1] <= QWEN_REPLAY_MARGIN, f"request {i}: a served id {gaps[-1]:.2e} of max|logit| "
              f"below the per-weight route's best (margin {QWEN_REPLAY_MARGIN})")
    print(f"[20 serve] {len(clips)} requests ({seconds.min():.1f}-{seconds.max():.1f} s, {QWEN_CONT_SLOTS} "
          f"slots, bf16 caches of {t_max} rows, starts staggered 0-200 ms) in {wall:.2f} s; healthz "
          f"{json.dumps(health)}")
    print(f"[20 serve] launches: multi-slot {multi} (= decode_steps {health['decode_steps']}), batch-1 "
          f"{fused}, int4 {int4} ({len(clips)} prefills x {n_prefill}), int8 {int8} ({len(clips)} towers x "
          f"{n_tower}); every request's ids bitwise equal to it alone through the batcher; equal to "
          f"session.transcribe for {equal}/{len(clips)}, the other {len(gaps)} replayed: every served id "
          f"within {max(gaps, default=0.0):.2e} of max|logit| of the per-weight best (margin "
          f"{QWEN_REPLAY_MARGIN})")
    toks = health["tokens_generated"]
    step_s = health["step_latency_avg_s"]
    agg = toks / (health["decode_steps"] * step_s) if step_s else 0.0
    one = 1e3 / numbers["ms_per_token"]
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    out = {"launches": multi, "int8": int8, "int4": int4, "tokens": toks, "agg_tok_s": agg,
           "e2e_tok_s": toks / wall, "batch1_tok_s": one, "step_ms": step_s * 1e3, "p50_s": p50,
           "p95_s": p95, "queue_wait_s": health["queue_wait_avg_s"], "peak_mib": peak, "equal": equal,
           "wall_s": wall}
    print(f"[20 numbers] decode {toks} tokens: {agg:.0f} tokens/s over step time ({toks / wall:.0f} end "
          f"to end) vs {one:.0f} tokens/s on the batch-1 fused route (phase 16); average step "
          f"{step_s * 1e3:.3f} ms; completion p50 {p50:.2f} s, p95 {p95:.2f} s (client side); average "
          f"queue wait {health['queue_wait_avg_s']:.3f} s; peak memory {peak:.0f} MiB  [{card}]")

    # Two requests on the rowwise route: a session without stacked weights.
    rows_sess = copy.copy(session)
    rows_sess.stacked = None
    rows_sess.decode_cfg = dataclasses.replace(session.decode_cfg, max_new_tokens=QWEN_SERVE_BUDGET)
    srv2 = ContinuousSessionServer(rows_sess, n_slots=QWEN_CONT_SLOTS, kv_dtype="f32")
    try:
        before_m = fdm.LAUNCHES
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
    check(st2["step_kernel"] == "rowwise" and fdm.LAUNCHES == before_m,
          "the rowwise route launched the multi-slot kernel")
    row_gap, row_equal = 0.0, 0
    for i in range(2):
        check(outs[i] is not None, f"rowwise request {i} failed")
        audio = pair[i].astype(np.float32) / 32768.0
        if rows_sess.transcribe(audio).token_ids == outs[i]["token_ids"]:
            row_equal += 1
            continue
        row_gap = max(row_gap, qwen_replay_gap(torch, rows_sess, audio, outs[i]["token_ids"]))
        check(row_gap <= MARGIN, f"rowwise request {i}: a served id {row_gap:.2e} of max|logit| below the "
              "per-weight best")
    print(f"[20 serve] rowwise route (no stacked weights, f32 caches, {QWEN_SERVE_BUDGET}-token budget): "
          f"2 requests, ids equal to the per-weight solo path for {row_equal}/2 (the rest within "
          f"{row_gap:.2e} of max|logit| of its best), {st2['decode_steps']} steps at "
          f"{st2['step_latency_avg_s'] * 1e3:.2f} ms, no multi-slot launch  [{card}]")
    del session, rows_sess, srv, srv2, bat
    torch.cuda.empty_cache()
    return out


# ── 21-24. Qwen3-ASR-0.6B with a packed-int2 LLM, the int2 kernel ────────
# Every packed (K, N) of the q2 LLM and how many of one LLM pass's 112 int2
# calls have it: q|k|v, o, gate|up and down in each of the 28 layers. The
# 2-bit tied head stays centered int8 and runs through the int8 kernel.
QWEN_P2_SHAPES = {(1024, 4096): 28, (2048, 1024): 28, (1024, 6144): 28, (3072, 1024): 28}
Q2_CONT_REQUESTS = 2  # the run-time limit
Q2_CONT_SECONDS = (5.0, 30.0)
Q2_CONT_BUDGET = 48  # new tokens a window on the continuous rowwise route (the run-time limit)


def phase_qwen_q2(torch, np, qm, fd, fdm, folder: str, card: str) -> dict:
    """[22] Qwen3-ASR-0.6B with a q8 tower, a packed-q2 LLM and a 2-bit tied
    head through an artifact folder and load_qwen_session (the per-weight
    route: a q2 LLM does not stack): 20 s with its launch counts, its ids
    against a replay with plain matmuls on the dequantized weights, one 30 s
    window's numbers, and the q2 logits against plain matmuls."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session

    cfg = qa.QwenAsrConfig()
    lcfg = cfg.llm
    t0 = time.perf_counter()
    tower = quantize_pytree(qa.init_tower_params(cfg, torch.Generator(device=DEV).manual_seed(0)), bits=8)
    llm = quantize_pytree(qwen3.init_params(lcfg, torch.Generator(device=DEV).manual_seed(1)), bits=2,
                          pack=True, quantize_embeddings=True)
    save_model(folder, {"tower": tower, "llm": llm}, qwen_metadata(cfg))
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del tower, llm
    torch.cuda.empty_cache()
    qm.set_quant_config(mm="f32")  # the exact product, so the plain replay below agrees to f32 rounding
    session = load_qwen_session(folder, DEV)
    check(session.stacked is None, "a q2 LLM stacked for the fused step")
    lins = [leaf["w"] for layer in session.llm_params["layers"] for part in ("attn", "mlp")
            for leaf in layer[part].values() if isinstance(leaf, dict) and "w" in leaf]
    check(len(lins) == 4 * lcfg.num_layers and all(w.packed and w.bits == 2 for w in lins),
          "not every LLM linear is packed 2-bit")
    emb = session.llm_params["embed"]
    check(emb.bits == 2 and not emb.q_t_packed and emb.q_t.dtype == torch.int8,
          "the 2-bit tied head is not centered int8")
    print(f"[22 q2] Qwen3-ASR-0.6B (q8 tower, packed-q2 LLM, 2-bit tied head {tuple(emb.q_t.shape)} "
          f"int8): init + quantize + artifact ({size_mb:.1f} MB) round trip in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(22)
    audio20 = (rng.standard_normal(20 * 16000) * 0.1).astype(np.float32)
    session.transcribe(audio20[:16000])  # warm-up
    torch.cuda.synchronize()
    # the checked window decodes the serving phases' budget (the run-time limit); the 30 s
    # window's numbers below take the session's own
    decode_cfg = session.decode_cfg
    session.decode_cfg = dataclasses.replace(decode_cfg, max_new_tokens=QWEN_SERVE_BUDGET)

    qm.LAUNCHES = qm.LAUNCHES_INT4 = qm.LAUNCHES_INT2 = fd.LAUNCHES = fdm.LAUNCHES = 0  # the q2 path starts here
    res = session.transcribe(audio20)
    int8, int4, int2, fused, multi = (qm.LAUNCHES, qm.LAUNCHES_INT4, qm.LAUNCHES_INT2, fd.LAUNCHES,
                                      fdm.LAUNCHES)  # and ends here
    ids = res.token_ids
    steps = qwen_counts(session, ids) - 1
    per_pass = 4 * lcfg.num_layers
    n_tower = 6 * cfg.tower_layers + 3
    check(int2 == per_pass * (1 + steps) and steps > 0,
          f"{int2} int2 launches, not {per_pass} x (the prefill + {steps} steps)")
    check(int8 == n_tower + 1 + steps, f"{int8} int8 launches, not the tower's {n_tower} + the head's "
          f"{1 + steps}")
    check(int4 == fused == multi == 0, f"int4 {int4}, fused {fused}, multi-slot {multi} launches on the "
          "q2 path")
    print(f"[22 q2] 20 s -> {len(ids)} tokens in {res.elapsed_seconds * 1e3:.1f} ms (per-weight route, "
          f"mm=f32); int2 {int2} ({per_pass} x (1 prefill + {steps} steps)), int8 {int8} (tower {n_tower} "
          f"+ head {1 + steps}), int4 {int4}, fused {fused}, multi-slot {multi}  [{card}]")

    # The same window replayed with plain matmuls on the dequantized weights.
    dense_tower, dense_llm = dequantize_pytree(session.tower_params), dequantize_pytree(session.llm_params)
    checked, under, worst = 0, 0, 0.0
    with torch.inference_mode():
        buf = torch.zeros((1, session.window_samples), device=DEV)
        buf[0, : len(audio20)] = torch.from_numpy(audio20).to(DEV)
        embeds, valid = qa.prompt_embeds(dense_tower, dense_llm, cfg, buf,
                                         torch.tensor([len(audio20)], device=DEV),
                                         session._batch_ids(session._prompt_ids(""), 1))
        state, shift, t_max, logits = qa.left_prefill(dense_llm, cfg, embeds, valid,
                                                      session.decode_cfg.max_new_tokens)
        lf = embeds.shape[1]
        for j, tok in enumerate(ids):
            lg = logits[0, : lcfg.vocab_size]
            scale = lg.abs().max().item()
            worst = max(worst, (lg.max() - lg[tok]).item() / scale)
            if logits_margin(lg).item() > MARGIN * scale:
                check(int(lg.argmax()) == tok, f"step {j}: the q2 id {tok} is not the plain replay's "
                      f"argmax {int(lg.argmax())} above a {MARGIN} top-2 margin")
                checked += 1
            else:
                under += 1
            if j + 1 == len(ids):
                break
            pos = lf + j
            tk = torch.tensor([[tok]], device=DEV)
            h, state = qwen3.decoder_pass(dense_llm, lcfg, dense_llm["embed"][tk], state, pos,
                                          qwen3.left_step_bias(shift, pos, t_max), pos_offset=shift)
            logits = qwen3.logits_from_hidden(dense_llm, lcfg, h[:, -1])
    del dense_tower, dense_llm, state
    print(f"[22 check] replay with plain matmuls on the dequantized weights: the session's id is the "
          f"replay's argmax at {checked}/{len(ids)} ids above a {MARGIN} top-2 margin ({under} under it); "
          f"every id within {worst:.2e} of max|logit| of the replay's best")

    out = {"int8": int8, "int2": int2, "steps": steps}
    qm.set_quant_config(mm="bf16")  # the serving mode for the window's numbers
    # the 30 s window's numbers decode the serving budget too (the run-time limit), the step
    # profile below the session's own
    out.update(qwen_window_numbers(torch, np, session, "22", "per-weight", card))
    session.decode_cfg = decode_cfg
    # Where a per-weight step's time goes: one step at the 30 s window's last position.
    with torch.inference_mode():
        state, shift, lf, t_max, logits = qwen_prefill(torch, session, audio20)
        pos, tk = t_max - 2, logits[:, : lcfg.vocab_size].argmax(-1)[:, None]
        emb_tk = session.llm_params["embed"][tk]
        bias = qwen3.left_step_bias(shift, pos, t_max)

        def step():
            h, _ = qwen3.decoder_pass(session.llm_params, lcfg, emb_tk, state, pos, bias, pos_offset=shift)
            return qwen3.logits_from_hidden(session.llm_params, lcfg, h[:, -1])

        host_ms, dev_ms, by_name = profile_steps(torch, step, steps=10)
        del state
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update(step_host_ms=host_ms, step_dev_ms=dev_ms, step_kernels=dict(top))
    print(f"[22 profile] one per-weight step (bf16, pos {pos}): {dev_ms * 1e3:.1f} us of kernels in a "
          f"{host_ms * 1e3:.1f} us step (idle share {1 - dev_ms / host_ms:.3f}); us a step: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in top) + f"  [{card}]")
    out["logits_rel"] = qwen_logits_vs_plain(torch, session, audio20, "22", "q2")
    del session
    torch.cuda.empty_cache()
    return out


def phase_qwen_q2_continuous(torch, np, qm, fd, fdm, folder: str, card: str) -> dict:
    """[24] Continuous serving of the q2 artifact over HTTP on the rowwise
    route (8 slots, bf16 caches, a Q2_CONT_BUDGET-token budget): 2 concurrent requests
    of 5-30 s with staggered starts, every step's linears through the int2
    kernel at M = 8; each request's ids against the same request alone
    through the batcher (bitwise) and against session.transcribe (a
    teacher-forced replay where they differ)."""
    from asr_tpu_torch.parallel.llm_server import start_background_continuous
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session

    qm.set_quant_config(mm="bf16")
    session = load_qwen_session(folder, DEV, max_new_tokens=Q2_CONT_BUDGET)  # phase 22's artifact
    check(session.stacked is None, "a q2 LLM stacked for the fused step")
    gc.collect()  # as in qwen_window_numbers: the peak below is this server's
    cfg = session.cfg
    rng = np.random.default_rng(24)
    seconds = rng.uniform(*Q2_CONT_SECONDS, size=Q2_CONT_REQUESTS)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16) for s in seconds]
    delays = rng.uniform(0.0, 0.2, size=len(clips))
    httpd, srv, thread = start_background_continuous(session, n_slots=QWEN_CONT_SLOTS, kv_dtype="bf16")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qm.LAUNCHES = qm.LAUNCHES_INT4 = qm.LAUNCHES_INT2 = fd.LAUNCHES = fdm.LAUNCHES = 0  # the path starts here
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
        int8, int4, int2, fused, multi = (qm.LAUNCHES, qm.LAUNCHES_INT4, qm.LAUNCHES_INT2, fd.LAUNCHES,
                                          fdm.LAUNCHES)  # and ends here
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=60)
    n_tower = 6 * cfg.tower_layers + 3
    per_pass = 4 * cfg.llm.num_layers
    check(health["ok"] and health["step_kernel"] == "rowwise" and health["decoder"] == "llm",
          f"healthz: {health}")
    check(health["requests_served"] == len(clips), f"served {health['requests_served']} windows")
    check(health["slots_active"] == 0 and health["queue_depth"] == 0, f"healthz: {health}")
    check(multi == 0 and fused == 0 and int4 == 0, f"multi-slot {multi}, batch-1 {fused}, int4 {int4} "
          "launches on the q2 rowwise route")
    passes = len(clips) + health["decode_steps"]  # each request's prefill, then one pass a step
    check(int2 == per_pass * passes, f"{int2} int2 launches, not {per_pass} x ({len(clips)} prefills + "
          f"{health['decode_steps']} steps)")
    check(int8 == len(clips) * n_tower + passes, f"{int8} int8 launches, not {len(clips)} towers x "
          f"{n_tower} + {passes} heads")
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
    lat = np.array([r[2] for r in results])
    t_max = srv.batcher.t_max

    # Each request alone through the same batcher: bitwise its served ids.
    bat, eot = srv.batcher, cfg.eot_id
    with torch.inference_mode():
        for i, clip in enumerate(clips):
            emb, valid = session.prompt_embeds(clip.astype(np.float32) / 32768.0)
            slot = bat.try_submit(emb, valid)
            while bat.is_active(slot):
                bat.step()
            alone = [t for t in bat.take_result(slot) if t != eot]
            check(alone == results[i][1]["token_ids"], f"request {i}: the served ids differ from the "
                  "request run alone through the batcher")
    # Against session.transcribe (batch 1, f32 caches); where they differ, every
    # served id within the replay margin of the per-weight route's best logit.
    equal, gaps = 0, []
    for i, clip in enumerate(clips):
        audio = clip.astype(np.float32) / 32768.0
        got = results[i][1]["token_ids"]
        if session.transcribe(audio).token_ids == got:
            equal += 1
            continue
        gaps.append(qwen_replay_gap(torch, session, audio, got))
        check(gaps[-1] <= QWEN_REPLAY_MARGIN, f"request {i}: a served id {gaps[-1]:.2e} of max|logit| "
              f"below the per-weight route's best (margin {QWEN_REPLAY_MARGIN})")
    toks = health["tokens_generated"]
    step_s = health["step_latency_avg_s"]
    agg = toks / (health["decode_steps"] * step_s) if step_s else 0.0
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    print(f"[24 serve] {len(clips)} requests ({seconds.min():.1f}-{seconds.max():.1f} s, {QWEN_CONT_SLOTS} "
          f"slots, bf16 caches of {t_max} rows, {Q2_CONT_BUDGET}-token budget, starts staggered "
          f"0-200 ms) in {wall:.2f} s; healthz {json.dumps(health)}")
    print(f"[24 serve] launches: int2 {int2} ({per_pass} x ({len(clips)} prefills + "
          f"{health['decode_steps']} rowwise steps at M = {QWEN_CONT_SLOTS})), int8 {int8}, multi-slot "
          f"{multi}, batch-1 {fused}; every request's ids bitwise equal to it alone through the "
          f"batcher; equal to session.transcribe for {equal}/{len(clips)}, the other {len(gaps)} "
          f"replayed: every served id within {max(gaps, default=0.0):.2e} of max|logit| of the "
          f"per-weight best (margin {QWEN_REPLAY_MARGIN})")
    print(f"[24 numbers] decode {toks} tokens: {agg:.0f} tokens/s over step time ({toks / wall:.0f} end "
          f"to end); average step {step_s * 1e3:.3f} ms; completion p50 {p50:.2f} s, p95 {p95:.2f} s "
          f"(client side); average queue wait {health['queue_wait_avg_s']:.3f} s; peak memory "
          f"{peak:.0f} MiB  [{card}]")
    del session, srv, bat
    torch.cuda.empty_cache()
    return {"int8": int8, "int2": int2, "tokens": toks, "agg_tok_s": agg, "e2e_tok_s": toks / wall,
            "step_ms": step_s * 1e3, "p50_s": p50, "p95_s": p95,
            "queue_wait_s": health["queue_wait_avg_s"], "peak_mib": peak, "equal": equal, "wall_s": wall}


# ── 26-29. the command line, Fun-ASR-Nano and the Qwen3 forced aligner ─────
CLI_SECONDS = (5.0, 7.0)  # two files shorter than one 8 s SenseVoice window
FUN_HEAD = (5, 2, 6)  # Fun-ASR-Nano prompt ids: head and suffix before the audio, tail after
FUN_BATCH = 4  # the lockstep batch of transcribe_batch
FUN_BUDGET = 48  # new tokens a window in the lockstep batch and on the continuous server (the run-time limit)
FUN_CONT_REQUESTS = 9
FUN_CONT_SECONDS = (5.0, 30.0)
CONT_PREFILL_ROWS = 1024  # the continuous batcher's prefill bucket of a Fun-ASR-Nano prompt
ALIGN_TEXT = "the quick brown fox jumps over the lazy dog and then sleeps"  # 12 words
ALIGN_SECONDS = 20.0
ALIGN_CHAR_BASE = 1000  # a character's token id: ALIGN_CHAR_BASE + its code point mod 4096


class CharTokenizer:
    """A pure-Python character-level encoder for the aligner's transcript."""

    def encode(self, text: str) -> list[int]:
        return [ALIGN_CHAR_BASE + ord(c) % 4096 for c in text]


def write_vocab(path: Path, n: int) -> None:
    """A vocab_txt tokenizer file of ``n`` entries: id i decodes to "w<i>"."""
    path.write_text("".join(f"w{i}\n" for i in range(n)), encoding="utf-8")


def vocab_ids(text: str) -> list[int]:
    """The ids behind a write_vocab decode ("w3w17" -> [3, 17])."""
    return [int(t) for t in text.split("w")[1:]]


def fun_prefill_rows(cfg) -> int:
    """Rows of one Fun-ASR-Nano LLM prefill (the static prompt buffer): the
    prompt ids and every adaptor row of the padded 30 s window."""
    return sum(FUN_HEAD) + fun_lfr_rows(cfg)


def aligner_prefill_rows(cfg, n_text: int) -> int:
    """Rows of one aligner pass: audio start, the tower's rows of the padded
    30 s window, audio end, the text and timestamp ids."""
    return 1 + qwen_tower_rows(cfg.asr) + 1 + n_text


def fun_aligner_prefill_rows() -> tuple:
    """The int4 kernel's rows on phases 27-29's LLM passes (phase 14 checks
    them): a Fun-ASR-Nano prefill, the lockstep batch's, the continuous
    batcher's bucket, and the aligner's pass over ALIGN_TEXT."""
    from asr_tpu_torch.models.forced_aligner import ForcedAlignerConfig
    from asr_tpu_torch.models.fun_asr_nano import FunAsrNanoConfig

    m = fun_prefill_rows(FunAsrNanoConfig())
    n_text = sum(len(w) + 1 for w in ALIGN_TEXT.split())
    return m, FUN_BATCH * m, CONT_PREFILL_ROWS, aligner_prefill_rows(ForcedAlignerConfig(), n_text)


def fun_metadata(cfg, family: str):
    """A Fun-ASR-Nano artifact's metadata: the config, chat-template-sized
    prompt ids (the LLM head) and a vocab_txt tokenizer file."""
    from asr_tpu_torch.runtime.artifact import ModelMetadata

    head, suffix, tail = FUN_HEAD
    special = cfg.llm.vocab_size - 292  # <|im_start|> = 151644 in the 151936-token vocab
    return ModelMetadata(family=family, tokenizer={"kind": "vocab_txt", "file": "tokens.txt"}, extra={
        "config": dataclasses.asdict(cfg), "prompt_head_ids": list(range(special, special + head)),
        "prompt_suffix_ids": list(range(special + 25, special + 25 + suffix)),
        "prompt_tail_ids": list(range(special + 26, special + 26 + tail))})


def run_cli(*argv) -> tuple[str, float]:
    """``python -m asr_tpu_torch argv`` from the checkout: (stdout, seconds);
    a non-zero exit fails the phase."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "asr_tpu_torch", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"python -m asr_tpu_torch {' '.join(argv)} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t


def phase_cli(torch, np, qm, folder: str, card: str) -> dict:
    """[26] ``python -m asr_tpu_torch`` in subprocesses on phase 4's
    SenseVoiceSmall q8 artifact folder, given a vocab_txt tokenizer file:
    ``inspect``; ``transcribe`` of the first of two files, whose printed text
    must be the tokenizer's decode of ``session.transcribe``'s ids; and of both at
    once (the ``transcribe_batch`` route: one padded forward), whose ids per
    file must be the file's alone or differ only where the file's logits
    have a top-2 margin below 1e-3 of max|logit|."""
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.runtime.audio import load_audio
    from asr_tpu_torch.runtime.metadata import ModelMetadata, config_from_dict
    from asr_tpu_torch.runtime.session import load_session
    from asr_tpu_torch.runtime.tokenizer import VocabTxtDecoder

    meta = ModelMetadata.load(folder)
    cfg = config_from_dict(sv.SenseVoiceConfig, meta.extra["config"])
    write_vocab(Path(folder) / "tokens.txt", cfg.vocab_size)
    meta.tokenizer = {"kind": "vocab_txt", "file": "tokens.txt"}
    meta.save(folder)
    rng = np.random.default_rng(26)
    files = []
    for i, secs in enumerate(CLI_SECONDS):
        path = Path(folder) / f"cli_{i}.wav"
        path.write_bytes(wav_bytes(np.round(rng.standard_normal(int(secs * 16000)) * 2000)))
        files.append(str(path))
    runs = wait_cli({"inspect": start_cli("inspect", "--model-dir", folder),  # three processes at once
                     "alone": start_cli("transcribe", "--model-dir", folder, files[0]),
                     "both": start_cli("transcribe", "--model-dir", folder, *files)})
    (out, t_inspect), alone, (both, t_both) = runs["inspect"], [runs["alone"]], runs["both"]
    info = json.loads(out)
    check(info["family"] == "sensevoice" and info["weights_bytes"] > 0, f"inspect printed {info}")

    qm.set_quant_config(mm="bf16")  # the command line's default mode
    session = load_session(folder, DEV)
    check(isinstance(session.tokenizer, VocabTxtDecoder), "load_session did not read the artifact's tokenizer")
    tok = session.tokenizer
    want = [session.transcribe(f).token_ids for f in files]
    for f, (out, secs), ids in zip(files, alone, want):
        text = out.strip().splitlines()[1]
        check(bool(ids) and text == tok.decode(ids), f"{f}: the command line printed {text[:80]!r}, not the "
              f"decode of session.transcribe's {len(ids)} ids")
        print(f"[26 cli] transcribe {Path(f).name}: {len(ids)} ids, text = the tokenizer's decode of "
              f"session.transcribe's ids ({secs:.2f} s in a subprocess)  [{card}]")
    texts = both.strip().splitlines()[1::2]
    check(len(texts) == len(files), f"two files printed {len(texts)} texts")
    same = 0
    for f, text, ids, secs in zip(files, texts, want, CLI_SECONDS):
        got = vocab_ids(text)
        check(text == tok.decode(got), "a printed text is not a decode of its ids")
        if got == ids:
            same += 1
            continue
        audio = torch.from_numpy(load_audio(f, 16000)).to(DEV)[None]
        with torch.inference_mode():
            logits, vs = sv.encode_logits(session.params, cfg, audio, torch.tensor([audio.shape[1]], device=DEV),
                                          torch.zeros(1, dtype=torch.int64, device=DEV))
        low = (logits_margin(logits[0, : int(vs[0])]).min() / logits.abs().max()).item()
        print(f"[26 cli] {Path(f).name}: the batch route's ids differ from the file alone; smallest top-2 "
              f"margin {low:.3e} of max|logit|")
        check(low <= MARGIN, f"{f}: batch ids differ with every top-2 margin above {MARGIN} of max|logit|")
    print(f"[26 cli] inspect in {t_inspect:.2f} s; transcribe of both files (transcribe_batch: one forward) "
          f"in {t_both:.2f} s, ids equal to each file alone for {same}/{len(files)}  [{card}]")
    del session
    torch.cuda.empty_cache()
    return {"equal": same, "inspect_s": t_inspect, "batch_s": t_both}


def fun_replay(torch, session, audio, ids: list, params=None, llm=None) -> list:
    """Teacher-force one window's generated ids through the per-weight route
    of (params, llm) (the session's own weights by default): per id, (the
    gap between the best logit and the id's, the top-2 margin, both shares
    of max|logit|, and the argmax)."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import fun_asr_nano as fn
    from asr_tpu_torch.models import qwen_asr as qa

    cfg, lcfg = session.cfg, session.cfg.llm
    params, llm = params or session.params, llm or session.llm_params
    rows = []
    with torch.inference_mode():
        buf = torch.zeros((1, session.window_samples), device=DEV)
        buf[0, : len(audio)] = torch.from_numpy(audio).to(DEV)
        embeds, valid = fn.prompt_embeds_llm(params, llm, cfg, buf, torch.tensor([len(audio)], device=DEV),
                                             session._batch_ids(session._prompt_ids(""), 1))
        state, shift, t_max, logits = qa.left_prefill(llm, qa.QwenAsrConfig(llm=lcfg, eot_id=cfg.eot_id),
                                                      embeds, valid, session.decode_cfg.max_new_tokens)
        lf = embeds.shape[1]
        for j, tok in enumerate(ids):
            lg = logits[0, : lcfg.vocab_size]
            scale = lg.abs().max().item()
            rows.append(((lg.max() - lg[tok]).item() / scale, logits_margin(lg).item() / scale, int(lg.argmax())))
            if j + 1 == len(ids):
                break
            pos = lf + j
            tk = torch.tensor([[tok]], device=DEV)
            h, state = qwen3.decoder_pass(llm, lcfg, llm["embed"][tk], state, pos,
                                          qwen3.left_step_bias(shift, pos, t_max), pos_offset=shift)
            logits = qwen3.logits_from_hidden(llm, lcfg, h[:, -1])
    return rows


def fun_window_numbers(torch, np, session, card: str) -> dict:
    """One 30 s Fun-ASR-Nano window on the fused route: encoder + adaptor
    time and prefill time (synchronized host clock, the mean of three: the
    encoder's 290 linears are host-paced), ms per token, RTF and peak
    memory."""
    from asr_tpu_torch.models import fun_asr_nano as fn
    from asr_tpu_torch.models import qwen_asr as qa

    cfg = session.cfg
    out = {}
    audio30 = (np.random.default_rng(27).standard_normal(30 * 16000) * 2000).astype(np.float32)
    a30, v30 = torch.from_numpy(audio30).to(DEV)[None], torch.tensor([len(audio30)], device=DEV)
    ids = session._batch_ids(session._prompt_ids(""), 1)

    def prefill():
        embeds, valid = fn.prompt_embeds_llm(session.params, session.llm_params, cfg, a30, v30, ids)
        return qa.left_prefill(session.llm_params, qa.QwenAsrConfig(llm=cfg.llm), embeds, valid,
                               session.decode_cfg.max_new_tokens)

    with torch.inference_mode():
        prefill()
        t_enc = sum(synced(torch, lambda: fn.audio_embeds(session.params, cfg, a30, v30))[1] for _ in range(3)) / 3
        t_pre = sum(synced(torch, prefill)[1] for _ in range(3)) / 3
    out["encoder_ms"] = t_enc * 1e3
    out["prefill_ms"] = (t_pre - t_enc) * 1e3
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = session.transcribe(audio30)
    out["rtf_30s"] = res.rtf
    out["window_ms"] = res.elapsed_seconds * 1e3
    out["steps_30s"] = qwen_counts(session, res.token_ids) - 1
    out["ms_per_token"] = (res.elapsed_seconds - t_pre) * 1e3 / max(out["steps_30s"], 1)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[27 numbers] one 30 s window: {out['window_ms']:.1f} ms, RTF {out['rtf_30s']:.5f}; encoder + "
          f"adaptor {out['encoder_ms']:.2f} ms ({fun_lfr_rows(cfg)} LFR rows), prefill {out['prefill_ms']:.2f} ms "
          f"({fun_prefill_rows(cfg)} rows), {out['steps_30s']} decode steps at {out['ms_per_token']:.3f} ms per "
          f"token (fused route, host wall); peak memory {out['peak_mib']:.0f} MiB  [{card}]")
    return out


def phase_fun_llm(torch, np, qm, fd, folder: str, card: str) -> dict:
    """[27] Fun-ASR-Nano-2512 with its LLM head at full width (q8 encoder and
    adaptor, packed-q4 LLM, 4-bit quantized tied embeddings) through an
    artifact folder and the command line's ``_build_session``: 20 s on the
    fused route with its launch counts, its ids replayed with plain matmuls
    on the dequantized weights, the prefill logits (mm=f32) against plain
    within 1e-3 of max|logit|, one 30 s window's numbers, then
    ``transcribe_batch`` of FUN_BATCH files (the lockstep per-weight route,
    the int4 kernel at M = FUN_BATCH)."""
    import copy

    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import fun_asr_nano as fn
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.runtime.qwen_session import FunAsrNanoLlmSession

    cfg = fn.FunAsrNanoConfig()
    lcfg = cfg.llm
    t0 = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(27)
    enc = quantize_pytree(fn.init_params(cfg, g), bits=8)
    llm = quantize_pytree(qwen3.init_params(lcfg, g), bits=4, pack=True, quantize_embeddings=True)
    save_model(folder, {"encoder": enc, "llm": llm}, fun_metadata(cfg, "fun_asr_nano_llm"))
    write_vocab(Path(folder) / "tokens.txt", lcfg.vocab_size)
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del enc, llm
    torch.cuda.empty_cache()
    qm.set_quant_config(mm="bf16")  # the serving mode; the session stacks for the fused step
    session = _build_session(Path(folder), device=torch.device(DEV))
    check(isinstance(session, FunAsrNanoLlmSession) and session.stacked is not None
          and "wh" in session.stacked, "the session did not stack the q4 LLM and its head")
    tok = session.tokenizer
    check(tok is not None, "_build_session did not read the artifact's tokenizer")
    n_enc = 4 * (cfg.num_encoders0 + cfg.num_encoders + cfg.num_tp_encoders)
    n_adaptor = 2 + 4 * cfg.adaptor_blocks
    n_prefill = 4 * lcfg.num_layers + 1
    print(f"[27 fun_llm] Fun-ASR-Nano (q8 encoder + adaptor, packed-q4 Qwen3-0.6B, 4-bit tied head): init + "
          f"quantize + artifact ({size_mb:.1f} MB) round trip in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(27)
    audio20 = (rng.standard_normal(20 * 16000) * 2000).astype(np.float32)
    session.transcribe(audio20[:16000])  # warm-up
    torch.cuda.synchronize()

    qm.LAUNCHES = qm.LAUNCHES_INT4 = fd.LAUNCHES = 0  # the Fun-ASR-Nano LLM path starts here
    res = session.transcribe(audio20)
    int8, int4, fused = qm.LAUNCHES, qm.LAUNCHES_INT4, fd.LAUNCHES  # and ends here
    ids = res.token_ids
    steps = qwen_counts(session, ids) - 1
    check(fused == steps > 0, f"{fused} fused launches for {steps} decode steps")
    check(int4 == n_prefill, f"{int4} int4 launches, not {n_prefill} (the prefill's linears and the first logits)")
    check(int8 == n_enc + n_adaptor, f"{int8} int8 launches, not the encoder's {n_enc} + the adaptor's {n_adaptor}")
    check(bool(res.text) and res.text == tok.decode(ids), "the text is not the decode of the ids")
    print(f"[27 fun_llm] 20 s -> {len(ids)} tokens in {res.elapsed_seconds * 1e3:.1f} ms; fused launches {fused} "
          f"(= decode steps), int4 {int4} ({lcfg.num_layers} x 4 + the first logits), int8 {int8} (encoder "
          f"{n_enc} + adaptor {n_adaptor}); text = the decode of the ids ({len(res.text)} chars)  [{card}]")

    # The generated ids replayed with plain matmuls on the dequantized weights
    # (f32 caches). The fused route rounds its matvec inputs to bf16 and keeps
    # bf16 caches, so it is held as phase 16 holds it: argmax equal wherever
    # the replay's top-2 margin is above QWEN_REPLAY_MARGIN.
    dense_enc, dense_llm = dequantize_pytree(session.params), dequantize_pytree(session.llm_params)
    rows = fun_replay(torch, session, audio20, ids, dense_enc, dense_llm)
    sure = [r for r in rows if r[1] > QWEN_REPLAY_MARGIN]
    flips = sum(r[2] != t for r, t in zip(rows, ids) if r[1] > QWEN_REPLAY_MARGIN)
    worst = max(r[0] for r in rows)
    near = sum(r[0] <= MARGIN for r in rows)
    print(f"[27 check] replay with plain matmuls on the dequantized weights: argmax = the generated id at "
          f"{len(sure) - flips}/{len(sure)} ids above a {QWEN_REPLAY_MARGIN} top-2 margin; every id within "
          f"{worst:.2e} of max|logit| of the replay's best ({near}/{len(rows)} within {MARGIN})")
    check(flips == 0, f"{flips} ids differ from the plain replay's argmax above a {QWEN_REPLAY_MARGIN} margin")
    check(worst <= QWEN_REPLAY_MARGIN, f"an id {worst:.2e} of max|logit| below the plain replay's best")

    # The prefill logits (mm=f32, the exact product) against plain matmuls.
    qm.set_quant_config(mm="f32")
    a8 = torch.from_numpy(audio20[: 8 * 16000]).to(DEV)[None]
    v8 = torch.tensor([8 * 16000], device=DEV)
    pids = session._batch_ids(session._prompt_ids(""), 1)
    qcfg = qa.QwenAsrConfig(llm=lcfg)
    with torch.inference_mode():
        lq = qa.left_prefill(session.llm_params, qcfg, *fn.prompt_embeds_llm(
            session.params, session.llm_params, cfg, a8, v8, pids), 1)[3]
        lp = qa.left_prefill(dense_llm, qcfg, *fn.prompt_embeds_llm(dense_enc, dense_llm, cfg, a8, v8, pids), 1)[3]
    qm.set_quant_config(mm="bf16")
    del dense_enc, dense_llm
    torch.cuda.empty_cache()
    diff, scale = (lq - lp).abs().max().item(), lp.abs().max().item()
    check(bool(torch.isfinite(lq).all()) and diff <= 1e-3 * scale, f"q4 prefill logits vs plain: {diff} > 1e-3 * {scale}")
    print(f"[27 check] q8 encoder + q4 LLM mm=f32 prefill logits (8 s) vs plain f32 matmuls on the dequantized "
          f"weights: max diff {diff:.3e} (max|logit| {scale:.3e}, {diff / scale:.2e} of it)")

    out = {"int8": int8, "int4": int4, "fused": fused, "steps": steps}
    out.update(fun_window_numbers(torch, np, session, card))

    # transcribe_batch: one lockstep batch of FUN_BATCH files (the per-weight route).
    bsess = copy.copy(session)
    bsess.decode_cfg = dataclasses.replace(session.decode_cfg, max_new_tokens=FUN_BUDGET)
    seconds = rng.uniform(5.0, 30.0, size=FUN_BATCH)
    clips = [(rng.standard_normal(int(s * 16000)) * 2000).astype(np.float32) for s in seconds]
    qm.LAUNCHES = qm.LAUNCHES_INT4 = fd.LAUNCHES = 0  # the batch path starts here
    results = bsess.transcribe_batch(clips)
    b_int8, b_int4, b_fused = qm.LAUNCHES, qm.LAUNCHES_INT4, fd.LAUNCHES  # and ends here
    check(b_fused == 0, f"the batch-{FUN_BATCH} route launched the fused kernel {b_fused} times")
    check(b_int8 == n_enc + n_adaptor, f"{b_int8} int8 launches for one batched encoder")
    check(b_int4 % n_prefill == 0 and b_int4 > 0, f"{b_int4} int4 launches is not a multiple of {n_prefill}")
    equal, gap = 0, 0.0
    for clip, r in zip(clips, results):
        check(bool(r.text) and r.text == tok.decode(r.token_ids), "a batch row's text is not its ids' decode")
        with torch.inference_mode():
            buf = torch.zeros((1, bsess.window_samples), device=DEV)
            buf[0, : len(clip)] = torch.from_numpy(clip).to(DEV)
            tokens, counts, starts = fn.forward_llm(bsess.params, bsess.llm_params, cfg, buf,
                                                    torch.tensor([len(clip)], device=DEV),
                                                    bsess._batch_ids(bsess._prompt_ids(""), 1), bsess.decode_cfg)
        v, c = int(starts[0]), int(counts[0])
        alone = [int(t) for t in tokens[0, v : v + c].tolist() if t != cfg.eot_id]
        if alone == r.token_ids:
            equal += 1
            continue
        gap = max(gap, max(row[0] for row in fun_replay(torch, bsess, clip, r.token_ids)))
        check(gap <= MARGIN, f"a batch row's id is {gap:.2e} of max|logit| below the per-weight route's best")
    print(f"[27 batch] transcribe_batch of {FUN_BATCH} ({', '.join(f'{s:.1f}' for s in seconds)} s, "
          f"{FUN_BUDGET}-token budget) in {results[0].elapsed_seconds * 1e3:.1f} ms: int4 {b_int4} "
          f"({b_int4 // n_prefill} passes x {n_prefill} at M = {FUN_BATCH}, the prefill at M = "
          f"{FUN_BATCH} x {fun_prefill_rows(cfg)}), int8 {b_int8}, fused {b_fused}; ids equal to the per-weight "
          f"route alone for {equal}/{FUN_BATCH} rows (the rest within {gap:.2e} of max|logit| of its best)  [{card}]")
    out.update(batch_int8=b_int8, batch_int4=b_int4, batch_equal=equal)
    return out, session


def phase_fun_ctc_continuous(torch, np, qm, fd, fdm, folder: str, session, card: str) -> dict:
    """[28] Fun-ASR-Nano's CTC head through a ``fun_asr_nano`` artifact folder
    (phase 27's q8 encoder) and ``_build_session``: a 45 s file (two windows,
    one forward) with its launches, RTF and text, and its q8 logits (mm=f32)
    against plain matmuls; then continuous serving of phase 27's LLM session
    over HTTP (8 slots, bf16 caches, a FUN_BUDGET-token budget): 9 concurrent
    requests of 5-30 s, every decode step one multi-slot kernel launch, each
    request's ids bitwise equal to it alone through the batcher."""
    import copy

    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.models import fun_asr_nano as fn
    from asr_tpu_torch.parallel.llm_server import start_background_continuous
    from asr_tpu_torch.quant.quantize import dequantize_pytree
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.runtime.transducer_session import FunAsrNanoCtcSession

    cfg = session.cfg
    save_model(folder, session.params, fun_metadata(cfg, "fun_asr_nano"))
    write_vocab(Path(folder) / "tokens.txt", cfg.ctc_vocab)
    qm.set_quant_config(mm="bf16")
    ctc = _build_session(Path(folder), device=torch.device(DEV))
    check(isinstance(ctc, FunAsrNanoCtcSession) and ctc.tokenizer is not None, "not a CTC session with a tokenizer")
    n_ctc = 4 * (cfg.num_encoders0 + cfg.num_encoders + cfg.num_tp_encoders) + 3 + 4 * cfg.ctc_blocks
    rng = np.random.default_rng(28)
    audio45 = (rng.standard_normal(45 * 16000) * 2000).astype(np.float32)
    ctc.transcribe(audio45[:16000])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qm.LAUNCHES = 0  # the CTC path starts here
    res = ctc.transcribe(audio45)
    ctc_int8 = qm.LAUNCHES  # and ends here
    peak = torch.cuda.max_memory_allocated() / 2**20
    check(ctc_int8 == n_ctc, f"{ctc_int8} int8 launches, not {n_ctc} (encoder + CTC head, one forward)")
    check(bool(res.text) and res.text == ctc.tokenizer.decode(res.token_ids), "CTC text is not the ids' decode")
    print(f"[28 fun_ctc] 45 s (2 windows, one forward) -> {len(res.token_ids)} tokens in "
          f"{res.elapsed_seconds * 1e3:.1f} ms, RTF {res.rtf:.5f}; int8 launches {ctc_int8}; peak memory "
          f"{peak:.0f} MiB  [{card}]")
    # The q8 CTC logits (mm=f32) against plain matmuls on the dequantized weights.
    qm.set_quant_config(mm="f32")
    w = ctc.window_samples
    a = torch.zeros((2, w), device=DEV)
    a[0] = torch.from_numpy(audio45[:w]).to(DEV)
    a[1, : len(audio45) - w] = torch.from_numpy(audio45[w:]).to(DEV)
    v = torch.tensor([w, len(audio45) - w], device=DEV)
    dense = dequantize_pytree(ctc.params)
    with torch.inference_mode():
        enc, vl, _ = fn.encode(ctc.params, cfg, a, v)
        lq = fn.ctc_logits(ctc.params, cfg, enc, vl)
        enc, _, _ = fn.encode(dense, cfg, a, v)
        lp = fn.ctc_logits(dense, cfg, enc, vl)
    qm.set_quant_config(mm="bf16")
    del dense
    diff, scale = (lq - lp).abs().max().item(), lp.abs().max().item()
    check(bool(torch.isfinite(lq).all()) and diff <= 1e-3 * scale, f"CTC logits vs plain: {diff} > 1e-3 * {scale}")
    frames = torch.arange(lq.shape[1], device=DEV)[None, :] < vl[:, None]
    sure = frames & (logits_margin(lp) > MARGIN * scale)
    check(bool((lq.argmax(-1) == lp.argmax(-1))[sure].all()), "CTC argmax differs above a 1e-3 margin")
    print(f"[28 check] q8 mm=f32 CTC logits vs plain f32: max diff {diff:.3e} (max|logit| {scale:.3e}), argmax "
          f"equal on {int(sure.sum())} frames, {int((frames & ~sure).sum())} under the margin")
    del ctc, lq, lp
    torch.cuda.empty_cache()

    # Continuous serving of the LLM session.
    csess = copy.copy(session)
    csess.decode_cfg = dataclasses.replace(session.decode_cfg, max_new_tokens=FUN_BUDGET)
    tok = csess.tokenizer
    seconds = rng.uniform(*FUN_CONT_SECONDS, size=FUN_CONT_REQUESTS)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 2000).astype(np.int16) for s in seconds]
    delays = rng.uniform(0.0, 0.2, size=len(clips))
    httpd, srv, thread = start_background_continuous(csess, n_slots=QWEN_CONT_SLOTS, kv_dtype="bf16")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qm.LAUNCHES = qm.LAUNCHES_INT4 = fd.LAUNCHES = fdm.LAUNCHES = 0  # the serving path starts here
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
        int8, int4, fused, multi = qm.LAUNCHES, qm.LAUNCHES_INT4, fd.LAUNCHES, fdm.LAUNCHES  # and ends here
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        thread.join(timeout=60)
    n_enc = 4 * (cfg.num_encoders0 + cfg.num_encoders + cfg.num_tp_encoders) + 2 + 4 * cfg.adaptor_blocks
    n_prefill = 4 * cfg.llm.num_layers + 1
    check(health["ok"] and health["step_kernel"] == "fused" and health["decoder"] == "llm", f"healthz: {health}")
    check(health["requests_served"] == len(clips) and health["slots_active"] == 0, f"healthz: {health}")
    check(multi == health["decode_steps"] > 0, f"{multi} multi-slot launches for {health['decode_steps']} steps")
    check(fused == 0, f"the batch-1 kernel was launched {fused} times")
    check(int8 == len(clips) * n_enc, f"{int8} int8 launches, not {len(clips)} x {n_enc}")
    check(int4 == len(clips) * n_prefill, f"{int4} int4 launches, not {len(clips)} prefills x {n_prefill}")
    bat, eot = srv.batcher, cfg.eot_id
    with torch.inference_mode():
        for i, clip in enumerate(clips):
            check(results[i] is not None and results[i][0] == 200, f"request {i}: {results[i]}")
            got = results[i][1]
            check(bool(got["text"]) and got["text"] == tok.decode(got["token_ids"]),
                  f"request {i}: the text is not the decode of its ids")
            emb, valid = csess.prompt_embeds(clip.astype(np.float32))
            slot = bat.try_submit(emb, valid)
            while bat.is_active(slot):
                bat.step()
            alone = [t for t in bat.take_result(slot) if t != eot]
            check(alone == got["token_ids"], f"request {i}: the served ids differ from the request alone "
                  "through the batcher")
    lat = np.array([r[2] for r in results])
    toks, step_s = health["tokens_generated"], health["step_latency_avg_s"]
    agg = toks / (health["decode_steps"] * step_s) if step_s else 0.0
    print(f"[28 serve] {len(clips)} requests ({seconds.min():.1f}-{seconds.max():.1f} s, {QWEN_CONT_SLOTS} slots, "
          f"bf16 caches of {bat.t_max} rows, {FUN_BUDGET}-token budget) in {wall:.2f} s: multi-slot launches "
          f"{multi} (= decode_steps), batch-1 {fused}, int4 {int4} ({len(clips)} prefills x {n_prefill} at M = "
          f"{CONT_PREFILL_ROWS}), int8 {int8}; every request's ids bitwise equal to it alone through the "
          f"batcher, texts = the decode of the ids  [{card}]")
    print(f"[28 numbers] decode {toks} tokens: {agg:.0f} tokens/s over step time ({toks / wall:.0f} end to end); "
          f"average step {step_s * 1e3:.3f} ms; completion p50 {np.percentile(lat, 50):.2f} s, p95 "
          f"{np.percentile(lat, 95):.2f} s (client side); peak memory {peak:.0f} MiB  [{card}]")
    del csess, srv, bat
    torch.cuda.empty_cache()
    return {"ctc_int8": ctc_int8, "ctc_rtf": res.rtf, "launches": multi, "int8": int8, "int4": int4,
            "tokens": toks, "agg_tok_s": agg, "step_ms": step_s * 1e3, "wall_s": wall}


def phase_aligner(torch, np, qm, card: str) -> dict:
    """[29] Qwen3-ForcedAligner-0.6B at full width (q8 tower, packed-q4 LLM
    with 4-bit embeddings, f32 class head) through QwenAlignerSession: a 20 s
    file and a 12-word text, a character-level encoder as the tokenizer. In
    mm=f32 the launch counts, monotone timestamps, and each bucket against
    the argmax of a replay with plain matmuls on the dequantized weights
    wherever its top-2 margin is above 1e-3 of max|logit|; then ms per
    ``align`` call in the bf16 mode."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import forced_aligner as fa
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree
    from asr_tpu_torch.runtime.aligner_session import QwenAlignerSession

    cfg = fa.ForcedAlignerConfig()
    lcfg = cfg.asr.llm
    g = torch.Generator(device=DEV).manual_seed(29)
    tower = quantize_pytree(qa.init_tower_params(cfg.asr, g), bits=8)
    llm = quantize_pytree(qwen3.init_params(lcfg, g), bits=4, pack=True, quantize_embeddings=True)
    head = {"w": torch.randn((lcfg.hidden, cfg.classify_num), generator=g, device=DEV) * lcfg.hidden ** -0.5}
    special = {"timestamp": lcfg.vocab_size - 200, "audio_start": lcfg.vocab_size - 201,
               "audio_end": lcfg.vocab_size - 202}
    sess = QwenAlignerSession(tower, llm, head, cfg, tokenizer=CharTokenizer(), special_ids=special)
    audio = (np.random.default_rng(29).standard_normal(int(ALIGN_SECONDS * 16000)) * 0.1).astype(np.float32)
    words = ALIGN_TEXT.split()
    qm.set_quant_config(mm="f32")
    sess.align(audio[:16000], "warm up")
    torch.cuda.synchronize()
    qm.LAUNCHES = qm.LAUNCHES_INT4 = 0  # the aligner's path starts here
    out = sess.align(audio, ALIGN_TEXT)
    int8, int4 = qm.LAUNCHES, qm.LAUNCHES_INT4  # and ends here
    n_tower = 6 * cfg.asr.tower_layers + 3
    check(int8 == n_tower, f"{int8} int8 launches, not the tower's {n_tower}")
    check(int4 == 7 * lcfg.num_layers, f"{int4} int4 launches, not {lcfg.num_layers} x 7 (the unfused linears)")
    check([o["text"] for o in out] == words, f"aligned units {[o['text'] for o in out]}")
    starts = [o["start_ms"] for o in out]
    check(all(a <= b for a, b in zip(starts, starts[1:])) and all(o["start_ms"] <= o["end_ms"] for o in out),
          f"timestamps not monotone: {out}")

    # The buckets against plain matmuls on the dequantized weights.
    text_ids, ts = [], []
    for w in words:
        text_ids.extend(CharTokenizer().encode(w))
        ts.append(len(text_ids))
        text_ids.append(special["timestamp"])
    dense_tower, dense_llm = dequantize_pytree(tower), dequantize_pytree(llm)
    buf = torch.zeros((1, sess.max_samples), device=DEV)
    buf[0, : len(audio)] = torch.from_numpy(audio).to(DEV)
    args = (buf, torch.tensor([len(audio)], device=DEV))
    tid = torch.tensor([text_ids], device=DEV)
    with torch.inference_mode():
        _, eq, vq = fa.prompt_for(tower, llm, cfg, *args, sess._embed(special["audio_start"]),
                                  sess._embed(special["audio_end"]), tid)
        lq = fa.align_logits(llm, head, cfg, eq, vq)[0]
        emb = lambda i: dense_llm["embed"][torch.tensor([[i]], device=DEV)]  # noqa: E731
        _, ep, vp = fa.prompt_for(dense_tower, dense_llm, cfg, *args, emb(special["audio_start"]),
                                  emb(special["audio_end"]), tid)
        lp = fa.align_logits(dense_llm, head, cfg, ep, vp)[0]
    del dense_tower, dense_llm
    torch.cuda.empty_cache()
    offset = int(vq[0]) - len(text_ids)
    pos = torch.tensor([offset + p for p in ts], device=DEV)
    bq, bp = lq[pos].argmax(-1), lp[pos].argmax(-1)
    margin = logits_margin(lp[pos]) / lp[pos].abs().amax(-1)
    sure = margin > MARGIN
    check(bool((bq == bp)[sure].all()), f"buckets {bq.tolist()} vs the plain replay's {bp.tolist()} above a "
          f"{MARGIN} margin")
    check(fa.word_timestamps(words, bq.tolist(), 1, cfg.segment_ms) == out,
          "the session's timestamps are not the checked buckets'")
    rows = aligner_prefill_rows(cfg, len(text_ids))
    check(eq.shape[1] == rows, f"the pass ran {eq.shape[1]} rows, not {rows}")
    print(f"[29 aligner] Qwen3-ForcedAligner-0.6B (q8 tower, packed-q4 LLM, f32 head of {cfg.classify_num}): "
          f"{ALIGN_SECONDS:.0f} s, {len(words)} words -> monotone timestamps {starts[0]}..{out[-1]['end_ms']} ms; "
          f"int8 {int8} (the tower), int4 {int4} ({lcfg.num_layers} x 7 at M = {rows}); buckets = the plain "
          f"replay's argmax at {int(sure.sum())}/{len(ts)} positions above a {MARGIN} margin  [{card}]")
    qm.set_quant_config(mm="bf16")
    sess.align(audio, ALIGN_TEXT)
    calls = 3
    _, secs = synced(torch, lambda: [sess.align(audio, ALIGN_TEXT) for _ in range(calls)])
    ms = secs * 1e3 / calls
    print(f"[29 numbers] align (bf16 mode): {ms:.1f} ms per call ({ALIGN_SECONDS:.0f} s of audio, {rows} LLM rows; "
          f"RTF {ms / (ALIGN_SECONDS * 1e3):.5f})  [{card}]")
    del sess, tower, llm
    torch.cuda.empty_cache()
    return {"int8": int8, "int4": int4, "ms": ms, "sure": int(sure.sum())}


# ── 30-33. FireRedASR-AED-L and Dolphin on the AED kernels ────────────────
FIRERED_GEOMETRY = (1280, 5120, 8192, 448, 750)  # D, F, V_pad, self and cross rows of a 30 s window
DOLPHIN_GEOMETRY = (512, 2048, 27648, 448, 749)
AED_FAMILY_TC = {"firered": (750, 512), "dolphin": (749, 301)}  # valid cross rows: all, and fewer
AED_FAMILY_MULTI_B = (2, 8)
# Dolphin's language and region spans inside its vocabulary (both probes
# run), and a catalog with one language to force by name.
DOLPHIN_SPANS = dict(language_token_start=27000, language_token_end=27100, region_token_start=27100,
                     region_token_end=27200)
DOLPHIN_CATALOG = {"languages": {"xx": 27005}, "regions": {"YY": 27105}, "aliases": {"Forced": "xx"}}
AED_FAMILY_REQUESTS = 9
AED_FAMILY_SECONDS = (5.0, 30.0)  # one window each, lengths drawn from this range


def aed_family(name: str):
    """(model module, full-width config) of FireRedASR-AED-L or Dolphin."""
    from asr_tpu_torch.models import dolphin, firered

    if name == "firered":
        return firered, firered.FireRedConfig()
    return dolphin, dolphin.DolphinConfig(**DOLPHIN_SPANS)


def aed_family_int8_paths() -> dict:
    """The int8 kernel's calls on the FireRed and Dolphin paths ({(M, K, N,
    block): calls}): one 30 s window's encoder (FireRed: ffn w1 x2 + conv
    pw1, ffn w2 x2, q|k|v|o, the rel-pos projection at 2T - 1 rows, conv
    pw2, the stem's linear over 32 x 19 features in one block; Dolphin: ffn
    w1 x2 + cgMLP proj1, ffn w2 x2, q|k|v|o, rel_k at 2T - 1 rows, proj2 +
    merge, the stem's linear) and its cross-KV (2 a decoder layer; Dolphin
    twice: the probes' state and the prompt's), Dolphin's CTC head, and the
    decoder passes at M rows (a per-weight step at M = 1, 2; Dolphin's
    prompt prefill at M = 3): 8 linears a decoder layer and the head."""
    pad = lambda v: -(-v // 512) * 512

    def add(calls, key, n):
        calls[key] = calls.get(key, 0) + n

    paths = {}
    for name in ("firered", "dolphin"):
        _, cfg = aed_family(name)
        t, d, nl, el = (FIRERED_GEOMETRY if name == "firered" else DOLPHIN_GEOMETRY)[4], cfg.d_model, \
            cfg.dec_layers, cfg.enc_layers
        calls: dict = {}
        if name == "firered":
            sub = 32 * (((cfg.n_mels - 1) // 2 - 1) // 2)
            add(calls, (t, d, 4 * d, 128), 3 * el)
            add(calls, (t, 4 * d, d, 128), 2 * el)
            add(calls, (t, d, d, 128), 4 * el + 2 * nl)
            add(calls, (2 * t - 1, d, d, 128), el)
            add(calls, (t, 2 * d, d, 128), el)
            add(calls, (t, sub, d, sub if sub % 128 else 128), 1)
        else:
            add(calls, (t, d * (((cfg.mel.n_mels - 1) // 2 - 1) // 2), d, 128), 1)
            add(calls, (t, d, cfg.enc_ffn, 128), 2 * el)
            add(calls, (t, d, cfg.cgmlp_dim, 128), el)
            add(calls, (t, cfg.enc_ffn, d, 128), 2 * el)
            add(calls, (t, d, d, 128), 4 * el + 2 * 2 * nl)
            add(calls, (2 * t - 1, d, d, 128), el)
            add(calls, (t, cfg.cgmlp_dim // 2, d, 128), el)
            add(calls, (t, 2 * d, d, 128), el)
            paths["dolphin_ctc_head"] = {(t, d, cfg.vocab_size, 128): 1}
        paths[f"{name}_encoder"] = calls
        for m in ((1, 2) if name == "firered" else (1, 2, 3)):
            step: dict = {}
            for key, n in (((m, d, d, 128), 6 * nl), ((m, d, cfg.dec_ffn, 128), nl),
                           ((m, cfg.dec_ffn, d, 128), nl), ((m, d, pad(cfg.vocab_size), 128), 1)):
                add(step, key, n)
            paths[f"{name}_{'prefill' if m == 3 else 'step'}_m{m}"] = step
    return paths


def aed_family_window_int8(name: str) -> tuple[int, int]:
    """(int8 calls of one window before its first decode step, of one
    per-weight step) on a FireRed / Dolphin session: the encoder, its
    cross-KV and the decoder passes of the prefill (FireRed: [SOS]; Dolphin:
    the language and region probes, then the prompt)."""
    paths = aed_family_int8_paths()
    per_step = sum(paths[f"{name}_step_m1"].values())
    return sum(paths[f"{name}_encoder"].values()) + (1 if name == "firered" else 3) * per_step, per_step


def randomize_decoder(torch, dec: dict, g) -> None:
    """Random biases (where the checkpoint has them) and LayerNorm
    parameters in an AED decoder (the init has zeros and ones), so that each
    reaches the comparison; absent biases stay absent and stack as zeros."""
    def norm(p):
        p["scale"] = 1 + 0.1 * torch.randn(p["scale"].shape, generator=g, device=DEV)
        p["bias"] = 0.1 * torch.randn(p["bias"].shape, generator=g, device=DEV)

    for p in dec["blocks"]:
        for key in ("ln1", "ln_cross", "ln2"):
            norm(p[key])
        for lin in (*p["attn"].values(), *p["cross"].values(), *p["mlp"].values()):
            if "b" in lin:
                lin["b"] = 0.1 * torch.randn(lin["b"].shape, generator=g, device=DEV)
    norm(dec["ln"])


def phase_aed_family_kernels(torch, fs, fm, quantize_pytree, card: str) -> dict:
    """[30] The fused and multi-slot AED kernels at FireRedASR-AED-L's (16
    layers at d 1280, a head of 8192 columns, 750 cross rows; o-projections
    without a bias) and Dolphin's (6 layers at d 512, 8 heads, a head of
    27648 columns, 749 cross rows) decoder geometry, random biases and
    LayerNorms: the fused step against its plain version (phase 8's gates,
    f32 and bf16 caches, three positions, all and fewer valid cross rows),
    its time in turns beside its bound and its profile; the multi-slot step
    against its plain version and, slot by slot, bitwise against the
    batch-1 kernel at B = 2 and 8 with one parked slot (phase 11's gates),
    and its time at B = 8."""
    from asr_tpu_torch.layers.conformer import absolute_positions

    out = {}
    for name in ("firered", "dolphin"):
        mod, cfg = aed_family(name)
        cfg = dataclasses.replace(cfg, enc_layers=0)  # the decoder at full width
        d, f, vp, t, tc = FIRERED_GEOMETRY if name == "firered" else DOLPHIN_GEOMETRY
        g = torch.Generator(device=DEV).manual_seed(30)
        params = mod.init_params(cfg, g)
        randomize_decoder(torch, params["decoder"], g)
        params = quantize_pytree(params, bits=8, block=128, quantize_embeddings=True)
        geom = fs.AedGeom(cfg.d_model, cfg.dec_ffn, cfg.dec_heads)
        stacked = fs.stack_aed_step_params(params["decoder"], geom)
        check(stacked is not None and tuple(stacked["wh"].shape) == (d, vp) and geom.ffn_dim == f,
              f"{name} q8 decoder did not stack at (D, V_pad) = {(d, vp)}")
        dec, table = params["decoder"], absolute_positions(cfg.max_target_positions, d, DEV)

        def x_of(toks, pos_l):
            pos = torch.tensor([max(p, 0) for p in pos_l], device=DEV)
            return (dec["embed"][toks] * d ** 0.5 + table[pos]).float()

        def x_one(pos):
            return x_of(torch.tensor([(1000 + pos) % cfg.vocab_size], device=DEV), [pos])

        label = f"30 {name}"
        dims = (cfg.dec_layers, t, tc, cfg.vocab_size)
        fused = fused_vs_plain(torch, fs, stacked, geom, *dims, x_one, AED_FAMILY_TC[name], g, label, card)
        rows, worst = multi_vs_plain(torch, fs, fm, stacked, geom, *dims, x_of, AED_FAMILY_TC[name], g,
                                     AED_FAMILY_MULTI_B, label)
        times = multi_times(torch, fs, fm, stacked, geom, *dims[:3], tc,
                            {c: fused["times"][c]["ms"] for c in fused["times"]}, g,
                            AED_FAMILY_MULTI_B[-1:], label, card)
        out[name] = {"fused": fused, "multi_rows": rows, "multi_max_abs_err": worst, "multi_times": times}
        del params, stacked, dec
        torch.cuda.empty_cache()
    return out


def write_firered_dict(path: Path, n: int) -> None:
    """A firered_dict tokenizer file of ``n`` entries: id i decodes to "w<i>"
    (ids 0-3 are its blank, unk, sos and eos, which decode to nothing)."""
    special = ("<blank>", "<unk>", "<sos>", "<eos>")
    path.write_text("".join(f"{special[i] if i < 4 else f'w{i}'} {i}\n" for i in range(n)),
                    encoding="utf-8")


def aed_family_prefill(torch, session, mod, audio, prompt=None, params=None) -> dict:
    """One window's ``prefill_window`` on a FireRed / Dolphin session's
    parameters, or ``params`` (Dolphin: ``prompt``, default the session's)."""
    a = torch.zeros((1, session.window_samples), device=DEV)
    a[0, : len(audio)] = torch.as_tensor(audio, dtype=torch.float32).to(DEV)
    v = torch.tensor([min(len(audio), session.window_samples)], device=DEV)
    if prompt is None and hasattr(session, "_prompt"):
        prompt = session._prompt(1)
    args = (a, v) if prompt is None else (a, v, prompt)
    return mod.prefill_window(session.params if params is None else params, session.cfg, *args,
                              session.decode_cfg)


def aed_family_caches(torch, state: dict, d: int):
    """The (NL, T, D) self and (NL, Tc, D) cross stacks of a batch-1 state."""
    layers = state["layers"]
    return [torch.stack([ls[k][0].reshape(-1, d) for ls in layers])
            for k in ("self_k", "self_v", "cross_k", "cross_v")]


def phase_aed_family(torch, np, qm, fs, name: str, folder: str, card: str) -> dict:
    """[31] FireRedASR-AED-L / [32] Dolphin q8 at full width (random weights
    from a seed, quantized on the card with the tied head) through an
    artifact folder (a firered_dict / vocab_txt tokenizer file; Dolphin's
    language catalog) and the command line's ``_build_session``: 20 s on the
    fused route (one fused launch a decode step; the encoder, cross-KV and
    prefill's int8 launches), its ids against a teacher-forced replay with
    plain matmuls on the dequantized decoder; 45 s (two windows) on the
    per-weight route; one 30 s window's encoder, prefill and per-token
    times, RTF, peak memory, the host sync's share and launch counts.
    Dolphin also forces its language through the catalog and times its CTC
    head over a 30 s window."""
    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.decode.ar import select_token
    from asr_tpu_torch.layers.attention import attention_bias_from_lengths
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model

    label = "31 firered" if name == "firered" else "32 dolphin"
    mod, cfg = aed_family(name)
    qm.set_quant_config(mm="bf16")  # the serving mode; the session stacks for the fused step
    t0 = time.perf_counter()
    q8 = quantize_pytree(mod.init_params(cfg, torch.Generator(device=DEV).manual_seed(31)), bits=8,
                         block=128, quantize_embeddings=True)
    extra = {"config": dataclasses.asdict(cfg)}
    if name == "firered":
        write_firered_dict(Path(folder) / "dict.txt", cfg.vocab_size)
        tok = {"kind": "firered_dict", "file": "dict.txt"}
    else:
        write_vocab(Path(folder) / "vocab.txt", cfg.vocab_size)
        tok = {"kind": "vocab_txt", "file": "vocab.txt"}
        extra["dolphin_language_catalog"] = DOLPHIN_CATALOG
    save_model(folder, q8, ModelMetadata(family=name, tokenizer=tok, extra=extra))
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del q8
    torch.cuda.empty_cache()
    session = _build_session(Path(folder), device=DEV)
    check(type(session).__name__ == ("FireRedSession" if name == "firered" else "DolphinSession"),
          f"_build_session gave a {type(session).__name__}")
    check(session.stacked is not None, "the session did not stack the q8 decoder for the fused step")
    params, dcfg, d = session.params, session.decode_cfg, cfg.d_model
    geom = fs.AedGeom(d, cfg.dec_ffn, cfg.dec_heads)
    print(f"[{label}] q8 (config {type(cfg).__name__}() at full width): init + quantize + artifact "
          f"({size_mb:.1f} MB) round trip in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(31)
    audio20 = (rng.standard_normal(20 * 16000) * 2000).astype(np.float32)  # the int16 range
    session.transcribe(audio20[:16000])  # warm-up: cuBLAS, cuDNN, the kernels' first launches
    torch.cuda.synchronize()
    per_win, per_step = aed_family_window_int8(name)

    qm.LAUNCHES = fs.LAUNCHES = 0  # the path starts here
    res = session.transcribe(audio20)
    int8, fused = qm.LAUNCHES, fs.LAUNCHES  # and ends here
    ids = res.token_ids
    check(fused == len(ids) - 1 and fused > 0, f"{fused} fused launches for {len(ids)} generated tokens")
    check(int8 == per_win, f"{int8} int8 launches, not {per_win} (encoder, cross-KV and prefill)")
    check(res.text == session.tokenizer.decode(ids), "the text is not the decode of the ids")
    print(f"[{label}] 20 s (1 window) -> {len(ids)} tokens in {res.elapsed_seconds * 1e3:.1f} ms; fused-step "
          f"launches {fused} (= tokens - 1), int8 launches {int8}; ids {ids[:4]}..., text "
          f"{res.text[:40]!r}  [{card}]")

    # Teacher-forced: the generated ids through the kernel on the session's
    # caches and through plain matmuls on the dequantized decoder.
    dense = {**params, "decoder": dequantize_pytree(params["decoder"])}
    with torch.inference_mode():
        pre = aed_family_prefill(torch, session, mod, audio20)
        p_len = 1 if name == "firered" else 3
        check(int(select_token(pre["logits0"], torch.zeros((1, 1), dtype=torch.int64, device=DEV), 0,
                               dcfg)[0]) == ids[0], "the first token differs from the session's")
        # the dense prefill takes the session's resolved prompt (Dolphin's probes)
        state = aed_family_prefill(torch, session, mod, audio20, pre.get("prompt"), dense)["state"]
        kc, vc, ck, cv = aed_family_caches(torch, pre["state"], d)
        tcv = int(pre["enc_valid"][0])
        bias = attention_bias_from_lengths(pre["enc_valid"], pre["enc"].shape[1])
        table_x = aed_adapter(torch, fs, session, mod).x_row
        worst_rel, under, same, over, flips = 0.0, 0, 0, [], 0
        for i, tok in enumerate(ids[:-1]):
            pos = p_len + i
            tk = torch.tensor([[tok]], device=DEV)
            want, state = mod._decoder_pass(dense, cfg, state, tk, pos, bias)
            want = want[:, -1]
            got, _, _ = fs.fused_aed_step(session.stacked, geom, table_x(tk, pos), kc, vc, ck, cv, pos,
                                          tc_valid=tcv)
            got = got[:, : cfg.vocab_size]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            worst_rel = max(worst_rel, err / scale)
            if err > TEACHER_TOL * scale:
                over.append(i)
            if logits_margin(want).item() > TEACHER_TOL * scale:
                flips += int(got.argmax()) != int(want.argmax())
            else:
                under += 1
            same += int(got.argmax()) == ids[i + 1]
        del state, dense
    steps = len(ids) - 1
    print(f"[{label}] teacher-forced over {steps} steps: fused vs plain matmuls on the dequantized decoder "
          f"max err {worst_rel:.3e} of max|logit| (bound {TEACHER_TOL}); {under} steps under the top-2 "
          f"margin, {flips} argmax differences above it; fused argmax = generated id at {same}/{steps}")
    check(not over, f"fused vs plain above {TEACHER_TOL} of max|logit| at steps {over[:10]}")
    check(flips == 0, f"{flips} argmax differences above the {TEACHER_TOL} top-2 margin")
    check(same == steps, f"the fused argmax is the session's id at only {same}/{steps} steps")
    with torch.inference_mode():
        buf = torch.zeros((1, p_len + dcfg.max_new_tokens + 1), dtype=torch.int64, device=DEV)
        buf[:, :p_len] = pre["prompt"] if "prompt" in pre else cfg.sos_id
        first = select_token(pre["logits0"], buf, p_len, dcfg)
        graphed = graphed_vs_eager(torch, fs, session.decoder, pre["state"]["layers"], p_len, first, buf,
                                   dcfg, tcv, label, card)
        del pre

    # Two windows: batched per-weight decode through the int8 kernel only.
    audio45 = (rng.standard_normal(45 * 16000) * 2000).astype(np.float32)
    before_q, before_f = qm.LAUNCHES, fs.LAUNCHES
    res45 = session.transcribe(audio45)
    dq = qm.LAUNCHES - before_q
    check(fs.LAUNCHES == before_f, "the 2-window run launched the fused kernel")
    check(dq > per_win and (dq - per_win) % per_step == 0,
          f"2-window run: {dq} int8 launches is not {per_win} + {per_step} per step")
    print(f"[{label}] 45 s (2 windows) -> {len(res45.token_ids)} tokens in {res45.elapsed_seconds * 1e3:.1f} ms; "
          f"int8 launches {dq} ({(dq - per_win) // per_step} per-weight steps of {per_step}), fused 0  [{card}]")
    out = {"int8": int8, "fused": fused, "steps": steps, "int8_45s": dq, **graphed}

    if name == "dolphin":  # the language forced by name through the catalog
        forced = _build_session(Path(folder), language="Forced", device=DEV)
        forced_id = DOLPHIN_CATALOG["languages"]["xx"]
        check((forced.language_id, forced.region_id) == (forced_id, -2), "--language did not resolve")
        with torch.inference_mode():
            fp = aed_family_prefill(torch, forced, mod, audio20)
        lang, region = int(fp["prompt"][0, 1]), int(fp["prompt"][0, 2])
        spans = DOLPHIN_SPANS
        check(lang == forced_id and spans["region_token_start"] <= region < spans["region_token_end"],
              f"forced prompt {fp['prompt'].tolist()}")
        check(spans["language_token_start"] <= session.last_language < spans["language_token_end"],
              f"probed language {session.last_language} outside its span")
        print(f"[{label}] language forced by name ('Forced' -> {forced_id}): prompt {fp['prompt'][0].tolist()} "
              f"(the region probed); auto: language {session.last_language}, region {session.last_region}")
        del forced, fp

    # One 30 s window's numbers.
    audio30 = (np.random.default_rng(32).standard_normal(30 * 16000) * 2000).astype(np.float32)
    with torch.inference_mode():
        a = torch.from_numpy(audio30)[None].to(DEV)
        v = torch.tensor([len(audio30)], device=DEV)
        mod.encode(params, cfg, a, v)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            mod.encode(params, cfg, a, v)
        end.record()
        torch.cuda.synchronize()
        out["encoder_ms"] = start.elapsed_time(end) / 3
        pre, t_pre = synced(torch, lambda: aed_family_prefill(torch, session, mod, audio30))
        out["prefill_ms"] = t_pre * 1e3
        # the decode loop with and without a stop test each step
        kc, vc, ck, cv = aed_family_caches(torch, pre["state"], d)
        tcv = int(pre["enc_valid"][0])
        x_row = aed_adapter(torch, fs, session, mod).x_row
        p_len = 1 if name == "firered" else 3
        n = dcfg.max_new_tokens

        def loop(sync: bool):
            tok = torch.full((1, 1), 5, device=DEV)
            for i in range(n):
                lg, _, _ = fs.fused_aed_step(session.stacked, geom, x_row(tok, p_len + i), kc, vc, ck, cv,
                                             p_len + i, tc_valid=tcv)
                tok = torch.argmax(lg[:, : cfg.vocab_size], dim=-1, keepdim=True)
                if sync:
                    bool((tok == cfg.eos_id).all())

        loop(False)
        t_sync = min(synced(torch, lambda: loop(True))[1] for _ in range(2))
        t_free = min(synced(torch, lambda: loop(False))[1] for _ in range(2))
        out["fused_ms_per_token"] = t_sync * 1e3 / n
        out["sync_share"] = (t_sync - t_free) / t_sync
        del kc, vc, ck, cv, pre
    gc.collect()  # the peak below counts what the earlier parts of the phase left alive
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qm.LAUNCHES = fs.LAUNCHES = 0
    res30 = session.transcribe(audio30)
    out.update({"rtf_30s": res30.rtf, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "window_int8": qm.LAUNCHES, "window_fused": fs.LAUNCHES,
                "window_tokens": len(res30.token_ids), "window_ms": res30.elapsed_seconds * 1e3})
    check(out["window_fused"] == len(res30.token_ids) - 1 and out["window_int8"] == per_win,
          f"30 s window launches: fused {out['window_fused']}, int8 {out['window_int8']}")
    print(f"[{label} numbers] one 30 s window: encoder ({cfg.enc_layers} layers) {out['encoder_ms']:.2f} ms, "
          f"prefill (encoder + cross-KV + {'[SOS]' if name == 'firered' else 'probes + prompt'}) "
          f"{out['prefill_ms']:.1f} ms, fused decode {out['fused_ms_per_token']:.3f} ms per token over {n} steps "
          f"(host sync {out['sync_share']:.1%} of it); session {out['window_ms']:.1f} ms for "
          f"{out['window_tokens']} tokens, RTF {out['rtf_30s']:.5f}, peak memory {out['peak_mib']:.0f} MiB; "
          f"launches: fused {out['window_fused']}, int8 {out['window_int8']}  [{card}]")
    if name == "dolphin":  # the CTC head over one 30 s window
        with torch.inference_mode():
            def ctc():
                enc, ev = mod.encode(params, cfg, a, v)
                toks, counts = mod.ctc_decode(params, cfg, enc, ev)
                return toks[0, : int(counts[0])]

            ctc()
            qm.LAUNCHES = 0
            ctc_ids, t_ctc = synced(torch, ctc)
            out["ctc_int8"] = qm.LAUNCHES
            out["ctc_rtf"] = t_ctc / 30.0
        check(out["ctc_int8"] == sum(aed_family_int8_paths()["dolphin_encoder"].values()) - 4 * cfg.dec_layers + 1,
              f"{out['ctc_int8']} int8 launches for the encoder and the CTC head")
        print(f"[{label} numbers] CTC head over one 30 s window: {t_ctc * 1e3:.1f} ms (encoder included), RTF "
              f"{out['ctc_rtf']:.5f}, {len(ctc_ids)} ids, int8 launches {out['ctc_int8']}  [{card}]")
    del session, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_aed_family_continuous(torch, np, qm, fs, fm, name: str, folder: str, card: str) -> dict:
    """[33] Continuous serving of phase 31's (FireRed) / 32's (Dolphin)
    artifact over HTTP: AED_FAMILY_REQUESTS concurrent one-window requests
    with staggered starts on 8 slots with f32 caches, every decode step
    through the multi-slot kernel and none through the batch-1 kernel; each
    request's ids bitwise equal to it alone through the batcher, and equal to
    ``session.transcribe`` or within the replay margin (a teacher-forced
    replay through the per-weight step) where they differ."""
    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.parallel.http_server import decode_audio_bytes
    from asr_tpu_torch.parallel.llm_server import start_background_continuous
    from asr_tpu_torch.runtime.audio import iter_windows

    label = f"33 {name}"
    mod, _ = aed_family(name)
    qm.set_quant_config(mm="bf16")
    session = _build_session(Path(folder), device=DEV)
    check(session.stacked is not None, "the session did not stack the q8 decoder")
    scale = np.float32(session.pcm_scale / 32768.0)
    rng = np.random.default_rng(33)
    seconds = rng.uniform(*AED_FAMILY_SECONDS, size=AED_FAMILY_REQUESTS)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16) for s in seconds]
    delays = rng.uniform(0.0, 0.2, size=len(clips))
    w = session.window_samples
    windows = sum(len(iter_windows(len(c), w, w)) for c in clips)
    check(session.aed_engine_spec().tc_max == AED_FAMILY_TC[name][0], "the engine's cross length")
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
    per_win, _ = aed_family_window_int8(name)
    check(health["ok"] and health["step_kernel"] == "fused", f"healthz: {health}")
    check(health["requests_served"] == windows, f"served {health['requests_served']} windows, not {windows}")
    check(multi == health["decode_steps"] > 0, f"{multi} multi-slot launches for {health['decode_steps']} "
          "decode steps")
    check(fused == 0, f"the batch-1 kernel was launched {fused} times")
    check(int8 == windows * per_win, f"{int8} int8 launches, not {windows} windows x {per_win}")
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
    lat = np.array([r[2] for r in results])

    # Each request alone through the same batcher: bitwise its served ids.
    bat, eot = srv.batcher, session.decode_cfg.eot_id
    with torch.inference_mode():
        for i, clip in enumerate(clips):
            samples = decode_audio_bytes(wav_bytes(clip), 16000) * scale
            alone = []
            for s0 in iter_windows(len(samples), w, w):
                pre = session.continuous_prefill(samples[s0 : s0 + w])
                slot = bat.try_submit(pre["state"], pre["p_len"], pre["logits0"], pre["tc_valid"])
                while bat.is_active(slot):
                    bat.step()
                alone += [t for t in bat.take_result(slot) if t != eot]
            check(alone == results[i][1]["token_ids"], f"request {i}: the served ids differ from the "
                  "request run alone through the batcher")
    # Against session.transcribe (the batch-1 kernel), with a replay where they differ.
    equal, replay, fam = 0, {"steps": 0, "worst_rel": 0.0, "under": 0, "same": 0}, \
        aed_adapter(torch, fs, session, mod)
    for i, clip in enumerate(clips):
        audio = clip.astype(np.float32) * scale
        got = results[i][1]["token_ids"]
        if got == [t for t in session.transcribe(audio).token_ids if t != eot]:
            equal += 1
            continue
        start = 0
        for s0 in iter_windows(len(audio), w, w):
            start += replay_window(torch, fs, fm, session, fam, audio[s0 : s0 + w], got[start:], replay,
                                   f"request {i}")
        check(start == len(got), f"request {i}: the replay consumed {start} of {len(got)} ids")
    toks = health["tokens_generated"]
    step_s = health["step_latency_avg_s"]
    agg = toks / (health["decode_steps"] * step_s) if step_s else 0.0
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    print(f"[{label} serve] {len(clips)} requests ({seconds.min():.1f}-{seconds.max():.1f} s, {SERVE_SLOTS} slots, "
          f"f32 caches, starts staggered 0-200 ms) in {wall:.2f} s; healthz {json.dumps(health)}")
    print(f"[{label} serve] launches: multi-slot {multi} (= decode_steps {health['decode_steps']}), batch-1 "
          f"{fused}, int8 {int8} ({windows} windows x {per_win}); every request's ids bitwise equal to it alone "
          f"through the batcher; equal to session.transcribe for {equal}/{len(clips)} (replayed "
          f"{replay['steps']} steps: within {replay['worst_rel']:.3e} of max|logit|, {replay['under']} under "
          f"the margin)")
    print(f"[{label} numbers] decode {toks} tokens: {agg:.0f} tokens/s over step time ({toks / wall:.0f} end to "
          f"end); average step {step_s * 1e3:.3f} ms; completion p50 {p50:.2f} s, p95 {p95:.2f} s; average "
          f"queue wait {health['queue_wait_avg_s']:.3f} s; peak memory {peak:.0f} MiB  [{card}]")
    del session, srv, bat
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": multi, "int8": int8, "tokens": toks, "agg_tok_s": agg, "e2e_tok_s": toks / wall,
            "step_ms": step_s * 1e3, "p50_s": p50, "p95_s": p95, "equal": equal, "wall_s": wall,
            "queue_wait_s": health["queue_wait_avg_s"], "peak_mib": peak}


# ── 34-36. Paraformer-large, Parakeet-TDT-0.6B and Nemotron-0.6B offline ──
OFFLINE_FAMILIES = ("paraformer", "parakeet", "nemotron")
OFFLINE_WINDOW_S = {"paraformer": 30.0, "parakeet": 24.0, "nemotron": 30.0}  # each session's window
OFFLINE_PCM = {"paraformer": 2000.0, "parakeet": 0.1, "nemotron": 0.1}  # int16 range / NeMo's [-1, 1]
OFFLINE_BENCH = (8, 8.0, 128)  # batch, seconds, max_tokens: tools/bench_matrix.py's geometry
OFFLINE_TIMED = 2  # timed forwards of each batch-8 variant (the run-time limit)
PARAFORMER_MAX_TOKENS = 256  # ParaformerSession's default
NEMOTRON_LANGUAGE = ("en", 3)  # a language profile and its prompt id, forced through --language


def offline_family(name: str):
    """(model module, full-width config) of Paraformer-large, Parakeet-TDT-0.6B or Nemotron-0.6B."""
    from asr_tpu_torch.models import nemotron, paraformer, parakeet

    mod = {"paraformer": paraformer, "parakeet": parakeet, "nemotron": nemotron}[name]
    cfg = {"paraformer": paraformer.ParaformerConfig, "parakeet": parakeet.ParakeetConfig,
           "nemotron": nemotron.NemotronConfig}[name]()
    return mod, cfg


def offline_rows(name: str, cfg, seconds: float) -> tuple[int, int]:
    """(rows of the encoder's first linear, rows of its blocks) for one
    window of ``seconds``: LFR frames (Paraformer), the 8x subsampling's
    frames (Parakeet), the causal pre-encode's frames before and after
    ``drop_extra`` (Nemotron)."""
    samples = int(seconds * cfg.sample_rate)
    if name == "paraformer":
        t = -(-cfg.fbank.num_frames(samples) // cfg.lfr_n)
        return t, t
    t = cfg.mel.num_frames(samples)
    if name == "parakeet":
        for _ in range(3):
            t = (t + 2 - 3) // 2 + 1
        return t, t
    t = (t + 2 + cfg.pre_encode_cache + 1 - 3) // 2 + 1
    for _ in range(2):
        t = (t + 2 + 1 - 3) // 2 + 1
    return t, t - cfg.drop_extra


def offline_int8_paths() -> dict:
    """The int8 kernel's calls on the three offline paths ({(M, K, N, block):
    calls}): one window of each session (Paraformer 30 s with the decoder at
    256 token rows and the cross K|V over the encoder's rows; Parakeet 24 s;
    Nemotron 30 s, its pre-encode linear before ``drop_extra``) and a batch
    of 8 x 8 s (bench_matrix's geometry, 128 token rows a window); the
    conformers' rel-pos projection at 2T - 1 rows for any batch; a greedy
    step's two joint linears at M = batch (Parakeet's head 8198 columns:
    8193 tokens and 5 durations; Nemotron's joint 8193)."""
    def add(calls, key, n):
        calls[key] = calls.get(key, 0) + n

    paths = {}
    for name in OFFLINE_FAMILIES:
        _, cfg = offline_family(name)
        for label, b, secs, tokens in (("window", 1, OFFLINE_WINDOW_S[name], PARAFORMER_MAX_TOKENS),
                                       (f"b{OFFLINE_BENCH[0]}", OFFLINE_BENCH[0], OFFLINE_BENCH[1],
                                        OFFLINE_BENCH[2])):
            r0, t = offline_rows(name, cfg, secs)
            m, calls = b * t, {}
            if name == "paraformer":
                h, f, fs, ne, nd = cfg.hidden, cfg.ffn_dim, cfg.feature_size, cfg.num_encoders, cfg.num_decoders
                md, nf = b * tokens, cfg.num_decoders + cfg.num_decoder_ffn
                add(calls, (m, fs, 3 * h, fs if fs % 128 else 128), cfg.num_encoders0)
                add(calls, (m, h, 3 * h, 128), ne)
                add(calls, (m, h, h, 128), cfg.num_encoders0 + ne)
                add(calls, (m, h, f, 128), cfg.num_encoders0 + ne)
                add(calls, (m, f, h, 128), cfg.num_encoders0 + ne)
                add(calls, (md, h, f, 128), nf)
                add(calls, (md, f, h, 128), nf)
                add(calls, (md, h, h, 128), 2 * nd)
                add(calls, (m, h, 2 * h, 128), nd)
                add(calls, (md, h, cfg.vocab_size, 128), 1)
                paths[f"paraformer_{label}"] = calls
                continue
            d, f, nl, ch = cfg.d_model, cfg.ffn_dim, cfg.num_layers, cfg.sub_channels
            freq = cfg.mel.n_mels
            for _ in range(3):
                freq = (freq + 2 + (1 if name == "nemotron" else 0) - 3) // 2 + 1
            add(calls, (b * r0, ch * freq, d, 128), 1)
            add(calls, (m, d, f, 128), 2 * nl)
            add(calls, (m, f, d, 128), 2 * nl)
            add(calls, (m, d, d, 128), 5 * nl)
            add(calls, (2 * t - 1, d, d, 128), nl)
            add(calls, (m, d, 2 * d, 128), nl)
            if name == "parakeet":
                hid, cols = cfg.dec_hidden, cfg.vocab_size + cfg.num_durations
                add(calls, (m, d, hid, 128), 1)
            else:
                hid, cols = cfg.joint_hidden, cfg.vocab_size + 1
                add(calls, (m, cfg.prompt_hidden, cfg.prompt_hidden, 128), 1)
                add(calls, (m, cfg.prompt_hidden, hid, 128), 1)
            paths[f"{name}_{label}_encoder"] = calls
            paths[f"{name}_{label}_step"] = {(b, hid, hid, 128): 1, (b, hid, cols, 128): 1}
    return paths


def offline_window_int8(name: str) -> int:
    """int8 calls of one window's forward before its greedy loop (the
    encoder; Paraformer: its whole forward)."""
    paths = offline_int8_paths()
    return sum(paths[f"{name}_window" + ("" if name == "paraformer" else "_encoder")].values())


def top2_share(logits):
    """Each row's top-2 logit margin as a share of the row's max|logit|."""
    return logits_margin(logits) / logits.abs().amax(-1).clamp(min=1e-30)


def offline_replay(torch, mod, name, params, plain, enc, valid, cfg, max_tokens: int) -> dict:
    """The greedy loop on ``params`` (the int8 kernel) with every step's
    inputs recorded, then each step's joint on ``plain`` (plain matmuls on
    the dequantized weights) from the same inputs: the largest logit gap as
    a share of max|logit|, the steps whose plain top-2 margin is above
    MARGIN and whose argmax differs from the kernel's, and the ids."""
    from asr_tpu_torch.decode.rnnt import rnnt_greedy
    from asr_tpu_torch.decode.tdt import tdt_greedy

    rec = []

    def step(token, h, c, enc_frame):
        out = mod.joint_step(params, token, h, c, enc_frame)
        rec.append((token, h, c, enc_frame, out))
        return out

    b = enc.shape[0]
    hid = cfg.dec_hidden if name == "parakeet" else cfg.pred_hidden
    h0 = torch.zeros((cfg.lstm_layers, b, hid), device=DEV)
    if name == "parakeet":
        ids, counts = tdt_greedy(step, enc, valid, h0, h0.clone(), cfg.blank_id, cfg.blank_id, cfg.durations,
                                 max_tokens, eos_id=cfg.eos_id)
    else:
        ids, counts = rnnt_greedy(step, enc, valid, h0, h0.clone(), cfg.blank_id, cfg.blank_id, max_tokens,
                                  cfg.max_symbols_per_frame)
    worst, flips, under = 0.0, 0, 0
    for token, h, c, enc_frame, out in rec:
        want = mod.joint_step(plain, token, h, c, enc_frame)
        for got_l, want_l in zip(out[:-2], want[:-2]):  # token (and duration) logits
            worst = max(worst, ((got_l - want_l).abs().max() / want_l.abs().max()).item())
            sure = top2_share(want_l) > MARGIN
            flips += int(((got_l.argmax(-1) != want_l.argmax(-1)) & sure).sum())
            under += int((~sure).sum())
    return {"ids": ids, "counts": counts, "steps": len(rec), "worst": worst, "flips": flips, "under": under}


def offline_metadata(name: str, cfg):
    """An artifact's metadata: the config, a vocab_txt tokenizer over the
    token logits' columns (Nemotron: one language profile)."""
    from asr_tpu_torch.runtime.artifact import ModelMetadata
    from asr_tpu_torch.runtime.metadata import LanguageProfile

    langs = [LanguageProfile(NEMOTRON_LANGUAGE[0], "English", prompt_token_id=NEMOTRON_LANGUAGE[1])]
    return ModelMetadata(family=name, tokenizer={"kind": "vocab_txt", "file": "tokens.txt"},
                         supported_languages=langs if name == "nemotron" else [],
                         extra={"config": dataclasses.asdict(cfg)})


def phase_offline(torch, np, qm, name: str, folder: str, card: str) -> dict:
    """[34] Paraformer-large / [35] Parakeet-TDT-0.6B / [36] Nemotron-0.6B at
    full width, random weights from a seed, q8 by ``quantize_pytree(bits=8,
    block=128)`` on the card, through an artifact folder (a vocab_txt file)
    and the command line's ``_build_session``. (a) mm=f32, one window: the
    encoder output and the logits (every greedy step's joint from the same
    inputs; Paraformer's decoder over the same fired embeddings) against
    plain matmuls on the dequantized weights within 1e-3 of max|plain|, the
    ids the plain argmax wherever its top-2 margin is above 1e-3 of
    max|logit|, and the int8 launches counted. (c) A batch of 8 x 8 s (128
    tokens a window), f32 weights and q8 in both modes: RTF; run before (b),
    so that (b)'s peak memory counts the session alone. (b) The serving
    mode (bf16): one window through ``session.transcribe`` (its int8
    launches: the main path), with the front end + encoder, the decode
    (tokens, steps, host syncs, ms a step, and with a host sync every step;
    Paraformer: predictor, the CIF scan, the decoder) timed apart, RTF and
    peak memory. Then [26 cli]: ``python
    -m asr_tpu_torch transcribe`` of a 5 s file on the artifact (Nemotron
    with ``--language``), its text the decode of ``session.transcribe``'s ids."""
    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.decode import cif, tdt
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree
    from asr_tpu_torch.runtime.artifact import save_model

    label = {"paraformer": "34 paraformer", "parakeet": "35 parakeet", "nemotron": "36 nemotron"}[name]
    mod, cfg = offline_family(name)
    t0 = time.perf_counter()
    params32 = mod.init_params(cfg, torch.Generator(device=DEV).manual_seed(34 + OFFLINE_FAMILIES.index(name)))
    q8 = quantize_pytree(params32, bits=8, block=128)
    cols = cfg.vocab_size + (1 if name == "nemotron" else 0)
    write_vocab(Path(folder) / "tokens.txt", cols)
    save_model(folder, q8, offline_metadata(name, cfg))
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del q8
    session = _build_session(Path(folder), device=DEV)
    check(type(session).__name__ == f"{name.capitalize()}Session", f"_build_session gave a {type(session).__name__}")
    params = session.params
    print(f"[{label}] q8 (config {type(cfg).__name__}() at full width): init + quantize + artifact "
          f"({size_mb:.1f} MB) round trip in {time.perf_counter() - t0:.2f} s")
    # [26 cli] the command line on this artifact, in its own process beside the mm=f32 checks
    # (a); its file is the draw that follows the window's and the batch's below
    draws = np.random.default_rng(34)
    draws.standard_normal(int(OFFLINE_WINDOW_S[name] * 16000))
    draws.standard_normal((OFFLINE_BENCH[0], int(OFFLINE_BENCH[1] * 16000)))
    wav = Path(folder) / "cli.wav"
    wav.write_bytes(wav_bytes(np.round(draws.standard_normal(5 * 16000) * 2000)))
    lang = ["--language", NEMOTRON_LANGUAGE[0]] if name == "nemotron" else []
    cli_run = start_cli("transcribe", *lang, "--model-dir", folder, str(wav))
    rng = np.random.default_rng(34)
    win = OFFLINE_WINDOW_S[name]
    audio = (rng.standard_normal(int(win * 16000)) * OFFLINE_PCM[name]).astype(np.float32)
    a = torch.from_numpy(audio).to(DEV)[None]
    v = torch.tensor([a.shape[1]], device=DEV)
    extra = (torch.tensor([session.prompt_id], device=DEV),) if name == "nemotron" else ()
    per_win = offline_window_int8(name)
    out = {}

    # (a) mm=f32: q8 against plain matmuls on the dequantized weights.
    qm.set_quant_config(mm="f32")
    plain = dequantize_pytree(params)
    with torch.inference_mode():
        mod.forward(params, cfg, a, v, *extra)  # warm-up
        before = qm.LAUNCHES
        if name == "paraformer":
            _, feats, vl = mod.frontend_features(params, cfg, a, v)
            enc = mod.encode(params, cfg, feats, vl)
            enc_n = qm.LAUNCHES - before
            enc_p = mod.encode(plain, cfg, feats, vl)
            emb, cnt = cif.cif_fire(mod.predict_alphas(params, cfg, enc, vl), enc, vl, PARAFORMER_MAX_TOKENS,
                                    cfg.tail_threshold)
            lq = mod.decode_tokens(params, cfg, emb, cnt, enc, vl)
            lp = mod.decode_tokens(plain, cfg, emb, cnt, enc, vl)
            n = int(cnt[0])
            lq, lp = lq[0, :n], lp[0, :n]
            worst = ((lq - lp).abs().max() / lp.abs().max()).item()
            sure = top2_share(lp) > MARGIN
            flips, under, steps = int(((lq.argmax(-1) != lp.argmax(-1)) & sure).sum()), int((~sure).sum()), n
            ids, counts = mod.forward(params, cfg, a, v, max_tokens=PARAFORMER_MAX_TOKENS)
            check(torch.equal(ids[0, :n], lq.argmax(-1).to(ids.dtype)) and int(counts[0]) == n,
                  "the forward's ids are not its decoder's argmax")
            launches = qm.LAUNCHES - before
            check(launches == 2 * per_win, f"{launches} int8 launches for the checked pieces and a forward, "
                  f"not 2 x {per_win}")
        else:
            enc, ev = mod.encode(params, cfg, a, v, *extra)
            enc_n = qm.LAUNCHES - before
            enc_p = mod.encode(plain, cfg, a, v, *extra)[0]
            before = qm.LAUNCHES
            rep = offline_replay(torch, mod, name, params, plain, enc, ev, cfg, 256)
            check(qm.LAUNCHES - before == 2 * rep["steps"], f"{qm.LAUNCHES - before} int8 launches for "
                  f"{rep['steps']} greedy steps, not 2 a step")
            ids, counts = mod.forward(params, cfg, a, v, *extra)
            check(torch.equal(ids, rep["ids"]) and torch.equal(counts, rep["counts"]),
                  "the forward's ids differ from the recorded loop's")
            worst, flips, under, steps, n = rep["worst"], rep["flips"], rep["under"], rep["steps"], int(counts[0])
        dec_n = 5 * cfg.num_decoders + 2 * cfg.num_decoder_ffn + 1 if name == "paraformer" else 0
        check(enc_n == per_win - dec_n,
              f"{enc_n} int8 launches for the encoder")
        enc_err = ((enc - enc_p).abs().max() / enc_p.abs().max()).item()
    check(bool(torch.isfinite(enc).all()), "non-finite encoder output")
    print(f"[{label} check] mm=f32, one {win:.0f} s window: encoder vs plain {enc_err:.3e} of max|plain| "
          f"({enc.shape[1]} rows, {enc_n} int8 launches); logits over {steps} "
          f"{'decoder rows' if name == 'paraformer' else 'greedy steps'} vs plain within {worst:.3e} of "
          f"max|logit|; {n} ids, argmax = plain's wherever the top-2 margin is above {MARGIN} ({under} rows "
          f"under it, {flips} differing above it)  [{card}]")
    check(enc_err <= 1e-3 and worst <= 1e-3, f"q8 vs plain: encoder {enc_err}, logits {worst} (bound 1e-3)")
    check(flips == 0 and n > 0, f"{flips} argmax differences above the margin, {n} ids")
    out.update({"enc_err": enc_err, "logit_err": worst, "ids": n, "check_steps": steps})
    del plain, enc_p
    gc.collect()
    torch.cuda.empty_cache()
    # the command line ran beside the checks above; the timed parts below run alone
    text_out, secs_cli = wait_cli({"26 cli": cli_run})["26 cli"]

    # (c) batch 8 x 8 s: f32 weights, q8 in both modes (before (b), whose peak counts the session alone).
    bsz, secs, tokens = OFFLINE_BENCH
    ab = torch.from_numpy((rng.standard_normal((bsz, int(secs * 16000))) * OFFLINE_PCM[name])
                          .astype(np.float32)).to(DEV)
    vb = torch.full((bsz,), ab.shape[1], device=DEV)
    eb = (torch.zeros(bsz, dtype=torch.int64, device=DEV),) if name == "nemotron" else ()
    rtf = {}
    for what, p, mm in (("f32", params32, "f32"), ("q8 mm=bf16", params, "bf16"), ("q8 mm=f32", params, "f32")):
        qm.set_quant_config(mm=mm)
        with torch.inference_mode():
            mod.forward(p, cfg, ab, vb, *eb, max_tokens=tokens)
            _, t = synced(torch, lambda: [mod.forward(p, cfg, ab, vb, *eb, max_tokens=tokens)
                                          for _ in range(OFFLINE_TIMED)])
        rtf[what] = t / (OFFLINE_TIMED * bsz * secs)
    out["rtf_b8"] = rtf
    print(f"[{label} numbers] RTF batch {bsz} x {secs:.0f} s ({tokens} tokens a window, {OFFLINE_TIMED} forwards): "
          + ", ".join(f"{k} {r:.6f}" for k, r in rtf.items()) + f"  [{card}]")
    qm.set_quant_config(mm="bf16")
    del params32, ab
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the serving mode: one window through the session, its parts timed apart.
    qm.set_quant_config(mm="bf16")
    session.transcribe(audio[:16000])  # warm-up
    with torch.inference_mode():
        if name == "paraformer":
            def front():
                _, feats, vl = mod.frontend_features(params, cfg, a, v)
                return mod.encode(params, cfg, feats, vl), vl

            (enc, vl), t_enc = synced(torch, front)
            alphas, t_pred = synced(torch, lambda: mod.predict_alphas(params, cfg, enc, vl))
            (emb, cnt), t_cif = synced(torch, lambda: cif.cif_fire(alphas, enc, vl, PARAFORMER_MAX_TOKENS,
                                                                   cfg.tail_threshold))
            _, t_dec = synced(torch, lambda: mod.decode_tokens(params, cfg, emb, cnt, enc, vl))
            out.update({"encoder_ms": t_enc * 1e3, "predictor_ms": t_pred * 1e3, "cif_ms": t_cif * 1e3,
                        "cif_steps": enc.shape[1] + 1, "decoder_ms": t_dec * 1e3, "tokens": int(cnt[0])})
        else:
            (enc, ev), t_enc = synced(torch, lambda: mod.encode(params, cfg, a, v, *extra))
            from asr_tpu_torch.decode.rnnt import rnnt_greedy

            period = tdt.SYNC_EVERY
            hid = cfg.dec_hidden if name == "parakeet" else cfg.pred_hidden
            h0 = torch.zeros((cfg.lstm_layers, 1, hid), device=DEV)
            for k, key in ((1, "_k1"), (period, "")):  # a host sync every step, then the module's period
                calls, syncs = [], tdt.SYNCS

                def step(token, h, c, enc_frame):
                    calls.append(1)
                    return mod.joint_step(params, token, h, c, enc_frame)

                if name == "parakeet":
                    run = lambda: tdt.tdt_greedy(step, enc, ev, h0, h0.clone(), cfg.blank_id, cfg.blank_id,
                                                 cfg.durations, 256, eos_id=cfg.eos_id)
                else:
                    run = lambda: rnnt_greedy(step, enc, ev, h0, h0.clone(), cfg.blank_id, cfg.blank_id, 256,
                                              cfg.max_symbols_per_frame)
                tdt.SYNC_EVERY = k
                try:
                    (_, cnt), t_dec = synced(torch, run)
                finally:
                    tdt.SYNC_EVERY = period
                out.update({f"decode_ms{key}": t_dec * 1e3, f"steps{key}": len(calls),
                            f"syncs{key}": tdt.SYNCS - syncs, f"ms_per_step{key}": t_dec * 1e3 / len(calls),
                            "tokens": int(cnt[0])})
            out["encoder_ms"] = t_enc * 1e3
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    syncs = tdt.SYNCS
    qm.LAUNCHES = 0  # the main path starts here
    res = session.transcribe(audio)
    out["int8"] = qm.LAUNCHES  # and ends here
    out.update({"rtf": res.rtf, "window_ms": res.elapsed_seconds * 1e3, "peak_mib": torch.cuda.max_memory_allocated()
                / 2**20, "window_syncs": tdt.SYNCS - syncs, "window_ids": len(res.token_ids)})
    want = per_win if name == "paraformer" else per_win + 2 * out["steps"]
    check(out["int8"] == want and res.text == session.tokenizer.decode(res.token_ids),
          f"one window launched the int8 kernel {out['int8']} times, not {want}")
    if name == "paraformer":
        print(f"[{label} numbers] one {win:.0f} s window (bf16 mode): front end + encoder {out['encoder_ms']:.2f} ms "
              f"({enc.shape[1]} LFR rows), predictor {out['predictor_ms']:.2f} ms, CIF scan "
              f"{out['cif_ms']:.2f} ms ({out['cif_steps']} sequential steps, host-launched), decoder "
              f"{out['decoder_ms']:.2f} ms ({out['tokens']} tokens); session {out['window_ms']:.1f} ms, RTF "
              f"{out['rtf']:.5f}, peak memory {out['peak_mib']:.0f} MiB; int8 launches {out['int8']}  [{card}]")
    else:
        print(f"[{label} numbers] one {win:.0f} s window (bf16 mode): front end + encoder {out['encoder_ms']:.2f} ms "
              f"({enc.shape[1]} frames); greedy decode {out['decode_ms']:.2f} ms: {out['tokens']} tokens in "
              f"{out['steps']} steps, {out['syncs']} host syncs (one every {tdt.SYNC_EVERY} steps), "
              f"{out['ms_per_step']:.3f} ms a step (syncing every step: {out['decode_ms_k1']:.2f} ms, "
              f"{out['syncs_k1']} syncs, {out['ms_per_step_k1']:.3f} ms a step); session {out['window_ms']:.1f} ms, "
              f"RTF {out['rtf']:.5f}, {out['window_syncs']} syncs, peak memory {out['peak_mib']:.0f} MiB; int8 "
              f"launches {out['int8']}  [{card}]")

    cli_session = _build_session(Path(folder), language=lang[1] if lang else None, device=DEV)
    if name == "nemotron":
        check(cli_session.prompt_id == NEMOTRON_LANGUAGE[1], f"--language gave prompt {cli_session.prompt_id}")
    ids = cli_session.transcribe(str(wav)).token_ids
    text = text_out.strip().splitlines()[1]
    check(bool(ids) and text == cli_session.tokenizer.decode(ids), f"{name}: the command line printed "
          f"{text[:80]!r}, not the decode of session.transcribe's {len(ids)} ids")
    print(f"[26 cli] {name}: transcribe {wav.name}{' --language ' + lang[1] if lang else ''}: {len(ids)} ids, "
          f"text = the tokenizer's decode of session.transcribe's ids ({secs_cli:.2f} s in a subprocess)  [{card}]")
    del session, cli_session, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


STREAM_FAMILIES = ("paraformer", "nemotron", "dolphin", "zipformer")
STREAM_ARTIFACT = {"paraformer": "paraformer_streaming", "nemotron": "nemotron_streaming",
                   "dolphin": "dolphin_streaming", "zipformer": "x_asr"}
STREAM_PHASE = {"paraformer": 37, "nemotron": 38, "dolphin": 39, "zipformer": 40}
# Dolphin's 30 s fill 736 of its 752 history frames: 32 s take the last windows past the clamp.
STREAM_SECONDS = {"paraformer": 30.0, "nemotron": 30.0, "dolphin": 32.0, "zipformer": 8.0}
STREAM_PCM = {"paraformer": 2000.0, "nemotron": 0.1, "dolphin": 2000.0, "zipformer": 2000.0}
STREAM_SLOTS = 8
STREAM_WINDOWS = 6       # windows of each slot's stream in phase 41
STREAM_RESET = (3, 4)    # phase 41: slot 3 is reset before tick 4 and restarts its stream
STREAM_TIMED_TICKS = 10  # timed ticks at N = 1 and N = 8
STREAM_K = 4             # ticks a host read in step_n (phase 41) and --ticks-per-sync (phase 42)
STREAM_SERVE_SECONDS = (4.0, 5.0)
STREAM_CHECK_WINDOWS = 32  # windows of the mm=f32 check (the run-time limit)
STREAM_F32_SECONDS = 10.0  # audio of the f32-weights session run (the run-time limit)


def stream_family(name: str):
    """(stream config, init_params(generator)) of a streaming family at full
    width: ParaformerStreamConfig(), NemotronStreamConfig(),
    DolphinStreamConfig(), ZipformerConfig()."""
    from asr_tpu_torch.models import dolphin, nemotron, paraformer, zipformer
    from asr_tpu_torch.streaming import dolphin_stream, nemotron_stream, paraformer_online

    if name == "zipformer":
        cfg = zipformer.ZipformerConfig()
        return cfg, lambda g: zipformer.init_params(cfg, g)
    mod, cfg = {"paraformer": (paraformer, paraformer_online.ParaformerStreamConfig()),
                "nemotron": (nemotron, nemotron_stream.NemotronStreamConfig()),
                "dolphin": (dolphin, dolphin_stream.DolphinStreamConfig())}[name]
    return cfg, lambda g: mod.init_params(cfg.base, g)


def stream_window(name: str, cfg) -> tuple[int, int]:
    """(window samples, advance) of a family's step."""
    if name == "paraformer":
        return cfg.chunk_samples, cfg.chunk_samples
    if name == "nemotron":
        return cfg.window_samples, cfg.window_samples
    return cfg.window_samples, cfg.advance_samples


def stream_int8_calls(name: str, cfg, n: int) -> dict:
    """The int8 kernel's calls of one chunk's step at ``n`` streams, by part:
    {"step": the encoder (Paraformer: its encoder; Zipformer: with the
    greedy search's decoder projection, one a frame), "decoder": Paraformer's
    decoder on a fire, "greedy": one Nemotron greedy step, "once": the
    position-key projection of a session or runner, "rescore": one Dolphin
    rescoring pass at M = n (the prompt pass at M = 3)} -> {(M, K, N,
    block): calls}. A linear is q8 when K N >= 65536 (``quantize_pytree``'s
    default), its block 128 where K is a multiple of 128, else K."""
    def add(calls, m, k, nn, count=1):
        if k * nn >= 1 << 16:
            key = (m, k, nn, 128 if k % 128 == 0 else k)
            calls[key] = calls.get(key, 0) + count

    parts = {"step": {}, "decoder": {}, "greedy": {}, "once": {}, "rescore": {}}
    step = parts["step"]
    if name == "paraformer":
        b = cfg.base
        h, f, m, md = b.hidden, b.ffn_dim, n * cfg.chunk_positions, n * cfg.max_fires
        add(step, m, b.feature_size, 3 * h, b.num_encoders0)
        add(step, m, h, 3 * h, b.num_encoders)
        for k, nn in ((h, h), (h, f), (f, h)):
            add(step, m, k, nn, b.num_encoders0 + b.num_encoders)
        dec = parts["decoder"]
        nf = b.num_decoders + b.num_decoder_ffn
        add(dec, md, h, f, nf)
        add(dec, md, f, h, nf)
        add(dec, md, h, h, 2 * b.num_decoders)
        add(dec, m, h, 2 * h, b.num_decoders)
        add(dec, md, h, b.vocab_size)
    elif name == "nemotron":
        b = cfg.base
        d, f, nl = b.d_model, b.ffn_dim, b.num_layers
        freq = b.mel.n_mels
        for _ in range(3):
            freq = (freq + 2 + 1 - 3) // 2 + 1
        m = n * cfg.chunk
        add(step, n * (cfg.chunk + b.drop_extra), b.sub_channels * freq, d)
        add(step, m, d, f, 2 * nl)
        add(step, m, f, d, 2 * nl)
        add(step, m, d, d, 3 * nl)
        add(step, n * cfg.kv_len, d, d, 2 * nl)
        add(step, m, d, 2 * d, nl)
        add(step, m, b.prompt_hidden, b.prompt_hidden)
        add(step, m, b.prompt_hidden, b.joint_hidden)
        add(parts["greedy"], n, b.pred_hidden, b.joint_hidden)
        add(parts["greedy"], n, b.joint_hidden, b.vocab_size + 1)
        add(parts["once"], 2 * cfg.kv_len - 1, d, d, nl)
    elif name == "dolphin":
        b = cfg.base
        d, m = b.d_model, n * cfg.chunk_frames
        sub_freq = ((b.mel.n_mels - 1) // 2 - 1) // 2
        add(step, m, d * sub_freq, d)
        add(step, m, d, b.enc_ffn, 2 * b.enc_layers)
        add(step, m, b.enc_ffn, d, 2 * b.enc_layers)
        add(step, m, d, d, 4 * b.enc_layers)
        add(step, m, d, b.cgmlp_dim, b.enc_layers)
        add(step, m, b.cgmlp_dim // 2, d, b.enc_layers)
        add(step, m, 2 * d, d, b.enc_layers)
        add(step, m, d, b.vocab_size)
        add(step, m, d, d, 2 * b.dec_layers)
        add(parts["once"], cfg.max_frames, d, d, b.enc_layers)
        res = parts["rescore"]
        add(res, n, d, d, 6 * b.dec_layers)
        add(res, n, d, b.dec_ffn, b.dec_layers)
        add(res, n, b.dec_ffn, d, b.dec_layers)
    else:
        add(step, n * cfg.chunk_size, cfg.sub_layer3 * cfg.embed_width, cfg.encoder_dim[0])
        for s in range(cfg.num_stacks):
            g = cfg.stack_geom(s)
            d, f, h, hid, m = g["dim"], g["ffn"], g["heads"], g["hidden"], n * g["seq"]
            for k, nn in ((d, 2 * h * g["qhd"] + h * g["phd"]), (d, f * 3 // 4), (f * 3 // 4, d), (d, f), (f, d),
                          (d, f * 5 // 4), (f * 5 // 4, d), (d, 3 * hid), (hid, d), (d, h * g["vhd"]),
                          (d, h * g["vhd"]), (h * g["vhd"], d), (h * g["vhd"], d), (d, 2 * d), (d, 2 * d),
                          (d, d), (d, d)):
                add(step, m, k, nn, cfg.num_encoder_layers[s])
        frames = cfg.chunk_size // cfg.output_downsampling_factor
        add(step, n * frames, cfg.output_dim, cfg.joiner_dim)
        add(step, n, cfg.decoder_dim, cfg.joiner_dim, frames)
    return parts


def stream_int8_paths() -> dict:
    """The streaming paths' int8 calls for phase 3: one chunk of each family
    at N = 1 and at the runner's 8 slots (Paraformer with its decoder,
    Nemotron with one greedy step), the once-a-session projections, and a
    Dolphin rescoring pass (the prompt at M = 3, a step at M = 1)."""
    paths = {}
    for name in STREAM_FAMILIES:
        cfg, _ = stream_family(name)
        for n in (1, STREAM_SLOTS):
            parts = stream_int8_calls(name, cfg, n)
            calls = {}
            for part in ("step", "decoder", "greedy"):
                for key, c in parts[part].items():
                    calls[key] = calls.get(key, 0) + c
            paths[f"stream_{name}_n{n}"] = calls
            if n == 1 and parts["once"]:
                paths[f"stream_{name}_once"] = parts["once"]
        if name == "dolphin":
            for m in (3, 1):
                paths[f"stream_dolphin_rescore_m{m}"] = stream_int8_calls(name, cfg, m)["rescore"]
    return paths


def stream_metadata(name: str, cfg):
    from asr_tpu_torch.runtime.artifact import ModelMetadata

    return ModelMetadata(family=STREAM_ARTIFACT[name], tokenizer={"kind": "vocab_txt", "file": "tokens.txt"},
                         extra={"config": dataclasses.asdict(cfg)})


def stream_vocab(name: str, cfg) -> int:
    return {"paraformer": lambda: cfg.base.vocab_size, "nemotron": lambda: cfg.base.vocab_size + 1,
            "dolphin": lambda: cfg.base.vocab_size, "zipformer": lambda: cfg.vocab_size}[name]()


def stream_push(name: str, session, window) -> list:
    """One window through a family's session -> the ids it emits."""
    if name in ("paraformer", "nemotron"):
        return session.push_chunk(window)
    return session.push_window(window)


def stream_audio_windows(name: str, cfg, audio) -> list:
    """The windows a session's ``transcribe`` feeds (X-ASR: after its
    snip-edges and tail pads; Paraformer: the last chunk's pad as the
    session draws it)."""
    import numpy as np

    from asr_tpu_torch.runtime.streaming_session import snip_edges_false_pad

    w, adv = stream_window(name, cfg)
    if name == "zipformer":
        fb = cfg.fbank
        audio = np.concatenate([snip_edges_false_pad(audio, fb.win_length, fb.hop_length),
                                np.zeros(int(0.3 * fb.sample_rate), np.float32)])
        starts = [p for p in range(0, len(audio) - w + 1, adv)] or [0]
    elif name == "dolphin":
        starts = [p for p in range(0, len(audio) - adv + 1, adv)] or [0]
    else:
        starts = list(range(0, len(audio), w))
    rng = np.random.default_rng(0)
    out = []
    for p in starts:
        win = np.zeros(w, np.float32)
        part = audio[p : p + w]
        win[: len(part)] = part
        if name == "paraformer" and len(part) < w:
            rms = float(np.sqrt(np.mean(np.square(part)))) if len(part) else 1.0
            win[len(part) :] = rng.standard_normal(w - len(part)) * max(rms, 1e-3)
        out.append(win)
    return out


def stream_chunk_check(torch, name: str, cfg, params, plain, ctx: dict, state, window):
    """One window on ``params`` from ``state`` (a session's N = 1 state),
    with the same inputs replayed on ``plain``: (state', ids, encoder
    output gap as a share of max|plain|, decisions [(logits, plain
    logits)]). The decisions are every argmax the step takes: Paraformer's
    decoder rows, each Nemotron greedy step's joint (run with a host read
    every step, so no step follows the stop), Dolphin's CTC frames, each
    X-ASR frame's joiner."""
    from asr_tpu_torch.decode import tdt
    from asr_tpu_torch.layers.transformer import dense
    from asr_tpu_torch.models import zipformer as zf
    from asr_tpu_torch.streaming import dolphin_stream as ds, nemotron_stream as ns, paraformer_online as po

    w = torch.from_numpy(window).to(DEV)[None]
    decisions, ids = [], []

    def gap(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    if name == "paraformer":
        st, fired, count, enc = po.encoder_step(params, cfg, state, w)
        enc_p = po.encoder_step(plain, cfg, state, w)[3]
        n = int(count[0])
        if n:
            st2, lq, _ = po.decoder_step(params, cfg, st, enc, fired, count, return_logits=True)
            lp = po.decoder_step(plain, cfg, st, enc, fired, count, return_logits=True)[1]
            decisions.append((lq[0, :n], lp[0, :n]))
            ids = lq[0, :n].argmax(-1).tolist()
            st = st2
        return st, ids, gap(enc, enc_p), decisions
    if name == "nemotron":
        pid = torch.zeros(1, dtype=torch.int64, device=DEV)
        st, enc = ns.encoder_step(params, cfg, state, w, pid, ctx["rel_k"])
        enc_p = ns.encoder_step(plain, cfg, state, w, pid, ctx["rel_k_plain"])[1]
        rec, orig, period = [], ns.joint_step, tdt.SYNC_EVERY

        def joint(p, token, h, c, frame):
            out = orig(p, token, h, c, frame)
            rec.append((token, h, c, frame, out[0]))
            return out

        ns.joint_step, tdt.SYNC_EVERY = joint, 1
        try:
            st, out, count = ns.rnnt_stream_step(params, cfg, st, enc)
        finally:
            ns.joint_step, tdt.SYNC_EVERY = orig, period
        for token, h, c, frame, lq in rec:
            decisions.append((lq, orig(plain, token, h, c, frame)[0]))
        return st, out[0, : int(count[0])].tolist(), gap(enc, enc_p), decisions
    if name == "dolphin":
        st, ctc, enc = ds.encoder_step(params, cfg, state, w, ctx["rel_k"])
        enc_p = ds.encoder_step(plain, cfg, state, w, ctx["rel_k_plain"])[2]
        decisions.append((dense(enc, params["ctc"])[0], dense(enc, plain["ctc"])[0]))
        return st, ctc[0].tolist(), gap(enc, enc_p), decisions
    st, enc = zf.encoder_step(params, cfg, state, w)
    enc_p = zf.encoder_step(plain, cfg, state, w)[1]
    joiner = zf._joiner_weight(params["joiner"]["out"]["w"])
    context = st["context"]
    for f in range(enc.shape[1]):
        lq = torch.tanh(enc[:, f] + zf.decoder_out(params, cfg, context)) @ joiner + params["joiner"]["out"]["b"]
        lp = torch.tanh(enc[:, f] + zf.decoder_out(plain, cfg, context)) @ joiner + params["joiner"]["out"]["b"]
        decisions.append((lq[0], lp[0]))
        tok = lq.argmax(-1)
        if int(tok[0]) != cfg.blank_id:
            context = torch.cat([context[:, 1:], tok[:, None]], dim=1)
    st, out, count = zf.greedy_chunk(params, cfg, st, enc)
    check(torch.equal(st["context"], context), "X-ASR greedy_chunk's context differs from the replay's")
    return st, out[0, : int(count[0])].tolist(), gap(enc, enc_p), decisions


def decision_gaps(decisions) -> tuple[float, int, int, int]:
    """(largest logit gap as a share of max|plain logit|, argmax differences
    where the plain top-2 margin is above MARGIN, decisions under it, all)."""
    worst, flips, under, total = 0.0, 0, 0, 0
    for lq, lp in decisions:
        lq, lp = lq.reshape(-1, lq.shape[-1]), lp.reshape(-1, lp.shape[-1])
        worst = max(worst, ((lq - lp).abs().max() / lp.abs().max()).item())
        sure = top2_share(lp) > MARGIN
        flips += int(((lq.argmax(-1) != lp.argmax(-1)) & sure).sum())
        under += int((~sure).sum())
        total += lq.shape[0]
    return worst, flips, under, total


def stream_ctx(torch, name: str, cfg, params) -> dict:
    """A family's once-a-session constants on ``params`` (the position keys)."""
    from asr_tpu_torch.streaming import dolphin_stream as ds, nemotron_stream as ns

    with torch.inference_mode():
        if name == "nemotron":
            return {"rel_k": ns.precompute_rel_k(params, cfg)}
        if name == "dolphin":
            return {"rel_k": ds.precompute_rel_k(params, cfg)}
    return {}


def timed_transcribe(name: str, session, audio):
    """``session.transcribe(audio)`` with each push (which ends in its host
    read of the ids) and Dolphin's final rescoring timed on the host clock
    -> (result, {per-chunk p50 / p95 / max ms, total ms, rescoring ms})."""
    import numpy as np

    times, extra = [], [0.0]
    push_name = "push_chunk" if name in ("paraformer", "nemotron") else "push_window"
    push, finalize = getattr(session, push_name), getattr(session, "finalize", None)

    def timed_push(win):
        t = time.perf_counter()
        out = push(win)
        times.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_finalize(*a):
        t = time.perf_counter()
        out = finalize(*a)
        extra[0] = (time.perf_counter() - t) * 1e3
        return out

    setattr(session, push_name, timed_push)
    if finalize is not None:
        session.finalize = timed_finalize
    try:
        res = session.transcribe(audio)
    finally:
        delattr(session, push_name)
        if finalize is not None:
            del session.finalize
    arr = np.asarray(times)
    return res, {"p50_ms": float(np.percentile(arr, 50)), "p95_ms": float(np.percentile(arr, 95)),
                 "max_ms": float(arr.max()), "total_ms": float(arr.sum()) + extra[0], "rescore_ms": extra[0],
                 "chunks": len(times)}


def phase_stream(torch, np, qm, name: str, folder: str, card: str) -> dict:
    """[37 paraformer] / [38 nemotron] / [39 dolphin] / [40 x-asr]: a
    streaming family at full width, random weights from a seed, q8 by
    ``quantize_pytree(bits=8, block=128)``, through an artifact folder and
    the command line's ``_build_session``. (a) mm=f32: the first
    STREAM_CHECK_WINDOWS windows of 30 s (Dolphin 32 s) chunk by chunk
    from the session's state, each window's encoder output
    and every decision's logits (Paraformer's decoder rows, Nemotron's
    greedy joints, Dolphin's CTC frames, X-ASR's joiner frames; Dolphin's
    rescoring decode replayed teacher-forced) against plain matmuls on the
    dequantized weights from the same inputs within 1e-3 of max|plain|, and
    every id the plain argmax wherever its top-2 margin is above MARGIN;
    the int8 calls of a chunk, recorded, equal to ``stream_int8_calls``.
    (b) The serving mode (bf16): the same audio through
    ``session.transcribe`` (the main path: its int8 launches, host syncs,
    ids), each push timed (per-chunk p50 / p95 against the chunk's
    duration, RTF, peak memory); (c) the first STREAM_F32_SECONDS with f32
    weights."""
    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.decode import tdt
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_pytree
    from asr_tpu_torch.runtime.artifact import save_model
    from asr_tpu_torch.streaming import dolphin_stream as ds, nemotron_stream as ns, paraformer_online as po

    label = f"{STREAM_PHASE[name]} {name} stream"
    cfg, init = stream_family(name)
    t0 = time.perf_counter()
    params32 = init(torch.Generator(device=DEV).manual_seed(37 + STREAM_FAMILIES.index(name)))
    q8 = quantize_pytree(params32, bits=8, block=128)
    write_vocab(Path(folder) / "tokens.txt", stream_vocab(name, cfg))
    save_model(folder, q8, stream_metadata(name, cfg))
    size_mb = (Path(folder) / "weights.safetensors").stat().st_size / 1e6
    del q8
    session = _build_session(Path(folder), device=DEV)
    want_cls = {"paraformer": "ParaformerStreamingSession", "nemotron": "NemotronStreamingSession",
                "dolphin": "DolphinStreamingSession", "zipformer": "XasrStreamingSession"}[name]
    check(type(session).__name__ == want_cls, f"_build_session gave a {type(session).__name__}")
    params = session.params
    print(f"[{label}] q8 (config {type(cfg).__name__}() at full width): init + quantize + artifact "
          f"({size_mb:.1f} MB) round trip in {time.perf_counter() - t0:.2f} s")
    secs = STREAM_SECONDS[name]
    rng = np.random.default_rng(37)
    audio = (rng.standard_normal(int(secs * 16000)) * STREAM_PCM[name]).astype(np.float32)
    windows = stream_audio_windows(name, cfg, audio)
    w, adv = stream_window(name, cfg)
    chunk_ms = adv / 16.0
    per = stream_int8_calls(name, cfg, 1)
    out = {"windows": len(windows), "chunk_ms": chunk_ms}

    # (a) mm=f32: q8 against plain matmuls on the dequantized weights, chunk by chunk.
    qm.set_quant_config(mm="f32")
    plain = dequantize_pytree(params)
    ctx = stream_ctx(torch, name, cfg, params)
    ctx.update({f"{k}_plain": v for k, v in stream_ctx(torch, name, cfg, plain).items()})
    shapes, orig_int8 = [], qm.quant_matmul_int8

    def recording(x, *a, **kw):
        shapes.append((x.shape[0], x.shape[1], a[0].shape[1], a[3]))
        return orig_int8(x, *a, **kw)

    session.reset()
    qm.quant_matmul_int8 = recording
    try:
        first_ids = stream_push(name, session, windows[0])  # one window through the session, recorded
    finally:
        qm.quant_matmul_int8 = orig_int8
    enc_worst, decisions, ids_all = 0.0, [], []
    with torch.inference_mode():
        session.reset()
        state = session.state
        for win in windows[:STREAM_CHECK_WINDOWS]:
            state, ids, enc_gap, dec = stream_chunk_check(torch, name, cfg, params, plain, ctx, state, win)
            enc_worst = max(enc_worst, enc_gap)
            decisions += dec
            ids_all.append(ids)
            check(bool(torch.isfinite(dec[0][0]).all()) if dec else True, "non-finite logits")
        if name == "dolphin":
            from asr_tpu_torch.models.dolphin import _decoder_pass
            from asr_tpu_torch.layers.attention import NEG_INF

            prompt = torch.tensor([[cfg.base.sos_id, -1, -2]], device=DEV)
            toks, counts = ds.rescore_decode(params, cfg, state, prompt, session.decode_cfg)
            n_tok = int(counts[0])
            seq = toks[:, : 3 + n_tok]
            zero = torch.zeros((), device=DEV)
            bias = torch.where(torch.arange(cfg.max_frames, device=DEV)[None] < state["valid"][:1, None], zero,
                               NEG_INF)[:, None, None, :]

            def forced(p):
                shape = (1, cfg.base.max_target_positions, cfg.base.dec_heads, cfg.base.head_dim)
                layers = tuple({"cross_k": state["cross_k"][:1, li], "cross_v": state["cross_v"][:1, li],
                                "self_k": torch.zeros(shape, device=DEV), "self_v": torch.zeros(shape, device=DEV)}
                               for li in range(cfg.base.dec_layers))
                return _decoder_pass(p, cfg.base, {"layers": layers}, seq, 0, bias)[0][0, 2 : 2 + n_tok]

            lq, lp = forced(params), forced(plain)
            off = lq.argmax(-1) != seq[0, 3 : 3 + n_tok]  # one pass against the step-by-step decode
            check(bool((top2_share(lq)[off] <= MARGIN).all()), "the teacher-forced rescoring logits' argmax "
                  "differs from a decoded id with a top-2 margin above MARGIN")
            decisions.append((lq, lp))
            out["rescored_ids"] = n_tok
    want_calls = {}
    for part in ("step",) + (("decoder",) if name == "paraformer" and first_ids else ()):
        for key, c in per[part].items():
            want_calls[key] = want_calls.get(key, 0) + c
    got_calls = {}
    for key in shapes:
        got_calls[key] = got_calls.get(key, 0) + 1
    if name == "nemotron":  # the greedy steps of the first window: two a step
        steps = sum(got_calls.get(k, 0) for k in per["greedy"]) // len(per["greedy"])
        for key in per["greedy"]:
            want_calls[key] = want_calls.get(key, 0) + steps
    check(got_calls == want_calls, f"the first window's int8 calls {sorted(got_calls.items())} differ from "
          f"stream_int8_calls' {sorted(want_calls.items())}")
    worst, flips, under, total = decision_gaps(decisions)
    n_check = min(len(windows), STREAM_CHECK_WINDOWS)
    print(f"[{label} check] mm=f32, the first {n_check} of {len(windows)} windows: encoder vs plain {enc_worst:.3e} of "
          f"max|plain|; {total} decisions' logits vs plain within {worst:.3e} of max|logit|; "
          f"{sum(len(i) for i in ids_all)} ids, argmax = plain's wherever the top-2 margin is above {MARGIN} "
          f"({under} under it, {flips} differing above it); int8 calls of a window = stream_int8_calls "
          f"({sum(want_calls.values())})  [{card}]")
    check(enc_worst <= 1e-3 and worst <= 1e-3, f"q8 vs plain: encoder {enc_worst}, logits {worst} (bound 1e-3)")
    check(flips == 0 and total > 0, f"{flips} argmax differences above the margin over {total} decisions")
    out.update({"enc_err": enc_worst, "logit_err": worst, "decisions": total})
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the serving mode: the main path, then each push timed.
    qm.set_quant_config(mm="bf16")
    session.transcribe(audio[: 2 * w])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, orig_joint = [], ns.joint_step
    passes, orig_pass = [], ds._decoder_pass
    fires, orig_dec = [], po.decoder_step
    ns.joint_step = lambda *a: steps.append(1) or orig_joint(*a)
    ds._decoder_pass = lambda *a: passes.append(1) or orig_pass(*a)
    po.decoder_step = lambda *a, **kw: fires.append(1) or orig_dec(*a, **kw)
    syncs = tdt.SYNCS
    try:
        qm.LAUNCHES = 0  # the main path starts here
        res, bf = timed_transcribe(name, session, audio)
        out["int8"] = qm.LAUNCHES  # and ends here
    finally:
        ns.joint_step, ds._decoder_pass, po.decoder_step = orig_joint, orig_pass, orig_dec
    out["syncs"] = tdt.SYNCS - syncs if name == "nemotron" else len(windows)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["ids"] = len(res.token_ids)
    fired = len(fires)
    want = (sum(per["step"].values()) * len(windows) + sum(per["decoder"].values()) * fired
            + sum(per["greedy"].values()) * len(steps)
            + (sum(stream_int8_calls(name, cfg, 1)["rescore"].values()) * len(passes)))
    check(out["int8"] == want, f"{name}: {out['int8']} int8 launches on the main path, not {want}")
    check(res.text == session.tokenizer.decode(res.token_ids), "the text is not the decode of the ids")
    kw = {"prompt_id": session.prompt_id} if name == "nemotron" else {}
    f32 = timed_transcribe(name, type(session)(params32, cfg, **kw), audio[: int(STREAM_F32_SECONDS * 16000)])[1]
    out.update({"bf16": bf, "f32": f32, "steps": len(steps), "passes": len(passes), "fired": fired})
    print(f"[{label} numbers] {secs:.0f} s, {len(windows)} chunks of {chunk_ms:.0f} ms: q8 serving mode (bf16) "
          f"per chunk p50 {bf['p50_ms']:.2f} ms, p95 {bf['p95_ms']:.2f} ms, max {bf['max_ms']:.2f} ms (chunk "
          f"{chunk_ms:.0f} ms), RTF {bf['total_ms'] / (secs * 1e3):.5f}"
          + (f", rescoring {bf['rescore_ms']:.1f} ms ({len(passes)} passes)" if name == "dolphin" else "")
          + f"; f32 weights (first {STREAM_F32_SECONDS:.0f} s) p50 {f32['p50_ms']:.2f} ms, p95 {f32['p95_ms']:.2f} "
          f"ms, RTF {f32['total_ms'] / (STREAM_F32_SECONDS * 1e3):.5f}; main path: {out['ids']} ids, int8 launches {out['int8']}"
          + (f" ({len(steps)} greedy steps)" if name == "nemotron" else "")
          + (f" ({fired} chunks fired)" if name == "paraformer" else "")
          + f", host syncs {out['syncs']}, peak memory {out['peak_mib']:.0f} MiB  [{card}]")
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    out["session"] = session
    return out


def stream_schedule(n_windows: int) -> list:
    """Phase 41's ticks: slot i starts at tick i // 2 and runs its windows
    in order; slot STREAM_RESET[0] is reset before tick STREAM_RESET[1] and
    restarts from its first window. -> per tick, per slot: a window index
    or None (inactive)."""
    ticks, pos, starts = [], [0] * STREAM_SLOTS, [i // 2 for i in range(STREAM_SLOTS)]
    t = 0
    while True:
        if t == STREAM_RESET[1]:
            pos[STREAM_RESET[0]] = 0
        row = []
        for i in range(STREAM_SLOTS):
            if t >= starts[i] and pos[i] < n_windows:
                row.append(pos[i])
                pos[i] += 1
            else:
                row.append(None)
        if all(r is None for r in row):
            return ticks
        ticks.append(row)
        t += 1


def runner_ids(name: str, outs: dict, i: int, st: dict) -> list:
    """Slot i's emitted ids of one tick (Dolphin: collapsed across ticks)."""
    if name == "dolphin":
        prev, new = st.get("last", 0), []
        for t in outs["ctc_ids"][i].tolist():
            if t != 0 and t != prev:
                new.append(t)
            prev = t
        st["last"] = prev
        return new
    return outs["ids"][i][: int(outs["count"][i])].tolist()


def make_runner(name: str, params, cfg, n: int):
    from asr_tpu_torch.streaming import multistream as ms

    return {"paraformer": ms.paraformer_multistream, "nemotron": ms.nemotron_multistream,
            "dolphin": ms.dolphin_multistream, "zipformer": ms.zipformer_multistream}[name](params, cfg, n)


def near_tie(torch, name: str, cfg, session, windows, t: int) -> float:
    """The smallest top-2 margin (a share of max|logit|) of the decisions
    the session takes at window t, alone from the start (the margin rule
    for a batched run that emits other ids there)."""
    ctx = stream_ctx(torch, name, cfg, session.params)
    ctx.update({f"{k}_plain": v for k, v in ctx.items()})
    session.reset()
    with torch.inference_mode():
        for win in windows[:t]:
            stream_push(name, session, win)
        dec = stream_chunk_check(torch, name, cfg, session.params, session.params, ctx, session.state,
                                 windows[t])[3]
    return min((top2_share(lq.reshape(-1, lq.shape[-1])).min().item() for lq, _ in dec), default=float("inf"))


STATE_TOL = 1e-3  # a slot's state against the session's before their first differing window


def state_gap(torch, states, i: int, session_state) -> float:
    """Slot i of a runner's state against a session's (N = 1) state: the
    largest float gap as a share of the leaf's max|session|; inf where an
    integer leaf (a counter, a token, a context) differs."""
    worst = 0.0
    for x, y in zip(_leaves(states), _leaves(session_state)):
        x, y = x[i], y[0]
        if not y.is_floating_point():
            if not torch.equal(x, y):
                return float("inf")
            continue
        worst = max(worst, ((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item())
    return worst


def compare_alone(torch, name: str, cfg, session, streams: list, got: list, label: str, state_before) -> int:
    """Each stream's per-window ids (``got``) against the session alone on
    the same windows. Where they differ, the margin rule: before the first
    differing window the batched slot's state (``state_before(i, t)``: a
    runner's states, slot i) must equal the session's within STATE_TOL of
    max|session| (counters exactly), so the ids part where a decision's
    top-2 margin is within rounding; the smallest margin of the window's
    decisions is printed. Returns the streams equal throughout."""
    equal = 0
    for i, (windows, ids) in enumerate(zip(streams, got)):
        session.reset()
        alone = [stream_push(name, session, win) for win in windows]
        if alone == ids:
            equal += 1
            continue
        t = next(k for k, (a, b) in enumerate(zip(alone, ids)) if a != b)
        session.reset()
        for win in windows[:t]:
            stream_push(name, session, win)
        gap = state_gap(torch, state_before(i, t), i, session.state)
        margin = near_tie(torch, name, cfg, session, windows, t)
        print(f"[{label}] stream {i}: ids differ from the session alone from window {t} of {len(windows)}; the "
              f"states before it within {gap:.3e} of max|session|; smallest top-2 margin of that window's "
              f"decisions {margin:.3e} of max|logit|")
        check(gap <= STATE_TOL, f"stream {i}: the batched state before window {t} is {gap} from the session's")
    return equal


def phase_stream_multi(torch, np, qm, name: str, run: dict, card: str) -> dict:
    """[41] A family's runner at N = 8 (mm=f32), staggered starts
    (slot i joins at tick i // 2; inactive slots ride the batch) and one
    reset: each slot's ids against its stream through the session alone
    (:func:`compare_alone`), inactive slots' state bitwise untouched,
    ``step_n`` at K = 4 the same ids as K = 1; then, in the serving mode
    (bf16), the tick latency at N = 1 and N = 8 (Dolphin: q8 and f32
    weights)."""
    session = run["session"]
    params, cfg = session.params, session.cfg
    label = f"41 {name}"
    # the ids in mm=f32: the bf16 mode rounds x, which turns f32 rounding gaps between batch
    # shapes into bf16 ulps; the tick latency below is the serving mode's
    qm.set_quant_config(mm="f32")
    w, adv = stream_window(name, cfg)
    rng = np.random.default_rng(41)
    streams = []
    for i in range(STREAM_SLOTS):
        audio = (rng.standard_normal(adv * (STREAM_WINDOWS - 1) + w) * STREAM_PCM[name]).astype(np.float32)
        streams.append([audio[k * adv : k * adv + w] for k in range(STREAM_WINDOWS)])
    ticks = stream_schedule(STREAM_WINDOWS)

    def run_ticks(k: int, stop: int | None = None):
        runner = make_runner(name, params, cfg, STREAM_SLOTS)
        got = [[] for _ in range(STREAM_SLOTS)]
        ext = [{} for _ in range(STREAM_SLOTS)]
        untouched = 0 if stop is None else 2
        qm.LAUNCHES = 0
        for t0 in range(0, len(ticks) if stop is None else stop, k):
            burst = ticks[t0 : t0 + k]
            if t0 <= STREAM_RESET[1] < t0 + k:
                check(t0 == STREAM_RESET[1], "the reset falls inside a burst")
                runner.reset(STREAM_RESET[0])
                got[STREAM_RESET[0]], ext[STREAM_RESET[0]] = [], {}
            chunks = np.zeros((len(burst), STREAM_SLOTS, w), np.float32)
            active = np.zeros((len(burst), STREAM_SLOTS), bool)
            for b, row in enumerate(burst):
                for i, pos in enumerate(row):
                    if pos is not None:
                        chunks[b, i], active[b, i] = streams[i][pos], True
            idle = [i for i in range(STREAM_SLOTS) if not active[:, i].any()]
            before = None
            if idle and untouched < 2:
                before = [[leaf[i].clone() for i in idle] for leaf in _leaves(runner.states)]
            if k == 1:
                outs = [runner.step(chunks[0], active[0])]
            else:
                stacked = runner.step_n(chunks, active)
                outs = [{kk: v[b] for kk, v in stacked.items()} for b in range(len(burst))]
            if before is not None:
                after = [[leaf[i] for i in idle] for leaf in _leaves(runner.states)]
                check(all(torch.equal(x, y) for xs, ys in zip(before, after) for x, y in zip(xs, ys)),
                      f"an inactive slot's state changed at tick {t0}")
                untouched += 1
            for b, row in enumerate(burst):
                for i, pos in enumerate(row):
                    if pos is not None:
                        got[i].append(runner_ids(name, outs[b], i, ext[i]))
        return got, qm.LAUNCHES, runner

    got1, launches, _ = run_ticks(1)
    got4, _, _ = run_ticks(STREAM_K)
    check(got4 == got1, f"step_n at K = {STREAM_K} gave other ids than K = 1")

    def state_before(i, t):  # the runner's states before the tick of slot i's (last) window t
        return run_ticks(1, stop=max(k for k, row in enumerate(ticks) if row[i] == t))[2].states

    with torch.inference_mode():
        equal = compare_alone(torch, name, cfg, session, streams, got1, label, state_before)
    out = {"bitwise_slots": equal, "ticks": len(ticks), "int8": launches}

    def tick_ms(p, n):
        runner = make_runner(name, p, cfg, n)
        chunks = np.stack([streams[i % STREAM_SLOTS][0] for i in range(n)])
        for _ in range(2):
            runner.step(chunks)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(STREAM_TIMED_TICKS):
            runner.step(chunks)
        return (time.perf_counter() - t) * 1e3 / STREAM_TIMED_TICKS

    qm.set_quant_config(mm="bf16")
    times = {n: tick_ms(params, n) for n in (1, STREAM_SLOTS)}
    out["tick_ms"] = times
    f32_txt = ""
    if name == "dolphin":
        cfg32, init = stream_family(name)
        p32 = init(torch.Generator(device=DEV).manual_seed(39))
        out["tick_ms_f32"] = {n: tick_ms(p32, n) for n in (1, STREAM_SLOTS)}
        del p32
        f32_txt = (f"; f32 weights: N=1 {out['tick_ms_f32'][1]:.2f} ms, N={STREAM_SLOTS} "
                   f"{out['tick_ms_f32'][STREAM_SLOTS]:.2f} ms (q8 / f32 at N={STREAM_SLOTS}: "
                   f"{times[STREAM_SLOTS] / out['tick_ms_f32'][STREAM_SLOTS]:.3f})")
    print(f"[{label}] runner at N={STREAM_SLOTS}: {len(ticks)} ticks, staggered starts, slot {STREAM_RESET[0]} "
          f"reset at tick {STREAM_RESET[1]}: {equal} of {STREAM_SLOTS} slots bitwise = the session alone (the "
          f"rest within the margin rule), inactive slots' state bitwise untouched, step_n K={STREAM_K} ids = K=1; "
          f"{launches} int8 launches; tick latency (q8, bf16 mode, host read included): N=1 {times[1]:.2f} ms, "
          f"N={STREAM_SLOTS} {times[STREAM_SLOTS]:.2f} ms ({times[STREAM_SLOTS] / STREAM_SLOTS:.2f} ms a stream, "
          f"{times[1] * STREAM_SLOTS / times[STREAM_SLOTS]:.2f}x the streams a second of N=1){f32_txt}  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree) -> list:
    from asr_tpu_torch.streaming.multistream import tree_map

    out = []
    tree_map(out.append, tree)
    return out


def server_windows(srv, audio) -> list:
    """The windows the stream server feeds one connection whose audio has
    all arrived: every ``advance`` from 0 while at least ``drain_min``
    samples remain of the audio and the tail pad, zero-padded to the
    window (``StreamingServer._gather_subtick``'s rule)."""
    import numpy as np

    buf = np.concatenate([audio.astype(np.float32) * srv.pcm_gain, np.zeros(srv.tail_pad, np.float32)])
    out, pos = [], 0
    while len(buf) - pos >= srv.drain_min:
        win = np.zeros(srv.chunk, np.float32)
        part = buf[pos : pos + srv.chunk]
        win[: len(part)] = part
        out.append(win)
        pos += srv.advance
    return out


def phase_stream_serve(torch, np, qm, name: str, folder: str, run: dict, card: str) -> dict:
    """[42] ``serve-stream`` through the command line (``cli.main``, in
    process, with ``serve_streams`` started in the background) on the
    family's artifact, 8 slots, ``--ticks-per-sync 4``, ``--quant-mm f32``
    (as phase 41's ids): a ninth connection
    gets 503 while 8 hold their slots; then 8 concurrent chunked-HTTP
    connections of 4-5 s each through ``stream_pcm_over_http``, each
    connection's events bitwise its windows (those the server forms)
    replayed in its slot of an 8-slot runner, and the session's ids on the
    same windows (:func:`compare_alone`); ``/healthz`` reports
    ``tick_latency_max_s`` and ``sync_latency_max_s``, the second at least
    the first."""
    import socket

    from asr_tpu_torch import cli
    from asr_tpu_torch.parallel import stream_server as sserv

    session = run["session"]
    label = f"42 {name}"
    started = {}
    orig = sserv.serve_streams

    def background(runner, chunk, host="127.0.0.1", port=0, **kw):
        started["httpd"], started["srv"], started["thread"] = sserv.start_stream_background(
            runner, chunk, host=host, port=port, **kw)

    sserv.serve_streams = background
    try:
        cli.main(["--quant-mm", "f32", "serve-stream", "--model-dir", folder, "--streams", str(STREAM_SLOTS),
                  "--ticks-per-sync", str(STREAM_K), "--port", "0"])
    finally:
        sserv.serve_streams = orig
    httpd, srv = started["httpd"], started["srv"]
    port = httpd.server_address[1]
    head = b"POST /stream HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
    out = {}
    try:
        holds = []
        for _ in range(STREAM_SLOTS):
            s = socket.create_connection(("127.0.0.1", port), timeout=60)
            s.sendall(head)
            check(s.recv(64).startswith(b"HTTP/1.1 200"), "a slot was refused")
            holds.append(s)
        ninth = socket.create_connection(("127.0.0.1", port), timeout=60)
        ninth.sendall(head)
        status = ninth.recv(64)
        ninth.close()
        check(status.startswith(b"HTTP/1.1 503"), f"the ninth connection got {status[:40]!r}, not 503")
        for s in holds:
            s.sendall(b"0\r\n\r\n")
            buf = b""
            while b"\r\n0\r\n\r\n" not in buf:
                piece = s.recv(65536)
                if not piece:
                    break
                buf += piece
            s.close()
        rng = np.random.default_rng(42)
        lengths = rng.uniform(*STREAM_SERVE_SECONDS, size=STREAM_SLOTS)
        scale = 3000.0 if name == "nemotron" else STREAM_PCM[name]  # int16 PCM on the wire
        pcms = [np.clip(np.round(rng.standard_normal(int(s * 16000)) * scale), -32768, 32767).astype(np.int16)
                for s in lengths]
        results, latency = [None] * STREAM_SLOTS, [0.0] * STREAM_SLOTS

        def client(i):
            t = time.perf_counter()
            results[i] = sserv.stream_pcm_over_http("127.0.0.1", port, pcms[i], send_chunk=6400, timeout=300)
            latency[i] = time.perf_counter() - t

        qm.LAUNCHES = 0
        threads = [threading.Thread(target=client, args=(i,)) for i in range(STREAM_SLOTS)]
        t_all = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t_all
        out["int8"] = qm.LAUNCHES
        check(not any(t.is_alive() for t in threads), "a stream did not finish")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        started["thread"].join(timeout=60)
    streams, got = [], []
    for i in range(STREAM_SLOTS):
        evs = results[i]
        check(bool(evs) and evs[-1].get("done") and not any("error" in e for e in evs), f"stream {i}: {evs[-3:]}")
        windows = server_windows(srv, pcms[i].astype(np.float32))
        check(evs[-1]["ticks"] == len(windows), f"stream {i}: {evs[-1]['ticks']} ticks for {len(windows)} windows")
        per_window = [[] for _ in windows]
        for e in evs:
            if "ids" in e:
                per_window[e["tick"] - 1] = e["ids"]  # an event's tick is its window's 1-based index
        streams.append(windows)
        got.append(per_window)
    params, cfg = session.params, session.cfg

    def replay(upto=None):
        """Every connection's windows in its own slot of a fresh 8-slot
        runner, window t at tick t (the server's batch shape: each slot's
        rows bitwise whatever the others hold); ``upto`` (slot, t) stops
        before that slot's window t."""
        runner, ids, ext = make_runner(name, params, cfg, STREAM_SLOTS), [[] for _ in streams], [{} for _ in streams]
        for t in range(max(len(w) for w in streams) if upto is None else upto[1]):
            chunks = np.zeros((STREAM_SLOTS, srv.chunk), np.float32)
            active = np.array([t < len(w) for w in streams])
            for i, w in enumerate(streams):
                if active[i]:
                    chunks[i] = w[t]
            outs = runner.step(chunks, active)
            for i in np.flatnonzero(active):
                ids[i].append(runner_ids(name, outs, i, ext[i]))
        return runner, ids

    replayed = replay()[1]
    for i in range(STREAM_SLOTS):
        check(replayed[i] == got[i], f"connection {i}: the served ids differ from its windows replayed in slot "
              f"{i} of an {STREAM_SLOTS}-slot runner")
    with torch.inference_mode():
        equal = compare_alone(torch, name, cfg, session, streams, got, label,
                              lambda i, t: replay((i, t))[0].states)
    check(health["ok"] and health["slots_active"] == 0, f"healthz {health}")
    check("sync_latency_max_s" in health and "tick_latency_max_s" in health, f"healthz {health}")
    check(health["sync_latency_max_s"] >= health["tick_latency_max_s"] > 0, f"healthz {health}")
    out.update({"equal": equal, "health": health, "wall_s": wall, "latency_s": latency})
    audio_s = float(sum(lengths))
    print(f"[{label}] serve-stream --streams {STREAM_SLOTS} --ticks-per-sync {STREAM_K}: a ninth connection "
          f"got 503; {STREAM_SLOTS} concurrent connections of {min(lengths):.1f}-{max(lengths):.1f} s "
          f"({audio_s:.1f} s of audio) in {wall:.2f} s (per connection {min(latency):.2f}-{max(latency):.2f} s), "
          f"{equal} of {STREAM_SLOTS} with the session's ids bitwise (the rest within the margin rule); "
          f"int8 launches {out['int8']}; healthz ticks {health['ticks']}, syncs {health['device_syncs']}, tick "
          f"latency avg {health['tick_latency_avg_s'] * 1e3:.2f} ms, max per subtick "
          f"{health['tick_latency_max_s'] * 1e3:.2f} ms, max per sync {health['sync_latency_max_s'] * 1e3:.2f} ms"
          f"  [{card}]")
    return out


# ── 43-44. checkpoint -> artifact -> quantized artifact on the card ────────
CLI_PLATFORM: tuple = ()  # the card; a CPU rehearsal sets ("--platform", "cpu")
SV_PLAN = {"plans": {"encoder": {"method": "q8", "algorithm": "kquant"},
                     "rest": {"method": "q8", "algorithm": "rtn"}},
           "assign": [["*encoders*", "encoder"], ["*", "rest"]]}
SV_QUANTIZED = {  # artifact -> its command line after --model-dir / --out ("PLAN": SV_PLAN's file)
    "rtn": ("quantize", "--algorithm", "rtn"),
    "kquant": ("quantize", "--algorithm", "kquant"),
    "hqq4": ("quantize", "--algorithm", "hqq", "--bits", "4", "--pack"),
    "dynamic": ("quantize", "--algorithm", "dynamic"),
    "plan": ("optimize", "--plan", "PLAN"),
    "reorder": ("quantize", "--reorder", "absmean", "--algorithm", "kquant"),
}
SV_CTC_COLUMNS = 2048  # the fits are column-independent: the head's first and last 2048 columns


def sv_sample(cfg) -> tuple:
    """One leaf of each SenseVoiceSmall shape class: (K, N) = (560, 1536),
    (512, 1536), (512, 512), (512, 2048), (2048, 512), the last tp-encoder's
    FFN, and the CTC head (512, 25055)."""
    return ("encoders0/0/qkv/w", "encoders/0/qkv/w", "encoders/0/out/w", "encoders/0/ffn/w1",
            "encoders/0/ffn/w2", f"tp_encoders/{cfg.num_tp_encoders - 1}/ffn/w1", "ctc/w")
FIT_SCALE_ULPS = 8  # a scale from f32 sums over at most 2048 rows, rounded in another order
FIT_MOVED_MAX = 1e-2  # blocks a rounding boundary moved on, as a share of a leaf's blocks


def leaf_codes(np, leaf: dict, k: int):
    """A quantized linear's codes ``q - zero`` (K, N) as int64, unpacking
    4-bit halves and 2-bit quarters; ``leaf`` holds numpy q, zero, bits,
    block, packed."""
    q = leaf["q"]
    if leaf["packed"]:
        u = q.view(np.uint8).astype(np.int64)
        width = int(leaf["bits"])
        q = np.concatenate([(u >> (width * j)) & ((1 << width) - 1) for j in range(8 // width)])
    return q.astype(np.int64) - np.repeat(leaf["zero"].astype(np.int64), int(leaf["block"]), axis=0)[:k]


def fit_gap(np, w, got: dict, want: dict, kquant: bool) -> dict:
    """Two fits of one (K, N) weight ``w`` made in two rounding orders (two
    devices, or two packages), block by block. A block is the same fit when
    its zero point is equal, its scale within FIT_SCALE_ULPS and its codes
    equal but where ``w / scale`` lies on a rounding boundary (there one
    apart). Otherwise it is counted as moved by such a boundary: a code that
    a refine step rounded the other way re-fits the least-squares scale
    (within 1e-3) and may move the zero point by one step and a few codes by
    one; or, under kquant, counted as a neighbouring pick of the grid (the
    scales' ratio that of two grid factors, within 1e-3). Any other block
    fails.
    Returns the counts."""
    from asr_tpu_torch.quant.quantize import KQUANT_FACTORS

    k, n = w.shape
    b = int(got["block"])
    cg, cw = (leaf_codes(np, x, k).reshape(k // b, b, n) for x in (got, want))
    sg, sw = got["scale"].astype(np.float32), want["scale"].astype(np.float32)
    zg, zw = got["zero"].astype(np.int64), want["zero"].astype(np.int64)
    ulps = np.abs(sg.view(np.int32).astype(np.int64) - sw.view(np.int32))
    x = w.astype(np.float64).reshape(k // b, b, n) / sg.astype(np.float64)[:, None, :]
    boundary = np.abs(np.abs(x - np.round(x)) - 0.5) <= (FIT_SCALE_ULPS + 2) * 2.0 ** -23 * (np.abs(x) + 256)
    dc = np.abs(cg - cw)
    same = (zg == zw) & (ulps <= FIT_SCALE_ULPS) & ((dc == 0) | (boundary & (dc == 1))).all(axis=1)
    ratio = sg.astype(np.float64) / sw.astype(np.float64)
    moved = ~same & (np.abs(zg - zw) <= 1) & (np.abs(ratio - 1) <= 1e-3) & (dc.max(axis=1) <= 1) & (
        (dc > 0).sum(axis=1) <= max(4, b // 16))
    grid = np.asarray(KQUANT_FACTORS, np.float64)
    pairs = (grid[:, None] / grid[None, :])[~np.eye(len(grid), dtype=bool)]
    picks = ~same & ~moved & kquant & (np.abs(ratio[..., None] / pairs - 1) <= 1e-3).any(axis=-1)
    bad = ~(same | moved | picks)
    check(not bad.any(), f"{int(bad.sum())} of {bad.size} blocks differ beyond a rounding boundary")
    return {"blocks": int(same.size), "same": int(same.sum()), "moved": int(moved.sum()), "picks": int(picks.sum())}
WHISPER_HF_DTYPE = "float16"  # the published model.safetensors
WHISPER_WINDOW_S = 30.0


def write_spm(path: Path, n: int) -> None:
    """A SentencePiece model file of ``n`` pieces (the port's decoder is pure
    Python): ``<unk>``, ``<s>``, ``</s>``, then ``▁w<i>``."""
    import struct

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7, v = v & 0x7F, v >> 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def piece(text: str, ptype: int) -> bytes:
        raw = text.encode()
        body = b"\x0a" + varint(len(raw)) + raw + b"\x15" + struct.pack("<f", 0.0) + b"\x18" + varint(ptype)
        return b"\x0a" + varint(len(body)) + body

    specials = [("<unk>", 2), ("<s>", 3), ("</s>", 3)]
    path.write_bytes(b"".join(piece(t, k) for t, k in specials)
                     + b"".join(piece(f"▁w{i}", 1) for i in range(len(specials), n)))


def funasr_state_dict(torch, params: dict, embed) -> dict:
    """The port's SenseVoice tree in FunASR ``model.pt`` names and layouts
    (torch Linear (out, in), FSMN (hidden, 1, K)), with the prompt table
    ``embed`` (16, 560)."""
    sd = {"embed.weight": embed}
    for name in ("encoders0", "encoders", "tp_encoders"):
        for i, b in enumerate(params[name]):
            p = f"encoder.{name}.{i}"
            sd.update({
                f"{p}.norm1.weight": b["norm1"]["scale"], f"{p}.norm1.bias": b["norm1"]["bias"],
                f"{p}.self_attn.linear_q_k_v.weight": b["qkv"]["w"].T,
                f"{p}.self_attn.linear_q_k_v.bias": b["qkv"]["b"],
                f"{p}.self_attn.fsmn_block.weight": b["fsmn_w"].T[:, None, :],
                f"{p}.self_attn.linear_out.weight": b["out"]["w"].T,
                f"{p}.self_attn.linear_out.bias": b["out"]["b"],
                f"{p}.norm2.weight": b["norm2"]["scale"], f"{p}.norm2.bias": b["norm2"]["bias"],
                f"{p}.feed_forward.w_1.weight": b["ffn"]["w1"].T, f"{p}.feed_forward.w_1.bias": b["ffn"]["b1"],
                f"{p}.feed_forward.w_2.weight": b["ffn"]["w2"].T, f"{p}.feed_forward.w_2.bias": b["ffn"]["b2"]})
    for name in ("after_norm", "tp_norm"):
        sd[f"encoder.{name}.weight"] = params[name]["scale"]
        sd[f"encoder.{name}.bias"] = params[name]["bias"]
    sd["ctc.ctc_lo.weight"], sd["ctc.ctc_lo.bias"] = params["ctc"]["w"].T, params["ctc"]["b"]
    return {k: v.detach().to("cpu").contiguous() for k, v in sd.items()}


def read_artifact_flat(folder) -> dict:
    """An artifact's weights, aliases expanded (numpy, host)."""
    from asr_tpu_torch.runtime.artifact import WEIGHTS_FILENAME, read_safetensors
    from asr_tpu_torch.runtime.metadata import ModelMetadata

    flat = read_safetensors(Path(folder) / WEIGHTS_FILENAME)
    for alias, canon in ModelMetadata.load(folder).extra.get("weight_aliases", {}).items():
        flat[alias] = flat[canon]
    return flat


def start_cli(*argv) -> tuple:
    """``python -m asr_tpu_torch argv`` started in its own process: (the
    process, its start time)."""
    return (subprocess.Popen([sys.executable, "-m", "asr_tpu_torch", *argv], cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True), time.perf_counter())


def wait_cli(runs: dict) -> dict:
    """{name: (stdout, seconds from its start to its exit)} of started
    command lines, each waited for in its own thread; a non-zero exit fails
    the phase."""
    from concurrent.futures import ThreadPoolExecutor

    def finish(run):
        proc, t0 = run
        o, e = proc.communicate(timeout=600)
        return o, e, proc.returncode, time.perf_counter() - t0

    with ThreadPoolExecutor(len(runs)) as pool:
        done = dict(zip(runs, pool.map(finish, runs.values())))
    for name, (_, e, rc, _) in done.items():
        check(rc == 0, f"[{name}] python -m asr_tpu_torch exited {rc}: {e[-3000:]}")
    return {name: (o, secs) for name, (o, _, _, secs) in done.items()}


def sv_refit_check(torch, np, name: str, flat: dict, built, reordered, sample: tuple) -> dict:
    """Gate (b): each sampled leaf of artifact ``name`` (quantized on the
    card by the command line) against the same fit of the built f32 weights
    made here: bitwise the card's, and, against the CPU's, the same fit in
    every block apart from blocks a rounding boundary moved on
    (:func:`fit_gap`; the two devices sum a block in different orders), at
    most FIT_MOVED_MAX of them."""
    from asr_tpu_torch.quant.quantize import quantize_linear

    counts = {"blocks": 0, "same": 0, "moved": 0, "picks": 0}
    for key in sample:
        src = reordered if name == "reorder" else built
        w = src[key]
        kw = dict(bits=8, block=128, refine_iters=2, pack=False, objective="rtn")
        if name in ("kquant", "reorder") or (name == "plan" and "encoders" in key):
            kw["objective"] = "kquant"
        elif name == "hqq4":
            kw.update(bits=4, pack=True, objective="hqq")
        elif name == "dynamic":
            kw["objective"] = "dynamic"
        card = quantize_linear(torch.from_numpy(w).to(DEV), **kw)
        stored = {f: flat[f"{key}/__quant__/{f}"] for f in ("q", "scale", "zero")}
        check(int(flat[f"{key}/__quant__/bits"]) == card.bits and int(flat[f"{key}/__quant__/block"]) == card.block
              and bool(int(flat[f"{key}/__quant__/packed"])) == card.packed
              and bool(int(flat[f"{key}/__quant__/dynamic"])) == card.dynamic,
              f"[43 {name}] {key}: the stored bits/block/packed/dynamic differ from the fit")
        check(all(np.array_equal(stored[f], getattr(card, f).cpu().numpy()) for f in stored),
              f"[43 {name}] {key}: the command line's leaf differs from the same fit on the card")
        n = w.shape[1]
        cols = ((0, min(n, SV_CTC_COLUMNS)), (max(0, n - SV_CTC_COLUMNS), n)) if key == "ctc/w" else ((0, n),)
        for c0, c1 in cols:
            wc = np.ascontiguousarray(w[:, c0:c1])
            cpu = quantize_linear(torch.from_numpy(wc), **kw)
            meta = {"bits": cpu.bits, "block": cpu.block, "packed": cpu.packed}
            gap = fit_gap(np, wc, {**{f: v[:, c0:c1] for f, v in stored.items()}, **meta},
                          {**{f: getattr(cpu, f).numpy() for f in stored}, **meta}, kw["objective"] == "kquant")
            counts = {c: counts[c] + gap[c] for c in counts}
    check(counts["moved"] + counts["picks"] <= FIT_MOVED_MAX * counts["blocks"],
          f"[43 {name}] {counts['moved'] + counts['picks']} of {counts['blocks']} blocks moved from the CPU's fit")
    return counts


DYN_TOL = 1e-5  # a dynamic product's f32 epilogue against the f64 plain route, of max|plain|


def plain_dynamic(torch, x2, leaf):
    """The dynamic route's plain version on rows ``x2`` (M, K): each row's
    int8 values as the route forms them (absmax / 127 in f32), both sides
    dequantized, one f64 matmul; and, as the witness of the bound, the same
    product without the activation quantization. Returns both (M, N) f64."""
    x2 = x2.float()
    absmax = x2.abs().amax(dim=1, keepdim=True)
    sx = torch.where(absmax > 0, absmax * (1.0 / 127.0), torch.ones_like(absmax))
    xq = torch.clamp(torch.round(x2 / sx), -127, 127)
    w = (leaf.q.double() - leaf.zero.double()) * leaf.scale.double()  # block = K: one scale row
    return (xq.double() * sx.double()) @ w, x2.double() @ w


def sv_forward_check(torch, np, qm, name: str, folder, batch, ref_logits) -> dict:
    """Gates (c) and (d) on one artifact through ``load_session``: the batch-8
    x 8 s forward in mm=f32 against plain matmuls on the dequantized weights
    within 1e-3 of max|logit|, argmax equal above the margin, the kernel
    launches a forward (int8, and int4 on the q4 artifact); a dynamic
    artifact's every product (the CTC head's logits the last) within
    DYN_TOL of the plain dynamic route on its rows, one of each width
    bitwise the CPU's on the same rows, no weight-only launch; the logit
    error against the f32 model."""
    from asr_tpu_torch.layers import transformer
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.quant.quantize import QuantizedLinear, dequantize_pytree, dynamic_quant_dense
    from asr_tpu_torch.runtime.session import load_session

    session = load_session(folder, DEV, window_seconds=WINDOW_S)
    params, cfg = session.params, session.cfg
    leaves = [v["w"] for b in params["encoders0"] + params["encoders"] + params["tp_encoders"]
              for v in (b["qkv"], b["out"])] + [b["ffn"][k] for b in params["encoders0"] + params["encoders"]
                                                 + params["tp_encoders"] for k in ("w1", "w2")] + [params["ctc"]["w"]]
    check(all(isinstance(w, QuantizedLinear) for w in leaves), f"[43 {name}] a linear is not quantized")
    packed = sum(w.packed for w in leaves)
    dyn = sum(w.dynamic for w in leaves)
    qm.set_quant_config(mm="f32")
    calls = {}  # N -> (two input rows, the leaf, their two output rows): one product of each width
    gaps = {"plain": 0.0, "calls": 0}  # every product against the plain dynamic route on its rows
    real = transformer.dynamic_quant_dense

    def recorded(x, leaf):
        y = real(x, leaf)
        n = leaf["q"].shape[1]
        x2, y2 = x.reshape(-1, x.shape[-1]), y.reshape(-1, n)
        ref, unquantized = plain_dynamic(torch, x2, leaf)
        gaps["plain"] = max(gaps["plain"], ((y2 - ref).abs().max() / ref.abs().max()).item())
        gaps.setdefault("unquantized", ((unquantized - ref).abs().max() / ref.abs().max()).item())
        gaps["calls"] += 1
        if n not in calls:
            calls[n] = (x2[:2].clone(), leaf, y2[:2].clone())
        return y

    audio, valid, lang = batch
    i8, i4 = qm.LAUNCHES, qm.LAUNCHES_INT4
    transformer.dynamic_quant_dense = recorded
    try:
        with torch.inference_mode():
            lq, vs = sv.encode_logits(params, cfg, audio, valid, lang)
    finally:
        transformer.dynamic_quant_dense = real
    n8, n4 = qm.LAUNCHES - i8, qm.LAUNCHES_INT4 - i4
    want8, want4 = len(leaves) - packed - dyn, packed
    check((n8, n4) == (want8, want4), f"[43 {name}] launches int8 {n8} int4 {n4}, not {want8} / {want4}")
    scale = lq.abs().max().item()
    err_f32 = (lq - ref_logits).abs().max().item() / ref_logits.abs().max().item()
    out = {"int8": n8, "int4": n4, "logit_err_vs_f32": err_f32}
    if dyn:
        widths = {w.q.shape[1] for w in leaves}
        check(dyn == len(leaves) and set(calls) == widths, f"[43 {name}] {dyn} of {len(leaves)} linears "
              f"dynamic, products of widths {sorted(calls)} recorded, not {sorted(widths)}")
        for x, leaf, y in calls.values():  # the same rows on the CPU: the exact f64 product
            cpu_leaf = QuantizedLinear(leaf.q.cpu(), leaf.scale.cpu(), leaf.zero.cpu(), 8, leaf.block, dynamic=True)
            check(torch.equal(dynamic_quant_dense(x.cpu(), cpu_leaf), y.cpu()),
                  f"[43 {name}] a dynamic product on the card differs from the CPU's on the same rows")
        # every product of the forward, the CTC head's logits (before the bias) the last
        check(gaps["calls"] == len(leaves) and gaps["plain"] <= DYN_TOL,
              f"[43 {name}] {gaps['calls']} dynamic products, the worst {gaps['plain']:.2e} of max|plain| off "
              f"the plain dynamic route (bound {DYN_TOL})")
        check(gaps["unquantized"] > 10 * DYN_TOL, f"[43 {name}] a product without the activation quantization "
              f"lies only {gaps['unquantized']:.2e} from the plain dynamic route: the bound cannot tell them apart")
        out.update(checked_products=len(calls), plain_gap=gaps["plain"], unquantized_gap=gaps["unquantized"])
    else:
        dense = dequantize_pytree(params)
        with torch.inference_mode():
            before = (qm.LAUNCHES, qm.LAUNCHES_INT4)
            lp, _ = sv.encode_logits(dense, cfg, audio, valid, lang)
        check((qm.LAUNCHES, qm.LAUNCHES_INT4) == before, f"[43 {name}] the plain forward launched a kernel")
        diff = (lq - lp).abs().max().item()
        check(bool(torch.isfinite(lq).all()) and diff <= 1e-3 * scale,
              f"[43 {name}] logits vs plain: {diff} > 1e-3 * {scale}")
        frames = torch.arange(lq.shape[1], device=DEV)[None, :] < vs[:, None]
        sure = frames & (logits_margin(lp) > MARGIN)
        check(bool((lq.argmax(-1) == lp.argmax(-1))[sure].all()), f"[43 {name}] argmax differs above the margin")
        out.update(max_abs_err=diff, rel_err=diff / scale, under_margin=int((frames & ~sure).sum()))
        del dense, lp
    del session, params, lq
    torch.cuda.empty_cache()
    return out


def phase_build_sensevoice(torch, np, qm, folder: str, card: str, cfg=None) -> dict:
    """[43] SenseVoiceSmall from a FunASR checkpoint folder to six quantized
    artifacts through the command line: ``build`` (host), then ``quantize
    --algorithm rtn | kquant | hqq --bits 4 --pack | dynamic``, ``optimize
    --plan`` (encoder q8 kquant, the rest q8 rtn) and ``quantize --reorder
    absmean --algorithm kquant``, each on the card in its own process, run
    together. Gates: (a) the built tree is bitwise the seeded weights under
    the FunASR layout; (b) sampled leaves against the same fit on the card
    and on the CPU (:func:`sv_refit_check`); (c, d) each
    artifact's batch-8 forward against plain matmuls and its launches; (e)
    ``transcribe`` prints the decode of the session's ids."""
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.quant.quantize import quantization_error
    from asr_tpu_torch.quant.reorder import channel_reorder_pytree
    from asr_tpu_torch.runtime.artifact import flatten_pytree, params_from_flat
    from asr_tpu_torch.runtime.session import load_session

    cfg = cfg or sv.SenseVoiceConfig()
    root = Path(folder)
    src, built = root / "SenseVoiceSmall", root / "built"
    src.mkdir()
    t0 = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(43)
    params = sv.init_params(cfg, g)
    embed = torch.randn((16, cfg.feature_size), generator=g, device=DEV) * 0.02
    sd = funasr_state_dict(torch, params, embed)
    del params
    torch.save(sd, src / "model.pt")
    rng = np.random.default_rng(43)
    neg = (rng.standard_normal(cfg.feature_size) * 3 - 8).astype(np.float32)
    istd = rng.uniform(0.2, 0.5, cfg.feature_size).astype(np.float32)
    f = cfg.feature_size
    (src / "am.mvn").write_text(
        f"<Nnet>\n<AddShift> {f} {f}\n<LearnRateCoef> 0 [ {' '.join(repr(float(v)) for v in neg)} ]\n"
        f"<Rescale> {f} {f}\n<LearnRateCoef> 0 [ {' '.join(repr(float(v)) for v in istd)} ]\n</Nnet>\n")
    write_spm(src / "chn_jpn_yue_eng_ko_spectok.bpe.model", cfg.vocab_size)
    size_gb = (src / "model.pt").stat().st_size / 1e9
    t_write = time.perf_counter() - t0
    out, t_build = run_cli("build", "--family", "sensevoice", "--checkpoint", str(src), "--out", str(built))
    check("built sensevoice artifact" in out, f"build printed {out!r}")

    # (a) the built tree against the checkpoint under the FunASR layout and the loader's folds
    flat = read_artifact_flat(built)
    scale = cfg.hidden ** 0.5
    e = sd["embed.weight"].numpy()
    want = {"cmvn_means": neg, "cmvn_istd": istd * scale,
            "language_embed": np.stack([e[tok] for _, _, _, tok in sv.LANGUAGE_PROFILES]) * scale,
            "system_embed": np.stack([e[t] for t in cfg.system_prompt_ids]) * scale,
            "ctc/w": sd["ctc.ctc_lo.weight"].numpy().T, "ctc/b": sd["ctc.ctc_lo.bias"].numpy()}
    for name in ("after_norm", "tp_norm"):
        want[f"{name}/scale"], want[f"{name}/bias"] = (sd[f"encoder.{name}.weight"].numpy(),
                                                       sd[f"encoder.{name}.bias"].numpy())
    for name, n in (("encoders0", cfg.num_encoders0), ("encoders", cfg.num_encoders),
                    ("tp_encoders", cfg.num_tp_encoders)):
        for i in range(n):
            p, k = f"encoder.{name}.{i}", f"{name}/{i}"
            g_ = lambda s: sd[f"{p}.{s}"].numpy()
            want.update({f"{k}/norm1/scale": g_("norm1.weight"), f"{k}/norm1/bias": g_("norm1.bias"),
                         f"{k}/qkv/w": g_("self_attn.linear_q_k_v.weight").T,
                         f"{k}/qkv/b": g_("self_attn.linear_q_k_v.bias"),
                         f"{k}/fsmn_w": g_("self_attn.fsmn_block.weight")[:, 0, :].T,
                         f"{k}/out/w": g_("self_attn.linear_out.weight").T,
                         f"{k}/out/b": g_("self_attn.linear_out.bias"),
                         f"{k}/norm2/scale": g_("norm2.weight"), f"{k}/norm2/bias": g_("norm2.bias"),
                         f"{k}/ffn/w1": g_("feed_forward.w_1.weight").T, f"{k}/ffn/b1": g_("feed_forward.w_1.bias"),
                         f"{k}/ffn/w2": g_("feed_forward.w_2.weight").T, f"{k}/ffn/b2": g_("feed_forward.w_2.bias")})
    check(sorted(flat) == sorted(want), f"[43 build] keys differ: {sorted(set(flat) ^ set(want))[:6]}")
    for k, v in want.items():
        v = np.ascontiguousarray(v, dtype=np.float32)
        check(flat[k].dtype == np.float32 and flat[k].shape == v.shape and flat[k].tobytes() == v.tobytes(),
              f"[43 build] {k} is not the checkpoint's tensor under the FunASR layout")
    del sd, want
    n_params = sum(v.size for v in flat.values())
    print(f"[43 build] FunASR folder: model.pt {size_gb:.3f} GB ({n_params} params) + am.mvn + a {cfg.vocab_size}-piece "
          f"SentencePiece model written in {t_write:.2f} s; python -m asr_tpu_torch build in {t_build:.2f} s "
          f"(a subprocess, host); the built tree is bitwise the checkpoint under the FunASR layout (gate a)  [{card}]")

    # the six quantized artifacts: one process each, on the card, run together
    (root / "plan.json").write_text(json.dumps(SV_PLAN))
    t0 = time.perf_counter()
    cmds = {name: [*CLI_PLATFORM, argv[0], "--model-dir", str(built), "--out", str(root / name),
                   *[a if a != "PLAN" else str(root / "plan.json") for a in argv[1:]]]
            for name, argv in SV_QUANTIZED.items()}
    done = wait_cli({name: start_cli(*argv) for name, argv in cmds.items()})
    texts = {name: done[name][0] for name in SV_QUANTIZED}
    secs = {name: done[name][1] for name in SV_QUANTIZED}
    t_all = time.perf_counter() - t0
    reorder_pairs = int(texts["reorder"].split("reordered ")[1].split()[0])
    check(reorder_pairs == cfg.num_blocks, f"[43 reorder] {reorder_pairs} FFN pairs, not {cfg.num_blocks}")
    meta_dyn = json.loads((root / "dynamic" / "metadata.json").read_text())["extra"]["quantization"]
    check(meta_dyn == {"bits": 8, "block": "per_column", "algorithm": "dynamic"}, f"dynamic metadata {meta_dyn}")
    print(f"[43 quantize] six processes at once on one card: "
          + ", ".join(f"{n} {s:.2f} s" for n, s in secs.items())
          + f" (wall {t_all:.2f} s); reorder permuted {reorder_pairs} FFN pairs  [{card}]")

    # (b) sampled leaves against the CPU's fit of the built weights
    reordered = flatten_pytree(channel_reorder_pytree(params_from_flat(flat, "cpu"), "absmean")[0])
    refit, qerr = {}, {}
    for name in SV_QUANTIZED:
        qflat = read_artifact_flat(root / name)
        refit[name] = sv_refit_check(torch, np, name, qflat, flat, reordered, sv_sample(cfg))
        src_w = reordered if name == "reorder" else flat
        qerr[name] = {key: quantization_error(torch.from_numpy(src_w[key]), {
            f: torch.from_numpy(qflat[f"{key}/__quant__/{f}"]) for f in ("q", "scale", "zero")}
            | {f: int(qflat[f"{key}/__quant__/{f}"]) for f in ("bits", "block", "packed")})
            for key in ("encoders/0/ffn/w1", "ctc/w")}
    print("[43 refit] sampled leaves (7 shape classes) bitwise the same fit on the card; against the CPU's "
          "(the CTC head in two column runs), blocks the same fit / moved on a rounding boundary / another "
          "kquant pick: " + ", ".join(f"{n} {r['same']}/{r['moved']}/{r['picks']} of {r['blocks']}"
                                     for n, r in refit.items())
          + "; quantization_error (ffn w1 / ctc): "
          + ", ".join(f"{n} {e['encoders/0/ffn/w1']:.5f}/{e['ctc/w']:.5f}" for n, e in qerr.items()))
    del reordered, flat, qflat

    # (e) runs in its own process beside (c, d): the command line's text against the session's ids
    qm.set_quant_config(mm="bf16")
    wav = root / "clip.wav"
    wav.write_bytes(wav_bytes(np.round(np.random.default_rng(44).standard_normal(6 * 16000) * 2000)))
    cli_run = start_cli(*CLI_PLATFORM, "transcribe", "--model-dir", str(root / "kquant"), str(wav))

    # (c, d) each artifact's batch-8 forward; the f32 model's logits are the yardstick
    samples = int(WINDOW_S * cfg.sample_rate)
    batch = (torch.from_numpy((rng.standard_normal((BATCH, samples)) * 2000).astype(np.float32)).to(DEV),
             torch.full((BATCH,), samples, dtype=torch.int64, device=DEV),
             torch.zeros(BATCH, dtype=torch.int64, device=DEV))
    f32_session = load_session(built, DEV, window_seconds=WINDOW_S)
    with torch.inference_mode():
        ref, _ = sv.encode_logits(f32_session.params, cfg, *batch)
    del f32_session
    fwd = {}
    for name in SV_QUANTIZED:
        fwd[name] = sv_forward_check(torch, np, qm, name, root / name, batch, ref)
        r = fwd[name]
        print(f"[43 forward] {name}: int8 {r['int8']}, int4 {r['int4']} launches a batch-{BATCH} x "
              f"{WINDOW_S:.0f} s forward; " + (f"every dynamic product within {r['plain_gap']:.3e} of max|plain| "
                                               f"of the plain dynamic route (without the activation quantization "
                                               f"{r['unquantized_gap']:.3e}), {r['checked_products']} bitwise the "
                                               f"CPU's"
                                               if "checked_products" in r else
                                               f"logits vs plain max diff {r['max_abs_err']:.3e} "
                                               f"({r['rel_err']:.3e} of max|logit|), {r['under_margin']} frames "
                                               "under the margin")
              + f"; logit error vs the f32 model {r['logit_err_vs_f32']:.4e} of max|logit|  [{card}]")
    del ref, batch

    # (e) the command line's text is the decode of the session's ids
    qm.set_quant_config(mm="bf16")
    printed, t_tr = wait_cli({"transcribe": cli_run})["transcribe"]
    session = load_session(root / "kquant", DEV)
    res = session.transcribe(str(wav))
    text = printed.strip().splitlines()[1]
    check(bool(res.token_ids) and text == session.tokenizer.decode(res.token_ids),
          f"[43 cli] printed {text[:80]!r}, not the decode of the session's {len(res.token_ids)} ids")
    print(f"[43 cli] transcribe on the kquant artifact: {len(res.token_ids)} ids, the printed text is the "
          f"SentencePiece decode of session.transcribe's ids ({t_tr:.2f} s in a subprocess)  [{card}]")
    del session
    torch.cuda.empty_cache()
    return {"int8": sum(r["int8"] for r in fwd.values()), "int4": sum(r["int4"] for r in fwd.values()),
            "build_s": t_build, "quantize_s": secs, "quantize_wall_s": t_all, "reorder_pairs": reorder_pairs,
            "quantization_error": qerr, "forward": fwd}


def whisper_hf_state_dict(torch, params: dict, dtype) -> dict:
    """The port's Whisper tree in HF ``WhisperForConditionalGeneration``
    names and layouts (Linear (out, in), Conv1d (Cout, Cin, K)), cast to
    ``dtype``."""
    def lin(p, prefix, out):
        out[f"{prefix}.weight"] = p["w"].T
        if "b" in p:
            out[f"{prefix}.bias"] = p["b"]

    def ln(p, prefix, out):
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = p["scale"], p["bias"]

    def attn(p, prefix, out):
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lin(p[ours], f"{prefix}.{hf}", out)

    sd: dict = {}
    enc, dec = params["encoder"], params["decoder"]
    for i in (1, 2):
        sd[f"model.encoder.conv{i}.weight"] = enc[f"conv{i}"]["w"].permute(2, 1, 0)
        sd[f"model.encoder.conv{i}.bias"] = enc[f"conv{i}"]["b"]
    sd["model.encoder.embed_positions.weight"] = enc["pos"]
    for i, b in enumerate(enc["blocks"]):
        p = f"model.encoder.layers.{i}"
        ln(b["ln1"], f"{p}.self_attn_layer_norm", sd)
        attn(b["attn"], f"{p}.self_attn", sd)
        ln(b["ln2"], f"{p}.final_layer_norm", sd)
        lin(b["mlp"]["fc1"], f"{p}.fc1", sd)
        lin(b["mlp"]["fc2"], f"{p}.fc2", sd)
    ln(enc["ln_post"], "model.encoder.layer_norm", sd)
    sd["model.decoder.embed_tokens.weight"] = dec["embed"]
    sd["model.decoder.embed_positions.weight"] = dec["pos"]
    for i, b in enumerate(dec["blocks"]):
        p = f"model.decoder.layers.{i}"
        ln(b["ln1"], f"{p}.self_attn_layer_norm", sd)
        attn(b["attn"], f"{p}.self_attn", sd)
        ln(b["ln_cross"], f"{p}.encoder_attn_layer_norm", sd)
        attn(b["cross"], f"{p}.encoder_attn", sd)
        ln(b["ln2"], f"{p}.final_layer_norm", sd)
        lin(b["mlp"]["fc1"], f"{p}.fc1", sd)
        lin(b["mlp"]["fc2"], f"{p}.fc2", sd)
    ln(dec["ln"], "model.decoder.layer_norm", sd)
    return {k: v.detach().to(dtype).cpu().contiguous().numpy() for k, v in sd.items()}


WHISPER_LANGS = {"en": 0, "zh": 1, "de": 2, "es": 3, "ja": 11}  # code -> index after first_language_id
WHISPER_SUPPRESS = [1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63, 90, 91, 92, 93, 359,
                    503, 522, 542, 873, 893, 902, 918, 922, 931, 1350, 1853, 1982, 2460, 2627]


def write_whisper_snapshot(torch, folder: str, cfg=None) -> dict:
    """[44, first part] An HF Whisper-Large-v3-Turbo snapshot from random
    weights (seeded): config.json, generation_config.json (suppress,
    language and task tables) and model.safetensors in F16, HF names,
    written by the port's own writer (the card has no ``transformers``).
    Returns the paths, the tables and the write's numbers."""
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.runtime.artifact import write_safetensors

    cfg = cfg or wh.WhisperConfig()
    src = Path(folder) / "whisper-large-v3-turbo"
    src.mkdir()
    t0 = time.perf_counter()
    params = wh.init_params(cfg, torch.Generator(device=DEV).manual_seed(44))
    sd = whisper_hf_state_dict(torch, params, getattr(torch, WHISPER_HF_DTYPE))
    del params
    write_safetensors(src / "model.safetensors", sd)
    n_params = sum(v.size for v in sd.values())
    del sd
    torch.cuda.empty_cache()
    (src / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "d_model": cfg.d_model, "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers, "encoder_attention_heads": cfg.num_heads,
        "decoder_attention_heads": cfg.num_heads, "encoder_ffn_dim": cfg.ffn_dim, "decoder_ffn_dim": cfg.ffn_dim,
        "num_mel_bins": cfg.n_mels, "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions, "decoder_start_token_id": cfg.sot_id,
        "eos_token_id": cfg.eot_id, "torch_dtype": WHISPER_HF_DTYPE}))
    gen = {"suppress_tokens": WHISPER_SUPPRESS, "begin_suppress_tokens": [220, cfg.eot_id],
           "lang_to_id": {f"<|{c}|>": cfg.first_language_id + i for c, i in WHISPER_LANGS.items()},
           "task_to_id": {"transcribe": cfg.transcribe_id, "translate": cfg.translate_id},
           "no_timestamps_token_id": cfg.no_timestamps_id, "no_speech_token_id": cfg.no_speech_id}
    (src / "generation_config.json").write_text(json.dumps(gen))
    return {"src": src, "built": src.parent / "built", "gen": gen, "n_params": n_params,
            "size_gb": (src / "model.safetensors").stat().st_size / 1e9, "write_s": time.perf_counter() - t0}


def phase_build_whisper(torch, np, qm, fs, snap: dict, card: str, cfg=None) -> dict:
    """[44] The snapshot of :func:`write_whisper_snapshot`, built by
    ``build`` (host), through ``quantize
    --algorithm kquant --quantize-embeddings`` to ``load_whisper_session``:
    the fused batch-1 route, ids on a 30 s window bitwise those of a session
    made in memory from the same quantization of the built tree, and the
    metadata's suppress and language tables."""
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.artifact import load_model
    from asr_tpu_torch.runtime.metadata import ModelMetadata
    from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig, load_whisper_session

    cfg = cfg or wh.WhisperConfig()
    built, q, gen = snap["built"], snap["src"].parent / "kquant", snap["gen"]
    n_params, size_gb, t_write = snap["n_params"], snap["size_gb"], snap["write_s"]
    out, t_build = run_cli("build", "--family", "whisper", "--checkpoint", str(snap["src"]), "--out", str(built))
    check("built whisper artifact" in out, f"build printed {out!r}")
    _, t_quant = run_cli(*CLI_PLATFORM, "quantize", "--model-dir", str(built), "--out", str(q),
                         "--algorithm", "kquant", "--quantize-embeddings")
    meta = ModelMetadata.load(q)
    check(meta.extra["suppress_tokens"] == gen["suppress_tokens"]
          and meta.extra["begin_suppress_tokens"] == gen["begin_suppress_tokens"],
          "[44] the suppress tables differ from generation_config.json")
    check({p.code: p.prompt_token_id for p in meta.supported_languages}
          == {c: cfg.first_language_id + i for c, i in WHISPER_LANGS.items()}, "[44] the language table differs")
    check(meta.tokenizer.get("file", "") == "", "[44] a tokenizer file was copied where none was written")
    print(f"[44 build] HF folder: model.safetensors {size_gb:.3f} GB ({n_params} params, {WHISPER_HF_DTYPE}) "
          f"written in {t_write:.2f} s; build {t_build:.2f} s (a subprocess, host), "
          f"quantize --algorithm kquant "
          f"--quantize-embeddings {t_quant:.2f} s (a subprocess, on the card); suppress and language tables "
          f"as written  [{card}]")

    qm.set_quant_config(mm="bf16")  # the serving mode: the session stacks the q8 decoder
    session = load_whisper_session(q, DEV)
    check(session.stacked is not None, "[44] the session did not stack the q8 decoder for the fused step")
    built_params, _ = load_model(built, DEV)
    dtypes = sorted({str(v.dtype) for v in built_params["encoder"]["ln_post"].values()})
    t0 = time.perf_counter()
    mem_params = quantize_pytree(built_params, objective="kquant", quantize_embeddings=True)
    t_mem = time.perf_counter() - t0
    del built_params
    mem = WhisperSession(mem_params, cfg, session_cfg=WhisperSessionConfig(
        suppress_ids=tuple(gen["suppress_tokens"]), begin_suppress_ids=tuple(gen["begin_suppress_tokens"])))
    rng = np.random.default_rng(44)
    audio = (rng.standard_normal(int(WHISPER_WINDOW_S * 16000)) * 0.1).astype(np.float32)
    session.transcribe(audio[:16000])
    torch.cuda.synchronize()
    qm.LAUNCHES = fs.LAUNCHES = 0  # the path starts here
    res = session.transcribe(audio)
    int8, fused = qm.LAUNCHES, fs.LAUNCHES  # and ends here
    ids = res.token_ids
    counts = len(ids) if len(ids) == session.scfg.max_new_tokens + 1 else len(ids) + 1  # + the EOT dropped
    check(fused > 0 and fused == counts - 1, f"[44] {fused} fused launches for {counts} generated tokens")
    want = mem.transcribe(audio)
    check(res.token_ids == want.token_ids, "[44] the artifact session's ids differ from the in-memory session's")
    print(f"[44 whisper] the built tree's plain leaves stay {dtypes} (the loader keeps the checkpoint's dtype); "
          f"a {WHISPER_WINDOW_S:.0f} s window -> {len(res.token_ids)} ids in {res.elapsed_seconds * 1e3:.1f} ms on the fused "
          f"route (fused launches {fused}, int8 {int8}), bitwise the ids of a session from the same kquant "
          f"quantization made in memory ({t_mem:.2f} s on the card)  [{card}]")
    del session, mem, mem_params
    torch.cuda.empty_cache()
    return {"int8": int8, "fused": fused, "build_s": t_build, "quantize_s": t_quant,
            "quantize_in_memory_s": t_mem, "ids": len(res.token_ids)}


# ── 45-48. parity, --profile, streaming under the profiler, BF16 on the card ──
PARITY_FIXTURES = ("en/test_sample.wav", "zh/zh-Shanghai.wav")  # the registry's two files
PARITY_SECONDS = 8.0
PARITY_ONE_FIXTURE = "whisper"  # a registry key with one fixture, en/test_sample.wav (the long decodes' cut)
PROFILE_CHUNKS = 8  # chunks of one stream in phase 47's trace (the run-time limit)
INT8_KERNEL = "int8_mma_kernel"  # the int8 kernel's name in the trace, bf16 mode
BF16_DEPTH = (2, 2)  # phase 48's tower and LLM layers (widths are the published ones)


def write_examples(root: Path) -> Path:
    """[45] A ``--examples`` folder: the registry's two fixtures as 16 kHz
    mono int16 noise from a seed, PARITY_SECONDS each."""
    import numpy as np

    rng = np.random.default_rng(45)
    for rel in PARITY_FIXTURES:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(wav_bytes(np.round(rng.standard_normal(int(PARITY_SECONDS * 16000)) * 3000)))
    return root


def add_parity_languages(folder: str) -> None:
    """[45] Give an artifact's metadata the fixtures' two languages where its
    session resolves them: Whisper's language table, Qwen3-ASR's prompt
    catalog (ids beside its ``en`` prompt's)."""
    from asr_tpu_torch.runtime.metadata import LanguageProfile, ModelMetadata

    meta = ModelMetadata.load(folder)
    if meta.family == "whisper":
        first = meta.extra["config"]["first_language_id"]
        meta.supported_languages = [LanguageProfile(c, c, prompt_token_id=first + WHISPER_LANGS[c])
                                    for c in ("en", "zh")]
    elif meta.family == "qwen_asr":
        catalog = meta.extra["language_prompt_ids"]
        catalog.setdefault("zh", [i + 2 for i in catalog["en"]])
    meta.save(folder)


def run_main(*argv) -> tuple[int, str, float]:
    """``cli.main(argv)`` in this process: (its code, its stdout, seconds)."""
    import contextlib

    from asr_tpu_torch import cli

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue(), time.perf_counter() - t


def phase_parity(torch, np, qm, fs, fd, name: str, folder: str, examples: Path, card: str,
                 family: str | None = None, cpu_golden=None) -> dict:
    """[45 <name>] ``parity`` through ``cli.main`` on an artifact folder with
    ``--examples``: ``--save-golden`` gives rc 0 and a probe for every
    fixture; ``--golden`` on that file gives rc 0 (the card run repeats
    itself); a golden whose encoder snapshot (SenseVoice: its logits; its
    CTC runs in one graph) has its head moved gives rc 1 naming that stage;
    the matmul mode comes back after each run. ``cpu_golden``: (the started
    ``--platform cpu`` capture, its golden file), compared on the card: the
    probes within ``compare_probes``' defaults and the ids equal."""
    golden = Path(folder) / "parity_golden.json"
    base = ["parity", "--model-dir", folder, "--examples", examples] + (["--family", family] if family else [])
    qm.set_quant_config(mm="bf16")  # the serving mode, which parity must give back
    qm.LAUNCHES = qm.LAUNCHES_INT4 = fs.LAUNCHES = fd.LAUNCHES = 0  # the path starts here
    rc, out, t_save = run_main(*base, "--save-golden", golden)
    check(rc == 0 and f"goldens captured -> {golden}" in out, f"[45 {name}] --save-golden gave {rc}: {out[-500:]}")
    check(qm._CONFIG["mm"] == "bf16", f"[45 {name}] parity left the matmul mode at {qm._CONFIG['mm']}")
    fixtures = json.loads(golden.read_text())["fixtures"]
    for fx, g in fixtures.items():
        check("probe" in g and all(np.isfinite([s["mean"], s["std"], *s["head"]]).all() for s in g["probe"].values()),
              f"[45 {name}] {fx}: no probe or a non-finite snapshot")
    rc, out, t_cmp = run_main(*base, "--golden", golden)
    check(rc == 0 and f"PARITY OK: {len(fixtures)} fixtures" in out,
          f"[45 {name}] the card run does not repeat itself: rc {rc}: {out[-800:]}")
    fx = sorted(fixtures)[-1]
    stage = "encoder" if "encoder" in fixtures[fx]["probe"] else "logits"
    snap = fixtures[fx]["probe"][stage]
    snap["head"][0] += 10.0 * (abs(snap["mean"]) + snap["std"]) + 1.0
    moved = Path(folder) / "parity_moved.json"
    moved.write_text(json.dumps({"golden_schema": 2, "fixtures": fixtures}))
    rc, out, t_moved = run_main(*base, "--golden", moved)
    check(rc == 1 and f"{fx}: first drift at stage '{stage}'" in out,
          f"[45 {name}] a moved {stage} head gave rc {rc}: {out[-800:]}")
    counts = {"int8": qm.LAUNCHES, "int4": qm.LAUNCHES_INT4, "fused_aed": fs.LAUNCHES,
              "fused_decode": fd.LAUNCHES}  # and ends here
    check(qm._CONFIG["mm"] == "bf16", f"[45 {name}] parity left the matmul mode at {qm._CONFIG['mm']}")
    check(counts["int8"] + counts["int4"] > 0, f"[45 {name}] parity launched no quantized kernel: {counts}")
    ids = {f: len(g["token_ids"]) for f, g in fixtures.items()}
    print(f"[45 {name} parity] {len(fixtures)} fixtures ({ids} ids): --save-golden {t_save:.2f} s, --golden on "
          f"the same file rc 0 in {t_cmp:.2f} s, a moved {stage} head rc 1 naming '{stage}' in {t_moved:.2f} s; "
          f"launches over the three runs {counts}  [{card}]")
    out_d = {"counts": counts, "save_s": t_save, "golden_s": t_cmp, "fixtures": len(fixtures)}
    if cpu_golden is not None:
        run, cpu_path = cpu_golden
        (_, cpu_s), = wait_cli({"cpu parity": run}).values()
        rc, out, t_cpu = run_main(*base, "--golden", cpu_path)
        if rc != 0:
            print(f"[45 {name} parity] the CPU golden on the card: {out.strip()[-1500:]}")
            from asr_tpu_torch.models import sensevoice as sv
            from asr_tpu_torch.runtime.audio import load_audio
            from asr_tpu_torch.runtime.session import load_session

            session = load_session(folder, DEV)
            for fxp in sorted(fixtures):
                audio = torch.from_numpy(load_audio(examples / next(r for r in PARITY_FIXTURES if r.endswith(fxp)),
                                                    16000))[: session.window_samples].to(DEV)[None]
                with torch.inference_mode():
                    logits, vs = sv.encode_logits(session.params, session.cfg, audio,
                                                  torch.tensor([audio.shape[1]], device=DEV),
                                                  torch.zeros(1, dtype=torch.int64, device=DEV))
                gap = (logits_margin(logits[0, : int(vs[0])]).min() / logits.abs().max()).item()
                print(f"[45 {name} parity] {fxp}: smallest top-2 logit gap {gap:.3e} of max|logit|")
        check(rc == 0, f"[45 {name}] the CPU's golden (the plain versions) drifts on the card")
        print(f"[45 {name} parity] a golden captured by `--platform cpu parity` (the plain versions, {cpu_s:.1f} s "
              f"in a subprocess) holds on the card: probes within compare_probes' defaults (rtol 2e-3, atol 1e-4 "
              f"of scale), ids equal ({t_cpu:.2f} s)  [{card}]")
        out_d["cpu_s"] = cpu_s
    return out_d


def phase_profile(torch, np, qm, folder: str, examples: Path, card: str) -> dict:
    """[46] ``transcribe --profile LOGDIR`` through ``cli.main`` on phase 4's
    SenseVoiceSmall q8 folder, one 8 s file (one window, one forward) in the
    serving mode: the Chrome trace exists, holds CUDA kernel events, and
    counts the int8 kernel LINEARS_PER_FORWARD times, as its launch counter
    does."""
    from asr_tpu_torch.runtime.profiling import device_summary

    logdir = Path(folder) / "profile"
    wav = examples / PARITY_FIXTURES[0]
    qm.LAUNCHES = 0  # the path starts here
    rc, out, secs = run_main("--quant-mm", "bf16", "transcribe", "--model-dir", folder, "--profile", logdir, wav)
    launches = qm.LAUNCHES  # and ends here
    traces = sorted(logdir.glob("*.pt.trace.json"))
    check(rc == 0 and len(traces) == 1 and f"trace written to {traces[0]}" in out,
          f"[46] transcribe --profile gave rc {rc}, traces {traces}: {out[-500:]}")
    s = device_summary(traces[0], INT8_KERNEL)
    kernels = s["kernels"]
    check(launches == LINEARS_PER_FORWARD and s["launches"] == launches,
          f"[46] the trace holds {s['launches']} int8 kernels, the counter {launches}, a forward "
          f"{LINEARS_PER_FORWARD}")
    print(f"[46 profile] transcribe --profile: {traces[0].name} ({traces[0].stat().st_size / 1e6:.1f} MB) holds "
          f"{kernels} CUDA kernel events, {s['launches']} of them the int8 kernel ({INT8_KERNEL}: one "
          f"forward's {LINEARS_PER_FORWARD}); device busy {s['busy_us'] / 1e3:.2f} ms of a {s['window_us'] / 1e3:.2f} "
          f"ms traced window (idle share {s['idle_share']:.3f}); {secs:.2f} s with the session build  [{card}]")
    return {"int8": launches, **s}


def phase_stream_profile(torch, np, qm, name: str, session, card: str) -> dict:
    """[47 <name>] PROFILE_CHUNKS chunks of one stream through a streaming
    session in the serving mode under ``runtime/profiling.trace``: kernel
    launches a chunk, device busy time a chunk (the union of the device
    events' intervals), the device's idle share of the traced window, the
    int8 kernel's launches (the trace's against the counter's: the profiler
    may drop a record, at most one in a hundred), beside the chunk p50 on
    the host clock, traced and untraced."""
    from asr_tpu_torch.runtime.profiling import annotate, device_summary, trace

    cfg = session.cfg
    w, adv = stream_window(name, cfg)
    rng = np.random.default_rng(47)
    audio = (rng.standard_normal(adv * (PROFILE_CHUNKS + 4) + w) * STREAM_PCM[name]).astype(np.float32)
    windows = stream_audio_windows(name, cfg, audio)[:PROFILE_CHUNKS]
    check(len(windows) == PROFILE_CHUNKS, f"[47 {name}] {len(windows)} windows")
    qm.set_quant_config(mm="bf16")

    def pushes() -> list:
        session.reset()
        times = []
        for i, win in enumerate(windows):
            t = time.perf_counter()
            with annotate(f"chunk {i}"):  # a named range in the trace
                stream_push(name, session, win)  # ends in its host read of the ids
            times.append((time.perf_counter() - t) * 1e3)
        return times

    untraced = pushes()  # also the warm-up
    with tempfile.TemporaryDirectory() as logdir:
        qm.LAUNCHES = 0  # the path starts here
        with trace(logdir, cuda=True) as tr:
            traced = pushes()
        int8 = qm.LAUNCHES  # and ends here
        s = device_summary(tr.path, INT8_KERNEL)
        allk = s["kernels"]
    lost = int8 - s["launches"]
    # the profiler drops a record now and then (0-2 of 2336-5168 int8 kernels in the runs that found
    # it): at most one in a hundred, never one too many
    check(int8 > 0 and 0 <= lost <= int8 // 100, f"[47 {name}] the trace holds {s['launches']} int8 kernels, "
          f"the counter {int8}")
    n = PROFILE_CHUNKS
    out = {"launches_per_chunk": allk / n, "int8_per_chunk": int8 / n, "int8_lost": lost,
           "busy_ms_per_chunk": s["busy_us"] / 1e3 / n,
           "idle_share": s["idle_share"], "p50_ms_traced": float(np.percentile(traced, 50)),
           "p50_ms": float(np.percentile(untraced, 50)), "chunk_ms": adv / 16.0, "int8": int8}
    print(f"[47 {name} stream profile] {n} chunks of {out['chunk_ms']:.0f} ms, one stream, serving mode: "
          f"{out['launches_per_chunk']:.1f} kernel launches a chunk ({out['int8_per_chunk']:.1f} int8; the trace "
          f"holds {int8 - lost} of the counter's {int8}), device "
          f"busy {out['busy_ms_per_chunk']:.3f} ms a chunk, idle share {out['idle_share']:.3f} of the traced window; "
          f"chunk p50 on the host {out['p50_ms']:.2f} ms ({out['p50_ms_traced']:.2f} ms traced)  [{card}]")
    return out


def qwen_asr_hf_state_dict(tower: dict, llm: dict) -> dict:
    """A Qwen3-ASR tree (the port's layout) -> the HF snapshot's tensors
    (``thinker.audio_tower.*`` and ``thinker.model.*``, torch layouts), the
    inverse of ``loaders/qwen_asr_hf`` and ``loaders/qwen3_hf``."""
    sd = {}

    def lin(key, p):
        sd[f"{key}.weight"] = p["w"].T
        if "b" in p:
            sd[f"{key}.bias"] = p["b"]

    def ln(key, p):
        sd[f"{key}.weight"] = p["scale"]
        if "bias" in p:
            sd[f"{key}.bias"] = p["bias"]

    a = "thinker.audio_tower."
    for i in (1, 2, 3):
        sd[f"{a}conv2d{i}.weight"] = tower[f"conv{i}"]["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        sd[f"{a}conv2d{i}.bias"] = tower[f"conv{i}"]["b"]
    lin(f"{a}conv_out", tower["conv_out"])
    for i, b in enumerate(tower["blocks"]):
        p = f"{a}layers.{i}."
        ln(p + "self_attn_layer_norm", b["ln1"])
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lin(p + "self_attn." + theirs, b["attn"][ours])
        ln(p + "final_layer_norm", b["ln2"])
        lin(p + "fc1", b["mlp"]["fc1"])
        lin(p + "fc2", b["mlp"]["fc2"])
    ln(f"{a}ln_post", tower["ln_post"])
    lin(f"{a}proj1", tower["proj1"])
    lin(f"{a}proj2", tower["proj2"])
    m = "thinker.model."
    sd[f"{m}embed_tokens.weight"] = llm["embed"]
    for i, lay in enumerate(llm["layers"]):
        p = f"{m}layers.{i}."
        ln(p + "input_layernorm", lay["input_norm"])
        for k in ("q", "k", "v", "o"):
            lin(f"{p}self_attn.{k}_proj", lay["attn"][k])
        for k in ("q_norm", "k_norm"):
            if k in lay["attn"]:
                ln(f"{p}self_attn.{k}", lay["attn"][k])
        ln(p + "post_attention_layernorm", lay["post_norm"])
        for k in ("gate", "up", "down"):
            lin(f"{p}mlp.{k}_proj", lay["mlp"][k])
    ln(f"{m}norm", llm["final_norm"])
    return {k: v.contiguous() for k, v in sd.items()}


def phase_bf16(torch, np, folder: str, card: str, cfg=None) -> dict:
    """[48] A synthetic BF16 Qwen3-ASR HF snapshot at the published widths
    and BF16_DEPTH layers (random weights from a seed, written by the port's
    safetensors writer), through ``build --family qwen_asr`` on the host:
    the artifact loads on the card with every leaf bitwise the snapshot's in
    the loaders' layout (bf16, as the JAX package keeps it); one window
    transcribes through ``_build_session`` with the serving cast
    ``float32`` (an exact widening: neither package's tower convolves bf16
    weights with f32 features) and its stage probes are finite; ``optimize``
    with a ``bf16`` plan writes an artifact whose leaves reload bitwise."""
    import dataclasses as dc

    from asr_tpu_torch.cli import _build_session
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import qwen_asr as qa
    from asr_tpu_torch.runtime.artifact import flatten_pytree, load_model, tensor_to_numpy, write_safetensors
    from asr_tpu_torch.runtime.probe import capture_probe

    cfg = cfg or qa.QwenAsrConfig()
    cfg = dc.replace(cfg, tower_layers=BF16_DEPTH[0], llm=dc.replace(cfg.llm, num_layers=BF16_DEPTH[1]))
    lc = cfg.llm
    g = torch.Generator(device=DEV).manual_seed(48)
    tower = qa.init_tower_params(cfg, g, DEV, torch.bfloat16)
    llm = qwen3.init_params(lc, g, DEV, torch.bfloat16)
    src, art, opt = Path(folder) / "snapshot", Path(folder) / "built", Path(folder) / "bf16_plan"
    src.mkdir()
    t0 = time.perf_counter()
    sd = qwen_asr_hf_state_dict(tower, llm)
    write_safetensors(src / "model.safetensors", {k: tensor_to_numpy(v) for k, v in sd.items()})
    hf_text = {"vocab_size": lc.vocab_size, "hidden_size": lc.hidden, "intermediate_size": lc.ffn_dim,
               "num_hidden_layers": lc.num_layers, "num_attention_heads": lc.num_heads,
               "num_key_value_heads": lc.num_kv_heads, "head_dim": lc.head_dim, "rope_theta": lc.rope_theta,
               "rms_norm_eps": lc.rms_eps, "tie_word_embeddings": lc.tie_embeddings}
    (src / "config.json").write_text(json.dumps({"thinker_config": {"audio_config": {
        "num_mel_bins": cfg.n_mels, "d_model": cfg.tower_dim, "encoder_layers": cfg.tower_layers,
        "encoder_attention_heads": cfg.tower_heads, "encoder_ffn_dim": cfg.tower_ffn,
        "downsample_hidden_size": cfg.downsample_hidden, "n_window": cfg.chunk_frames // 2,
        "n_window_infer": cfg.chunk_frames * cfg.chunks_per_window, "output_dim": cfg.output_dim},
        "text_config": hf_text}}))
    size_gb = (src / "model.safetensors").stat().st_size / 1e9
    t_write = time.perf_counter() - t0
    del sd
    rc, out, t_build = run_main("build", "--family", "qwen_asr", "--checkpoint", src, "--out", art)
    check(rc == 0 and "built qwen_asr artifact" in out, f"[48] build gave rc {rc}: {out[-500:]}")
    want = flatten_pytree({"tower": tower, "llm": llm})
    check({str(v.dtype) for v in want.values()} == {"|V2"}, "[48] the generated tree is not all bf16")

    def same_leaves(folder_, what):
        params, _ = load_model(folder_, DEV)
        leaf = params["llm"]["embed"]
        check(leaf.device.type == torch.device(DEV).type and leaf.dtype == torch.bfloat16, f"[48] {what}: embed is {leaf.dtype}")
        got = flatten_pytree(params)
        check(sorted(got) == sorted(want), f"[48] {what}: the leaves' keys differ")
        bad = [k for k in want if got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
               or got[k].tobytes() != want[k].tobytes()]
        check(not bad, f"[48] {what}: {len(bad)} leaves are not bitwise the snapshot's, e.g. {bad[:3]}")

    same_leaves(art, "the built artifact")
    sess = _build_session(art, dtype="float32", device=DEV)
    check(sess.tower_params["conv1"]["w"].dtype == torch.float32, "[48] the serving cast did not widen")
    rng = np.random.default_rng(48)
    audio = (rng.standard_normal(int(PARITY_SECONDS * 16000)) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    res = sess.transcribe(audio)
    t_tr = time.perf_counter() - t0
    probe = capture_probe(sess, audio)
    check(set(probe) == {"frontend", "encoder", "logits"}
          and all(np.isfinite([s["mean"], s["std"]]).all() for s in probe.values()),
          "[48] the widened session's stage snapshots are not finite")
    check(len(res.token_ids) > 0, "[48] the window gave no ids")
    del sess
    plan = Path(folder) / "plan.json"
    plan.write_text(json.dumps({"plans": {"half": {"method": "bf16"}}, "assign": [["*", "half"]]}))
    rc, out, t_opt = run_main("optimize", "--model-dir", art, "--out", opt, "--plan", plan)
    check(rc == 0, f"[48] optimize gave rc {rc}: {out[-500:]}")
    same_leaves(opt, "the bf16-plan artifact")
    print(f"[48 bf16] a BF16 Qwen3-ASR HF snapshot ({cfg.tower_layers} tower + {lc.num_layers} LLM layers at the "
          f"published widths, {size_gb:.3f} GB) written in {t_write:.2f} s; build (host) {t_build:.2f} s: "
          f"{len(want)} leaves load on the card bitwise the snapshot's, all bf16; one {PARITY_SECONDS:.0f} s window "
          f"with the serving cast float32 -> {len(res.token_ids)} ids in {t_tr:.2f} s, finite stage probes; "
          f"optimize (a bf16 plan, on the card) {t_opt:.2f} s: its leaves reload bitwise  [{card}]")
    torch.cuda.empty_cache()
    return {"leaves": len(want), "build_s": t_build, "optimize_s": t_opt, "ids": len(res.token_ids)}


# ── 49-52. training at full width: CTC, AED cross-entropy, RNN-T, checkpoint / resume ──
TRAIN_LR = 1e-4
TRAIN_SV = (8, 8.0, (24, 48), 5)  # batch, seconds, label lengths, fit steps (the first is the warm step)
TRAIN_SV_CUT = (1, 2, 1)  # encoders0, encoders, tp_encoders of the card = CPU checks and the resume (batch 2)
TRAIN_WH = (2, 3000, 64, (64, 40), 0.1, 3)  # batch, mel frames (30 s), tokens, valid, smoothing, steps
TRAIN_WH_CUT = (1, 1, 400)  # encoder layers, decoder layers, mel frames of the card = CPU check
TRAIN_PK = (4, 8.0, 32, (32, 20, 32, 12), 3)  # batch, seconds, labels, valid, steps
GRAD_REL = 1e-3  # a leaf's gradient, card against CPU, relative to its own max|g| ...
GRAD_FLOOR = 1e-6  # ... plus this share of the tree's max|g|: a leaf whose gradient is zero in exact
# arithmetic (the key part of an attention bias: softmax does not see a shift shared by every key) holds
# rounding noise on both devices, which no bound relative to itself can hold
LATTICE_TOL = 1e-5
RESUME_TOL = 1e-5
RESUME_STEPS = (4, 2)  # uninterrupted steps; steps before the checkpoint


def kernel_counts(qm, fs, fm, fd, fdm) -> dict:
    return {"int8": qm.LAUNCHES, "int4": qm.LAUNCHES_INT4, "int2": qm.LAUNCHES_INT2, "fused_aed": fs.LAUNCHES,
            "fused_aed_multi": fm.LAUNCHES, "fused_decode": fd.LAUNCHES, "fused_decode_multi": fdm.LAUNCHES}


def zero_counts(qm, fs, fm, fd, fdm) -> None:
    qm.LAUNCHES = qm.LAUNCHES_INT4 = qm.LAUNCHES_INT2 = 0
    fs.LAUNCHES = fm.LAUNCHES = fd.LAUNCHES = fdm.LAUNCHES = 0


def to_dev(torch, tree, dev):
    from asr_tpu_torch.parallel.checkpoint import tree_leaves, unflatten

    return unflatten(tree, [t.to(dev) for t in tree_leaves(tree)])


def grads_gap(torch, want, got, spreads=()) -> dict:
    """Gradients ``got`` against ``want`` (card against CPU, or two on the card), leaf by leaf: the
    worst |got - want| / (GRAD_REL * max|want leaf| + GRAD_FLOOR * max|want|)
    (at most 1 to pass), its leaf, and how many leaves need the floor.
    With ``spreads`` (gradient trees of the same function under changes
    that move nothing but roundings), ``spread`` is the worst such ratio
    of any of them: the function's own spread on this input."""
    from asr_tpu_torch.parallel.checkpoint import named_leaves

    w, g = named_leaves(want), dict(named_leaves(got))
    sp = [dict(named_leaves(t)) for t in spreads]
    top = max(t.abs().max().item() for _, t in w)
    worst, name, floored, spread = 0.0, "", 0, 0.0
    for k, t in w:
        gap = (g[k].to(t.device) - t).abs().max().item()
        own = t.abs().max().item()
        bound = GRAD_REL * own + GRAD_FLOOR * top
        ratio = gap / bound
        floored += gap > GRAD_REL * own
        spread = max([spread] + [(x[k].to(t.device) - t).abs().max().item() / bound for x in sp])
        if ratio >= worst:
            worst, name = ratio, k
    return {"worst": worst, "leaf": name, "floored": floored, "leaves": len(w), "max_g": top, "spread": spread}


def card_vs_cpu(torch, np, label: str, loss_fn, cpu_params, cfg, batch, dev) -> dict:
    """``value_and_grad(loss_fn)`` on the CPU and on the card from the same
    weights and batch (numpy arrays, and other arguments as they are): the
    loss within 1e-4 relative, every leaf's gradient within GRAD_REL of its
    own max|g| (+ GRAD_FLOOR of the tree's)."""
    from asr_tpu_torch.parallel.train import value_and_grad

    loss_c, g_c = value_and_grad(loss_fn, cpu_params, cfg, *batch)
    card_params = to_dev(torch, cpu_params, dev)
    on_card = tuple(torch.as_tensor(b).to(dev) if isinstance(b, np.ndarray) else b for b in batch)
    loss_d, g_d = value_and_grad(loss_fn, card_params, cfg, *on_card)
    rel = abs(loss_d.item() - loss_c.item()) / abs(loss_c.item())
    gap = grads_gap(torch, g_c, g_d)
    check(rel <= 1e-4, f"[{label}] card loss {loss_d.item()} against the CPU's {loss_c.item()}")
    check(gap["worst"] <= 1.0, f"[{label}] gradient of {gap['leaf']} off the CPU's: {gap}")
    return {"loss_rel": rel, "grad_worst": gap["worst"], "grad_leaf": gap["leaf"], "floored": gap["floored"],
            "leaves": gap["leaves"]}


def timed_fit(torch, label: str, step_fn, params, optimizer, batch, n_steps: int, ckpt_dir=None):
    """``fit`` over ``n_steps`` copies of one batch, each step between two
    CUDA events, its log lines printed. -> (params, opt_state, losses, ms a step)."""
    import itertools

    from asr_tpu_torch.parallel.train import fit

    events = []

    def timed(params, opt_state, optimizer, *b):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(params, opt_state, optimizer, *b)
        end.record()
        events.append((start, end))
        return out

    params, opt_state, losses = fit(timed, params, optimizer, itertools.repeat(batch, n_steps), n_steps,
                                    ckpt_dir=ckpt_dir, log_every=1, log_fn=lambda s: print(f"[{label}] {s}"))
    torch.cuda.synchronize()
    return params, opt_state, losses, [s.elapsed_time(e) for s, e in events]


def traced_run(torch, run) -> dict:
    """One call of ``run`` under ``runtime/profiling.trace``: kernel
    launches, device busy ms and the device's idle share of the window."""
    from asr_tpu_torch.runtime.profiling import device_summary, trace

    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir, cuda=True) as tr:
            run()
        s = device_summary(tr.path)
    return {"kernels": s["kernels"], "busy_ms": s["busy_us"] / 1e3, "window_ms": s["window_us"] / 1e3,
            "idle_share": s["idle_share"]}


def falling(label: str, losses) -> None:
    import math

    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"[{label}] the losses are not finite and falling: {losses}")


def phase_train_sensevoice(torch, np, counters, card: str) -> tuple:
    """[49] SenseVoiceSmall (``SenseVoiceConfig()``: 920 f32 leaves) CTC
    fine-tuning at full width through ``fit`` and ``train_step``: batch 8 x
    8 s, labels of 24-48 ids, mixed language rows, TRAIN_SV[3] steps at lr
    TRAIN_LR on one batch; the losses finite and falling, no launch of the
    seven kernels (the f32 leaves never reach ``quant_dense``); ms a step
    (CUDA events, after the warm first), the AdamW update's share, peak
    memory, kernel launches a step (``runtime/profiling.trace``); then the
    card = CPU check at the cut depth TRAIN_SV_CUT, batch 2. -> (numbers, the
    trained parameters and AdamW state for phase 52, the host batch)."""
    import dataclasses as dc

    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.parallel.checkpoint import named_leaves
    from asr_tpu_torch.parallel.train import (apply_updates, make_optimizer, sensevoice_ctc_loss, train_step,
                                              value_and_grad)

    cfg = sv.SenseVoiceConfig()
    b, seconds, (lo, hi), n_steps = TRAIN_SV
    rng = np.random.default_rng(49)
    n = int(seconds * 16000)
    label_valid = rng.integers(lo, hi + 1, b).astype(np.int32)
    host = ((rng.standard_normal((b, n)) * 2000).astype(np.float32), np.full(b, n, np.int32),
            rng.integers(0, len(sv.LANGUAGE_PROFILES), b).astype(np.int32),
            rng.integers(1, cfg.vocab_size, (b, hi)).astype(np.int32), label_valid)
    batch = tuple(torch.as_tensor(a).to(DEV) for a in host)
    params = sv.init_params(cfg, torch.Generator(device=DEV).manual_seed(49), DEV)
    n_leaves = len(named_leaves(params))
    n_params = sum(t.numel() for _, t in named_leaves(params))
    optimizer = make_optimizer(lr=TRAIN_LR)

    def step_fn(params, opt_state, optimizer, *batch):
        return train_step(params, opt_state, cfg, optimizer, *batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)  # the path starts here
    params, opt_state, losses, ms = timed_fit(torch, "49 fit", step_fn, params, optimizer, batch, n_steps)
    counts = kernel_counts(*counters)  # and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    falling("49", losses)
    check(not any(counts.values()), f"[49] the training step launched a kernel of the seven: {counts}")
    prof = traced_run(torch, lambda: train_step(params, opt_state, cfg, optimizer, *batch)[2].item())
    # the AdamW update alone on this step's gradients, after a warm one
    _, grads = value_and_grad(sensevoice_ctc_loss, params, cfg, *batch)

    def adamw():
        nonlocal opt_state
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)

    adamw_ms = time_ms(adamw, iters=3, warmup=1)
    del grads
    step_ms = float(np.median(ms[1:]))
    cut = dc.replace(cfg, num_encoders0=TRAIN_SV_CUT[0], num_encoders=TRAIN_SV_CUT[1],
                     num_tp_encoders=TRAIN_SV_CUT[2])
    cpu_params = sv.init_params(cut, torch.Generator().manual_seed(4901), "cpu")
    same = card_vs_cpu(torch, np, "49 card = CPU", sensevoice_ctc_loss, cpu_params, cut, tuple(a[:2] for a in host), DEV)
    out = {"params_m": n_params / 1e6, "leaves": n_leaves, "losses": losses, "ms_steps": ms, "step_ms": step_ms,
           "adamw_ms": adamw_ms, "adamw_share": adamw_ms / step_ms, "peak_gib": peak, "profile": prof,
           "counts": counts, "card_vs_cpu": same}
    print(f"[49 train sensevoice] SenseVoiceSmall at full width ({n_params / 1e6:.3f} M f32 parameters, {n_leaves} "
          f"leaves), batch {b} x {seconds:.0f} s, labels {lo}-{hi}: fit {n_steps} steps at lr {TRAIN_LR}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; {step_ms:.2f} ms a step (CUDA events, steps 2-{n_steps}: "
          f"{', '.join(f'{x:.2f}' for x in ms[1:])}), AdamW update {adamw_ms:.2f} ms ({out['adamw_share']:.3f} "
          f"of a step), peak {peak:.2f} GiB; one step traced: {prof['kernels']} kernel launches, device busy "
          f"{prof['busy_ms']:.2f} ms of {prof['window_ms']:.2f} (idle {prof['idle_share']:.3f}); the seven kernels "
          f"0 launches; card = CPU at {TRAIN_SV_CUT} blocks, batch 2: loss {same['loss_rel']:.2e} apart, worst "
          f"leaf gradient {same['grad_worst']:.3f} of its bound ({same['grad_leaf']}; {same['floored']} of "
          f"{same['leaves']} leaves inside the floor)  [{card}]")
    return out, params, opt_state, host


def phase_train_whisper(torch, np, counters, card: str) -> dict:
    """[50] Whisper-Large-v3-Turbo (``WhisperConfig()``) teacher-forced
    cross-entropy at full width through ``fit`` and
    ``whisper_train_step``: B = 2 x 30 s of mel, 64-token targets with valid
    lengths 64 and 40, label smoothing 0.1, TRAIN_WH[-1] steps; the losses
    finite and falling, none of the seven kernels; ms a step, peak memory;
    card = CPU at full widths with TRAIN_WH_CUT (layers, mel frames)."""
    import dataclasses as dc

    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.parallel.checkpoint import named_leaves
    from asr_tpu_torch.parallel.train import make_optimizer, whisper_ce_loss, whisper_train_step

    cfg = wh.WhisperConfig()
    b, frames, s, valid, smoothing, n_steps = TRAIN_WH
    rng = np.random.default_rng(50)
    host = ((rng.standard_normal((b, frames, cfg.n_mels)) * 0.3).astype(np.float32),
            rng.integers(3, cfg.eot_id, (b, s)).astype(np.int32), np.array(valid, np.int32))
    batch = tuple(torch.as_tensor(a).to(DEV) for a in host)
    params = wh.init_params(cfg, torch.Generator(device=DEV).manual_seed(50), DEV)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    optimizer = make_optimizer(lr=TRAIN_LR)

    def step_fn(params, opt_state, optimizer, *batch):
        return whisper_train_step(params, opt_state, cfg, optimizer, *batch, label_smoothing=smoothing)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    params, opt_state, losses, ms = timed_fit(torch, "50 fit", step_fn, params, optimizer, batch, n_steps)
    counts = kernel_counts(*counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    falling("50", losses)
    check(not any(counts.values()), f"[50] the training step launched a kernel of the seven: {counts}")
    del params, opt_state
    torch.cuda.empty_cache()
    cut = dc.replace(cfg, encoder_layers=TRAIN_WH_CUT[0], decoder_layers=TRAIN_WH_CUT[1])
    cpu_params = wh.init_params(cut, torch.Generator().manual_seed(5001), "cpu")
    cut_batch = (host[0][:, :TRAIN_WH_CUT[2]], host[1], host[2], smoothing)
    same = card_vs_cpu(torch, np, "50 card = CPU", whisper_ce_loss, cpu_params, cut, cut_batch, DEV)
    step_ms = float(np.median(ms[1:]))
    out = {"params_m": n_params / 1e6, "leaves": len(named_leaves(cpu_params)), "losses": losses, "ms_steps": ms,
           "step_ms": step_ms, "peak_gib": peak, "counts": counts, "card_vs_cpu": same}
    print(f"[50 train whisper] Whisper-Large-v3-Turbo at full width ({n_params / 1e6:.3f} M f32 parameters), "
          f"B = {b} x {frames} mel frames, {s} tokens (valid {valid}), smoothing {smoothing}: fit {n_steps} steps: "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; {step_ms:.2f} ms a step (CUDA events: "
          f"{', '.join(f'{x:.2f}' for x in ms)}), peak {peak:.2f} GiB; the seven kernels 0 launches; card = CPU "
          f"at {TRAIN_WH_CUT[0]} + {TRAIN_WH_CUT[1]} layers, {TRAIN_WH_CUT[2]} frames: loss {same['loss_rel']:.2e} "
          f"apart, worst leaf gradient {same['grad_worst']:.3f} of its bound ({same['grad_leaf']}; "
          f"{same['floored']} of {same['leaves']} leaves inside the floor)  [{card}]")
    return out


def lattice_check(torch, np, lat_shape: tuple, labels, t_valid, u_valid, blank: int, durations, card: str) -> dict:
    """``rnnt_loss`` and ``tdt_loss`` on one random lattice of the phase's
    joint shape, card against CPU: per-sample NLL and the gradient w.r.t.
    the log-probs within LATTICE_TOL of max|.|; the card's wavefront timed
    (forward + backward, CUDA events) and its peak memory above the inputs,
    with the checkpointed steps; the RNN-T wavefront's kernel launches."""
    from asr_tpu_torch.parallel.rnnt_loss import rnnt_loss, tdt_loss

    g = torch.Generator().manual_seed(51)
    tok = torch.log_softmax(torch.randn(lat_shape, generator=g), dim=-1)
    dur = torch.log_softmax(torch.randn(lat_shape[:3] + (len(durations),), generator=g), dim=-1)
    out = {}
    for name in ("rnnt", "tdt"):
        def run(x, y, dev):
            args = (torch.as_tensor(labels).to(dev), torch.as_tensor(t_valid).to(dev), torch.as_tensor(u_valid).to(dev))
            if name == "rnnt":
                return rnnt_loss(x, *args, blank)
            return tdt_loss(x, y, *args, durations=durations, blank_id=blank)

        got = {}
        for dev in ("cpu", DEV):
            x = tok.to(dev).clone().requires_grad_(True)
            y = dur.to(dev).clone().requires_grad_(True)
            nll = run(x, y, dev)
            nll.sum().backward()
            got[dev] = (nll.detach().cpu(), x.grad.cpu(), y.grad.cpu() if name == "tdt" else None)
            del x, y, nll
        gaps = {}
        for i, what in enumerate(("nll", "d_log_probs", "d_durations")):
            if got["cpu"][i] is None:
                continue
            ref = got["cpu"][i]
            gaps[what] = ((got[DEV][i] - ref).abs().max() / ref.abs().max()).item()
            check(gaps[what] <= LATTICE_TOL, f"[51 {name}] {what} on the card {gaps[what]:.2e} off the CPU's")
        x = tok.to(DEV).clone().requires_grad_(True)
        y = dur.to(DEV).clone().requires_grad_(True)

        def fwd_bwd():
            x.grad = y.grad = None
            run(x, y, DEV).sum().backward()

        fwd_bwd()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = time_ms(fwd_bwd, iters=3, warmup=0)
        out[name] = {"gaps": gaps, "ms": ms, "peak_mib": peak}
        traced = ""
        if name == "rnnt":  # the RNN-T wavefront's launches (the step's loss); TDT's trace costs ~7 s
            prof = traced_run(torch, fwd_bwd)
            out[name].update(kernels=prof["kernels"], busy_ms=prof["busy_ms"], idle_share=prof["idle_share"])
            traced = (f", {prof['kernels']} kernel launches, device busy {prof['busy_ms']:.2f} ms (idle "
                      f"{prof['idle_share']:.3f})")
        del x, y
        print(f"[51 {name} lattice] {name}_loss on a random {tuple(lat_shape)} lattice: card = CPU within "
              f"{', '.join(f'{k} {v:.2e}' for k, v in gaps.items())} of max|.|; forward + backward {ms:.2f} ms "
              f"(CUDA events; {lat_shape[1] + lat_shape[2] - 1} wavefront steps, checkpointed){traced}, peak "
              f"{peak:.1f} MiB above its inputs  [{card}]")
    return out


def phase_train_parakeet(torch, np, counters, card: str) -> dict:
    """[51] Parakeet-TDT-0.6B (``ParakeetConfig()``) RNN-T fine-tuning at
    full width through ``fit`` and ``transducer_train_step``: B = 4 x 8 s,
    32 labels with valid lengths 32, 20, 32, 12, TRAIN_PK[-1] steps; the
    losses finite and falling, none of the seven kernels; ms a step, peak
    memory; card = CPU for the step at one conformer block; ``rnnt_loss``
    and ``tdt_loss`` card = CPU on a random lattice of the joint's shape,
    the wavefront's time, launches and peak memory."""
    import dataclasses as dc

    from asr_tpu_torch.models import parakeet as pk
    from asr_tpu_torch.parallel.checkpoint import named_leaves
    from asr_tpu_torch.parallel.train import make_optimizer, transducer_loss, transducer_train_step

    cfg = pk.ParakeetConfig()
    b, seconds, u, valid, n_steps = TRAIN_PK
    rng = np.random.default_rng(51)
    n = int(seconds * 16000)
    host = ((rng.standard_normal((b, n)) * 0.1).astype(np.float32), np.full(b, n, np.int32),
            rng.integers(0, cfg.blank_id, (b, u)).astype(np.int32), np.array(valid, np.int32))
    batch = tuple(torch.as_tensor(a).to(DEV) for a in host)
    params = pk.init_params(cfg, torch.Generator(device=DEV).manual_seed(51), DEV)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    optimizer = make_optimizer(lr=TRAIN_LR)

    def step_fn(params, opt_state, optimizer, *batch):
        return transducer_train_step(params, opt_state, cfg, optimizer, *batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)
    params, opt_state, losses, ms = timed_fit(torch, "51 fit", step_fn, params, optimizer, batch, n_steps)
    counts = kernel_counts(*counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    falling("51", losses)
    check(not any(counts.values()), f"[51] the training step launched a kernel of the seven: {counts}")
    with torch.no_grad():
        enc, t_valid = pk.encode(params, cfg, batch[0], batch[1])
    lat_shape = (b, enc.shape[1], u + 1, cfg.vocab_size)
    del params, opt_state, enc
    torch.cuda.empty_cache()
    cut = dc.replace(cfg, num_layers=1)
    cpu_params = pk.init_params(cut, torch.Generator().manual_seed(5101), "cpu")
    same = card_vs_cpu(torch, np, "51 card = CPU", transducer_loss, cpu_params, cut, host, DEV)
    lattice = lattice_check(torch, np, lat_shape, host[2], t_valid.cpu(), host[3], cfg.blank_id,
                            cfg.durations, card)
    step_ms = float(np.median(ms[1:]))
    out = {"params_m": n_params / 1e6, "leaves": len(named_leaves(cpu_params)), "losses": losses,
           "ms_steps": ms, "step_ms": step_ms, "peak_gib": peak, "counts": counts, "card_vs_cpu": same,
           "lattice_shape": list(lat_shape), "lattice": lattice}
    print(f"[51 train parakeet] Parakeet-TDT-0.6B at full width ({n_params / 1e6:.3f} M f32 parameters), "
          f"B = {b} x {seconds:.0f} s, {u} labels (valid {valid}), joint lattice {lat_shape}: fit {n_steps} steps: "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; {step_ms:.2f} ms a step (CUDA events: "
          f"{', '.join(f'{x:.2f}' for x in ms)}), peak {peak:.2f} GiB; the seven kernels 0 launches; card = CPU at "
          f"one conformer block: loss {same['loss_rel']:.2e} apart, worst leaf gradient {same['grad_worst']:.3f} "
          f"of its bound ({same['grad_leaf']}; {same['floored']} of {same['leaves']} leaves inside the floor)  "
          f"[{card}]")
    return out


def phase_train_checkpoint(torch, np, params, opt_state, host, card: str) -> dict:
    """[52] ``save_train_state`` / ``restore_train_state`` of phase 49's
    full-width SenseVoiceSmall parameters and AdamW state: every leaf and
    the step back bitwise on the card, seconds of each; then ``fit``'s
    resume at phase 49's cut depth (batch 2): RESUME_STEPS[0] steps
    uninterrupted against RESUME_STEPS[1] steps + a checkpoint + a restore
    into fresh tensors + the rest, losses and parameters within RESUME_TOL
    relative."""
    import dataclasses as dc

    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.parallel import checkpoint as ckpt
    from asr_tpu_torch.parallel.train import make_optimizer, train_step

    step = TRAIN_SV[3]
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_train_state(d, params, opt_state, step)
        t_save = time.perf_counter() - t0
        size_gb = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file()) / 1e9
        t0 = time.perf_counter()
        p2, o2, s2 = ckpt.restore_train_state(d, {"params": params, "opt_state": opt_state})
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    want = ckpt.named_leaves({"params": params, "opt_state": opt_state})
    got = dict(ckpt.named_leaves({"params": p2, "opt_state": o2}))
    bad = [k for k, t in want if got[k].device != t.device or got[k].dtype != t.dtype or not torch.equal(got[k], t)]
    check(s2 == step and not bad, f"[52] the round trip gave step {s2}, {len(bad)} leaves not bitwise: {bad[:3]}")
    del p2, o2, got
    torch.cuda.empty_cache()

    # resume: PyTorch promises no bitwise result on the card (its CUDA ctc_loss backward, for one,
    # accumulates with atomics where 2 x labels + 1 > 2 x vocabulary), so the gate is RESUME_TOL and
    # bitwise is reported; the CPU tests hold the same check bitwise
    cfg = sv.SenseVoiceConfig()
    cut = dc.replace(cfg, num_encoders0=TRAIN_SV_CUT[0], num_encoders=TRAIN_SV_CUT[1],
                     num_tp_encoders=TRAIN_SV_CUT[2])
    batch = tuple(torch.as_tensor(a[:2]).to(DEV) for a in host)
    n_all, n_first = RESUME_STEPS
    optimizer = make_optimizer(lr=TRAIN_LR)

    def fresh():
        return sv.init_params(cut, torch.Generator(device=DEV).manual_seed(5201), DEV)

    def step_fn(params, opt_state, optimizer, *b):
        return train_step(params, opt_state, cut, optimizer, *b)

    p_all, o_all, l_all, _ = timed_fit(torch, "52 straight", step_fn, fresh(), optimizer, batch, n_all)
    with tempfile.TemporaryDirectory() as d:
        _, _, l_a, _ = timed_fit(torch, "52 first", step_fn, fresh(), optimizer, batch, n_first, ckpt_dir=d)
        p_b, o_b, l_b, _ = timed_fit(torch, "52 resumed", step_fn, fresh(), optimizer, batch, n_all, ckpt_dir=d)
    losses = l_a + l_b
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(losses, l_all))
    a = ckpt.named_leaves({"params": p_all, "opt_state": o_all})
    bb = dict(ckpt.named_leaves({"params": p_b, "opt_state": o_b}))
    leaf_gap = max(((bb[k].double() - t.double()).abs().max() / t.double().abs().max().clamp(min=1e-30)).item()
                   for k, t in a)
    bitwise = all(torch.equal(bb[k], t) for k, t in a)
    check(len(losses) == n_all and loss_gap <= RESUME_TOL and leaf_gap <= RESUME_TOL,
          f"[52] resumed against straight: losses {losses} / {l_all} ({loss_gap:.2e}), leaves {leaf_gap:.2e}")
    out = {"size_gb": size_gb, "save_s": t_save, "restore_s": t_restore, "leaves": len(want),
           "resume_loss_gap": loss_gap, "resume_leaf_gap": leaf_gap, "resume_bitwise": bitwise}
    print(f"[52 checkpoint] SenseVoiceSmall parameters + AdamW state at full width ({len(want)} leaves, "
          f"{size_gb:.3f} GB): save {t_save:.2f} s, restore onto the card {t_restore:.2f} s, every leaf and the "
          f"step bitwise on the card; resume at {TRAIN_SV_CUT} blocks: {n_first} steps + "
          f"save + restore into fresh tensors + {n_all - n_first} against {n_all} straight: losses "
          f"{loss_gap:.2e} apart, leaves {leaf_gap:.2e} of their max (bitwise: {bitwise})  [{card}]")
    return out


# ── 53-59. multi-device serving: meshes of repeated positions on the card ───
# (data, model) layouts of the SenseVoice runs; tp is virtual on one card
# (every position on the same card), so its times are no speed result.
SHARD_CONFIGS = ((2, 2), (1, 4), (4, 1))
SHARD_BUDGET = 24  # new tokens a window on the sharded and replicated decodes
SHARD_REQUESTS = 4
SHARD_SECONDS = (5.0, 12.0)
VIRTUAL = "every mesh position on the one card: not a speed result"


def card_positions(torch, n: int) -> list:
    """``n`` mesh positions over the visible cards in turn (one card: repeated)."""
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def shard_vs_plain(torch, qm, leaf, m: int, seed: int) -> float:
    """One shard's int8 call against its plain version (bf16 mode): max
    |diff|, checked within 1e-4 * max|plain|."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    k = leaf.scale.shape[0] * leaf.block
    x = torch.randn((m, k), generator=g, device=DEV)
    got = qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, leaf.block, "bf16")
    want = qm.quant_dense_reference(x, leaf.q, leaf.scale, leaf.zero, leaf.block, "bf16")
    err = (got - want).abs().max().item()
    check(err <= 1e-4 * want.abs().max().item(), f"shard ({k}, {leaf.q.shape[1]}) vs plain: {err}")
    return err


def phase_sensevoice_sharded(torch, np, qm, params, cfg, card: str) -> dict:
    """[53] SenseVoiceSmall q8, batch 8 x 8 s, through DataParallelRunner at
    each of SHARD_CONFIGS against the unsharded forward, checked in mm=f32 (in
    bf16 mode a last-bit gap of a sum flips an activation's bf16 rounding):
    tp runs' logits within 1e-3 * max|logit| with the framewise argmax equal
    above the margin, dp-only rows bitwise; the int8 launches on the shards;
    forwards timed in mm=bf16; a column and two row shard calls held against
    their plain version in bf16 mode."""
    from asr_tpu_torch.decode.ctc import ctc_greedy_collapse
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel.serve import DataParallelRunner

    rng = np.random.default_rng(53)
    samples = int(WINDOW_S * cfg.sample_rate)
    audio = (rng.standard_normal((BATCH, samples)) * 2000).astype(np.float32)
    valid = rng.integers(samples // 2, samples + 1, size=BATCH).astype(np.int64)
    valid[0] = samples
    lang = np.zeros(BATCH, np.int64)

    def fn(p, a, v, li):
        return sv.encode_logits(p, cfg, a, v, li)

    def timed(call) -> float:
        qm.set_quant_config(mm="bf16")
        call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        qm.set_quant_config(mm="f32")
        return (time.perf_counter() - t) / 3 * 1e3

    qm.set_quant_config(mm="f32")
    with torch.inference_mode():
        args = [torch.from_numpy(x).to(DEV) for x in (audio, valid, lang)]
        want, vseq = fn(params, *args)
        base_ms = timed(lambda: fn(params, *args))
    frames = torch.arange(want.shape[1], device=DEV)[None, :] < vseq[:, None]
    sure = frames & (logits_margin(want) > MARGIN)
    want_ids = ctc_greedy_collapse(want.argmax(-1), vseq, cfg.blank_id)
    scale = want.abs().max().item()
    out = {"launches": {}, "ms": {"unsharded": base_ms}, "max_abs_err": 0.0}
    for dp, tp in SHARD_CONFIGS:
        name = f"sensevoice_dp{dp}_tp{tp}"
        mesh = pm.make_mesh(dp * tp, model_parallel=tp, devices=card_positions(torch, dp * tp))
        runner = DataParallelRunner(mesh, pm.sensevoice_param_specs if tp > 1 else None)
        lay = runner.shard_params(params)
        runner(fn, lay, audio, valid, lang)  # first call: threads, workspaces
        torch.cuda.synchronize()
        qm.LAUNCHES = 0  # the path starts here
        got, gv = runner(fn, lay, audio, valid, lang)
        torch.cuda.synchronize()
        launches = qm.LAUNCHES  # and ends here
        ms = timed(lambda: runner(fn, lay, audio, valid, lang))
        check(launches == LINEARS_PER_FORWARD * dp * tp, f"[53] {name}: {launches} int8 launches, not "
              f"{LINEARS_PER_FORWARD} x {dp * tp} positions")
        check(bool(torch.isfinite(got).all()) and torch.equal(gv, vseq), f"[53] {name}: bad output")
        diff = (got - want).abs().max().item()
        if tp == 1:
            check(diff == 0.0, f"[53] {name}: data-parallel rows differ from the unsharded rows by {diff}")
        check(diff <= 1e-3 * scale, f"[53] {name}: logits {diff} > 1e-3 * {scale}")
        check(bool((got.argmax(-1) == want.argmax(-1))[sure].all()),
              f"[53] {name}: framewise argmax differs above the {MARGIN} margin")
        ids = ctc_greedy_collapse(got.argmax(-1), gv, cfg.blank_id)
        same = torch.equal(ids[1], want_ids[1]) and torch.equal(ids[0], want_ids[0])
        check(same or int((frames & ~sure).sum()) > 0, f"[53] {name}: ids differ with every frame sure")
        out["launches"][name] = launches
        out["ms"][name] = ms
        print(f"[53 sharded] {name}: {launches} int8 launches ({dp * tp} positions x {LINEARS_PER_FORWARD}), "
              f"logits vs unsharded max diff {diff:.3e} (max|logit| {scale:.3e}{', bitwise' if diff == 0 else ''}), "
              f"ids {'equal' if same else 'differ only on frames under the margin'} (mm=f32); forward "
              f"{ms:.1f} ms vs unsharded {base_ms:.1f} ms (mm=bf16, {VIRTUAL})  [{card}]")
        if (dp, tp) == SHARD_CONFIGS[0]:
            blk = lay.local(0, tp - 1)["encoders"][0]
            m = BATCH // dp * ROWS
            out["max_abs_err"] = max(shard_vs_plain(torch, qm, blk["qkv"]["w"], m, 1),
                                     shard_vs_plain(torch, qm, blk["out"]["w"], m, 2),
                                     shard_vs_plain(torch, qm, blk["ffn"]["w2"], m, 3))
            print(f"[53 sharded] rank {tp - 1}'s qkv column shard {tuple(blk['qkv']['w'].q.shape)}, out and "
                  f"ffn.w2 row shards {tuple(blk['out']['w'].q.shape)} {tuple(blk['ffn']['w2'].q.shape)} at "
                  f"M={m} vs plain: max |diff| {out['max_abs_err']:.3e}")
        del lay, runner
    torch.cuda.empty_cache()
    return out


def phase_cli_sharded(torch, np, qm, folder: str, params, cfg, card: str) -> dict:
    """[57] ``transcribe --data-parallel 2 --tensor-parallel 2`` through
    ``cli.main`` on phase 4's artifact, both commands in the exact mode
    (``--quant-mm f32``: in bf16 a last-bit gap of a sum flips a bf16
    rounding): the unsharded command's printout (or, where ids differ, an
    unsharded top-2 margin under MARGIN)."""
    import contextlib

    from asr_tpu_torch import cli
    from asr_tpu_torch.models import sensevoice as sv

    rng = np.random.default_rng(57)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 2000).astype(np.int16) for s in (8.0, 5.5)]
    with tempfile.TemporaryDirectory() as d:
        wavs = []
        for i, c in enumerate(clips):
            p = Path(d) / f"c{i}.wav"
            p.write_bytes(wav_bytes(c))
            wavs.append(str(p))

        def run(*flags) -> tuple[list, float]:
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--quant-mm", "f32", "transcribe", "--model-dir", folder, *flags, *wavs])
            check(rc == 0, f"[57] transcribe {flags} exited {rc}")
            lines = buf.getvalue().splitlines()
            return [ln for ln in lines if not ln.startswith(tuple(wavs))], time.perf_counter() - t

        plain, plain_s = run()
        qm.LAUNCHES = 0  # the path starts here
        got, got_s = run("--data-parallel", "2", "--tensor-parallel", "2")
        launches = qm.LAUNCHES  # and ends here
    check(launches > 0, "[57] the sharded command launched no int8 kernel")
    if got != plain:
        qm.set_quant_config(mm="f32")
        with torch.inference_mode():
            for c in clips:
                a = torch.from_numpy(c.astype(np.float32))[None].to(DEV)
                lg, _ = sv.encode_logits(params, cfg, a, torch.tensor([len(c)], device=DEV),
                                         torch.zeros(1, dtype=torch.int64, device=DEV))
                low = logits_margin(lg).min().item()
                check(low <= MARGIN, f"[57] printouts differ with every top-2 margin above {MARGIN}")
    print(f"[57 cli] transcribe --data-parallel 2 --tensor-parallel 2: {len(clips)} files "
          f"{'printed as' if got == plain else 'differ (under the margin) from'} the unsharded command; "
          f"{launches} int8 launches; {got_s:.2f} s vs {plain_s:.2f} s, artifact load included  [{card}]")
    return {"int8": launches}


def phase_dryrun_serving(torch, np, card: str) -> dict:
    """[58] ``__graft_entry__.dryrun_multichip`` on a dp 4 x tp 2 mesh of
    card positions, at its tiny f32 widths. The training half: its
    SenseVoice CTC step (batch 2 x data of 4800 samples, 8 labels, by
    ``sensevoice_param_specs``) through ``train_step`` on a layout of the
    positions' own leaves, the loss within 1e-4 of the unsharded one and
    every gathered gradient within the card gradient gate (``grads_gap``). The serving half: a
    Whisper encode, a Qwen3 prefill and one step, and a continuous
    tensor-parallel step; each against the unsharded run."""
    from asr_tpu_torch.decode.ar import DecodeConfig
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher
    from asr_tpu_torch.parallel.serve import DataParallelRunner
    from asr_tpu_torch.parallel.train import make_optimizer, sensevoice_ctc_loss, train_step, value_and_grad

    mesh = pm.make_mesh(8, model_parallel=2, devices=card_positions(torch, 8))
    g = torch.Generator(device=DEV).manual_seed(58)
    rng = np.random.default_rng(58)
    batch = 2 * mesh.shape["data"]

    scfg = sv.SenseVoiceConfig(vocab_size=128, hidden=64, num_heads=4, head_dim=16, ffn_dim=128,
                               num_encoders0=1, num_encoders=2, num_tp_encoders=1, fsmn_kernel=5)
    sp = sv.init_params(scfg, g)
    samples = 4800
    sbatch = ((rng.standard_normal((batch, samples)) * 2000).astype(np.float32), np.full(batch, samples, np.int32),
              np.zeros(batch, np.int32), rng.integers(1, scfg.vocab_size, (batch, 8)).astype(np.int32),
              np.full(batch, 8, np.int32))
    loss_u, g_u = value_and_grad(sensevoice_ctc_loss, sp, scfg, *sbatch)
    lay = pm.shard_params(sp, mesh, pm.sensevoice_param_specs(sp), own=True)
    loss_g, g_m = value_and_grad(sensevoice_ctc_loss, lay, scfg, *sbatch)
    optimizer = make_optimizer()
    _, state, loss_m = train_step(lay, optimizer.init(lay), scfg, optimizer, *sbatch)
    train_rel = abs(loss_m.item() - loss_u.item()) / abs(loss_u.item())
    gap = grads_gap(torch, to_dev(torch, g_u, "cpu"), pm.gather_params(g_m, "cpu"))
    check(train_rel <= 1e-4 and loss_g.item() == loss_m.item() and gap["worst"] <= 1.0,
          f"[58] sensevoice dp x tp train step: loss {loss_m.item()} vs {loss_u.item()}, gradients {gap}")
    check(int(state["count"]) == 1 and bool(torch.isfinite(loss_m)), "[58] the train step did not step")
    del lay, g_m, state
    wcfg = wh.WhisperConfig(vocab_size=128, d_model=32, encoder_layers=1, decoder_layers=1, num_heads=4,
                            n_mels=16, max_source_positions=20, max_target_positions=16, sot_id=1,
                            eot_id=2, first_language_id=10, num_languages=4, transcribe_id=20,
                            translate_id=21, no_timestamps_id=22, no_speech_id=30)
    wp = wh.init_params(wcfg, g)
    mel = rng.standard_normal((batch, 40, 16)).astype(np.float32)
    runner = DataParallelRunner(mesh, pm.whisper_param_specs)
    enc = runner(lambda p, m: wh.encode(p, wcfg, m), runner.shard_params(wp), mel)
    with torch.inference_mode():
        want = wh.encode(wp, wcfg, torch.from_numpy(mel).to(DEV))
    enc_diff = (enc - want).abs().max().item()
    check(enc_diff <= 1e-4 * want.abs().max().item(), f"[58] whisper tp x dp encode: {enc_diff}")

    qcfg = qwen3.Qwen3Config(vocab_size=128, hidden=32, num_layers=2, num_heads=4, num_kv_heads=2,
                             head_dim=8, ffn_dim=48)
    qp = qwen3.init_params(qcfg, g)
    s, t_max = 6, 12
    ids = rng.integers(0, qcfg.vocab_size, (batch, s))

    def prefill_and_step(p, ids):
        state = qwen3.make_kv_state(qcfg, ids.shape[0], t_max, device=ids.device)
        full = torch.full((ids.shape[0],), s, device=ids.device)
        hidden, state = qwen3.decoder_pass(p, qcfg, p["embed"][ids], state, 0,
                                           qwen3.causal_prefill_bias(full, s, t_max))
        tok = qwen3.logits_from_hidden(p, qcfg, hidden)[:, -1].argmax(-1)
        h2, state = qwen3.decoder_pass(p, qcfg, p["embed"][tok[:, None]], state, s,
                                       qwen3.step_bias(full, s, t_max))
        return qwen3.logits_from_hidden(p, qcfg, h2)[:, -1]

    qrunner = DataParallelRunner(mesh, pm.qwen3_param_specs)
    lg = qrunner(prefill_and_step, qrunner.shard_params(qp), ids)
    with torch.inference_mode():
        lw = prefill_and_step(qp, torch.from_numpy(ids).to(DEV))
    q_diff = (lg - lw).abs().max().item()
    check(q_diff <= 1e-4 * lw.abs().max().item() and torch.equal(lg.argmax(-1), lw.argmax(-1)),
          f"[58] qwen3 tp x dp prefill + step: {q_diff}")

    bat = ContinuousLlmBatcher(qwen3.init_params(qcfg, g), qcfg, DecodeConfig(max_new_tokens=3, eot_id=-1),
                               n_slots=2, t_max=40, steps_per_tick=2, mesh=mesh.row(0))
    slot = bat.try_submit(torch.from_numpy(rng.standard_normal((5, qcfg.hidden)).astype(np.float32)).to(DEV), 5)
    n_ev = sum(len(bat.step_tick()) for _ in range(2))
    got = bat.take_result(slot)
    check(len(got) == 4, f"[58] continuous tp slot gave {got}")
    print(f"[58 dryrun] dp {mesh.shape['data']} x tp 2 positions: sensevoice train step loss "
          f"{loss_m.item():.6f} within {train_rel:.2e} of unsharded, worst leaf gradient {gap['worst']:.3f} of its "
          f"bound; whisper encode {tuple(enc.shape)} within {enc_diff:.2e} of unsharded, qwen3 prefill + step "
          f"logits within {q_diff:.2e}, continuous tp step: {n_ev} events, ids {got}  [{card}]")
    return {"train_loss_rel": train_rel, "train_grad_worst": gap["worst"], "enc_diff": enc_diff,
            "qwen_diff": q_diff}


def first_diff(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def phase_whisper_tp(torch, np, qm, fs, folder: str, card: str) -> tuple:
    """[54] Whisper-Large-v3-Turbo q8 (phase 9's artifact), one 30 s window at
    tp 2 (10 of the 20 heads a rank) on the rowwise (per-weight) decode,
    SHARD_BUDGET new tokens: ids against the unsharded rowwise run (equal, or
    first differing where the unsharded step's top-2 margin is under MARGIN)
    and ms a token. Returns the numbers and the unsharded session (for 56)."""
    from asr_tpu_torch.decode.strategies import suppress_tokens
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.runtime.whisper_session import WhisperSession, load_whisper_session

    qm.set_quant_config(mm="bf16")
    base = load_whisper_session(folder, DEV)
    base.scfg = dataclasses.replace(base.scfg, max_new_tokens=SHARD_BUDGET, no_speech_threshold=None)
    cfg = base.cfg
    kw = dict(session_cfg=base.scfg, language_id_map=base.language_id_map)
    plain = WhisperSession(base.params, cfg, **kw)
    plain.stacked = None  # the rowwise route, as the sharded session decodes
    tp = WhisperSession(base.params, cfg, **kw, mesh=pm.make_mesh(2, 2, devices=card_positions(torch, 2)),
                        param_specs=pm.whisper_param_specs)
    check(tp.stacked is None and tp.runner is not None, "[54] the sharded session stacked or has no runner")
    audio = (np.random.default_rng(54).standard_normal(30 * 16000) * 0.1).astype(np.float32)
    margins = []  # the unsharded run's top-2 margin at each generated id
    step, prefill_window = wh.step, wh.prefill_window
    suppress = base.decode_cfg.suppress_ids

    def recorded_prefill(*a, **k):
        pre = prefill_window(*a, **k)
        margins.append(logits_margin(pre["logits0"])[0].item())
        return pre

    def recorded_step(*a, **k):
        lg, st = step(*a, **k)
        margins.append(logits_margin(suppress_tokens(lg.float(), suppress))[0].item())
        return lg, st

    wh.step, wh.prefill_window = recorded_step, recorded_prefill
    try:
        want = plain.transcribe(audio).token_ids
    finally:
        wh.step, wh.prefill_window = step, prefill_window
    qm.LAUNCHES = fs.LAUNCHES = 0  # the path starts here
    got = tp.transcribe(audio)
    int8, fused = qm.LAUNCHES, fs.LAUNCHES  # and ends here
    check(int8 > 0 and fused == 0, f"[54] {int8} int8 and {fused} fused launches on the tp path")
    j = first_diff(got.token_ids, want)
    if got.token_ids != want:
        check(j < len(margins) and margins[j] <= MARGIN,
              f"[54] tp ids differ at {j} where the unsharded margin is above {MARGIN}")
    times = {}
    for label, sess in (("unsharded", plain), ("tp2", tp)):
        full = sess.transcribe(audio)
        short = dataclasses.replace(sess.scfg, max_new_tokens=1)
        keep, sess.scfg = sess.scfg, short
        head = sess.transcribe(audio)
        sess.scfg = keep
        n = max(len(full.token_ids) - len(head.token_ids), 1)
        times[label] = {"window_s": full.elapsed_seconds,
                        "ms_per_token": (full.elapsed_seconds - head.elapsed_seconds) / n * 1e3}
    print(f"[54 whisper tp] 30 s window, tp 2 ({cfg.num_heads // 2} heads a rank), rowwise decode of "
          f"{len(got.token_ids)} ids: {'equal to' if got.token_ids == want else f'first differing at {j} (margin under {MARGIN}) from'} "
          f"the unsharded rowwise run; int8 launches {int8}; window {times['tp2']['window_s'] * 1e3:.0f} ms, "
          f"{times['tp2']['ms_per_token']:.2f} ms a token vs unsharded {times['unsharded']['window_s'] * 1e3:.0f} ms, "
          f"{times['unsharded']['ms_per_token']:.2f} ms a token ({VIRTUAL})  [{card}]")
    del plain, tp
    torch.cuda.empty_cache()
    return {"int8": int8, "equal": got.token_ids == want, **times}, base


def count_submits(srv) -> list:
    """Per replica, the requests its batcher took."""
    counts = [0] * len(srv.replicas)
    for i, rep in enumerate(srv.replicas):
        orig = rep.batcher.try_submit

        def counted(*a, _i=i, _orig=orig, **k):
            slot = _orig(*a, **k)
            counts[_i] += slot is not None
            return slot

        rep.batcher.try_submit = counted
    return counts


def serve_clips(torch, srv, clips, counters) -> tuple:
    """POST ``clips`` at once to an HTTP front end over ``srv``; the launch
    counts ``counters`` name ((module, count name) pairs) over the run. ->
    (replies, healthz, launches, wall s)."""
    from asr_tpu_torch.parallel.http_server import make_http_server

    httpd = make_http_server(srv, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: list = [None] * len(clips)
    try:
        torch.cuda.synchronize()
        for mod, name in counters:
            setattr(mod, name, 0)  # the path starts here
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post_clip, args=(base, c, 0.0, results, i))
                   for i, c in enumerate(clips)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "an HTTP request did not finish")
        launches = [getattr(mod, name) for mod, name in counters]  # and ends here
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    for i, r in enumerate(results):
        check(r is not None and r[0] == 200, f"request {i}: {r}")
    return [r[1]["token_ids"] for r in results], health, launches, wall


def phase_whisper_dp(torch, np, qm, fs, fm, session, card: str) -> dict:
    """[56] Continuous Whisper-Large-v3-Turbo q8 at data_parallel=2 (two
    replicas, each its own multi-slot kernel; on one card both on it):
    SHARD_REQUESTS requests, each bitwise the request alone through a
    replica's batcher, both replicas serving."""
    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer, _to

    check(session.stacked is not None, "[56] the session did not stack the q8 decoder")
    rng = np.random.default_rng(56)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16)
             for s in rng.uniform(*SHARD_SECONDS, size=SHARD_REQUESTS)]
    srv = ContinuousSessionServer(session, n_slots=2, kv_dtype="f32", data_parallel=2,
                                  devices=card_positions(torch, 2))
    try:
        taken = count_submits(srv)
        got, health, (int8, fused, multi), wall = serve_clips(
            torch, srv, clips, ((qm, "LAUNCHES"), (fs, "LAUNCHES"), (fm, "LAUNCHES")))
        taken = list(taken)  # the served requests only
    finally:
        srv.close()
    eot = session.decode_cfg.eot_id
    with torch.inference_mode():  # each request alone on each replica's batcher
        for r, rep in enumerate(srv.replicas):
            for i, clip in enumerate(clips):
                pre = session.continuous_prefill(clip.astype(np.float32) / 32768.0)
                slot = rep.batcher.try_submit(_to(pre["state"], rep.device), pre["p_len"],
                                              pre["logits0"].to(rep.device), pre["tc_valid"])
                while rep.batcher.is_active(slot):
                    rep.batcher.step()
                alone = [t for t in rep.batcher.take_result(slot) if t != eot]
                check(alone == got[i], f"[56] request {i}: served ids differ from it alone on replica {r}")
    check(health["ok"] and health["replicas"] == 2 and health["step_kernel"] == "fused", f"[56] {health}")
    check(multi == health["decode_steps"] > 0 and fused == 0, f"[56] {multi} multi-slot launches for "
          f"{health['decode_steps']} steps, {fused} batch-1")
    check(all(t > 0 for t in taken), f"[56] a replica served nothing: {taken}")
    print(f"[56 whisper dp] data_parallel=2 on {', '.join(str(r.device) for r in srv.replicas)}: "
          f"{len(clips)} requests ({taken} a replica) in {wall:.2f} s, multi-slot launches {multi} "
          f"(= decode steps), int8 {int8}; each request bitwise it alone on either replica; healthz "
          f"{json.dumps(health)}  [{card}]")
    return {"int8": int8, "launches": multi}


def phase_qwen_sharded(torch, np, qm, fd, fdm, folder: str, card: str) -> dict:
    """[55] Qwen3-ASR-0.6B (phase 16's artifact: q8 tower, q4 LLM) through
    ContinuousSessionServer: tensor_parallel=2 (the rowwise tp engine; ids
    against the unsharded rowwise batcher, differing only under the replay
    margin) and data_parallel=2 (each request bitwise it alone through a
    replica's batcher, both replicas serving, healthz 2 replicas)."""
    from asr_tpu_torch.parallel.llm_batcher import ContinuousLlmBatcher
    from asr_tpu_torch.parallel.llm_server import ContinuousSessionServer
    from asr_tpu_torch.runtime.qwen_session import load_qwen_session

    qm.set_quant_config(mm="bf16")
    session = load_qwen_session(folder, DEV, max_new_tokens=SHARD_BUDGET)
    cfg, eot = session.cfg, session.cfg.eot_id
    counters = ((qm, "LAUNCHES"), (qm, "LAUNCHES_INT4"), (fd, "LAUNCHES"), (fdm, "LAUNCHES"))
    rng = np.random.default_rng(55)
    clips = [np.round(rng.standard_normal(int(s * 16000)) * 3277).astype(np.int16)
             for s in rng.uniform(*SHARD_SECONDS, size=SHARD_REQUESTS)]
    out = {}
    srv = ContinuousSessionServer(session, n_slots=2, kv_dtype="bf16", tensor_parallel=2,
                                  devices=card_positions(torch, 2))
    try:
        got, health, (int8, int4, fused, multi), wall = serve_clips(torch, srv, clips, counters)
        t_max = srv.batcher.t_max
    finally:
        srv.close()
    check(health["ok"] and health["tensor_parallel"] == 2 and health["step_kernel"] == "rowwise",
          f"[55] tp healthz {health}")
    check(int4 > 0 and int8 > 0 and fused == 0 and multi == 0,
          f"[55] tp launches: int4 {int4}, int8 {int8}, batch-1 {fused}, multi {multi}")
    rows = ContinuousLlmBatcher(session.llm_params, cfg.llm, session.decode_cfg, n_slots=2, t_max=t_max,
                                kv_dtype=torch.bfloat16)
    import copy

    rows_sess = copy.copy(session)
    rows_sess.stacked = None
    equal, gap = 0, 0.0
    with torch.inference_mode():
        for i, clip in enumerate(clips):
            audio = clip.astype(np.float32) / 32768.0
            emb, valid = session.prompt_embeds(audio)
            slot = rows.try_submit(emb, valid)
            while rows.is_active(slot):
                rows.step()
            alone = [t for t in rows.take_result(slot) if t != eot]
            if alone == got[i]:
                equal += 1
                continue
            gap = max(gap, qwen_replay_gap(torch, rows_sess, audio, got[i]))
            check(gap <= MARGIN, f"[55] tp request {i}: a served id {gap:.2e} of max|logit| below the best")
    out["tp"] = {"int8": int8, "int4": int4, "wall_s": wall, "step_ms": health["step_latency_avg_s"] * 1e3,
                 "equal": equal}
    print(f"[55 qwen tp] tensor_parallel=2: {len(clips)} requests in {wall:.2f} s, {health['decode_steps']} "
          f"steps at {health['step_latency_avg_s'] * 1e3:.2f} ms; int4 {int4}, int8 {int8}, multi-slot 0; ids "
          f"equal to the unsharded rowwise batcher for {equal}/{len(clips)} (the rest within {gap:.2e} of "
          f"max|logit| of the per-weight best) ({VIRTUAL})  [{card}]")

    srv = ContinuousSessionServer(session, n_slots=2, kv_dtype="bf16", data_parallel=2,
                                  devices=card_positions(torch, 2))
    try:
        taken = count_submits(srv)
        got, health, (int8, int4, fused, multi), wall = serve_clips(torch, srv, clips, counters)
        taken = list(taken)  # the served requests only
    finally:
        srv.close()
    with torch.inference_mode():  # each request alone on each replica's batcher
        for r, rep in enumerate(srv.replicas):
            for i, clip in enumerate(clips):
                emb, valid = session.prompt_embeds(clip.astype(np.float32) / 32768.0)
                slot = rep.batcher.try_submit(emb.to(rep.device), valid)
                while rep.batcher.is_active(slot):
                    rep.batcher.step()
                alone = [t for t in rep.batcher.take_result(slot) if t != eot]
                check(alone == got[i], f"[55] dp request {i}: served ids differ from it alone on replica {r}")
    check(health["ok"] and health["replicas"] == 2 and health["step_kernel"] == "fused", f"[55] dp {health}")
    check(multi == health["decode_steps"] > 0 and fused == 0, f"[55] dp: {multi} multi-slot launches for "
          f"{health['decode_steps']} steps, {fused} batch-1")
    check(all(t > 0 for t in taken), f"[55] a replica served nothing: {taken}")
    out["dp"] = {"int8": int8, "int4": int4, "launches": multi, "wall_s": wall}
    print(f"[55 qwen dp] data_parallel=2: {len(clips)} requests ({taken} a replica) in {wall:.2f} s; "
          f"multi-slot {multi} (= decode steps), int4 {int4}, int8 {int8}; each bitwise it alone on either "
          f"replica; healthz replicas {health['replicas']}, slots {health['slots']}  [{card}]")
    del session, rows, rows_sess
    torch.cuda.empty_cache()
    return out


def phase_second_device(torch, qm, quantize_linear, card: str) -> dict:
    """[59] The per-device shared-memory limit: the int8 and int4 kernels
    launched on cuda:0, then on cuda:1 at shapes above 48 KiB of dynamic
    shared memory, against their plain versions (kernels 5 and 7 run on
    cuda:1 as phase 55's and 56's second replicas). Needs two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"[59 second device] skipped: {n} card visible, so the per-device shared-memory repair "
              "is not exercised here (phases 55-56 put both replicas on cuda:0)")
        return {"ran": False}
    errs = {}
    for name, bits in (("int8", 8), ("int4", 4)):
        w = torch.randn((1024, 4096), generator=torch.Generator(device=DEV).manual_seed(bits), device=DEV)
        leaf = quantize_linear(w * 1024 ** -0.5, bits, 128, pack=bits == 4)
        for dev in ("cuda:0", "cuda:1"):
            x = torch.randn((432, 1024), device=dev)
            q, s, z = (t.to(dev) for t in (leaf.q, leaf.scale, leaf.zero))
            if bits == 8:
                got = qm.quant_matmul_int8(x, q, s, z, leaf.block, "bf16")
                want = qm.quant_dense_reference(x, q, s, z, leaf.block, "bf16")
            else:
                got = qm.quant_matmul_int4(x, q, s, z, leaf.block, "bf16")
                want = qm.quant_dense_p4_reference(x, q, s, z, leaf.block, "bf16")
            torch.cuda.synchronize(dev)
            errs[f"{name} {dev}"] = (got - want).abs().max().item()
            check(errs[f"{name} {dev}"] <= 1e-4 * want.abs().max().item(), f"[59] {name} on {dev}: {errs}")
    print(f"[59 second device] int8 and int4 on cuda:0 then cuda:1 vs plain: {errs}  [{card}]")
    return {"ran": True, "max_abs_err": errs}



# ── 60-63. training over a mesh: dp x tp steps on repeated card positions ──
# (data, model) layouts; every position on the one card, so the times are virtual
MESH_TRAIN_SV = ((2, 2), (1, 4))
MESH_TRAIN_WH = ((2, 2),)
MESH_TRAIN_PK = ((2, 1),)
MESH_TRAIN_STEPS = 3  # fit steps a layout (the first is the warm step)
MESH_LOSS_RTOL = {"sensevoice": 1e-4, "whisper": 2e-5, "parakeet": 1e-4}  # JAX's own bounds


def positions_agree(torch, pm, sharded) -> int:
    """Every position's copy of a leaf bitwise the copy at (0, its model
    rank) and a replicated leaf's at (0, 0); -> the leaves compared."""
    from asr_tpu_torch.parallel.checkpoint import tree_leaves

    splits = pm.layout_leaves(sharded.layout)
    ref = {m: tree_leaves(sharded.local(0, m)) for m in range(sharded.mesh.shape["model"])}
    n = 0
    for d, m in sharded.positions():
        for i, (split, t) in enumerate(zip(splits, tree_leaves(sharded.local(d, m)))):
            check(torch.equal(t, ref[0 if split.whole else m][i]),
                  f"position ({d}, {m}) holds another copy of leaf {i} ({split})")
            n += 1
    return n


def mesh_train(torch, np, counters, label: str, make_params, cfg, loss_fn, step, batch: tuple, layouts,
               specs_fn, rtol: float, card: str) -> dict:
    """One family's training over each (dp, tp) of ``layouts`` on card
    positions, against the unsharded port on the same weights and batch:
    the global loss within ``rtol``, every leaf's gathered gradient within
    the card gradient gate (``grads_gap``), or, where the unsharded port's own gradient moves
    further under changes of roundings alone (the batch rows reversed, one
    ulp up at every 7th input value: at full depth it does), within twice
    that spread (``grads_gap``; the repo's rule for depth); then ``fit``
    MESH_TRAIN_STEPS steps
    (losses falling, the seven kernels at 0, every position's leaves and
    moments bitwise alike), ms a step (CUDA events, virtual), peak memory,
    launches a step (a traced step of the first layout), and the gradient reduction's and the
    AdamW update's shares of a step (each timed alone, the second moments
    standing in for the gradients). ``make_params()`` gives the weights on
    the card, dropped once the last layout holds them. -> the numbers."""
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel import train as tt
    from asr_tpu_torch.parallel.checkpoint import tree_leaves

    params = make_params()
    loss_u, g_u = tt.value_and_grad(loss_fn, params, cfg, *batch)
    # the unsharded port's own spread: the batch rows reversed (the loss is the same function of
    # them, summed in another order) and one ulp up at every 7th input value
    moved = batch[0].clone()
    moved.view(torch.int32).view(-1)[::7] += 1
    spreads = [tt.value_and_grad(loss_fn, params, cfg, *b)[1]
               for b in (tuple(a.flip(0) if isinstance(a, torch.Tensor) else a for a in batch),
                         (moved,) + batch[1:])]
    del moved
    torch.cuda.synchronize()
    out = {"unsharded_loss": loss_u.item(), "layouts": {}}
    lay = opt_state = None
    for dp, tp in layouts:
        name = f"dp{dp}_tp{tp}"
        del lay, opt_state
        gc.collect()
        torch.cuda.empty_cache()
        mesh = pm.make_mesh(dp * tp, model_parallel=tp, devices=card_positions(torch, dp * tp))
        lay = pm.shard_params(params, mesh, specs_fn(params) if specs_fn and tp > 1 else None, own=True)
        if (dp, tp) == layouts[-1]:
            del params  # the last layout's leaves are the only copy on the card from here
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(*counters)  # the path starts here
        t0 = time.perf_counter()
        loss_m, g_m = tt.value_and_grad(loss_fn, lay, cfg, *batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        rel = abs(loss_m.item() - loss_u.item()) / abs(loss_u.item())
        check(rel <= rtol, f"[{label} {name}] mesh loss {loss_m.item()} against the unsharded {loss_u.item()}")
        gap = grads_gap(torch, g_u, pm.gather_params(g_m), spreads)
        bound = max(1.0, 2 * gap["spread"])
        check(gap["worst"] <= bound, f"[{label} {name}] gradient of {gap['leaf']} off the unsharded one's: {gap}")
        agree = positions_agree(torch, pm, g_m)
        del g_m
        if (dp, tp) == layouts[-1]:
            del g_u, spreads
        optimizer = tt.make_optimizer(lr=TRAIN_LR)
        lay, opt_state, losses, ms = timed_fit(torch, f"{label} {name} fit", step, lay, optimizer, batch,
                                               MESH_TRAIN_STEPS)
        counts = kernel_counts(*counters)  # and ends here
        peak = torch.cuda.max_memory_allocated() / 2**30
        falling(f"{label} {name}", losses)
        check(not any(counts.values()), f"[{label} {name}] the mesh step launched a kernel of the seven: {counts}")
        agree += sum(positions_agree(torch, pm, t) for t in (lay, opt_state["mu"], opt_state["nu"]))
        prof = None  # one traced step a family (a trace of ~70000 launches costs ~15 s of the run)
        if (dp, tp) == layouts[0]:
            prof = traced_run(torch, lambda: step(lay, opt_state, optimizer, *batch)[2].item())
        stand_in = opt_state["nu"]  # shaped as the gradients
        raw = [[tree_leaves(stand_in.local(d, m)) for m in range(tp)] for d in range(dp)]
        reduce_ms = time_ms(lambda: tt.reduce_gradients(lay, raw), iters=3, warmup=1)
        del raw

        def adamw():
            nonlocal opt_state
            updates, opt_state = optimizer.update(stand_in, opt_state, lay)
            tt.apply_updates(lay, updates)

        adamw_ms = time_ms(adamw, iters=2, warmup=1)
        step_ms = float(np.median(ms[1:]))
        out["layouts"][name] = {
            "loss_rel": rel, "grad_worst": gap["worst"], "grad_leaf": gap["leaf"], "floored": gap["floored"],
            "grad_own_spread": gap["spread"], "grad_bound": bound,
            "leaves": gap["leaves"], "copies_bitwise": agree, "losses": losses, "ms_steps": ms, "step_ms": step_ms,
            "first_grad_s": first_s, "peak_gib": peak, "profile": prof, "reduce_ms": reduce_ms,
            "reduce_share": reduce_ms / step_ms, "adamw_ms": adamw_ms, "adamw_share": adamw_ms / step_ms,
            "counts": counts}
        print(f"[{label} mesh train] {name} on {dp * tp} card positions: loss {loss_m.item():.6f} vs unsharded "
              f"{loss_u.item():.6f} ({rel:.2e} apart, bound {rtol:g}); worst leaf gradient {gap['worst']:.3f} of "
              f"the card gradient gate ({gap['leaf']}; {gap['floored']} of {gap['leaves']} leaves past "
              f"1e-3 of their max), "
              f"the unsharded port's own spread {gap['spread']:.3f} of it, so bound {bound:.3f}; fit "
              f"{MESH_TRAIN_STEPS} steps: losses {', '.join(f'{x:.4f}' for x in losses)}; {step_ms:.1f} ms a step "
              f"(CUDA events: {', '.join(f'{x:.1f}' for x in ms)}; {VIRTUAL}); first value_and_grad "
              f"{first_s:.2f} s; gradient reduction {reduce_ms:.2f} ms ({reduce_ms / step_ms:.3f} of a step), "
              f"AdamW on every position {adamw_ms:.2f} ms ({adamw_ms / step_ms:.3f}); peak {peak:.2f} GiB; "
              + (f"one step traced: {prof['kernels']} kernel launches, device busy {prof['busy_ms']:.1f} ms of "
                 f"{prof['window_ms']:.1f} (idle {prof['idle_share']:.3f}); " if prof else "not traced; ")
              + f"{agree} position copies bitwise alike; the seven kernels 0 launches  [{card}]")
    return out


def phase_train_sensevoice_mesh(torch, np, counters, card: str) -> tuple:
    """[60] SenseVoiceSmall (``SenseVoiceConfig()``) CTC at full width, phase
    49's batch (8 x 8 s, the same draws), at dp 2 x tp 2 and tp 4 by
    ``sensevoice_param_specs`` (4 heads: one a rank at tp 4; the 25055-wide
    CTC head split unevenly), through ``mesh_train``. -> (numbers, the host
    batch for phase 63)."""
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel.train import sensevoice_ctc_loss, train_step

    cfg = sv.SenseVoiceConfig()
    b, seconds, (lo, hi), _ = TRAIN_SV
    rng = np.random.default_rng(49)
    n = int(seconds * 16000)
    label_valid = rng.integers(lo, hi + 1, b).astype(np.int32)
    host = ((rng.standard_normal((b, n)) * 2000).astype(np.float32), np.full(b, n, np.int32),
            rng.integers(0, len(sv.LANGUAGE_PROFILES), b).astype(np.int32),
            rng.integers(1, cfg.vocab_size, (b, hi)).astype(np.int32), label_valid)
    batch = tuple(torch.as_tensor(a).to(DEV) for a in host)

    def step(params, opt_state, optimizer, *batch):
        return train_step(params, opt_state, cfg, optimizer, *batch)

    out = mesh_train(torch, np, counters, "60",
                     lambda: sv.init_params(cfg, torch.Generator(device=DEV).manual_seed(60), DEV),
                     cfg, sensevoice_ctc_loss, step, batch, MESH_TRAIN_SV, pm.sensevoice_param_specs,
                     MESH_LOSS_RTOL["sensevoice"], card)
    return out, host


def phase_train_whisper_mesh(torch, np, counters, card: str) -> dict:
    """[61] Whisper-Large-v3-Turbo (``WhisperConfig()``) teacher-forced
    cross-entropy at full width, phase 50's batch (2 x 30 s of mel, 64
    tokens, valid 64 and 40: the two data slices weigh 63 and 39 target
    positions), at dp 2 x tp 2 by ``whisper_param_specs`` (20 heads, 10 a
    rank), through ``mesh_train``."""
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel.train import whisper_ce_loss, whisper_train_step

    cfg = wh.WhisperConfig()
    b, frames, s, valid, smoothing, _ = TRAIN_WH
    rng = np.random.default_rng(50)
    host = ((rng.standard_normal((b, frames, cfg.n_mels)) * 0.3).astype(np.float32),
            rng.integers(3, cfg.eot_id, (b, s)).astype(np.int32), np.array(valid, np.int32))
    batch = tuple(torch.as_tensor(a).to(DEV) for a in host) + (smoothing,)

    def step(params, opt_state, optimizer, *batch):
        return whisper_train_step(params, opt_state, cfg, optimizer, *batch)

    return mesh_train(torch, np, counters, "61",
                      lambda: wh.init_params(cfg, torch.Generator(device=DEV).manual_seed(61), DEV),
                      cfg, whisper_ce_loss, step, batch, MESH_TRAIN_WH, pm.whisper_param_specs,
                      MESH_LOSS_RTOL["whisper"], card)


def phase_train_parakeet_mesh(torch, np, counters, card: str) -> dict:
    """[62] Parakeet-TDT-0.6B (``ParakeetConfig()``) RNN-T at full width,
    phase 51's batch (4 x 8 s, 32 labels, valid 32, 20, 32, 12), at dp 2
    with the parameters replicated (JAX has no Parakeet spec tree), through
    ``mesh_train``."""
    from asr_tpu_torch.models import parakeet as pk
    from asr_tpu_torch.parallel.train import transducer_loss, transducer_train_step

    cfg = pk.ParakeetConfig()
    b, seconds, u, valid, _ = TRAIN_PK
    rng = np.random.default_rng(51)
    n = int(seconds * 16000)
    host = ((rng.standard_normal((b, n)) * 0.1).astype(np.float32), np.full(b, n, np.int32),
            rng.integers(0, cfg.blank_id, (b, u)).astype(np.int32), np.array(valid, np.int32))
    batch = tuple(torch.as_tensor(a).to(DEV) for a in host)

    def step(params, opt_state, optimizer, *batch):
        return transducer_train_step(params, opt_state, cfg, optimizer, *batch)

    return mesh_train(torch, np, counters, "62",
                      lambda: pk.init_params(cfg, torch.Generator(device=DEV).manual_seed(62), DEV),
                      cfg, transducer_loss, step, batch, MESH_TRAIN_PK, None, MESH_LOSS_RTOL["parakeet"], card)


def phase_train_mesh_checkpoint(torch, np, host, card: str) -> dict:
    """[63] ``fit`` with a checkpoint on a dp 2 x tp 2 mesh of SenseVoiceSmall
    at phase 52's cut depth (TRAIN_SV_CUT blocks at the published widths,
    phase 49's first 2 rows): RESUME_STEPS[1] steps and a checkpoint, the
    file read into the unsharded layout bitwise ``gather_params`` of the
    mesh's parameters and moments; resumed on a fresh layout to
    RESUME_STEPS[0] steps against as many straight, within RESUME_TOL
    (bitwise reported, as phase 52); the mesh's last checkpoint resumed in
    the unsharded layout for one more step."""
    import dataclasses as dc

    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.parallel import checkpoint as ckpt
    from asr_tpu_torch.parallel import mesh as pm
    from asr_tpu_torch.parallel.train import make_optimizer, train_step

    cut = dc.replace(sv.SenseVoiceConfig(), num_encoders0=TRAIN_SV_CUT[0], num_encoders=TRAIN_SV_CUT[1],
                     num_tp_encoders=TRAIN_SV_CUT[2])
    batch = tuple(torch.as_tensor(a[:2]).to(DEV) for a in host)
    n_all, n_first = RESUME_STEPS
    optimizer = make_optimizer(lr=TRAIN_LR)
    mesh = pm.make_mesh(4, model_parallel=2, devices=card_positions(torch, 4))
    base = sv.init_params(cut, torch.Generator(device=DEV).manual_seed(6301), DEV)

    def fresh_layout():
        return pm.shard_params(base, mesh, pm.sensevoice_param_specs(base), own=True)

    def step_fn(params, opt_state, optimizer, *b):
        return train_step(params, opt_state, cut, optimizer, *b)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p_all, o_all, l_all, ms = timed_fit(torch, "63 straight", step_fn, fresh_layout(), optimizer, batch, n_all)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as d:
        p_a, o_a, l_a, _ = timed_fit(torch, "63 first", step_fn, fresh_layout(), optimizer, batch, n_first,
                                     ckpt_dir=d)
        size_gb = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file()) / 1e9
        template = to_dev(torch, base, "cpu")
        t0 = time.perf_counter()
        p_w, o_w, s_w = ckpt.restore_train_state(d, {"params": template, "opt_state": optimizer.init(template)})
        t_read = time.perf_counter() - t0
        want = dict(ckpt.named_leaves({"params": pm.gather_params(p_a, "cpu"), "mu": pm.gather_params(o_a["mu"], "cpu"),
                                       "nu": pm.gather_params(o_a["nu"], "cpu")}))
        got = ckpt.named_leaves({"params": p_w, "mu": o_w["mu"], "nu": o_w["nu"]})
        bad = [k for k, t in got if not torch.equal(t, want[k])]
        check(s_w == n_first and len(got) == len(want) and not bad,
              f"[63] the mesh checkpoint in the unsharded layout: step {s_w}, {len(bad)} leaves not bitwise "
              f"gather_params: {bad[:3]}")
        del p_a, o_a, p_w, o_w, want, got
        p_b, o_b, l_b, _ = timed_fit(torch, "63 resumed", step_fn, fresh_layout(), optimizer, batch, n_all,
                                     ckpt_dir=d)
        _, _, l_u, _ = timed_fit(torch, "63 unsharded", step_fn, to_dev(torch, base, DEV), optimizer, batch,
                                 n_all + 1, ckpt_dir=d)
    losses = l_a + l_b
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(losses, l_all))
    leaf_gap, bitwise = 0.0, True
    for a, b in ((p_all, p_b), (o_all["mu"], o_b["mu"]), (o_all["nu"], o_b["nu"])):
        for dd, m in a.positions():
            for x, y in zip(ckpt.tree_leaves(a.local(dd, m)), ckpt.tree_leaves(b.local(dd, m))):
                bitwise &= torch.equal(x, y)
                leaf_gap = max(leaf_gap, ((x.double() - y.double()).abs().max()
                                          / x.double().abs().max().clamp(min=1e-30)).item())
    check(len(losses) == n_all and loss_gap <= RESUME_TOL and leaf_gap <= RESUME_TOL,
          f"[63] resumed against straight: losses {losses} / {l_all} ({loss_gap:.2e}), leaves {leaf_gap:.2e}")
    check(len(l_u) == 1 and np.isfinite(l_u[0]), f"[63] the unsharded resume gave {l_u}")
    step_ms = float(np.median(ms[1:]))
    out = {"size_gb": size_gb, "read_unsharded_s": t_read, "resume_loss_gap": loss_gap,
           "resume_leaf_gap": leaf_gap, "resume_bitwise": bitwise, "unsharded_resume_loss": l_u[0],
           "step_ms": step_ms, "peak_gib": peak}
    print(f"[63 mesh checkpoint] SenseVoiceSmall at {TRAIN_SV_CUT} blocks on dp 2 x tp 2 ({step_ms:.1f} ms a "
          f"step, {VIRTUAL}; peak {peak:.2f} GiB; not traced): {n_first} steps + a "
          f"checkpoint ({size_gb:.3f} GB, the unsharded layout's file: read unsharded in {t_read:.2f} s, bitwise "
          f"gather_params of the mesh's parameters and moments) + a restore into a fresh layout + "
          f"{n_all - n_first} against {n_all} straight: losses {loss_gap:.2e} apart, leaves {leaf_gap:.2e} of "
          f"their max (bitwise: {bitwise}); the mesh's step-{n_all} checkpoint resumed unsharded: loss "
          f"{l_u[0]:.4f}  [{card}]")
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

    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.ops import fused_aed_multi as fm
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.ops import fused_decode_multi as fdm
    from asr_tpu_torch.ops import quant_matmul as qm
    from asr_tpu_torch.parallel.http_server import start_background
    from asr_tpu_torch.quant.quantize import dequantize_pytree, quantize_linear, quantize_pytree
    from asr_tpu_torch.runtime.artifact import ModelMetadata, save_model
    from asr_tpu_torch.runtime.session import bucket_windows, load_session

    t_start = time.perf_counter()
    card = phase_device(torch)
    from asr_tpu_torch.ops import nvcc_build

    check(len(nvcc_build.SOURCES) == 7 and {qm.SOURCE, qm.SOURCE_INT4, qm.SOURCE_INT2, fs.SOURCE,
                                             fm.SOURCE, fd.SOURCE, fdm.SOURCE} == set(nvcc_build.SOURCES),
          f"expected the seven kernel sources, found {[p.name for p in nvcc_build.SOURCES]}")
    phase_build(nvcc_build.SOURCES, salted=(qm.SOURCE, qm.SOURCE_INT4, qm.SOURCE_INT2))
    kern = phase_kernel_vs_plain(torch, qm, quantize_linear, card)
    print(f"[t] phases 1-3: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 4. model: full geometry, q8, artifact round trip, session ─────────
    cfg = sv.SenseVoiceConfig()
    n_lin = LINEARS_PER_FORWARD
    check(4 * cfg.num_blocks + 1 == n_lin, f"SenseVoiceSmall has {n_lin} quantized linears")
    t0 = time.perf_counter()
    params32 = sv.init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    q8 = quantize_pytree(params32, bits=8, block=128)
    sv_dir = tempfile.TemporaryDirectory()  # kept for the command line (phase 26)
    save_model(sv_dir.name, q8, ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(cfg)}))
    size_mb = (Path(sv_dir.name) / "weights.safetensors").stat().st_size / 1e6
    session = load_session(sv_dir.name, DEV, window_seconds=WINDOW_S)
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

    print(f"[t] phases 4-6: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 53, 57-59. SenseVoice on a mesh, the command line, the dryrun's serving half, a second card ──
    del dense, lq, lp, params32
    torch.cuda.empty_cache()
    sh53 = phase_sensevoice_sharded(torch, np, qm, params, cfg, card)
    cli57 = phase_cli_sharded(torch, np, qm, sv_dir.name, params, cfg, card)
    dry58 = phase_dryrun_serving(torch, np, card)
    dev59 = phase_second_device(torch, qm, quantize_linear, card)
    del session, params
    torch.cuda.empty_cache()
    print(f"[t] phases 53, 57-59: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    examples_dir = tempfile.TemporaryDirectory()  # phase 45's fixtures, for every family's parity
    examples = write_examples(Path(examples_dir.name))
    par = {}

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
        aed_mv = phase_aed_matvec(torch, fs, card)
        serve = phase_continuous(torch, np, qm, fs, fm, whisper_dir, wnum, card)
        # ── 54, 56. Whisper at tp 2, continuous Whisper at data_parallel=2 ──
        wtp54, wbase = phase_whisper_tp(torch, np, qm, fs, whisper_dir, card)
        wdp56 = phase_whisper_dp(torch, np, qm, fs, fm, wbase, card)
        del wbase
        torch.cuda.empty_cache()
        add_parity_languages(whisper_dir)
        par["whisper"] = phase_parity(torch, np, qm, fs, fd, "whisper", whisper_dir, examples, card)
    print(f"[t] phases 8-13, 45 whisper: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 14-17. Qwen3-ASR-0.6B q4, the int4 kernel, the fused Qwen3 step ────
    from asr_tpu_torch.models.qwen_asr import QwenAsrConfig

    p4 = phase_packed(torch, qm, quantize_linear, 4, qwen_prefill_rows(QwenAsrConfig()), card,
                      m_more=fun_aligner_prefill_rows())
    dec = phase_decode_vs_plain(torch, fd, qwen3, quantize_pytree, card)
    step_mv = phase_step_matvec(torch, fd, card)
    with tempfile.TemporaryDirectory() as qwen_dir:
        qrun = phase_qwen(torch, np, qm, fd, qwen_dir, card)
        qserve = phase_qwen_serve(torch, np, qm, fd, qwen_dir, card)
        # ── 18-20. the multi-slot Qwen3 step, continuous Qwen3-ASR serving ──
        mdec = phase_decode_multi_vs_plain(torch, fd, fdm, qwen3, quantize_pytree, card)
        mtimes = phase_decode_multi_times(torch, fd, fdm, mdec.pop("stacked"), mdec.pop("cfg"),
                                          {c: dec["times"][c]["ms"] for c in dec["times"]}, card)
        qcont = phase_qwen_continuous(torch, np, qm, fd, fdm, qwen_dir, qrun, card)
        # ── 55. continuous Qwen3-ASR at tensor_parallel=2 and data_parallel=2 ──
        q55 = phase_qwen_sharded(torch, np, qm, fd, fdm, qwen_dir, card)
        add_parity_languages(qwen_dir)
        # one fixture: 257 tokens a fixture on the per-weight route
        par["qwen_asr"] = phase_parity(torch, np, qm, fs, fd, "qwen_asr", qwen_dir, examples, card,
                                       family=PARITY_ONE_FIXTURE)
    print(f"[t] phases 14-20, 45 qwen_asr: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 21-24. Qwen3-ASR-0.6B with a packed-int2 LLM, the int2 kernel ──────
    p2 = phase_packed(torch, qm, quantize_linear, 2, qwen_prefill_rows(QwenAsrConfig()), card)
    with tempfile.TemporaryDirectory() as q2_dir:
        q2run = phase_qwen_q2(torch, np, qm, fd, fdm, q2_dir, card)
        q2serve = phase_qwen_serve(torch, np, qm, fd, q2_dir, card, label="23")
        q2cont = phase_qwen_q2_continuous(torch, np, qm, fd, fdm, q2_dir, card)
    print(f"[t] phases 21-24: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 25. the int8 and packed kernels' linkage ────────────────────────────
    phase_linkage(torch, qm, quantize_linear, card)
    print(f"[t] phase 25: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 26-29. the command line, Fun-ASR-Nano, the forced aligner ───────────
    phase_cli(torch, np, qm, sv_dir.name, card)
    print(f"[t] phase 26: {time.perf_counter() - t_start:.1f} s since the start", flush=True)
    # ── 45-46. parity (the CPU's golden held on the card) and --profile on phase 4's folder ──
    cpu_golden = Path(sv_dir.name) / "parity_cpu.json"
    cpu_run = start_cli("--platform", "cpu", "parity", "--model-dir", sv_dir.name, "--examples", str(examples),
                        "--save-golden", str(cpu_golden))
    par["sensevoice"] = phase_parity(torch, np, qm, fs, fd, "sensevoice", sv_dir.name, examples, card,
                                     cpu_golden=(cpu_run, cpu_golden))
    prof = phase_profile(torch, np, qm, sv_dir.name, examples, card)
    sv_dir.cleanup()
    print(f"[t] phases 45-46 sensevoice: {time.perf_counter() - t_start:.1f} s since the start", flush=True)
    with tempfile.TemporaryDirectory() as fun_dir, tempfile.TemporaryDirectory() as ctc_dir:
        frun, fun_session = phase_fun_llm(torch, np, qm, fd, fun_dir, card)
        fcont = phase_fun_ctc_continuous(torch, np, qm, fd, fdm, ctc_dir, fun_session, card)
        del fun_session
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[t] phases 27-28: {time.perf_counter() - t_start:.1f} s since the start", flush=True)
    arun = phase_aligner(torch, np, qm, card)
    print(f"[t] phase 29: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 30-33. FireRedASR-AED-L and Dolphin on the AED kernels ─────────────
    famk = phase_aed_family_kernels(torch, fs, fm, quantize_pytree, card)
    fam_run, fam_cont = {}, {}
    for name in ("firered", "dolphin"):
        with tempfile.TemporaryDirectory() as fam_dir:
            fam_run[name] = phase_aed_family(torch, np, qm, fs, name, fam_dir, card)
            fam_cont[name] = phase_aed_family_continuous(torch, np, qm, fs, fm, name, fam_dir, card)
    print(f"[t] phases 30-33: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 34-36. Paraformer, Parakeet and Nemotron offline; their command line (26) ──
    off_run = {}
    for name in OFFLINE_FAMILIES:
        with tempfile.TemporaryDirectory() as off_dir:
            off_run[name] = phase_offline(torch, np, qm, name, off_dir, card)
    print(f"[t] phases 34-36: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 37-42. streaming: the four families, their runners at 8 slots, serve-stream ──
    st_run, st_multi, st_serve, st_prof = {}, {}, {}, {}
    for name in STREAM_FAMILIES:
        with tempfile.TemporaryDirectory() as st_dir:
            st_run[name] = phase_stream(torch, np, qm, name, st_dir, card)
            st_multi[name] = phase_stream_multi(torch, np, qm, name, st_run[name], card)
            st_serve[name] = phase_stream_serve(torch, np, qm, name, st_dir, st_run[name], card)
            # ── 47. the stream under the profiler; 45 on the X-ASR folder ──
            st_prof[name] = phase_stream_profile(torch, np, qm, name, st_run[name]["session"], card)
            del st_run[name]["session"]
            if name == "zipformer":
                # one fixture: 404 ids a fixture, chunk by chunk
                par["x_asr"] = phase_parity(torch, np, qm, fs, fd, "x_asr", st_dir, examples, card,
                                            family=PARITY_ONE_FIXTURE)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[t] phases 37-42 {name}: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 43-44. checkpoint -> artifact -> quantized artifact, through the command line ──
    with tempfile.TemporaryDirectory() as b_dir:
        sv43 = phase_build_sensevoice(torch, np, qm, b_dir, card)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as w_dir:
        wh44 = phase_build_whisper(torch, np, qm, fs, write_whisper_snapshot(torch, w_dir), card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[t] phases 43-44: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    # ── 48. a BF16 Qwen3-ASR snapshot -> build -> the card -> a bf16 plan ──
    with tempfile.TemporaryDirectory() as bf_dir:
        bf = phase_bf16(torch, np, bf_dir, card)
    examples_dir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[t] phase 48: {time.perf_counter() - t_start:.1f} s since the start", flush=True)
    print(f"[45-48] " + json.dumps({"parity": {k: {"launches": v["counts"], "save_s": round(v["save_s"], 3),
                                                  "golden_s": round(v["golden_s"], 3)} for k, v in par.items()},
                                   "profile": prof, "stream_profile": st_prof, "bf16": bf}))

    # ── 49-52. training at full width: CTC, AED cross-entropy, RNN-T; checkpoint / resume ──
    counters = (qm, fs, fm, fd, fdm)
    tr49, sv_params, sv_state, sv_host = phase_train_sensevoice(torch, np, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    tr50 = phase_train_whisper(torch, np, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    tr51 = phase_train_parakeet(torch, np, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    tr52 = phase_train_checkpoint(torch, np, sv_params, sv_state, sv_host, card)
    del sv_params, sv_state
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[t] phases 49-52: {time.perf_counter() - t_start:.1f} s since the start", flush=True)
    print("[49-52] " + json.dumps({"sensevoice_ctc": tr49, "whisper_aed": tr50, "parakeet_rnnt": tr51,
                                   "checkpoint": tr52}))

    # ── 60-63. training over a mesh of card positions: dp x tp steps, fit and the checkpoint ──
    tr60, mesh_host = phase_train_sensevoice_mesh(torch, np, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    tr61 = phase_train_whisper_mesh(torch, np, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    tr62 = phase_train_parakeet_mesh(torch, np, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    tr63 = phase_train_mesh_checkpoint(torch, np, mesh_host, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[t] phases 60-63: {time.perf_counter() - t_start:.1f} s since the start", flush=True)
    print("[60-63] " + json.dumps({"sensevoice_ctc_mesh": tr60, "whisper_aed_mesh": tr61,
                                   "parakeet_rnnt_mesh": tr62, "mesh_checkpoint": tr63}))
    # every kernel's launches on the mesh training paths (each checked to be 0)
    mesh_tr = {k: sum(r["layouts"][n]["counts"][k] for r in (tr60, tr61, tr62) for n in r["layouts"])
               for k in tr60["layouts"]["dp2_tp2"]["counts"]}

    print("[53-59] " + json.dumps({"sensevoice_sharded": sh53, "whisper_tp2": wtp54, "qwen": q55,
                                   "whisper_dp2": wdp56, "cli": cli57, "dryrun": dry58, "second_device": dev59}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    k_ms, p_ms = kern["per_forward"]["bf16"]
    f_t = fused["times"]["float32"]
    m_t = multi["times"][(MULTI_TIMED_B[-1], "float32")]
    q_t = mtimes[(QWEN_MULTI_TIMED_B[-1], "bfloat16")]
    sv = kern["per_path"]["sensevoice_b8"]
    print(json.dumps({"kernels": [{
        "name": "quant_matmul_int8",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/quant_matmul_int8.cu",
        "replaces": "asr_tpu/ops/quant_matmul.py:115",
        "launches": (launches + wrun_int8 + serve["int8"] + qrun["int8"] + qserve["int8"] + qcont["int8"]
                     + q2run["int8"] + q2serve["int8"] + q2cont["int8"] + frun["int8"] + frun["batch_int8"]
                     + fcont["ctc_int8"] + fcont["int8"] + arun["int8"]
                     + sum(fam_run[n]["int8"] + fam_cont[n]["int8"] for n in fam_run)
                     + fam_run["dolphin"]["ctc_int8"] + sum(r["int8"] for r in off_run.values())
                     + sum(r[n]["int8"] for r in (st_run, st_multi, st_serve) for n in STREAM_FAMILIES)
                     + sv43["int8"] + wh44["int8"] + sum(r["counts"]["int8"] for r in par.values())
                     + prof["int8"] + sum(r["int8"] for r in st_prof.values())
                     + sum(sh53["launches"].values()) + cli57["int8"] + wtp54["int8"] + wdp56["int8"]
                     + q55["tp"]["int8"] + q55["dp"]["int8"] + mesh_tr["int8"]),
        "launches_by_path": {"sensevoice": launches, "whisper": wrun_int8, "continuous": serve["int8"],
                             "qwen": qrun["int8"], "qwen_serve": qserve["int8"],
                             "qwen_continuous": qcont["int8"], "qwen_q2": q2run["int8"],
                             "qwen_q2_serve": q2serve["int8"], "qwen_q2_continuous": q2cont["int8"],
                             "fun_llm": frun["int8"], "fun_llm_batch": frun["batch_int8"],
                             "fun_ctc": fcont["ctc_int8"], "fun_continuous": fcont["int8"],
                             "aligner": arun["int8"], "firered": fam_run["firered"]["int8"],
                             "firered_continuous": fam_cont["firered"]["int8"],
                             "dolphin": fam_run["dolphin"]["int8"], "dolphin_ctc": fam_run["dolphin"]["ctc_int8"],
                             "dolphin_continuous": fam_cont["dolphin"]["int8"],
                             **{name: r["int8"] for name, r in off_run.items()},
                             **{f"{name}_stream": r["int8"] for name, r in st_run.items()},
                             **{f"{name}_stream_runner": r["int8"] for name, r in st_multi.items()},
                             **{f"{name}_serve_stream": r["int8"] for name, r in st_serve.items()},
                             "sensevoice_built_artifacts": sv43["int8"], "whisper_built_kquant": wh44["int8"],
                             **{f"{name}_parity": r["counts"]["int8"] for name, r in par.items()},
                             "sensevoice_profile": prof["int8"],
                             **{f"{name}_stream_profile": r["int8"] for name, r in st_prof.items()},
                             **sh53["launches"], "sensevoice_cli_dp2_tp2": cli57["int8"],
                             "whisper_tp2": wtp54["int8"], "whisper_dp2_continuous": wdp56["int8"],
                             "qwen_tp2_continuous": q55["tp"]["int8"], "qwen_dp2_continuous": q55["dp"]["int8"],
                             "mesh_training": mesh_tr["int8"]},
        "mesh_shards_max_abs_err": sh53["max_abs_err"],
        "mesh_forward_ms": {k: v for k, v in sh53["ms"].items()},
        "mesh_note": f"phase 53's batch-8 x 8 s forward by (data, model) layout, mm=bf16, host clock; {VIRTUAL}",
        "streaming_paths": "Paraformer (M = 13 encoder, 10 decoder rows a stream), Nemotron (14 query, 84 "
                           "key/value, 16 pre-encode rows, greedy M = 1), Dolphin (16; rescoring M = 3 and 1) and "
                           "X-ASR Zipformer2 (8, 4, 2, 1 rows by stack) streaming q8, at 1 and 8 streams "
                           "(per_path_ms: stream_*)",
        "offline_paths": "Paraformer-large (K = 560 in one block, N = 8404 head), Parakeet-TDT-0.6B "
                     "(joint head N = 8198) and Nemotron-0.6B (joint N = 8193) q8; greedy steps at M = 1 and 8, "
                     "rel-pos projections at 2T - 1 rows (per_path_ms: *_window*, *_b8*)",
        "max_abs_err": kern["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": sv["bound_ms"],
        "bound_by": sv["bound_by"],
        "library_ms": None,
        "yardstick": "torch.matmul of bf16 x and the bf16 dequantized weight (cuBLAS): not the same "
                     "function, never called by the port",
        "yardstick_ms": sv["bf16_yardstick_ms"],
        "per_path_ms": {name: {key: pp[key] for key in ("calls", "bf16_ms", "bf16_host_ms", "bf16_plain_ms",
                                                         "bf16_yardstick_ms", "bound_ms")}
                        for name, pp in kern["per_path"].items()},
        "timing": "sum over one batch-8 x 8 s forward's 281 calls (M=1096), mm=bf16, device time of a "
                  f"CUDA graph of {GRAPH_CALLS} calls (the plain version with CUDA events); bound summed per call",
    }, {
        "name": "fused_aed_step",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/fused_aed_step.cu",
        "replaces": "asr_tpu/ops/fused_aed_step.py:302",
        "launches": (wrun_fused + sum(r["fused"] for r in fam_run.values()) + wh44["fused"]
                     + par["whisper"]["counts"]["fused_aed"] + mesh_tr["fused_aed"]),
        "launches_by_path": {"whisper": wrun_fused, "firered": fam_run["firered"]["fused"],
                             "dolphin": fam_run["dolphin"]["fused"], "whisper_built_kquant": wh44["fused"],
                             "whisper_parity": par["whisper"]["counts"]["fused_aed"],
                             "mesh_training": mesh_tr["fused_aed"]},
        "max_abs_err": fused["max_abs_err"],
        "ms": f_t["ms"],
        "plain_ms": f_t["plain_ms"],
        "bound_ms": f_t["bound_ms"],
        "bound_by": f_t["bound_by"],
        "library_ms": None,
        "timing": "one turbo q8 step, f32 caches, pos 447, 1500 cross rows, CUDA events",
        "steps": {cache: {"ms": t["ms"], "graph_ms": t["profile"]["graph_ms"],
                          "busy_ms": t["profile"]["busy_ms"], "host_ms": t["profile"]["host_ms"],
                          "idle_share": t["profile"]["idle_share"], "unchained_parts_ms": t["profile"]["parts_ms"],
                          "launches_per_step": t["profile"]["launches_per_step"], "bound_ms": t["bound_ms"]}
                  for cache, t in fused["times"].items()},
        "matvec_alone_ms": {name: {key: m[key] for key in ("ms", "gb_s", "bound_ms", "tile")}
                            for name, m in aed_mv.items()},
        "geometries": {name: {cache: {key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
                              | {"graph_ms": t["profile"]["graph_ms"],
                                 "launches_per_step": t["profile"]["launches_per_step"]}
                              for cache, t in k["fused"]["times"].items()}
                       | {"max_abs_err": k["fused"]["max_abs_err"]}
                       for name, k in famk.items()},
    }, {
        "name": "fused_aed_multi",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/fused_aed_multi.cu",
        "replaces": "asr_tpu/ops/fused_aed_multi.py:90",
        "launches": (serve["launches"] + sum(r["launches"] for r in fam_cont.values()) + wdp56["launches"]
                     + mesh_tr["fused_aed_multi"]),
        "launches_by_path": {"continuous": serve["launches"], "firered_continuous": fam_cont["firered"]["launches"],
                             "dolphin_continuous": fam_cont["dolphin"]["launches"],
                             "whisper_dp2_continuous": wdp56["launches"],
                             "mesh_training": mesh_tr["fused_aed_multi"]},
        "max_abs_err": multi["max_abs_err"],
        "ms": m_t["ms"],
        "plain_ms": m_t["plain_ms"],
        "bound_ms": m_t["bound_ms"],
        "bound_by": m_t["bound_by"],
        "library_ms": None,
        "timing": f"one turbo q8 step of {MULTI_TIMED_B[-1]} slots, f32 caches, pos 447, 1500 cross "
                  "rows, CUDA events",
        "steps": {f"B={bs} {cache}": {"ms": t["ms"], "graph_ms": t["profile"]["graph_ms"],
                                      "busy_ms": t["profile"]["busy_ms"], "host_ms": t["profile"]["host_ms"],
                                      "idle_share": t["profile"]["idle_share"],
                                      "unchained_parts_ms": t["profile"]["parts_ms"],
                                      "launches_per_step": t["profile"]["launches_per_step"],
                                      "bound_ms": t["bound_ms"]}
                  for (bs, cache), t in multi["times"].items()},
        "geometries": {name: {f"B={bs} {cache}": {key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
                              | {"graph_ms": t["profile"]["graph_ms"]}
                              for (bs, cache), t in k["multi_times"].items()}
                       | {"max_abs_err": k["multi_max_abs_err"]}
                       for name, k in famk.items()},
    }, {
        "name": "quant_matmul_int4",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/quant_matmul_int4.cu",
        "replaces": "asr_tpu/ops/quant_matmul.py:493",
        "launches": (qrun["int4"] + qserve["int4"] + qcont["int4"] + frun["int4"] + frun["batch_int4"]
                     + fcont["int4"] + arun["int4"] + sv43["int4"] + par["qwen_asr"]["counts"]["int4"]
                     + q55["tp"]["int4"] + q55["dp"]["int4"] + mesh_tr["int4"]),
        "launches_by_path": {"qwen": qrun["int4"], "qwen_serve": qserve["int4"],
                             "qwen_continuous": qcont["int4"], "fun_llm": frun["int4"],
                             "fun_llm_batch": frun["batch_int4"], "fun_continuous": fcont["int4"],
                             "aligner": arun["int4"], "sensevoice_built_hqq4": sv43["int4"],
                             "qwen_parity": par["qwen_asr"]["counts"]["int4"],
                             "qwen_tp2_continuous": q55["tp"]["int4"], "qwen_dp2_continuous": q55["dp"]["int4"],
                             "mesh_training": mesh_tr["int4"]},
        "max_abs_err": p4["max_abs_err"],
        "ms": p4["per_prefill"]["bf16"]["ms"],
        "plain_ms": p4["per_prefill"]["bf16"]["plain_ms"],
        "bound_ms": p4["per_prefill"]["bf16"]["bound_ms"],
        "bound_by": p4["per_prefill"]["bf16"]["bound_by"],
        "library_ms": p4["per_prefill"]["bf16"]["library_ms"],
        "library": "torch._weight_int4pack_mm (bf16, group 128), the same 113 calls"
                   + (f"; not timed: {p4['library_note']}" if p4["library_note"] else ""),
        "per_pass_ms": {f"M={m}": {key: t[key] for key in ("ms", "library_ms", "bound_ms")}
                        for m, t in p4["per_pass"].items()},
        "timing": f"sum over one 30 s prefill's 113 calls (112 at M={qwen_prefill_rows(QwenAsrConfig())}, "
                  f"the tied head at M=1), mm=bf16, device time of a CUDA graph of {GRAPH_CALLS} calls "
                  "(the library call likewise; the plain version with CUDA events); bound summed per call",
    }, {
        "name": "fused_decode",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/fused_decode.cu",
        "replaces": "asr_tpu/ops/fused_decode.py:310",
        "launches": (qrun["fused"] + frun["fused"] + par["qwen_asr"]["counts"]["fused_decode"]
                     + mesh_tr["fused_decode"]),
        "launches_by_path": {"qwen": qrun["fused"], "qwen_serve": 0, "qwen_continuous": 0,
                             "fun_llm": frun["fused"], "qwen_parity": par["qwen_asr"]["counts"]["fused_decode"],
                             "mesh_training": mesh_tr["fused_decode"]},
        "max_abs_err": dec["max_abs_err"],
        "ms": dec["times"]["bfloat16"]["ms"],
        "plain_ms": dec["times"]["bfloat16"]["plain_ms"],
        "bound_ms": dec["times"]["bfloat16"]["bound_ms"],
        "bound_by": dec["times"]["bfloat16"]["bound_by"],
        "library_ms": None,
        "timing": "one Qwen3-0.6B q4 step with the packed tied head, bf16 caches, pos 440, shift 17, "
                  "CUDA events",
        "steps": {cache: {"ms": t["ms"], "graph_ms": t["profile"]["graph_ms"],
                          "busy_ms": t["profile"]["busy_ms"], "host_ms": t["profile"]["host_ms"],
                          "idle_share": t["profile"]["idle_share"], "unchained_parts_ms": t["profile"]["parts_ms"],
                          "launches_per_step": t["profile"]["launches_per_step"], "bound_ms": t["bound_ms"]}
                  for cache, t in dec["times"].items()},
        "matvec_alone_ms": {name: {key: m[key] for key in ("ms", "gb_s", "bound_ms", "tile")}
                            for name, m in step_mv.items()},
    }, {
        "name": "fused_decode_multi",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/fused_decode_multi.cu",
        "replaces": "asr_tpu/ops/fused_decode_multi.py:92",
        "launches": qcont["launches"] + fcont["launches"] + q55["dp"]["launches"] + mesh_tr["fused_decode_multi"],
        "launches_by_path": {"qwen_continuous": qcont["launches"], "fun_continuous": fcont["launches"],
                             "qwen_dp2_continuous": q55["dp"]["launches"],
                             "mesh_training": mesh_tr["fused_decode_multi"]},
        "max_abs_err": mdec["max_abs_err"],
        "ms": q_t["ms"],
        "plain_ms": q_t["plain_ms"],
        "bound_ms": q_t["bound_ms"],
        "bound_by": q_t["bound_by"],
        "library_ms": None,
        "timing": f"one Qwen3-0.6B q4 step of {QWEN_MULTI_TIMED_B[-1]} slots with the packed tied head, "
                  f"bf16 caches, every slot at pos {QWEN_MULTI_TIMED_POS}, CUDA events",
        "steps": {f"B={bs} {cache}": {"ms": t["ms"], "graph_ms": t["profile"]["graph_ms"],
                                      "busy_ms": t["profile"]["busy_ms"], "host_ms": t["profile"]["host_ms"],
                                      "idle_share": t["profile"]["idle_share"],
                                      "unchained_parts_ms": t["profile"]["parts_ms"],
                                      "launches_per_step": t["profile"]["launches_per_step"],
                                      "bound_ms": t["bound_ms"]}
                  for (bs, cache), t in mtimes.items()},
    }, {
        "name": "quant_matmul_int2",
        "route": "cuda",
        "source": "asr_tpu_torch/csrc/quant_matmul_int2.cu",
        "replaces": "asr_tpu/ops/quant_matmul.py:231",
        "launches": q2run["int2"] + q2serve["int2"] + q2cont["int2"] + mesh_tr["int2"],
        "launches_by_path": {"qwen_q2": q2run["int2"], "qwen_q2_serve": q2serve["int2"],
                             "qwen_q2_continuous": q2cont["int2"], "mesh_training": mesh_tr["int2"]},
        "max_abs_err": p2["max_abs_err"],
        "ms": p2["per_prefill"]["bf16"]["ms"],
        "plain_ms": p2["per_prefill"]["bf16"]["plain_ms"],
        "bound_ms": p2["per_prefill"]["bf16"]["bound_ms"],
        "bound_by": p2["per_prefill"]["bf16"]["bound_by"],
        "library_ms": p2["per_prefill"]["bf16"]["library_ms"],
        "library": "torch._weight_int4pack_mm (bf16, group 128) on the 2-bit values widened to nibbles, "
                   "the same 112 calls" + (f"; not timed: {p2['library_note']}" if p2["library_note"] else ""),
        "per_pass_ms": {f"M={m}": {key: t[key] for key in ("ms", "library_ms", "bound_ms")}
                        for m, t in p2["per_pass"].items()},
        "timing": f"sum over one 30 s prefill's 112 calls at M={qwen_prefill_rows(QwenAsrConfig())}, "
                  f"mm=bf16, device time of a CUDA graph of {GRAPH_CALLS} calls (the library call "
                  "likewise; the plain version with CUDA events); bound summed per call",
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
