"""Time the batch-1 fused AED decode-step kernel built from two checkouts'
sources against each other on one card, in turns (A, B, B, A), at the
Whisper-Large-v3-Turbo q8 decoder geometry.

    python3 chip_ab_step.py OTHER_ROOT

A is built from ``OTHER_ROOT/asr_tpu_torch/csrc/fused_aed_step.cu`` (for
example an earlier commit unpacked with ``git archive``), B from this
checkout's; both keep the same C interface and are driven through this
checkout's wrapper on the same inputs (random q8 weights from a seed, pos
447, 1500 cross rows, f32 and bf16 caches). Prints each build's ptxas
lines, ms per step for A and B, and the largest difference of their logits.
Exits 2 where no card is visible.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3  # A, B, B, A repeated
ITERS = 200


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.quant.quantize import quantize_pytree

    card = cs.phase_device(torch)
    libs = {}
    for label, root in (("A", other), ("B", ROOT)):
        fs._lib = None
        fs.SOURCE = root / "asr_tpu_torch" / "csrc" / "fused_aed_step.cu"
        path, log = fs.build()
        print(f"[build {label}] {fs.SOURCE} -> {path.name}")
        for line in log.splitlines():
            if "q8_matvec" in line or ("registers" in line and "ptxas" in line):
                print(f"[build {label}] {line.strip()}")
        libs[label] = fs._load()

    cfg = wh.WhisperConfig(encoder_layers=0)
    g = torch.Generator(device="cuda").manual_seed(8)
    params = quantize_pytree(wh.init_params(cfg, g), bits=8, block=128, quantize_embeddings=True)
    stacked = fs.stack_whisper_step_params(params, cfg)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc, v = (cfg.decoder_layers, cfg.d_model, cfg.max_target_positions,
                       cfg.max_source_positions, cfg.vocab_size)
    pos, tc_valid = cs.FUSED_POS[-1], cs.FUSED_TC[0]
    for cdt in (torch.float32, torch.bfloat16):
        ks, vs = (torch.randn((nl, t, d), generator=g, device="cuda").to(cdt) for _ in range(2))
        ck, cv = (torch.randn((nl, tc, d), generator=g, device="cuda").to(cdt) for _ in range(2))
        x = torch.randn((1, d), generator=g, device="cuda") * 0.05

        def run(label):
            fs._lib = libs[label]  # row `pos` is rewritten with the same values each call
            return fs.fused_aed_step_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tc_valid)[0]

        diff = (run("A")[:, :v] - run("B")[:, :v]).abs().max().item()
        ms = {"A": [], "B": []}
        for _ in range(ROUNDS):
            for label in ("A", "B", "B", "A"):
                ms[label].append(cs.time_ms(lambda: run(label), ITERS, 10))
        cache = str(cdt).split(".")[-1]
        print(f"[ab] cache={cache:8s} pos={pos} tc_valid={tc_valid}: "
              f"A {' '.join(f'{m:.4f}' for m in ms['A'])} ms (mean {sum(ms['A']) / len(ms['A']):.4f}); "
              f"B {' '.join(f'{m:.4f}' for m in ms['B'])} ms (mean {sum(ms['B']) / len(ms['B']):.4f}); "
              f"max|logits A - B| {diff:.3e}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
