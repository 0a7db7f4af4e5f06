"""Time a batch-1 fused decode-step kernel built from two checkouts' sources
against each other on one card, in turns (A, B, B, A), and compare their
results.

    python3 chip_ab_step.py OTHER_ROOT [aed|qwen]

A is built from ``OTHER_ROOT/asr_tpu_torch/csrc/<kernel>.cu`` (for example an
earlier commit unpacked with ``git archive``), B from this checkout's; both
keep the same C interface and are driven through this checkout's wrapper on
the same inputs. ``aed`` (the default): the fused AED step
(``fused_aed_step.cu``) at the Whisper-Large-v3-Turbo q8 decoder geometry,
pos 447, 1500 cross rows. ``qwen``: the fused Qwen3 step
(``fused_decode.cu``) at the Qwen3-ASR-0.6B q4 geometry with the packed tied
head, pos 440, shift 17. Both with f32 and bf16 caches and random weights
from a seed. Prints each build's ptxas lines, ms per step for A and B, the
largest difference of their outputs and whether they are bitwise equal.
Exits 2 where no card is visible.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3  # A, B, B, A repeated
ITERS = 200


def _aed_case(torch, cs, fs):
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.quant.quantize import quantize_pytree

    cfg = wh.WhisperConfig(encoder_layers=0)
    g = torch.Generator(device="cuda").manual_seed(8)
    params = quantize_pytree(wh.init_params(cfg, g), bits=8, block=128, quantize_embeddings=True)
    stacked = fs.stack_whisper_step_params(params, cfg)
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.max_source_positions
    pos, tc_valid = cs.FUSED_POS[-1], cs.FUSED_TC[0]

    def inputs(cdt):
        ks, vs = (torch.randn((nl, t, d), generator=g, device="cuda").to(cdt) for _ in range(2))
        ck, cv = (torch.randn((nl, tc, d), generator=g, device="cuda").to(cdt) for _ in range(2))
        x = torch.randn((1, d), generator=g, device="cuda") * 0.05

        def step():  # row `pos` is rewritten with the same values each call
            return fs.fused_aed_step_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tc_valid)[:1]
        return step

    return inputs, f"pos={pos} tc_valid={tc_valid}"


def _qwen_case(torch, cs, fd):
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.layers.rope import rope_tables
    from asr_tpu_torch.quant.quantize import quantize_pytree

    cfg = qwen3.Qwen3Config()
    g = torch.Generator(device="cuda").manual_seed(15)
    params = qwen3.fuse_params(quantize_pytree(qwen3.init_params(cfg, g), bits=4, pack=True,
                                               refine_iters=0, quantize_embeddings=True), cfg)
    stacked = fd.stack_decode_params(params, cfg)
    del params
    for key in ("in_s", "post_s", "qn_s", "kn_s", "fn_s"):  # the init has ones
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device="cuda")
    nl, kvw, t = cfg.num_layers, cfg.num_kv_heads * 128, 464
    (pos, shift) = cs.QWEN_DECODE_POS[-1]
    tab = torch.from_numpy(rope_tables(t, 128, cfg.rope_theta)).cuda()
    cos, sin = tab[0, pos - shift][None], tab[1, pos - shift][None]

    def inputs(cdt):
        kc, vc = (torch.randn((nl, t, kvw), generator=g, device="cuda").to(cdt) for _ in range(2))
        x = torch.randn((1, cfg.hidden), generator=g, device="cuda") * 0.05

        def step():  # row `pos` is rewritten with the same values each call
            h, lg, k, v = fd.fused_decode_step_cuda(stacked, cfg, x, kc, vc, pos, shift, cos, sin)
            return h, lg, k[:, pos].clone(), v[:, pos].clone()
        return step

    return inputs, f"pos={pos} shift={shift}"


def main() -> int:
    if len(sys.argv) not in (2, 3) or (len(sys.argv) == 3 and sys.argv[2] not in ("aed", "qwen")):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    which = sys.argv[2] if len(sys.argv) == 3 else "aed"
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if which == "aed":
        from asr_tpu_torch.ops import fused_aed_step as mod
        source, marker = "fused_aed_step.cu", "q8_matvec"
    else:
        from asr_tpu_torch.ops import fused_decode as mod
        source, marker = "fused_decode.cu", "p4_matvec"
    card = cs.phase_device(torch)
    libs = {}
    for label, root in (("A", other), ("B", ROOT)):
        mod._lib = None
        mod.SOURCE = root / "asr_tpu_torch" / "csrc" / source
        path, log = mod.build()
        print(f"[build {label}] {mod.SOURCE} -> {path.name}")
        for line in log.splitlines():
            if marker in line or ("registers" in line and "ptxas" in line):
                print(f"[build {label}] {line.strip()}")
        libs[label] = mod._load()

    inputs, where = (_aed_case if which == "aed" else _qwen_case)(torch, cs, mod)
    for cdt in (torch.float32, torch.bfloat16):
        step = inputs(cdt)

        def run(label):
            mod._lib = libs[label]
            return step()

        outs = {label: [o.clone() for o in run(label)] for label in ("A", "B")}
        diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs["A"], outs["B"]))
        same = all(torch.equal(a, b) for a, b in zip(outs["A"], outs["B"]))
        ms = {"A": [], "B": []}
        for _ in range(ROUNDS):
            for label in ("A", "B", "B", "A"):
                ms[label].append(cs.time_ms(lambda: run(label), ITERS, 10))
        cache = str(cdt).split(".")[-1]
        print(f"[ab] {which} cache={cache:8s} {where}: "
              f"A {' '.join(f'{m:.4f}' for m in ms['A'])} ms (mean {sum(ms['A']) / len(ms['A']):.4f}); "
              f"B {' '.join(f'{m:.4f}' for m in ms['B'])} ms (mean {sum(ms['B']) / len(ms['B']):.4f}); "
              f"max|A - B| {diff:.3e}, bitwise equal: {same}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
