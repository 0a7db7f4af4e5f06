"""Time a kernel built from two checkouts' sources against each other on one
card, in turns (A, B, B, A), and compare their results.

    python3 chip_ab_step.py OTHER_ROOT [aed|aed_multi|qwen|qwen_multi|p4|p2|int8]

A is built from ``OTHER_ROOT/asr_tpu_torch/csrc/<kernel>.cu`` (for example an
earlier commit unpacked with ``git archive``), B from this checkout's, on the
same inputs. ``aed`` (the default): the fused AED step
(``fused_aed_step.cu``) at the Whisper-Large-v3-Turbo q8 decoder geometry,
pos 447, 1500 cross rows; ``aed_multi``: the multi-slot AED step
(``fused_aed_multi.cu``) at the same geometry, 8 slots at pos 447 and 1500
cross rows. ``qwen``: the fused Qwen3 step (``fused_decode.cu``) at the Qwen3-ASR-0.6B q4
geometry with the packed tied head, pos 440, shift 17; ``qwen_multi``: the
multi-slot Qwen3 step (``fused_decode_multi.cu``) at the same geometry, 8
slots at pos 440. Each side of these four runs through its own checkout's
wrapper (``ops/fused_aed_step.py`` / ``ops/fused_aed_multi.py`` /
``ops/fused_decode.py`` / ``ops/fused_decode_multi.py``, loaded from that
checkout, so each passes its own C signature); each build's ptxas lines, ms
per step from CUDA events and from a CUDA graph of 10 steps, the largest
difference of the outputs (logits and the written cache rows; the Qwen
steps' hidden too) and whether they are bitwise equal (a redesigned step
sums in another order, so the two are not). All with f32 and bf16 caches
and random weights from a seed.
``p4`` / ``p2``: the packed-int4 / packed-int2 matmul
(``quant_matmul_int4.cu`` / ``quant_matmul_int2.cu``) at every (K, N) of
the Qwen3-ASR-0.6B q4 / q2 path and M = 1, 4, 8, 432, in both modes, each
side called through its own C signature (the split-K one, with the plan
of this checkout's wrapper, or the earlier one without a plan); ms per call
from a CUDA graph of back-to-back calls (device time, no host launch cost),
whether the f32-mode outputs are bitwise equal and the bf16-mode largest
difference, and the sums over one LLM pass. ``int8``: the int8 matmul
(``quant_matmul_int8.cu``) at every (M, K, N, block) of the main paths
(``chip_smoke.int8_paths``: SenseVoiceSmall, the Whisper encoder and
per-weight step, the Qwen3-ASR tower, the q2 head), in both modes, each side
through its own C signature (the planned one, with this checkout's
``int8_plan`` and a workspace, or the earlier one); the same timing, f32-mode
bitwise equality (exit 1 otherwise), the bf16-mode largest difference, and
the sums over each path. Exits 2 where no card is visible.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3  # A, B, B, A repeated
ITERS = 200


def _wrapper(root: Path, name: str):
    """``asr_tpu_torch/ops/<name>.py`` of the checkout at ``root`` as its own
    module, building from that checkout's ``csrc``."""
    import importlib.util

    path = root / "asr_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ab_{name}_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    mod.SOURCE = root / "asr_tpu_torch" / "csrc" / f"{name}.cu"
    mod._lib = None
    return mod


def _build_sides(name: str, other: Path) -> dict:
    """Each side's ``ops/<name>.py`` as its own module, built, with its ptxas lines printed."""
    mods = {}
    for label, root in (("A", other), ("B", ROOT)):
        mod = _wrapper(root, name)
        path, log = mod.build()
        print(f"[build {label}] {mod.SOURCE} -> {path.name}")
        for line in log.splitlines():
            if "registers" in line and "ptxas" in line:
                print(f"[build {label}] {line.strip()}")
        mods[label] = mod
    return mods


def _race(torch, cs, step) -> tuple[dict, dict]:
    """ms per step of A and B on CUDA events and in a CUDA graph of 10 steps,
    timed A, B, B, A, ROUNDS times."""
    ms = {"A": [], "B": []}
    gms = {"A": [], "B": []}
    for _ in range(ROUNDS):
        for label in ("A", "B", "B", "A"):
            ms[label].append(cs.time_ms(lambda: step(label), ITERS // 2, 10))
            gms[label].append(cs.graph_ms(torch, lambda: step(label), 10, 3))
    return ms, gms


def _report(which: str, where: str, ms: dict, gms: dict, diffs: list, names: str, same: bool,
            card: str) -> None:
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    gmean = {k: sum(v) / len(v) for k, v in gms.items()}
    print(f"[ab] {which} {where}: CUDA events A "
          f"{' '.join(f'{m:.4f}' for m in ms['A'])} ms (mean {mean['A']:.4f}); B "
          f"{' '.join(f'{m:.4f}' for m in ms['B'])} ms (mean {mean['B']:.4f}); A/B {mean['A'] / mean['B']:.2f}x; "
          f"CUDA graph of 10 steps A {gmean['A']:.4f} ms, B {gmean['B']:.4f} ms, A/B "
          f"{gmean['A'] / gmean['B']:.2f}x; largest difference relative to B's max ({names}): "
          f"{', '.join(f'{d:.2e}' for d in diffs)}; bitwise equal: {same}  [{card}]")


def aed_ab(torch, cs, which: str, other: Path, card: str) -> int:
    """A (OTHER_ROOT's AED step) against B (this checkout's), each through its
    own wrapper."""
    from asr_tpu_torch.models import whisper as wh
    from asr_tpu_torch.ops import fused_aed_step as fs
    from asr_tpu_torch.quant.quantize import quantize_pytree

    mods = _build_sides("fused_aed_step" if which == "aed" else "fused_aed_multi", other)
    cfg = wh.WhisperConfig(encoder_layers=0)
    g = torch.Generator(device="cuda").manual_seed(8)
    params = quantize_pytree(wh.init_params(cfg, g), bits=8, block=128, quantize_embeddings=True)
    stacked = fs.stack_whisper_step_params(params, cfg)
    del params
    for key in ("ba", "bb", "ln1_b", "lnc_b", "ln2_b", "lnf_b"):  # the init has zeros and ones
        stacked[key] = 0.1 * torch.randn(stacked[key].shape, generator=g, device="cuda")
    for key in ("ln1_s", "lnc_s", "ln2_s", "lnf_s"):
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device="cuda")
    geom = fs.AedGeom(cfg.d_model, cfg.ffn_dim, cfg.num_heads)
    nl, d, t, tc = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions, cfg.max_source_positions
    pos, tc_valid = cs.FUSED_POS[-1], cs.FUSED_TC[0]
    bs = 1 if which == "aed" else MULTI_AB_SLOTS
    for cdt in (torch.float32, torch.bfloat16):
        shape = (lambda r: (nl, r, d)) if which == "aed" else (lambda r: (nl, bs, r, d))
        ks, vs = (torch.randn(shape(t), generator=g, device="cuda").to(cdt) for _ in range(2))
        ck, cv = (torch.randn(shape(tc), generator=g, device="cuda").to(cdt) for _ in range(2))
        x = torch.randn((bs, d), generator=g, device="cuda") * 0.05
        pos_t = torch.full((bs,), pos, dtype=torch.int32, device="cuda")
        tcv_t = torch.full((bs,), tc_valid, dtype=torch.int32, device="cuda")

        def step(label):  # row `pos` is rewritten with the same values each call
            if which == "aed":
                lg, k, v = mods[label].fused_aed_step_cuda(stacked, geom, x, ks, vs, ck, cv, pos, tc_valid)
                return lg, k[:, pos].clone(), v[:, pos].clone()
            lg, k, v = mods[label].fused_aed_step_multi_cuda(stacked, geom, x, ks, vs, ck, cv, pos_t, tcv_t)
            return lg, k[:, :, pos].clone(), v[:, :, pos].clone()

        outs = {label: [o.clone() for o in step(label)] for label in ("A", "B")}
        diffs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                 for a, b in zip(outs["A"], outs["B"])]
        same = all(torch.equal(a, b) for a, b in zip(outs["A"], outs["B"]))
        ms, gms = _race(torch, cs, step)
        cache = str(cdt).split(".")[-1]
        _report(which, f"B={bs} cache={cache:8s} pos={pos} tc_valid={tc_valid}", ms, gms, diffs,
                "logits, k row, v row", same, card)
    return 0


def qwen_ab(torch, cs, which: str, other: Path, card: str) -> int:
    """A (OTHER_ROOT's Qwen3 step) against B (this checkout's), each through
    its own wrapper."""
    from asr_tpu_torch.layers import qwen3
    from asr_tpu_torch.layers.rope import rope_tables
    from asr_tpu_torch.ops import fused_decode as fd
    from asr_tpu_torch.quant.quantize import quantize_pytree

    mods = _build_sides("fused_decode" if which == "qwen" else "fused_decode_multi", other)
    cfg = qwen3.Qwen3Config()
    g = torch.Generator(device="cuda").manual_seed(15)
    params = qwen3.fuse_params(quantize_pytree(qwen3.init_params(cfg, g), bits=4, pack=True,
                                               refine_iters=0, quantize_embeddings=True), cfg)
    stacked = fd.stack_decode_params(params, cfg)
    del params
    for key in ("in_s", "post_s", "qn_s", "kn_s", "fn_s"):  # the init has ones
        stacked[key] = 1 + 0.1 * torch.randn(stacked[key].shape, generator=g, device="cuda")
    nl, kvw, t = cfg.num_layers, cfg.num_kv_heads * 128, 464
    tab = torch.from_numpy(rope_tables(t, 128, cfg.rope_theta)).cuda()
    bs = 1 if which == "qwen" else MULTI_AB_SLOTS
    (pos, shift) = cs.QWEN_DECODE_POS[-1] if which == "qwen" else (cs.QWEN_MULTI_TIMED_POS, 0)
    cos = tab[0, pos - shift].expand(bs, -1).contiguous()
    sin = tab[1, pos - shift].expand(bs, -1).contiguous()
    for cdt in (torch.float32, torch.bfloat16):
        shape = (nl, t, kvw) if which == "qwen" else (nl, bs, t, kvw)
        kc, vc = (torch.randn(shape, generator=g, device="cuda").to(cdt) for _ in range(2))
        x = torch.randn((bs, cfg.hidden), generator=g, device="cuda") * 0.05
        pos_t = torch.full((bs,), pos, dtype=torch.int32, device="cuda")

        def step(label):  # row `pos` is rewritten with the same values each call
            if which == "qwen":
                h, lg, k, v = mods[label].fused_decode_step_cuda(stacked, cfg, x, kc, vc, pos, shift, cos, sin)
                return h, lg, k[:, pos].clone(), v[:, pos].clone()
            h, lg, k, v = mods[label].fused_decode_step_multi_cuda(stacked, cfg, x, kc, vc, pos_t, cos, sin)
            return h, lg, k[:, :, pos].clone(), v[:, :, pos].clone()

        outs = {label: [o.clone() for o in step(label)] for label in ("A", "B")}
        diffs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                 for a, b in zip(outs["A"], outs["B"])]
        same = all(torch.equal(a, b) for a, b in zip(outs["A"], outs["B"]))
        ms, gms = _race(torch, cs, step)
        cache = str(cdt).split(".")[-1]
        _report(which, f"B={bs} cache={cache:8s} pos={pos} shift={shift}", ms, gms, diffs,
                "hidden, logits, k row, v row", same, card)
    return 0


MULTI_AB_SLOTS = 8
PACKED_M = (1, 4, 8, 432)


def _packed_fn(lib, name: str, source: Path):
    """The C entry point with the argtypes its source declares: the split-K
    signature (with a workspace and a plan) or the earlier one."""
    import ctypes

    fn = getattr(lib, name)
    split = "int splits" in source.read_text()
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 if split
                   else [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, split


def packed_ab(torch, cs, which: str, other: Path, card: str) -> int:
    """A (OTHER_ROOT's packed kernel) against B (this checkout's)."""
    import ctypes

    from asr_tpu_torch.ops import nvcc_build
    from asr_tpu_torch.ops import quant_matmul as qm
    from asr_tpu_torch.quant.quantize import quantize_linear

    bits, parts = (4, 2) if which == "p4" else (2, 4)
    name = f"quant_matmul_int{bits}"
    shapes = cs.QWEN_P4_SHAPES if which == "p4" else cs.QWEN_P2_SHAPES
    fns = {}
    for label, root in (("A", other), ("B", ROOT)):
        source = root / "asr_tpu_torch" / "csrc" / f"{name}.cu"
        path, log = nvcc_build.build(source)
        print(f"[build {label}] {source} -> {path.name}")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"[build {label}] {line.strip()}")
        fns[label] = _packed_fn(ctypes.CDLL(str(path)), name, source)

    g = torch.Generator(device="cuda").manual_seed(21 if which == "p2" else 14)
    rows, all_f32_equal = [], True
    for (k, n), count in shapes.items():
        leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, bits, 128,
                               pack=True)
        for m in PACKED_M:
            x = torch.randn((m, k), generator=g, device="cuda")
            for mm in ("f32", "bf16"):
                s, bn, bm = qm.packed_plan(m, k, n, parts, 128) if mm == "bf16" else (1, 0, 0)
                ws = torch.empty(qm.packed_workspace(m, k), device="cuda") if mm == "bf16" else None
                outs = {lab: torch.empty((m, n), device="cuda") for lab in ("A", "B")}

                def call(label, s=s, bn=bn, bm=bm, ws=ws, x=x, m=m, mm=mm):
                    fn, split = fns[label]
                    stream = torch.cuda.current_stream().cuda_stream  # the graph's, while capturing
                    ptrs = [t.data_ptr() for t in (x, leaf.q, leaf.scale, leaf.zero, outs[label])]
                    if split:
                        err = fn(*ptrs, None if ws is None else ws.data_ptr(), m, k, n, 128,
                                 int(mm == "bf16"), s, bn, bm, stream)
                    else:
                        err = fn(*ptrs, m, k, n, 128, int(mm == "bf16"), stream)
                    if err:
                        raise RuntimeError(f"{label}: CUDA error {err}")

                call("A")
                call("B")
                torch.cuda.synchronize()
                diff = (outs["A"] - outs["B"]).abs().max().item()
                same = torch.equal(outs["A"], outs["B"])
                if mm == "f32":
                    all_f32_equal &= same
                ms = {"A": [], "B": []}
                for _ in range(ROUNDS):
                    for label in ("A", "B", "B", "A"):
                        ms[label].append(cs.graph_ms(torch, lambda label=label: call(label)))
                a_ms, b_ms = (sum(v) / len(v) for v in (ms["A"], ms["B"]))
                rows.append({"k": k, "n": n, "m": m, "mm": mm, "count": count, "A": a_ms, "B": b_ms})
                print(f"[ab] {which} M={m:4d} K={k:4d} N={n:6d} mm={mm:4s} plan S={s} BN={bn} BM={bm}: "
                      f"A {' '.join(f'{v:.4f}' for v in ms['A'])} ms (mean {a_ms:.4f}); "
                      f"B {' '.join(f'{v:.4f}' for v in ms['B'])} ms (mean {b_ms:.4f}); "
                      f"A/B {a_ms / b_ms:.2f}x; max|A - B| {diff:.3e}, bitwise equal: {same}  [{card}]")
    calls = sum(shapes.values())
    for mm in ("bf16", "f32"):
        for m in PACKED_M:
            a = sum(r["count"] * r["A"] for r in rows if r["m"] == m and r["mm"] == mm)
            b = sum(r["count"] * r["B"] for r in rows if r["m"] == m and r["mm"] == mm)
            print(f"[ab] {which} one pass's {calls} calls at M={m} mm={mm}: A {a:.4f} ms, B {b:.4f} ms, "
                  f"A/B {a / b:.2f}x  [{card}]")
    print(f"[ab] {which} f32-mode outputs bitwise equal at every shape: {all_f32_equal}")
    return 0 if all_f32_equal else 1


def _int8_fn(lib, source: Path):
    """quant_matmul_int8 with the argtypes its source declares: the planned
    signature (a workspace, V, BN, BM, walk) or the earlier one."""
    import ctypes

    fn = lib.quant_matmul_int8
    planned = "int walk" in source.read_text()
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 if planned
                   else [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, planned


def int8_ab(torch, cs, other: Path, card: str) -> int:
    """A (OTHER_ROOT's int8 kernel) against B (this checkout's)."""
    import ctypes

    from asr_tpu_torch.ops import nvcc_build
    from asr_tpu_torch.ops import quant_matmul as qm
    from asr_tpu_torch.quant.quantize import quantize_linear

    fns = {}
    for label, root in (("A", other), ("B", ROOT)):
        source = root / "asr_tpu_torch" / "csrc" / "quant_matmul_int8.cu"
        path, log = nvcc_build.build(source)
        print(f"[build {label}] {source} -> {path.name}")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                print(f"[build {label}] {line.strip()}")
        fns[label] = _int8_fn(ctypes.CDLL(str(path)), source)

    paths = cs.int8_paths()
    calls = sorted({key for path_calls in paths.values() for key in path_calls}, key=lambda c: c[1:] + c[:1])
    g = torch.Generator(device="cuda").manual_seed(8)
    leaves, times, all_f32_equal = {}, {}, True
    for m, k, n, block in calls:
        if (k, n) not in leaves:
            leaves.clear()  # one weight at a time: the q2 head alone is 156 MB
            w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
            leaves[(k, n)] = quantize_linear(w, 8, 128)
        leaf = leaves[(k, n)]
        x = torch.randn((m, k), generator=g, device="cuda")
        for mm in ("f32", "bf16"):
            plan = qm.int8_plan(m, k, n, block) if mm == "bf16" else (1, 0, 0, False)
            ws = torch.empty(qm.int8_workspace(m, k, block), device="cuda") if mm == "bf16" else None
            outs = {lab: torch.empty((m, n), device="cuda") for lab in ("A", "B")}

            def call(label, plan=plan, ws=ws, x=x, m=m, k=k, n=n, block=block, mm=mm, leaf=leaf):
                fn, planned = fns[label]
                stream = torch.cuda.current_stream().cuda_stream  # the graph's, while capturing
                ptrs = [t.data_ptr() for t in (x, leaf.q, leaf.scale, leaf.zero, outs[label])]
                if planned:
                    err = fn(*ptrs, None if ws is None else ws.data_ptr(), m, k, n, block, int(mm == "bf16"),
                             plan[0], plan[1], plan[2], int(plan[3]), stream)
                else:
                    err = fn(*ptrs, m, k, n, block, int(mm == "bf16"), stream)
                if err:
                    raise RuntimeError(f"{label}: CUDA error {err}")

            call("A")
            call("B")
            torch.cuda.synchronize()
            diff = (outs["A"] - outs["B"]).abs().max().item()
            same = torch.equal(outs["A"], outs["B"])
            if mm == "f32":
                all_f32_equal &= same
            ms = {"A": [], "B": []}
            for _ in range(ROUNDS):
                for label in ("A", "B", "B", "A"):
                    ms[label].append(cs.graph_ms(torch, lambda label=label: call(label),
                                                 cs.INT8_GRAPH_CALLS["f32"], 3))
            a_ms, b_ms = (sum(v) / len(v) for v in (ms["A"], ms["B"]))
            times[(m, k, n, block, mm)] = (a_ms, b_ms)
            plan_txt = (f"plan V={plan[0]} BN={plan[1]} BM={plan[2]} {'walk' if plan[3] else 'cluster'} "
                        if mm == "bf16" else "")
            print(f"[ab] int8 M={m:5d} K={k:5d} N={n:6d} mm={mm:4s} {plan_txt}"
                  f"A {' '.join(f'{v:.4f}' for v in ms['A'])} ms (mean {a_ms:.4f}); "
                  f"B {' '.join(f'{v:.4f}' for v in ms['B'])} ms (mean {b_ms:.4f}); "
                  f"A/B {a_ms / b_ms:.2f}x; max|A - B| {diff:.3e}, bitwise equal: {same}  [{card}]")
    for name, path_calls in paths.items():
        for mm in ("bf16", "f32"):
            a = sum(c * times[key + (mm,)][0] for key, c in path_calls.items())
            b = sum(c * times[key + (mm,)][1] for key, c in path_calls.items())
            print(f"[ab] int8 {name}'s {sum(path_calls.values())} calls, mm={mm}: A {a:.4f} ms, "
                  f"B {b:.4f} ms, "
                  f"A/B {a / b:.2f}x  [{card}]")
    print(f"[ab] int8 f32-mode outputs bitwise equal at every shape: {all_f32_equal}")
    return 0 if all_f32_equal else 1


def main() -> int:
    if len(sys.argv) not in (2, 3) or (len(sys.argv) == 3 and
                                       sys.argv[2] not in ("aed", "aed_multi", "qwen", "qwen_multi", "p4",
                                                           "p2", "int8")):
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

    if which in ("p4", "p2"):
        return packed_ab(torch, cs, which, other, cs.phase_device(torch))
    if which == "int8":
        return int8_ab(torch, cs, other, cs.phase_device(torch))
    if which in ("qwen", "qwen_multi"):
        return qwen_ab(torch, cs, which, other, cs.phase_device(torch))
    return aed_ab(torch, cs, which, other, cs.phase_device(torch))


if __name__ == "__main__":
    sys.exit(main())
