"""Declarative serving-optimization plans.

TPU analog of the reference's optimizer recipe system
(``Optimize_ONNX_Common.py``: ``Plan`` :85, ``OptimizerConfig`` :137,
``ResolvedPlan`` :198, ``resolve_plan`` :250, ``validate_plan`` :319): a
per-model-component declarative recipe (serving dtype / weight-only quant
method, algorithm, block size, include/exclude patterns) with plan
inheritance and fail-closed validation. The reference's recipes drive an
ONNX graph pipeline; here they drive pytree casts and block quantization —
everything else the reference's pipeline does (op fusion, cast removal,
slimming) is XLA's job.

The port's copy of ``asr_tpu/quant/plan.py``: the same JSON, plans,
resolution and walk over torch trees (quantization runs where the tree
lies, on the card when it is there).

Pattern keys are fnmatch globs over parameter paths (``encoder/*``,
``*/decoder/*/w1``); the first matching pattern in declaration order wins,
with ``"*"`` as the customary default row.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
from pathlib import Path
from typing import Any

import torch

METHODS = ("f32", "bf16", "q8", "q4", "q2")
ALGORITHMS = ("rtn", "kquant", "hqq", "dynamic")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One component recipe. ``inherit`` names another plan in the same
    config whose fields serve as defaults for fields left at None."""

    method: str | None = None          # f32 | bf16 | q8 | q4 | q2
    algorithm: str | None = None       # rtn | kquant | hqq | dynamic
    block: int | None = None
    refine_iters: int | None = None
    pack: bool | None = None
    min_size: int | None = None        # skip linear weights smaller than this
    exclude: tuple[str, ...] = ()      # path globs never quantized/cast
    embeddings: bool | None = None     # also quantize matching "embed" tables
    inherit: str | None = None


@dataclasses.dataclass(frozen=True)
class ResolvedPlan:
    method: str = "f32"
    algorithm: str = "rtn"
    block: int = 128
    refine_iters: int = 2
    pack: bool = False
    min_size: int = 1 << 16
    exclude: tuple[str, ...] = ()
    embeddings: bool = False

    @property
    def bits(self) -> int | None:
        return {"q8": 8, "q4": 4, "q2": 2}.get(self.method)


@dataclasses.dataclass
class OptimizerConfig:
    """Named plans + the pattern table mapping parameter paths to them."""

    plans: dict[str, Plan] = dataclasses.field(default_factory=dict)
    # ordered (path glob, plan name); first match wins.
    assign: tuple[tuple[str, str], ...] = (("*", "default"),)

    @classmethod
    def load(cls, path: str | Path) -> "OptimizerConfig":
        raw = json.loads(Path(path).read_text(encoding="utf-8"))
        plans = {name: Plan(**{**p, "exclude": tuple(p.get("exclude", ()))})
                 for name, p in raw.get("plans", {}).items()}
        assign = tuple((str(a[0]), str(a[1])) for a in raw.get("assign", [["*", "default"]]))
        return cls(plans=plans, assign=assign)

    def save(self, path: str | Path) -> None:
        payload = {
            "plans": {n: {k: v for k, v in dataclasses.asdict(p).items() if v not in (None, ())}
                      for n, p in self.plans.items()},
            "assign": [list(a) for a in self.assign],
        }
        Path(path).write_text(json.dumps(payload, indent=2), encoding="utf-8")


class PlanError(ValueError):
    pass


def resolve_plan(cfg: OptimizerConfig, name: str) -> ResolvedPlan:
    """Walk the inherit chain (fail-closed: unknown names and cycles are
    errors, like the reference's resolve_plan/validate_plan)."""
    chain: list[Plan] = []
    seen: set[str] = set()
    cur: str | None = name
    while cur is not None:
        if cur in seen:
            raise PlanError(f"plan inheritance cycle through {cur!r}")
        if cur not in cfg.plans:
            raise PlanError(f"unknown plan {cur!r}; have {sorted(cfg.plans)}")
        seen.add(cur)
        plan = cfg.plans[cur]
        chain.append(plan)
        cur = plan.inherit

    resolved: dict[str, Any] = {}
    exclude: list[str] = []
    for plan in reversed(chain):  # base first, derived overrides
        for f in ("method", "algorithm", "block", "refine_iters", "pack",
                  "min_size", "embeddings"):
            v = getattr(plan, f)
            if v is not None:
                resolved[f] = v
        exclude.extend(plan.exclude)
    rp = ResolvedPlan(**resolved, exclude=tuple(dict.fromkeys(exclude)))
    validate_plan(rp)
    return rp


def validate_plan(plan: ResolvedPlan) -> None:
    if plan.method not in METHODS:
        raise PlanError(f"method {plan.method!r} not in {METHODS}")
    if plan.algorithm not in ALGORITHMS:
        raise PlanError(f"algorithm {plan.algorithm!r} not in {ALGORITHMS}")
    if plan.block <= 0 or plan.block % 8 != 0:
        raise PlanError(f"block must be a positive multiple of 8, got {plan.block}")
    if plan.refine_iters < 0:
        raise PlanError(f"refine_iters must be >= 0, got {plan.refine_iters}")
    if plan.pack and plan.method not in ("q4", "q2"):
        raise PlanError(f"pack requires q4/q2, got method {plan.method!r}")


def plan_for_path(cfg: OptimizerConfig, path: str) -> ResolvedPlan | None:
    """First matching assignment row, or None (leave untouched)."""
    for pattern, name in cfg.assign:
        if fnmatch.fnmatch(path, pattern):
            return resolve_plan(cfg, name)
    return None


def apply_plans(params, cfg: OptimizerConfig):
    """Apply the config to a parameter pytree: each path is matched to a
    plan; q* methods block-quantize eligible 2-D linear weights (plus
    ``embed`` tables into gather-dequant :class:`QuantizedEmbedding` leaves
    when the plan sets ``embeddings``), bf16 casts floating leaves, f32
    leaves things alone. ``exclude`` globs on the matched plan veto
    individual paths.

    Depthwise-conv kernels (``dw``/``dw1``/``dw2`` parents) are always
    skipped: they are stored as 2-D ``{"w": (K, C)}`` dicts but consumed
    ELEMENTWISE (``depthwise_conv1d_time`` indexes ``weight[k]``), not
    through ``dense()`` — quantizing them would hand the model a
    QuantizedLinear where it expects a raw array (same guard as
    :func:`asr_tpu_torch.quant.quantize.quantize_pytree`)."""
    from asr_tpu_torch.quant.quantize import quantize_embedding, quantize_linear

    non_matmul_parents = ("dw", "dw1", "dw2")

    # Validate every referenced plan up front (fail closed before touching weights).
    for _, name in cfg.assign:
        resolve_plan(cfg, name)

    def walk(node, path):
        parent = path.rsplit("/", 1)[-1]
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                p = f"{path}/{key}" if path else key
                plan = plan_for_path(cfg, p)
                if plan is not None and any(fnmatch.fnmatch(p, g) for g in plan.exclude):
                    plan = None
                if (
                    plan is not None
                    and plan.bits is not None
                    and key in ("w", "w1", "w2")
                    and parent not in non_matmul_parents
                    and isinstance(value, torch.Tensor)
                    and value.ndim == 2
                    and value.numel() >= plan.min_size
                ):
                    out[key] = quantize_linear(
                        value, bits=plan.bits, block=plan.block,
                        refine_iters=plan.refine_iters, pack=plan.pack,
                        objective=plan.algorithm,
                    )
                elif (
                    plan is not None
                    and plan.bits is not None
                    and plan.embeddings
                    and key == "embed"
                    and isinstance(value, torch.Tensor)
                    and value.ndim == 2
                    and value.numel() >= plan.min_size
                ):
                    out[key] = quantize_embedding(
                        value,
                        max(plan.bits, 8) if plan.algorithm == "dynamic" else plan.bits,
                        plan.block,
                        objective="rtn" if plan.algorithm == "dynamic" else plan.algorithm,
                    )
                elif (
                    plan is not None and plan.method == "bf16"
                    and isinstance(value, torch.Tensor)
                    and value.is_floating_point()
                ):
                    out[key] = value.to(torch.bfloat16)
                else:
                    out[key] = walk(value, p)
            return out
        if isinstance(node, (list, tuple)):
            walked = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return type(node)(walked) if isinstance(node, tuple) else walked
        return node

    return walk(params, "")
