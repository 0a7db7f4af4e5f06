"""Training checkpoint save/restore.

Counterpart of ``asr_tpu/parallel/checkpoint.py``: (params, opt_state,
step) persist under ``step_{:08d}`` folders so fine-tuning runs can resume.
The JAX package writes orbax checkpoints; the port writes its own: one
safetensors file (the port's writer, no pickle) of every tensor leaf of
``{"params": ..., "opt_state": ...}`` under ``flatten_pytree``'s names
(``params/…``, ``opt_state/count``, ``opt_state/mu/…``), the step in the
file's metadata. A checkpoint of one package does not load into the other;
parameters cross between them through artifacts.

A save writes into a hidden folder that ``step_*`` does not match and
renames it into place when the file is whole, so an interrupted save leaves
no ``step_*`` folder behind (orbax commits atomically too).

A tree laid out on a mesh (``parallel/mesh.ShardedParams``: the parameters
and the AdamW moments of a mesh step) is saved whole, through
``mesh.gather_params``, so the file is the unsharded layout's, as orbax's
global arrays give the JAX package; a restore into a laid-out template
shards what it reads by the template's specs. A checkpoint written at one
layout resumes at any other.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any

import torch

from asr_tpu_torch.parallel.mesh import ShardedParams, gather_params, shard_params
from asr_tpu_torch.runtime.artifact import (
    read_safetensors,
    read_safetensors_metadata,
    tensor_from_numpy,
    tensor_to_numpy,
    write_safetensors,
)
from asr_tpu_torch.streaming.multistream import tree_map

STATE_FILENAME = "train_state.safetensors"


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """The tensor leaves of a dict / list / tuple tree with
    ``flatten_pytree``'s names, in its order, without copying them."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in named_leaves(v, f"{prefix}{i}/")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"{prefix[:-1]}: a training tree holds tensors, not {type(tree).__name__}")
    return [(prefix[:-1], tree)]


def tree_leaves(tree: Any, like: Any = None) -> list[torch.Tensor]:
    """The tensor leaves of ``tree``; with ``like``, in the order of
    ``like``'s leaves of the same names (trees whose dicts were built in
    another key order line up)."""
    named = named_leaves(tree)
    if like is None:
        return [t for _, t in named]
    by_name = dict(named)
    return [by_name[name] for name, _ in named_leaves(like)]


def unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its tensor leaves replaced, in
    :func:`named_leaves` order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _whole(tree: Any, device) -> Any:
    """``tree`` with every laid-out subtree gathered whole on ``device``."""
    if isinstance(tree, ShardedParams):
        return gather_params(tree, device)
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_whole(v, device) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def _relaid(template: Any, tree: Any) -> Any:
    """``tree`` (whole) with every subtree where ``template`` holds a
    laid-out one sharded as that one is."""
    if isinstance(template, ShardedParams):
        return shard_params(tree, template.mesh, template.specs, own=template.own)
    if isinstance(template, dict):
        return {k: _relaid(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_relaid(v, t) for v, t in zip(template, tree)]
        return tuple(out) if isinstance(template, tuple) else out
    return tree


def _step_dir(path: Path, step: int) -> Path:
    return path / f"step_{step:08d}"


def save_train_state(path: str | Path, params: Any, opt_state: Any, step: int) -> None:
    """Write ``{"params", "opt_state"}`` at ``step``; laid-out trees whole."""
    path = Path(path).resolve()
    final = _step_dir(path, step)
    if final.exists():
        raise FileExistsError(f"{final} exists")
    partial = path / f".step_{step:08d}.partial"  # hidden from latest_step's step_* glob
    if partial.exists():
        shutil.rmtree(partial)  # what an interrupted save of this step left
    partial.mkdir(parents=True)
    flat = {name: tensor_to_numpy(t).reshape(t.shape)  # a 0-d leaf (the count) stays 0-d
            for name, t in named_leaves(_whole({"params": params, "opt_state": opt_state}, "cpu"))}
    write_safetensors(partial / STATE_FILENAME, flat, metadata={"step": str(int(step))})
    os.replace(partial, final)


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    if not path.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in path.glob("step_*"))
    return steps[-1] if steps else None


def restore_train_state(path: str | Path, template: Any, step: int | None = None):
    """-> (params, opt_state, step) from ``path``'s checkpoint at ``step``
    (default: the latest), every leaf on the device of the ``template``'s
    leaf of the same name (``template``: ``{"params", "opt_state"[, "step"]}``);
    where the template holds a laid-out tree (``ShardedParams``), what is
    read is laid out as it is, on its mesh. Raises ValueError when the
    stored tree's names, shapes or dtypes differ from the (whole) template's."""
    path = Path(path).resolve()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    file = _step_dir(path, step) / STATE_FILENAME
    laid = {"params": template["params"], "opt_state": template["opt_state"]}
    want_tree = _whole(laid, "meta")  # names, shapes and dtypes only
    want = named_leaves(want_tree)
    flat = read_safetensors(file)
    got = {name: tensor_from_numpy(a) for name, a in flat.items()}
    del flat  # the file's bytes
    if sorted(got) != sorted(name for name, _ in want):
        missing = sorted({n for n, _ in want} - set(got))
        extra = sorted(set(got) - {n for n, _ in want})
        raise ValueError(f"{file}: the stored tree differs from the template's "
                         f"(missing {missing[:3]}, extra {extra[:3]})")
    bad = [name for name, t in want if got[name].shape != t.shape or got[name].dtype != t.dtype]
    if bad:
        name = bad[0]
        raise ValueError(f"{file}: {len(bad)} leaves differ from the template's in shape or dtype, "
                         f"e.g. {name}: stored {tuple(got[name].shape)} {got[name].dtype}, "
                         f"template {tuple(dict(want)[name].shape)} {dict(want)[name].dtype}")
    restored = _relaid(laid, unflatten(want_tree, [got[name] if t.is_meta else got[name].to(t.device)
                                                   for name, t in want]))
    return restored["params"], restored["opt_state"], int(read_safetensors_metadata(file)["step"])
