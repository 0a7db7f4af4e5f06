"""Sharded serving in one process: batch data parallel x tensor parallel.

Counterpart of ``asr_tpu/parallel/serve.py``. Batch data parallelism needs
no collectives: the window batch splits over the mesh's ``data`` axis and
every data position runs the family's forward on its own rows. With
``param_specs`` (a spec tree or a callable ``params -> specs``; see
``parallel/mesh.*_param_specs``) the weights also shard over the ``model``
axis, Megatron style, and the model-axis ranks of a data position meet at
the collectives inside ``layers/transformer.dense``. Sessions route through
this when built with ``mesh=`` (``transcribe`` / ``serve --data-parallel N
[--tensor-parallel T]``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from asr_tpu_torch.parallel.mesh import Mesh, ShardedParams, make_mesh, map_tree, run_grid
from asr_tpu_torch.parallel.mesh import shard_params as _shard_params


def _tree_cat(trees: list, device: torch.device):
    """Concatenate the data positions' output trees on axis 0, on ``device``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees], device) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_tree_cat([t[i] for t in trees], device) for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees], dim=0)
    return first


class DataParallelRunner:
    """Pads a batch to a multiple of the data axis, splits it over the data
    positions, runs ``fn`` at every (data, model) position and concatenates
    the data positions' results, the padding rows trimmed."""

    def __init__(self, mesh: Mesh | None = None, param_specs=None):
        self.mesh = mesh or make_mesh(model_parallel=1)
        self.n_data = self.mesh.shape["data"]
        self.param_specs = param_specs

    @property
    def device(self) -> torch.device:
        """Where results land: the first position's device."""
        return self.mesh.devices[0][0]

    def shard_params(self, params) -> ShardedParams:
        specs = self.param_specs
        if callable(specs):
            specs = specs(params)
        return _shard_params(params, self.mesh, specs)

    def __call__(self, fn: Callable, params, *batch_args):
        """``fn(local params, *local batch args)`` with every batch arg
        (numpy array or tensor) split on axis 0. The batch pads to a
        multiple of the data axis by repeating the last row (masked out by
        per-sample valid lengths downstream)."""
        if not isinstance(params, ShardedParams):
            params = _shard_params(params, self.mesh)
        b = batch_args[0].shape[0]
        pad = (-b) % self.n_data
        split = []
        for a in batch_args:
            a = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
            if pad:
                a = torch.cat([a, a[-1:].expand(pad, *a.shape[1:])], dim=0)
            split.append(torch.tensor_split(a, self.n_data, dim=0))

        def run(d, m):
            dev = self.mesh.devices[d][m]
            return fn(params.local(d, m), *(s[d].to(dev) for s in split))

        grid = run_grid(self.mesh, run)
        out = _tree_cat([row[0] for row in grid], self.device)
        return map_tree(lambda _, x: x[:b] if isinstance(x, torch.Tensor) else x, out)
