"""Device meshes, tensor-parallel specs and the model-axis group.

Counterpart of ``asr_tpu/parallel/mesh.py`` in one process:

- **data**: batch data parallelism, the throughput axis for serving
  (independent audio windows per device, no collectives).
- **model**: tensor parallelism of the wide matmuls (qkv / out / ffn /
  vocabulary head), Megatron layout.

A :class:`Mesh` is a (data, model) grid of ``torch.device``s, which may
repeat (``[cuda:0] * 4`` runs dp x tp on one card, as the JAX tests run on
virtual CPU devices). :func:`shard_params` gives every position its own
local tree on its device (``own=True``: tensors of its own, for training)
and :func:`gather_params` joins the pieces back into the whole tree;
:func:`run_grid` runs the ordinary model function at every position in a
thread of its own, and the model-axis ranks of one data position meet at
:func:`all_reduce` and :func:`all_gather`. Where
GSPMD reshards a sharded JAX array behind the scenes, the port's local
compute cannot, so :func:`shard_params` splits fused leaves by heads and
marks each sharded weight with the role that ``layers/transformer.dense``
honours (``tp_role``):

- no mark (a column shard): the output stays local to the rank;
- ``"row"``: a row shard; local product, :func:`all_reduce`, then the bias;
- ``"gather"``: a column shard of a head whose output every rank needs
  (the CTC / LM head, split unevenly where T does not divide it, and the
  FSMN taps); the output is :func:`all_gather`-ed;
- a whole weight whose input arrives as local columns (a quantized weight
  at a row position, which the spec functions replicate: the packed row
  layout interleaves K, and a block must not straddle ranks): ``dense``
  gathers the input's columns, then every rank runs the full product.

The spec functions return the JAX package's spec trees leaf for leaf, with
the port's own :class:`P`.

Under ``run_grid(..., grad=True)`` the collectives are ordinary autograd
ops across the rank threads' tensors (a sum, a concatenation), so the
forward of every position is one graph, and its backward, taken once by
the caller, reaches no collective: on one card every CUDA backward runs on
that device's single autograd thread, where a collective waiting for
another rank would wait for ever (``parallel/train.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch

from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear

# seconds a rank waits for its group at a collective before giving up (a
# safety net: a rank that raises aborts the others at once)
COLLECTIVE_TIMEOUT_S = 600.0


class P(tuple):
    """PartitionSpec counterpart: one entry per tensor axis, ``None``
    (replicated along it) or a mesh axis name."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


class Mesh:
    """A (data, model) grid of torch devices; ``shape`` is a dict, as JAX's."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = {"data": len(rows), "model": len(rows[0])}

    def row(self, d: int) -> "Mesh":
        """Data position ``d`` as a (1, model) mesh."""
        return Mesh([self.devices[d]])

    def __repr__(self) -> str:
        return f"Mesh({self.devices}, axis_names={self.axis_names})"


def visible_devices() -> list[torch.device]:
    """Every visible CUDA card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices`` (the
    visible cards by default; a device may repeat)."""
    devices = list(visible_devices() if devices is None else devices)
    if not devices:
        raise ValueError("no CUDA card is visible: pass devices= "
                         "(e.g. [torch.device('cpu')] * 4)")
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % model_parallel or n_devices > len(devices) or n_devices < 1:
        raise ValueError(f"cannot lay {n_devices} of {len(devices)} devices out as "
                         f"(data, model={model_parallel})")
    flat = devices[:n_devices]
    return Mesh([flat[i : i + model_parallel] for i in range(0, n_devices, model_parallel)])


def replicated(mesh: Mesh) -> P:
    return P()


def batch_sharded(mesh: Mesh) -> P:
    return P("data")


# ── the model-axis group ─────────────────────────────────────────────────

class ModelGroup:
    """The model-axis ranks of one data position, each a thread. A
    collective deposits each rank's tensor and meets at a barrier; slots
    alternate between two buffers, so a rank that runs ahead to the next
    collective never overwrites a tensor a slower rank still reads."""

    def __init__(self, size: int, timeout: float = COLLECTIVE_TIMEOUT_S):
        self.size = int(size)
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots = [[None] * self.size, [None] * self.size]
        self._calls = [0] * self.size

    @property
    def exchanges(self) -> int:
        """Collectives entered so far, summed over the ranks."""
        return sum(self._calls)

    def _exchange(self, rank: int, t: torch.Tensor) -> list[torch.Tensor]:
        buf = self._slots[self._calls[rank] % 2]
        self._calls[rank] += 1
        buf[rank] = t
        lock = getattr(_ctx, "lock", None)  # the device's turn passes on while we wait
        if lock is not None:
            lock.release()
        try:
            self._barrier.wait()
        finally:
            if lock is not None:
                lock.acquire()
        return list(buf)

    def all_reduce(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, added in rank order on every rank, so each
        rank holds bitwise the same tensor."""
        parts = self._exchange(rank, t)
        out = parts[0].to(t.device)
        for p in parts[1:]:
            out = out + p.to(t.device)
        return out

    def all_gather(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated on the last axis, in rank order."""
        parts = self._exchange(rank, t)
        return torch.cat([p.to(t.device) for p in parts], dim=-1)

    def abort(self) -> None:
        self._barrier.abort()


_ctx = threading.local()
_device_locks: dict[str, threading.Lock] = {}
_device_locks_guard = threading.Lock()


def device_lock(device) -> threading.Lock:
    """The process-wide lock of one device. The threads that drive a device
    (rank threads, server replicas) take turns, each holding it until it
    waits at a collective: Python threads launching kernels on one device
    at once only fight over the interpreter's and the driver's locks (a
    batch-8 SenseVoice forward split over four such threads took 20x the
    unsharded one on an H100), and the device runs their work in one
    stream's order anyway."""
    key = str(torch.device(device))
    with _device_locks_guard:
        return _device_locks.setdefault(key, threading.Lock())


def current_group() -> ModelGroup | None:
    """The calling rank thread's model group (None outside a group of > 1)."""
    return getattr(_ctx, "group", None)


def model_rank() -> int:
    return getattr(_ctx, "rank", 0)


def model_size() -> int:
    g = current_group()
    return 1 if g is None else g.size


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    g = current_group()
    return t if g is None else g.all_reduce(model_rank(), t)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    g = current_group()
    return t if g is None else g.all_gather(model_rank(), t)


def rank_generator(generator: torch.Generator | None) -> torch.Generator | None:
    """A rank thread's own copy of ``generator`` (the same state: the ranks
    of a group draw the same numbers); rank threads never share one."""
    if generator is None:
        return None
    g = torch.Generator(device=generator.device)
    g.set_state(generator.get_state())
    return g


@contextlib.contextmanager
def _at(m: int, device: torch.device, group: ModelGroup | None, lock=None, grad: bool = False):
    prev = (getattr(_ctx, "group", None), getattr(_ctx, "rank", 0), getattr(_ctx, "lock", None))
    _ctx.group, _ctx.rank, _ctx.lock = group, m, lock
    dev_ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    mode = torch.enable_grad() if grad else torch.inference_mode()
    try:
        with lock or contextlib.nullcontext(), dev_ctx, mode:
            yield
    finally:
        _ctx.group, _ctx.rank, _ctx.lock = prev


def run_grid(mesh: Mesh, fn: Callable[[int, int], Any],
             timeout: float = COLLECTIVE_TIMEOUT_S, grad: bool = False) -> list[list[Any]]:
    """``fn(d, m)`` at every position of ``mesh``, each in a thread of its
    own (in the caller's thread for a 1 x 1 mesh) under
    ``torch.inference_mode`` (``grad=True``: with autograd on, the
    positions' graphs joined at the collectives) with its device current
    and its turn on the device (:func:`device_lock`); returns the results
    as a (data, model) grid. A rank that raises aborts its siblings at
    their next collective; the first error is raised here. Not to be called
    by a thread that holds one of the mesh's devices' turns (a server
    replica's driver does not)."""
    n_d, n_m = mesh.shape["data"], mesh.shape["model"]
    if n_d * n_m == 1:
        with _at(0, mesh.devices[0][0], None, grad=grad):
            return [[fn(0, 0)]]
    groups = [ModelGroup(n_m, timeout) if n_m > 1 else None for _ in range(n_d)]
    results = [[None] * n_m for _ in range(n_d)]
    errors: list[BaseException] = []

    def target(d, m):
        try:
            dev = mesh.devices[d][m]
            with _at(m, dev, groups[d], device_lock(dev), grad):
                results[d][m] = fn(d, m)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller
            errors.append(exc)
            for g in groups:
                if g is not None:
                    g.abort()

    threads = [threading.Thread(target=target, args=(d, m), daemon=True)
               for d in range(n_d) for m in range(n_m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return results


# ── spec trees ───────────────────────────────────────────────────────────

def _sanm_block_spec() -> dict:
    """One SANM block: qkv / ffn-in column-sharded, out / ffn-out
    row-sharded (Megatron layout)."""
    return {
        "norm1": {"scale": P(), "bias": P()},
        "qkv": {"w": P(None, "model"), "b": P("model")},
        "fsmn_w": P(None, "model"),
        "out": {"w": P("model", None), "b": P()},
        "norm2": {"scale": P(), "bias": P()},
        "ffn": {"w1": P(None, "model"), "b1": P("model"), "w2": P("model", None), "b2": P()},
    }


def sensevoice_param_specs(params: Any) -> Any:
    """Spec tree matching a SenseVoice parameter tree."""
    return {
        "cmvn_means": P(),
        "cmvn_istd": P(),
        "language_embed": P(),
        "system_embed": P(),
        "encoders0": [_sanm_block_spec() for _ in params["encoders0"]],
        "encoders": [_sanm_block_spec() for _ in params["encoders"]],
        "tp_encoders": [_sanm_block_spec() for _ in params["tp_encoders"]],
        "after_norm": {"scale": P(), "bias": P()},
        "tp_norm": {"scale": P(), "bias": P()},
        "ctc": {"w": P(None, "model"), "b": P("model")},
    }


def map_tree(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; ``path``
    joins the keys with '/'."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def _specs_by_rule(params: Any, rule) -> Any:
    """A spec tree mirroring ``params``: ``rule`` maps a '/'-joined key path
    to a spec; unmatched leaves replicate. A quantized weight is one leaf at
    its '.../w' path: a column position shards q / scale / zero on their
    shared output axis (exact: block quantization is per column); a row
    position replicates."""

    def assign(path, leaf):
        spec = rule(path)
        if isinstance(leaf, QuantizedLinear):
            s = P(None, "model") if spec == P(None, "model") else P()
            return QuantizedLinear(s, s, s, leaf.bits, leaf.block, leaf.packed, leaf.dynamic)
        return spec

    return map_tree(assign, params)


def whisper_param_specs(params: Any) -> Any:
    """Whisper: attention q / k / v and mlp fc1 column-sharded (heads must
    divide the model axis), o / fc2 row-sharded; embeddings, convs and norms
    replicate."""

    def rule(key: str):
        for proj in ("attn/q", "attn/k", "attn/v", "cross/q", "cross/k", "cross/v", "mlp/fc1"):
            if key.endswith(proj + "/w"):
                return P(None, "model")
            if key.endswith(proj + "/b"):
                return P("model")
        for proj in ("attn/o", "cross/o", "mlp/fc2"):
            if key.endswith(proj + "/w"):
                return P("model", None)
        return P()

    return _specs_by_rule(params, rule)


def qwen3_param_specs(params: Any) -> Any:
    """A Qwen3 decoder: q / k / v (or the fused qkv), gate / up (or gateup)
    and lm_head column-sharded, o / down row-sharded; kv heads must divide
    the model axis; the per-head q / k RMSNorm scales replicate."""

    def rule(key: str):
        for proj in ("attn/q", "attn/k", "attn/v", "attn/qkv",
                     "mlp/gate", "mlp/up", "mlp/gateup", "lm_head"):
            if key.endswith(proj + "/w"):
                return P(None, "model")
            if key.endswith(proj + "/b"):
                return P("model")
        for proj in ("attn/o", "mlp/down"):
            if key.endswith(proj + "/w"):
                return P("model", None)
        return P()

    return _specs_by_rule(params, rule)


# ── local trees ──────────────────────────────────────────────────────────

# column-sharded leaves whose output every rank needs whole
GATHERED = ("ctc/w", "lm_head/w", "fsmn_w")


class Split:
    """How one leaf lies over the model ranks: ``kind`` "whole" (every rank
    holds all of it), "col" (pieces of the last axis, each part of a fused
    axis split on its own: ``parts``), "row" (pieces of axis 0), "qcol" /
    "qrow" (a quantized weight's q / scale / zero cut so); ``role`` the
    pieces' ``tp_role``."""

    __slots__ = ("kind", "parts", "role")

    def __init__(self, kind: str, parts: tuple[int, ...] = (), role: str | None = None):
        self.kind, self.parts, self.role = kind, tuple(parts), role

    @property
    def whole(self) -> bool:
        return self.kind == "whole"

    def __repr__(self) -> str:
        return f"Split({self.kind!r}, {self.parts}, {self.role!r})"


WHOLE = Split("whole")


class ShardedParams:
    """A parameter tree laid out on a mesh: ``local(d, m)`` is position (d,
    m)'s own tree on its device. Positions on one device with the same
    model rank share their tensors, unless laid out with ``own=True``.
    ``layout`` mirrors the tree with each leaf's :class:`Split` (what
    :func:`gather_params` inverts), ``specs`` is the spec tree it was laid
    out by (None: replicated)."""

    def __init__(self, mesh: Mesh, trees: list[list[Any]], layout: Any = None, specs: Any = None,
                 own: bool = False):
        self.mesh = mesh
        self.trees = trees
        self.layout = layout
        self.specs = specs
        self.own = own

    def local(self, d: int, m: int) -> Any:
        return self.trees[d][m]

    def positions(self) -> list[tuple[int, int]]:
        return [(d, m) for d in range(self.mesh.shape["data"]) for m in range(self.mesh.shape["model"])]

    def map(self, fn: Callable[[int, int], Any]) -> "ShardedParams":
        """Another tree of this layout (gradients, optimizer moments):
        ``fn(d, m)`` is position (d, m)'s, in tensors of its own."""
        return ShardedParams(self.mesh, [[fn(d, m) for m in range(self.mesh.shape["model"])]
                                         for d in range(self.mesh.shape["data"])],
                             self.layout, self.specs, own=True)

    @staticmethod
    def zip(*parts: "ShardedParams") -> "ShardedParams":
        """Positionwise tuples of several laid-out trees on one mesh."""
        mesh = parts[0].mesh
        return ShardedParams(mesh, [[tuple(p.trees[d][m] for p in parts)
                                     for m in range(mesh.shape["model"])]
                                    for d in range(mesh.shape["data"])])


def _place(leaf, device: torch.device, copy: bool = False):
    """A leaf on ``device`` (``copy``: always in tensors of its own):
    tensors moved, quantized leaves copied with their tensors moved (cached
    product operands and the rank role dropped), others as is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device, copy=copy)
    if isinstance(leaf, (QuantizedLinear, QuantizedEmbedding)):
        new = object.__new__(type(leaf))
        new.__dict__.update({k: (v.to(device, copy=copy) if isinstance(v, torch.Tensor) else v)
                             for k, v in vars(leaf).items() if k not in ("_int_mm", "tp_role")})
        return new
    return leaf


def _in_features(leaf) -> int:
    if isinstance(leaf, QuantizedLinear):
        return leaf.scale.shape[0] * leaf.block
    return leaf.shape[0]


def _fused_parts(path: str, ancestors: tuple, n: int) -> tuple[int, ...]:
    """Widths of the parts of a fused output axis that split separately:
    the Qwen3 ``attn/qkv`` (q | k | v, q's width from ``o``), ``mlp/gateup``
    (gate | up) and the SANM block's ``qkv`` (q | k | v, equal); one part
    otherwise."""
    parts = path.split("/")
    if len(parts) >= 2 and parts[-2] == "qkv":
        if len(parts) >= 3 and parts[-3] == "attn":
            qd = _in_features(ancestors[-2]["o"]["w"])
            return (qd, (n - qd) // 2, (n - qd) // 2)
        return (n // 3,) * 3
    if len(parts) >= 2 and parts[-2] == "gateup":
        return (n // 2, n // 2)
    return (n,)


def _share(n: int, tp: int, r: int) -> int:
    """Rank r's share of n under ``tensor_split``: the first n % tp ranks
    take one more."""
    return n // tp + (1 if r < n % tp else 0)


def _col_pieces(t: torch.Tensor, parts: tuple[int, ...], tp: int, axis: int) -> list[torch.Tensor]:
    """Rank r's piece: its share of each part along ``axis``, concatenated
    (``tensor_split``: shares differ by at most one where T does not
    divide a part)."""
    chunks = torch.split(t, list(parts), dim=axis)
    per = [torch.tensor_split(c, tp, dim=axis) for c in chunks]
    return [torch.cat([p[r] for p in per], dim=axis).contiguous() for r in range(tp)]


def _join_cols(pieces: list[torch.Tensor], parts: tuple[int, ...], axis: int) -> torch.Tensor:
    """The inverse of :func:`_col_pieces`: each part's shares in rank order,
    the parts in order."""
    tp = len(pieces)
    shares = [torch.split(p, [_share(n, tp, r) for n in parts], dim=axis) for r, p in enumerate(pieces)]
    return torch.cat([shares[r][i] for i in range(len(parts)) for r in range(tp)], dim=axis)


def _split_leaf(path: str, leaf, spec, ancestors: tuple, tp: int) -> tuple[list, Split]:
    """(the T rank pieces of one leaf, how they split) under ``spec``."""
    qspec = spec.q if isinstance(spec, QuantizedLinear) else spec
    name = path.split("/")[-1]
    col = qspec == P(None, "model") or (qspec == P("model") and name.startswith("b"))
    row = qspec == P("model", None)
    role = "gather" if path.endswith(GATHERED) else None
    if isinstance(leaf, QuantizedLinear):
        if col:
            parts = _fused_parts(path, ancestors, leaf.q.shape[1])
            fields = {f: _col_pieces(getattr(leaf, f), parts, tp, 1) for f in ("q", "scale", "zero")}
            pieces = [QuantizedLinear(fields["q"][r], fields["scale"][r], fields["zero"][r],
                                      leaf.bits, leaf.block, leaf.packed, leaf.dynamic)
                      for r in range(tp)]
            return pieces, Split("qcol", parts, role)
        k_blocks = leaf.scale.shape[0]
        if row and not leaf.packed and not leaf.dynamic and k_blocks % tp == 0:
            rows = k_blocks // tp
            pieces = [QuantizedLinear(leaf.q[r * rows * leaf.block : (r + 1) * rows * leaf.block].contiguous(),
                                      leaf.scale[r * rows : (r + 1) * rows].contiguous(),
                                      leaf.zero[r * rows : (r + 1) * rows].contiguous(),
                                      leaf.bits, leaf.block, leaf.packed, leaf.dynamic)
                      for r in range(tp)]
            return pieces, Split("qrow", role="row")
        return [leaf] * tp, WHOLE
    if not isinstance(leaf, torch.Tensor) or not (col or row):
        return [leaf] * tp, WHOLE
    if row:
        return [p.contiguous() for p in torch.tensor_split(leaf, tp, dim=0)], Split("row", role="row")
    parts = _fused_parts(path, ancestors, leaf.shape[-1])
    return _col_pieces(leaf, parts, tp, leaf.ndim - 1), Split("col", parts, role)


class _Leaf:
    """A leaf's rank pieces (one, when it is not split) and their split."""

    __slots__ = ("pieces", "split", "placed")

    def __init__(self, pieces: list, split: Split):
        self.pieces, self.split, self.placed = pieces, split, {}

    def on(self, m: int, device: torch.device, own: bool):
        r = m if len(self.pieces) > 1 else 0
        key = (r, str(device))
        if own or key not in self.placed:
            leaf = _place(self.pieces[r], device, copy=own)
            if self.split.role is not None:  # a piece of our own, never the caller's leaf
                leaf.tp_role = self.split.role
            if own:
                return leaf
            self.placed[key] = leaf
        return self.placed[key]


def shard_params(params: Any, mesh: Mesh, specs: Any | None = None, own: bool = False) -> ShardedParams:
    """Lay a parameter tree out on ``mesh``: replicated by default, or per
    ``specs`` (a spec tree from the functions above) over the model axis.
    Each position's local tree lies on its device; a weight sharded by rows,
    or gathered after its product, carries its ``tp_role``. With ``own``
    every position holds tensors of its own, never the caller's or another
    position's (training updates each position's leaves in place)."""
    tp = mesh.shape["model"]

    def walk(tree, spec, path, ancestors):
        if isinstance(tree, (dict, list, tuple)):
            keys = list(tree.keys()) if isinstance(tree, dict) else range(len(tree))
            out = {k: walk(tree[k], None if spec is None else spec[k],
                           f"{path}/{k}" if path else str(k), ancestors + (tree,)) for k in keys}
            if isinstance(tree, dict):
                return out
            return type(tree)(out[k] for k in keys) if isinstance(tree, tuple) else list(out.values())
        if tp == 1 or spec is None:
            return _Leaf([tree], WHOLE)
        return _Leaf(*_split_leaf(path, tree, spec, ancestors, tp))

    leaves = walk(params, specs, "", ())
    trees = [[map_tree(lambda _, leaf: leaf.on(m, mesh.devices[d][m], own), leaves) for m in range(tp)]
             for d in range(mesh.shape["data"])]
    return ShardedParams(mesh, trees, map_tree(lambda _, leaf: leaf.split, leaves), specs, own)


def _zip_layout(fn, layout, trees: list):
    """``fn(split, [each tree's leaf])`` over ``layout``'s structure."""
    if isinstance(layout, dict):
        return {k: _zip_layout(fn, v, [t[k] for t in trees]) for k, v in layout.items()}
    if isinstance(layout, (list, tuple)):
        out = [_zip_layout(fn, v, [t[i] for t in trees]) for i, v in enumerate(layout)]
        return tuple(out) if isinstance(layout, tuple) else out
    return fn(layout, trees)


def _join(split: Split, pieces: list, device: torch.device):
    """One leaf whole on ``device`` from its rank pieces."""
    if split.kind == "whole":
        return _place(pieces[0], device, copy=True)
    if split.kind in ("col", "row"):
        on = [p.to(device) for p in pieces]
        return _join_cols(on, split.parts, on[0].ndim - 1) if split.kind == "col" else torch.cat(on, dim=0)
    first = pieces[0]
    fields = [[getattr(p, f).to(device) for p in pieces] for f in ("q", "scale", "zero")]
    joined = [_join_cols(f, split.parts, 1) if split.kind == "qcol" else torch.cat(f, dim=0) for f in fields]
    return QuantizedLinear(*joined, first.bits, first.block, first.packed, first.dynamic)


def gather_params(sharded: ShardedParams, device=None) -> Any:
    """The whole tree of a laid-out one (:func:`shard_params`' inverse,
    bitwise) on ``device`` (default: the first position's), in tensors of
    its own: row pieces and the shares of every fused column part joined in
    rank order, a replicated leaf copied from rank 0. Data position 0's
    pieces are read."""
    if sharded.layout is None:
        raise ValueError("this ShardedParams has no layout (made by ShardedParams.zip?)")
    dev = torch.device(device) if device is not None else sharded.mesh.devices[0][0]
    ranks = [sharded.local(0, r) for r in range(sharded.mesh.shape["model"])]
    return _zip_layout(lambda split, pieces: _join(split, pieces, dev), sharded.layout, ranks)


def layout_leaves(layout: Any) -> list[Split]:
    """The :class:`Split`s of a layout tree in its leaves' order (the order
    of ``parallel/checkpoint.named_leaves``)."""
    out: list[Split] = []
    map_tree(lambda _, split: out.append(split), layout)
    return out
