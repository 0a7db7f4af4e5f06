"""Model artifact folders: ``weights.safetensors`` + ``metadata.json``.

Counterpart of ``asr_tpu/runtime/artifact.py``, reading and writing the
same folders: flattened keys joined with ``/`` (list items by index),
quantized leaves as ``<path>/__quant__/{q,scale,zero,bits,block,packed,dynamic}``,
quantized embedding tables as ``<path>/__qembed__/{q,scale,zero,bits,block,tied}``
(the tied-head copy is derived on load, never stored), and byte-identical
tensors of at least 1 KiB stored once, with the other keys listed in
``metadata.extra["weight_aliases"]``.

The safetensors format is parsed and written here with numpy: an 8-byte
little-endian header length, a JSON header mapping each name to its dtype,
shape and byte range, then the raw little-endian bytes. numpy has no
bfloat16 of its own, so a BF16 tensor travels through numpy as its raw
16-bit patterns (:data:`BF16_BITS`, which no numpy cast or arithmetic
accepts) and becomes a ``torch.bfloat16`` tensor through an int16 view:
leaves keep BF16 where the JAX package keeps it, bit for bit.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from asr_tpu_torch.runtime.metadata import ModelMetadata
from asr_tpu_torch.quant.quantize import QuantizedEmbedding, QuantizedLinear, tied_head_arrays

WEIGHTS_FILENAME = "weights.safetensors"

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_CODES = {np.dtype(v).str: k for k, v in _DTYPES.items()}
# BF16 as raw little-endian 16-bit patterns. ml_dtypes' bfloat16 (what the
# JAX package's arrays hold) is also a two-byte void type and is taken alike.
BF16_BITS = np.dtype("V2")


def is_bf16_bits(a) -> bool:
    """Whether a numpy array holds bfloat16 values as two-byte voids
    (:data:`BF16_BITS`, or ml_dtypes' ``bfloat16``)."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and a.dtype.names is None


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A C-contiguous CPU tensor of its own memory; bfloat16 bits become
    ``torch.bfloat16``."""
    a = np.array(a, order="C", copy=True)
    if is_bf16_bits(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A contiguous host copy; a ``torch.bfloat16`` tensor comes out as
    :data:`BF16_BITS`."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return np.ascontiguousarray(t.view(torch.int16).numpy()).view(BF16_BITS)
    return np.ascontiguousarray(t.numpy())


def read_safetensors_metadata(path: str | Path) -> dict[str, str]:
    """The ``__metadata__`` strings of a safetensors file's header ({} if none)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        return json.loads(fh.read(n).decode("utf-8")).get("__metadata__", {})


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a writable numpy array."""
    data = bytearray(Path(path).read_bytes())
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] == "BF16":
            out[name] = np.frombuffer(data, dtype=BF16_BITS, count=(end - begin) // 2,
                                      offset=base + begin).reshape(info["shape"])
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{name}: dtype {info['dtype']} is not supported")
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize, offset=base + begin)
        out[name] = arr.reshape(info["shape"]).astype(dtype.newbyteorder("="), copy=False)
    return out


# The safetensors library writes tensors by descending dtype rank, then by
# name; the same order here makes both packages' files byte-identical.
_RANK = {code: i for i, code in enumerate(("BOOL", "U8", "I8", "I16", "F16", "BF16", "I32", "F32",
                                           "F64", "I64"))}


def write_safetensors(path: str | Path, tensors: dict[str, np.ndarray],
                      metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (and ``metadata``, string to string) as the
    safetensors library's ``save_file`` would."""
    items = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr) if np.ndim(arr) else np.asarray(arr)  # 0-d stays 0-d
        if is_bf16_bits(arr):
            code, raw = "BF16", arr.tobytes()
        else:
            little = arr.dtype.newbyteorder("<")
            code = _CODES.get(little.str)
            if code is None:
                raise ValueError(f"{name}: dtype {arr.dtype} is not supported")
            raw = arr.astype(little, copy=False).tobytes()
        items.append((name, code, list(arr.shape), raw))
    items.sort(key=lambda it: (-_RANK[it[1]], it[0]))
    header: dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name, code, shape, raw in items:
        header[name] = {"dtype": code, "shape": shape, "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for *_, raw in items:
            fh.write(raw)


def flatten_pytree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Parameter tree -> ``{key: numpy array}`` with the JAX package's keys."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, QuantizedLinear):
        for k in ("q", "scale", "zero"):
            out[f"{prefix}__quant__/{k}"] = tensor_to_numpy(tree[k])
        for k in ("bits", "block", "packed", "dynamic"):
            out[f"{prefix}__quant__/{k}"] = np.asarray(int(tree[k]), np.int32)
    elif isinstance(tree, QuantizedEmbedding):
        for k in ("q", "scale", "zero"):
            out[f"{prefix}__qembed__/{k}"] = tensor_to_numpy(getattr(tree, k))
        out[f"{prefix}__qembed__/bits"] = np.asarray(tree.bits, np.int32)
        out[f"{prefix}__qembed__/block"] = np.asarray(tree.block, np.int32)
        out[f"{prefix}__qembed__/tied"] = np.asarray(int(tree.q_t is not None), np.int32)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        # at least 1-d, as the JAX package's np.ascontiguousarray stores a 0-d leaf
        out[prefix[:-1]] = tensor_to_numpy(tree)
    else:
        out[prefix[:-1]] = np.ascontiguousarray(np.asarray(tree))
    return out


def params_from_flat(flat: dict[str, np.ndarray], device) -> Any:
    """Flat ``{key: numpy array}`` (from either package's ``flatten_pytree``
    or an artifact) -> the port's parameter tree on ``device``. Arrays that
    are the same numpy object become one device tensor; bfloat16 bits
    (:func:`is_bf16_bits`) become ``torch.bfloat16`` tensors."""
    device = torch.device(device)
    memo: dict[int, torch.Tensor] = {}

    def put(a: np.ndarray) -> torch.Tensor:
        if id(a) not in memo:
            memo[id(a)] = tensor_from_numpy(a).to(device)
        return memo[id(a)]

    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def num(a) -> int:  # a stored scalar, 0-d or of shape (1,)
        return int(np.asarray(a).reshape(-1)[0])

    def build(node, key=""):
        if not isinstance(node, dict):
            if key.endswith("log_scale") and np.shape(node) == (1,):
                # a 0-d scalar (Zipformer's BiasNorm scales), stored as (1,) by the
                # JAX package's flatten (np.ascontiguousarray has ndim >= 1)
                return put(node).reshape(())
            return put(node)
        if "__qembed__" in node and len(node) == 1:
            q = node["__qembed__"]
            bits, block = num(q["bits"]), num(q["block"])
            emb = QuantizedEmbedding(put(q["q"]), put(q["scale"]), put(q["zero"]), bits, block)
            if num(q.get("tied", 1)):
                emb.q_t, emb.scale_t, emb.zero_t, emb.q_t_packed = tied_head_arrays(
                    emb.q.T, emb.scale.T, emb.zero.T, bits=bits, block=block)
            return emb
        if "__quant__" in node and len(node) == 1:
            q = node["__quant__"]
            return QuantizedLinear(put(q["q"]), put(q["scale"]), put(q["zero"]),
                                   num(q["bits"]), num(q["block"]),
                                   packed=bool(num(q.get("packed", 0))),
                                   dynamic=bool(num(q.get("dynamic", 0))))
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [build(node[str(i)]) for i in range(len(keys))]
        return {k: build(v, k) for k, v in node.items()}

    return build(root)


def dedup_flat(flat: dict[str, np.ndarray]) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Keep one copy of each byte-identical tensor of at least 1 KiB; the
    rest become ``{alias_key: canonical_key}`` rows."""
    by_sig: dict[tuple, str] = {}
    kept: dict[str, np.ndarray] = {}
    aliases: dict[str, str] = {}
    for key, arr in flat.items():
        if arr.nbytes < 1024:
            kept[key] = arr
            continue
        raw = arr.tobytes()
        sig = (arr.dtype.str, arr.shape, hash(raw))
        canon = by_sig.get(sig)
        if canon is not None and kept[canon].tobytes() == raw:
            aliases[key] = canon
        else:
            by_sig[sig] = key
            kept[key] = arr
    return kept, aliases


def save_model(folder: str | Path, params: Any, metadata: ModelMetadata) -> None:
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    flat, aliases = dedup_flat(flatten_pytree(params))
    if aliases:
        metadata.extra["weight_aliases"] = aliases
    else:
        metadata.extra.pop("weight_aliases", None)
    write_safetensors(folder / WEIGHTS_FILENAME, flat)
    metadata.save(folder)


def load_model(folder: str | Path, device="cuda") -> tuple[Any, ModelMetadata]:
    folder = Path(folder)
    flat = read_safetensors(folder / WEIGHTS_FILENAME)
    meta = ModelMetadata.load(folder)
    for alias, canon in meta.extra.get("weight_aliases", {}).items():
        flat[alias] = flat[canon]
    return params_from_flat(flat, device), meta


def load_tokenizer(folder: str | Path, meta: ModelMetadata):
    """The decoder of an artifact's tokenizer file (``meta.tokenizer``:
    ``{"kind", "file"}``), or None when the metadata names none or the file
    is missing. Kinds: ``sentencepiece``, ``vocab_txt`` (with
    ``extra["decode_mode"]``), ``json``, ``firered_dict`` and ``tiktoken``
    are pure Python; ``hf`` needs the ``tokenizers`` package and raises
    without it."""
    from asr_tpu_torch.runtime import tokenizer as tok

    kind = meta.tokenizer.get("kind", "")
    file = meta.tokenizer.get("file", "")
    path = Path(folder) / file if file else None
    if not path or not path.exists():
        return None
    if kind == "sentencepiece":
        return tok.SentencePieceDecoder(path)
    if kind == "vocab_txt":
        return tok.VocabTxtDecoder(path, meta.extra.get("decode_mode", "zh"))
    if kind == "hf":
        return tok.HFTokenizerDecoder(path)
    if kind == "json":
        return tok.JsonVocabDecoder(path)
    if kind == "firered_dict":
        return tok.FireRedDictDecoder(path)
    if kind == "tiktoken":
        return tok.TiktokenVocabDecoder(path)
    return None
