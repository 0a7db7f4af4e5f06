"""BF16 safetensors in the port, against the JAX package (which keeps BF16
leaves as ml_dtypes ``bfloat16`` through ``safetensors.numpy``).

The fault these tests name: ``runtime/artifact.read_safetensors`` refused a
BF16 tensor, ``write_safetensors`` and ``flatten_pytree`` could not hold a
bf16 leaf, and the writer's tensor order was not the safetensors library's.
So a real (BF16) Qwen3-ASR snapshot did not build, and a ``bf16`` serving
plan made leaves that ``save_model`` could not write.

- a BF16 file written by the JAX package reads into the port bitwise, and
  the port writes it back byte for byte;
- a synthetic BF16 Qwen3-ASR snapshot built by both packages gives the same
  bf16 leaves and byte-identical ``weights.safetensors`` files; it loads
  into the port as ``torch.bfloat16`` and transcribes, widened by the
  serving cast ``--dtype float32``, to JAX's ids;
- a ``bf16`` plan through both ``optimize`` command lines gives
  byte-identical files that reload bitwise.
"""

import json
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.runtime import artifact as tart
from tests.test_torch_cli_build import _restore_modes, _run, _sensevoice_src  # noqa: F401 (a fixture)
from tests.test_torch_export import QWEN_WORDS, assert_same_artifact, hf_tokenizer
from tests.test_torch_quant_objectives import xla_order  # noqa: F401 (a fixture)

pytest.importorskip("transformers")


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array (ml_dtypes, the port's raw
    two-byte values or a torch tensor)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _bf16_snapshot(tmp: Path) -> Path:
    """The tiny HF Qwen3-ASR snapshot of the JAX loader tests with every
    floating tensor stored as BF16, as the published checkpoint stores it."""
    from tests.test_qwen_loaders import _write_snapshot

    src, _, _ = _write_snapshot(tmp)
    hf_tokenizer(src / "tokenizer.json", QWEN_WORDS)
    sd = load_file(str(src / "model.safetensors"))
    save_file({k: v.astype(ml_dtypes.bfloat16) if v.dtype.kind == "f" else v for k, v in sd.items()},
              str(src / "model.safetensors"))
    return src


def test_jax_written_bf16_file_reads_bitwise_and_writes_back(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "w": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
        "b": np.asarray([-0.0, np.inf, -np.inf, np.nan, 1e-40, 3.0], ml_dtypes.bfloat16),
        "scale": rng.standard_normal(3).astype(np.float32),
        "q": rng.integers(-128, 127, (4, 2)).astype(np.int8),
        "n": np.asarray([3], np.int32),
        "h": rng.standard_normal(4).astype(np.float16),
    }
    path = tmp_path / "jax.safetensors"
    save_file(tensors, str(path))
    got = tart.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for name, want in tensors.items():
        assert got[name].shape == want.shape, name
        if want.dtype == ml_dtypes.bfloat16:
            assert tart.is_bf16_bits(got[name]), name
            np.testing.assert_array_equal(_bits(got[name]), _bits(want))
        else:
            assert got[name].dtype == want.dtype and got[name].tobytes() == want.tobytes(), name
    tart.write_safetensors(tmp_path / "port.safetensors", got)
    assert (tmp_path / "port.safetensors").read_bytes() == path.read_bytes()
    tree = tart.params_from_flat(got, "cpu")
    assert tree["w"].dtype == torch.bfloat16 and tree["scale"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(tree["w"]), _bits(tensors["w"]))
    np.testing.assert_array_equal(tree["w"].float().numpy(), tensors["w"].astype(np.float32))
    flat = tart.flatten_pytree(tree)
    np.testing.assert_array_equal(_bits(flat["b"]), _bits(tensors["b"]))
    # the raw values refuse numpy arithmetic and casts instead of reading as integers
    with pytest.raises((TypeError, ValueError)):
        got["w"].astype(np.float32)


def test_bf16_qwen_asr_snapshot_builds_as_jax(tmp_path, capsys):
    import wave

    from asr_tpu import cli as jcli
    from asr_tpu_torch import cli as tcli
    from asr_tpu_torch.loaders.qwen_asr_hf import load_qwen_asr_dir

    src = _bf16_snapshot(tmp_path)
    tdir, jdir, got, want = _run(tmp_path, capsys, ["build", "--family", "qwen_asr", "--checkpoint", str(src)])
    assert got == want.replace(str(jdir), str(tdir))
    assert_same_artifact(jdir, tdir)
    assert (tdir / "weights.safetensors").read_bytes() == (jdir / "weights.safetensors").read_bytes()
    jflat = jart.flatten_pytree(jart.load_model(jdir)[0])
    assert {str(v.dtype) for v in jflat.values()} == {"bfloat16"}
    params, _ = tart.load_model(tdir, "cpu")
    tflat = tart.flatten_pytree(params)
    assert sorted(tflat) == sorted(jflat)
    for key, want_leaf in jflat.items():
        np.testing.assert_array_equal(_bits(tflat[key]), _bits(want_leaf), err_msg=key)
    tower, llm, _ = load_qwen_asr_dir(src)
    assert tower["conv1"]["w"].dtype == torch.bfloat16 and llm["embed"].dtype == torch.bfloat16

    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.default_rng(3).standard_normal(16000) * 3000).astype(np.int16).tobytes())
    # neither package's tower convolves bf16 weights with f32 features: the
    # serving cast widens them exactly
    assert tcli.main(["--platform", "cpu", "--quant-mm", "f32", "transcribe", "--dtype", "float32",
                      "--model-dir", str(tdir), str(wav)]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["--compile-cache", "", "--quant-mm", "f32", "transcribe", "--dtype", "float32",
                      "--model-dir", str(jdir), str(wav)]) == 0
    want = capsys.readouterr().out
    assert got.splitlines()[1] == want.splitlines()[1]


def test_bf16_plan_optimize_is_byte_identical(tmp_path, capsys, xla_order):
    from asr_tpu_torch import cli as tcli

    src = _sensevoice_src(tmp_path / "src")
    assert tcli.main(["build", "--family", "sensevoice", "--checkpoint", str(src),
                      "--out", str(tmp_path / "art")]) == 0
    plan = {"plans": {"enc": {"method": "q8"}, "half": {"method": "bf16"}},
            "assign": [["encoders/0/*", "enc"], ["*", "half"]]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    argv = ["optimize", "--model-dir", str(tmp_path / "art"), "--plan", str(tmp_path / "plan.json")]
    tdir, jdir, _, _ = _run(tmp_path, capsys, argv)
    assert_same_artifact(jdir, tdir)
    assert (tdir / "weights.safetensors").read_bytes() == (jdir / "weights.safetensors").read_bytes()
    params, meta = tart.load_model(tdir, "cpu")
    dtypes = {v.dtype for v in tart.flatten_pytree(params).values()}
    assert tart.BF16_BITS in dtypes and np.dtype(np.int8) in dtypes
    tart.save_model(tmp_path / "again", params, meta)
    assert (tmp_path / "again" / "weights.safetensors").read_bytes() == (
        tdir / "weights.safetensors").read_bytes()
