"""PyTorch port on a CUDA card: the int8 dequant-matmul kernel against its
plain version at the SenseVoiceSmall q8 shapes, and the kernel launch count
of one full-geometry forward. Each test skips where no card is present.

This file imports no JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import pytest
import torch

from asr_tpu_torch.ops import quant_matmul as qm
from asr_tpu_torch.quant.quantize import quantize_linear

# Every distinct (K, N, block) of the SenseVoiceSmall q8 forward.
SLICE_SHAPES = [(560, 1536, 560), (512, 1536, 128), (512, 512, 128),
                (512, 2048, 128), (2048, 512, 128), (512, 25055, 128)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("k,n,block", SLICE_SHAPES)
def test_kernel_matches_plain_version(k, n, block, mm):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(k + n)
    leaf = quantize_linear(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, 8, 128)
    assert leaf.block == block
    for m in (1, 137, 1096):
        x = torch.randn((m, k), generator=g, device="cuda")
        before = qm.LAUNCHES
        got = qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        torch.cuda.synchronize()
        assert qm.LAUNCHES == before + 1
        want = qm.quant_dense_reference(x, leaf.q, leaf.scale, leaf.zero, leaf.block, mm)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    leaf = quantize_linear(torch.randn((256, 128), device="cuda"), 8, 128)
    x = torch.randn((4, 256), device="cuda")
    with pytest.raises(TypeError):
        qm.quant_matmul_int8(x.double(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int8(x.t().contiguous().t(), leaf.q, leaf.scale, leaf.zero, 128, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int8(x, leaf.q, leaf.scale, leaf.zero, 96, "f32")
    with pytest.raises(ValueError):
        qm.quant_matmul_int8(x, leaf.q.cpu(), leaf.scale, leaf.zero, 128, "f32")


@pytest.mark.gpu
def test_q8_forward_launches_kernel_once_per_linear():
    _need_card()
    from asr_tpu_torch.models import sensevoice as sv
    from asr_tpu_torch.quant.quantize import quantize_pytree

    cfg = sv.SenseVoiceConfig()
    params = quantize_pytree(sv.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
    audio = torch.randn((2, 32000), device="cuda") * 2000
    valid = torch.tensor([32000, 20000], device="cuda")
    lang = torch.zeros(2, dtype=torch.int64, device="cuda")
    before = qm.LAUNCHES
    with torch.inference_mode():
        toks, counts = sv.forward(params, cfg, audio, valid, lang)
    torch.cuda.synchronize()
    assert qm.LAUNCHES - before == 4 * cfg.num_blocks + 1 == 281
    assert toks.shape[0] == 2 and counts.shape == (2,)
