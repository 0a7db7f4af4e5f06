"""PyTorch port: the split-K plan of the packed-int4 and packed-int2
tensor-core kernels, on the CPU.

``packed_plan`` picks the split count S and the tile width BN from
(K, N, block, parts) alone, so the sum behind each output never depends on
the row count M; its parts fall on scale-block boundaries and cover every
packed row once; every decode shape of the q2 and q4 paths gets at least
132 blocks (one an H100 SM); and the wrapper's shape check takes every
leaf the packer packs at blocks 32, 64 and 128. The kernel's bf16
arithmetic, written out here in PyTorch along the plan's split (per scale
block and plane ``p * s - rowsum(x16) * (z * s)``, parts added in order),
holds JAX's Pallas p4 / p2 kernels in interpret mode to 1e-4 of max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant import quantize as jq
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant import quantize as tq
from asr_tpu_torch.quant.quantize import unpack2_quarters, unpack4_halves

TOL = 1e-4
# Every packed (K, N) of the Qwen3-ASR-0.6B q4 path (with the tied head)
# and of the q2 path, at block 128: parts 2 for int4, 4 for int2.
PATH_SHAPES = [(2, 1024, 4096), (2, 2048, 1024), (2, 1024, 6144), (2, 3072, 1024), (2, 1024, 153600),
               (4, 1024, 4096), (4, 2048, 1024), (4, 1024, 6144), (4, 3072, 1024)]
# Off the path: the CPU tests' widths (hidden 512, FFN 1024), ragged N, blocks 32 and 64.
OTHER_SHAPES = [(2, 512, 1024, 128), (4, 1024, 512, 128), (2, 256, 30, 32), (4, 1024, 100, 64),
                (4, 512, 1024, 128), (2, 4096, 11008, 64)]
PLAN_CASES = [(p, k, n, 128) for p, k, n in PATH_SHAPES] + OTHER_SHAPES


def split_rows(k, parts, block, s):
    """The packed-row range [start, end) of each of the S parts, as
    ``packed_mma_kernel`` cuts them: part i takes scale blocks
    [i*nb // S, (i+1)*nb // S)."""
    nbk = k // parts // block
    return [(i * nbk // s * block, (i + 1) * nbk // s * block) for i in range(s)]


@pytest.mark.parametrize("parts,k,n,block", PLAN_CASES)
def test_plan_does_not_depend_on_m(parts, k, n, block):
    s1, bn1, _ = tqm.packed_plan(1, k, n, parts, block)
    for m in range(1, 513):
        s, bn, bm = tqm.packed_plan(m, k, n, parts, block)
        assert (s, bn) == (s1, bn1), f"M={m}"
        assert bm == 16 if m <= 16 else bm in (32, 64)


@pytest.mark.parametrize("parts,k,n,block", PLAN_CASES)
def test_splits_cover_each_packed_row_once_on_block_boundaries(parts, k, n, block):
    s, bn, _ = tqm.packed_plan(1, k, n, parts, block)
    kp = k // parts
    assert 1 <= s <= min(kp // block, tqm.PACKED_MAX_SPLIT) and bn in (16, 32, 64, 128)
    spans = split_rows(k, parts, block, s)
    assert len(spans) == s and spans[0][0] == 0 and spans[-1][1] == kp
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    for a0, a1 in spans:
        assert a0 < a1 and a0 % block == 0 and a1 % block == 0
        assert a0 % tqm.PACKED_STAGE == 0 and (a1 - a0) % tqm.PACKED_STAGE == 0
    covered = np.zeros(kp, np.int64)
    for a0, a1 in spans:
        covered[a0:a1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("parts,k,n", PATH_SHAPES)
def test_decode_shapes_fill_the_card(parts, k, n):
    s, bn, bm = tqm.packed_plan(1, k, n, parts, 128)
    assert bm == 16
    assert -(-n // bn) * s >= tqm.SMS == 132


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4])
def test_wrapper_takes_every_leaf_the_packer_packs(bits, block):
    parts = 8 // bits
    packed = 0
    for k in range(32, 3200, 32):
        for n in (1, 30, 100, 1024):
            w = torch.zeros((k, n))
            leaf = tq.quantize_linear(w, bits, block, 0, pack=True)
            if not leaf.packed:
                continue
            packed += 1
            for m in (1, 17, 432):
                tqm.check_packed_shapes(parts, (m, k), leaf.q.shape, leaf.scale.shape,
                                        leaf.zero.shape, leaf.block)
                s, _, _ = tqm.packed_plan(m, k, n, parts, leaf.block)
                assert 1 <= s <= k // parts // leaf.block
    assert packed > 0


def test_wrapper_refuses_blocks_off_the_stage():
    leaf = tq.quantize_linear(torch.zeros((512, 64)), 2, 16, 0, pack=True)
    assert leaf.packed and leaf.block == 16
    with pytest.raises(ValueError, match="multiple"):
        tqm.check_packed_shapes(4, (1, 512), leaf.q.shape, leaf.scale.shape, leaf.zero.shape, 16)


def _split_schedule(x, q, scale, zero, block, parts, s):
    """The kernel's bf16 arithmetic in PyTorch (f32): per part, per scale
    block, per plane, acc += p * s - xs * (z * s); parts added in order."""
    u = (unpack4_halves(q) if parts == 2 else unpack2_quarters(q)).to(torch.float32)
    k = u.shape[0]
    kp, nbk = k // parts, k // parts // block
    x16 = x.to(torch.bfloat16).to(torch.float32)
    out = None
    for a0, a1 in split_rows(k, parts, block, s):
        acc = torch.zeros((x.shape[0], u.shape[1]))
        for b in range(a0 // block, a1 // block):
            for j in range(parts):
                rows = slice(j * kp + b * block, j * kp + (b + 1) * block)
                p = x16[:, rows] @ u[rows]
                xs = x16[:, rows].sum(dim=1, keepdim=True)
                sc, zs = scale[j * nbk + b], zero[j * nbk + b] * scale[j * nbk + b]
                acc = acc + (p * sc - xs * zs)
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("m", [1, 2, 16, 17])
@pytest.mark.parametrize("bits,k,n", [(4, 1024, 256), (2, 2048, 128)])
def test_split_schedule_matches_jax_interpret_kernel(bits, k, n, m):
    parts = 8 // bits
    w = (np.random.default_rng(k + n).standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    leaf = jq.quantize_linear(jnp.asarray(w), bits, 128, 0, pack=True)
    assert leaf.packed
    s, _, _ = tqm.packed_plan(m, k, n, parts, 128)
    assert s == k // parts // 128 > 1  # few columns: the plan splits to every scale block
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // 8) * 8
    xp = np.zeros((m_pad, k), np.float32)
    xp[:m] = x
    kern = jqm.quant_matmul_pallas_p4 if bits == 4 else jqm.quant_matmul_pallas_p2
    tile_k = {"tile_k2": k // 2} if bits == 4 else {"tile_k4": k // 4}
    want = np.asarray(kern(jnp.asarray(xp), leaf.q, leaf.scale, leaf.zero, 128, tile_m=m_pad,
                           tile_n=128, interpret=True, mm="bf16", **tile_k))[:m]
    got = _split_schedule(torch.from_numpy(x), *(torch.from_numpy(np.asarray(a))
                          for a in (leaf.q, leaf.scale, leaf.zero)), 128, parts, s).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
