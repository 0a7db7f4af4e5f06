"""PyTorch port: the plan of the int8 tensor-core kernel, on the CPU.

``int8_plan`` splits a weight's K/block scale blocks into V contiguous
equal parts, V from (K, N, block) alone, so the sum behind each output
(``((part_0 + part_1) + ...) + part_{V-1}``, each part folded block by
block) never depends on the row count M; M picks only the schedule (a
thread block cluster of the V parts, or one block walking them) and the
tile. Every decode shape of the Whisper and q2 paths gets at least 132
blocks (one an H100 SM), every leaf the quantizer makes gets a tile the
kernel has, and the workspace holds x in bf16 over the padded K axis with
its chunk sums. The kernel's bf16 arithmetic, written out here in PyTorch
along the plan's parts (per scale block ``p * s - rowsum(x16) * (z * s)``,
parts added in order), holds JAX's Pallas int8 kernel in interpret mode to
1e-4 of max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.ops import quant_matmul as jqm
from asr_tpu.quant import quantize as jq
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.quant import quantize as tq

TOL = 1e-4
# The int8 (K, N) of the main paths at M = 1..8: Whisper's per-weight step
# (q|k|v|o and cross q|o, fc1, fc2), its head (V padded to 52224) and the
# q2 model's 2-bit tied head (V padded to 152064).
DECODE_SHAPES = [(1280, 1280), (1280, 5120), (5120, 1280), (1280, 52224), (1024, 152064)]
# The other int8 shapes of the main paths: SenseVoiceSmall (K = block = 560
# first, the CTC head at N = 25055), the Whisper encoder, the Qwen3-ASR
# tower (conv_out at K = 7680, the projections), and odd ones (one block of
# 140 rows, few columns).
PATH_SHAPES = [(560, 1536, 560), (512, 1536, 128), (512, 512, 128), (512, 2048, 128),
               (2048, 512, 128), (512, 25055, 128), (7680, 1280, 128), (1280, 1024, 128)]
OTHER_SHAPES = [(140, 100, 140), (256, 30, 128), (1024, 4096, 64), (4096, 11008, 128)]
PLAN_CASES = [(k, n, 128) for k, n in DECODE_SHAPES] + PATH_SHAPES + OTHER_SHAPES
CLUSTER_TILES = set(tqm.INT8_CLUSTER_TILES)


def part_blocks(k, block, v):
    """The scale-block range [start, end) of each of the V parts."""
    per = k // block // v
    return [(i * per, (i + 1) * per) for i in range(v)]


@pytest.mark.parametrize("k,n,block", PLAN_CASES)
def test_split_does_not_depend_on_m(k, n, block):
    v1, bn1 = tqm.int8_split(k, n, block)
    schedules = set()
    for m in range(1, 2049):
        v, bn, bm, walk = tqm.int8_plan(m, k, n, block)
        assert v == v1, f"M={m}"
        if walk:
            assert m > 16 and (bm, bn) in tqm.INT8_WALK_TILES
        else:
            assert (bm, bn) == ((16, bn1) if m <= 16 else (64, 128))
        schedules.add((bn, bm, walk))
    assert len(schedules) >= 2  # the schedule follows M


@pytest.mark.parametrize("k,n,block", PLAN_CASES)
def test_parts_cover_each_scale_block_once(k, n, block):
    v, _ = tqm.int8_split(k, n, block)
    nbk = k // block
    assert 1 <= v <= tqm.PACKED_MAX_SPLIT and nbk % v == 0
    spans = part_blocks(k, block, v)
    assert spans[0][0] == 0 and spans[-1][1] == nbk
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0
    covered = np.zeros(nbk, np.int64)
    for a0, a1 in spans:
        assert a1 - a0 == nbk // v
        covered[a0:a1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_decode_shapes_fill_the_card(k, n):
    for m in range(1, 9):
        v, bn, bm, walk = tqm.int8_plan(m, k, n, 128)
        assert not walk and bm == 16
        assert -(-n // bn) * v >= tqm.SMS == 132


@pytest.mark.parametrize("m,k,block", [(1, 512, 128), (17, 560, 560), (137, 140, 140),
                                       (1096, 2048, 128), (1500, 5120, 128), (416, 7680, 128)])
def test_workspace_holds_padded_x_and_chunk_sums(m, k, block):
    mpad = -(-m // 16) * 16
    bp = -(-block // 64) * 64  # each scale block padded with zero rows to whole stages
    assert bp % tqm.INT8_STAGE == 0 and bp - block < tqm.INT8_STAGE
    kp = k // block * bp
    assert tqm.int8_workspace(m, k, block) == mpad * kp // 2 + (kp // 64) * mpad


def test_every_leaf_the_quantizer_makes_gets_a_tile():
    seen = set()
    for k in list(range(16, 1100, 16)) + [140, 560, 7680]:
        for n in (1, 30, 100, 512, 25055):
            leaf = tq.quantize_linear(torch.zeros((k, 1)), 8, 128)
            block = leaf.block
            assert block == (128 if k % 128 == 0 else k)
            for m in (1, 16, 17, 137, 1500):
                v, bn, bm, walk = tqm.int8_plan(m, k, n, block)
                assert (k // block) % v == 0
                assert ((bm, bn) in tqm.INT8_WALK_TILES) if walk else ((bm, bn) in CLUSTER_TILES)
                seen.add((bm, bn, walk))
    assert {walk for _, _, walk in seen} == {True, False}


def _planned_association(x, q, scale, zero, block, v):
    """The kernel's bf16 arithmetic in PyTorch (f32): per part, per scale
    block, acc += p * s - xs * (z * s); parts added in order."""
    x16 = x.to(torch.bfloat16).to(torch.float32)
    qf = q.to(torch.float32)
    out = None
    for b0, b1 in part_blocks(q.shape[0], block, v):
        acc = torch.zeros((x.shape[0], q.shape[1]))
        for b in range(b0, b1):
            rows = slice(b * block, (b + 1) * block)
            p = x16[:, rows] @ qf[rows]
            xs = x16[:, rows].sum(dim=1, keepdim=True)
            acc = acc + (p * scale[b] - xs * (zero[b] * scale[b]))
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("m", [1, 2, 16, 17])
@pytest.mark.parametrize("k,n,block", [(1280, 256, 128), (512, 128, 128), (560, 64, 560),
                                       (140, 32, 140)])
def test_planned_association_matches_jax_interpret_kernel(k, n, block, m):
    w = (np.random.default_rng(k + n).standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    leaf = jq.quantize_linear(jnp.asarray(w), 8, block, 0)
    assert leaf.block == block
    v, _, _, _ = tqm.int8_plan(m, k, n, block)
    assert (v > 1) == (k // block > 1)  # few columns: the plan splits wherever there are blocks
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // 8) * 8
    xp = np.zeros((m_pad, k), np.float32)
    xp[:m] = x
    want = np.asarray(jqm.quant_matmul_pallas(jnp.asarray(xp), leaf.q, leaf.scale, leaf.zero, block,
                                              tile_m=m_pad, tile_n=min(n, 128), tile_k=k,
                                              interpret=True, mm="bf16"))[:m]
    got = _planned_association(torch.from_numpy(x), *(torch.from_numpy(np.array(a))
                               for a in (leaf.q, leaf.scale, leaf.zero)), block, v).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
