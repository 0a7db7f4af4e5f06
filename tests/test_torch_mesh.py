"""PyTorch port: ``parallel/mesh.py`` against the JAX package's mesh module.

The spec functions return JAX's spec trees leaf for leaf (compared as
strings). The port's ``shard_params`` splits fused leaves by heads (SANM
``qkv`` and ``fsmn_w``, Qwen3 ``qkv`` / ``gateup``), splits an uneven
vocabulary head with ``tensor_split`` and marks row shards and gathered
heads; the model-axis group sums in rank order (every rank bitwise the
same) and a rank that raises aborts the others. Sharded forwards are held
against JAX's ``shard_params`` forward on the 8 virtual CPU devices of
``tests/conftest.py`` and against the unsharded port: f32 logits within
1e-4 * max|logit|, q8 / q4 logits within 1e-3 * max|logit|, ids equal.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.layers import qwen3 as jq3
from asr_tpu.models import sensevoice as jsv
from asr_tpu.models import whisper as jwh
from asr_tpu.parallel import mesh as jmesh
from asr_tpu.quant.quantize import quantize_pytree as jquantize
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.layers import qwen3 as tq3
from asr_tpu_torch.layers import sanm as tsanm
from asr_tpu_torch.models import sensevoice as tsv
from asr_tpu_torch.models import whisper as twh
from asr_tpu_torch.ops import quant_matmul as tqm
from asr_tpu_torch.parallel import mesh as pm
from asr_tpu_torch.quant.quantize import QuantizedLinear
from asr_tpu_torch.runtime import artifact as tart

CPU = torch.device("cpu")
SV = dict(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=64, num_encoders0=1,
          num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)
WH = dict(vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1, num_heads=4, n_mels=16,
          max_source_positions=40, max_target_positions=24, sot_id=1, eot_id=2,
          first_language_id=10, num_languages=4, transcribe_id=20, translate_id=21,
          no_timestamps_id=22, no_speech_id=30)
UNEVEN = dict(SV, vocab_size=63)  # SenseVoiceSmall's 25055 is odd too
Q3 = dict(vocab_size=64, hidden=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
          ffn_dim=48)


@pytest.fixture(autouse=True)
def _torch_mode():
    prev, mm = torch.get_num_threads(), tqm._CONFIG["mm"]
    torch.set_num_threads(2)
    tqm.set_quant_config(mm="f32")
    yield
    tqm._CONFIG["mm"] = mm
    torch.set_num_threads(prev)


def to_port(jp):
    return tart.params_from_flat(jart.flatten_pytree(jp), "cpu")


def cpu_mesh(n, tp=1):
    return pm.make_mesh(n, model_parallel=tp, devices=[CPU] * n)


def spec_strings(tree, prefix=""):
    """{path: str(spec)} of a spec tree of either package; a quantized
    leaf's spec lists its q / scale / zero specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(spec_strings(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(spec_strings(v, f"{prefix}{i}/"))
        return out
    if hasattr(tree, "scale") and hasattr(tree, "q"):
        return {prefix + f: str(getattr(tree, f)) for f in ("q", "scale", "zero")}
    return {prefix[:-1]: str(tree)}


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _sv_params(seed=0, q8=False):
    jp = jsv.init_params(jsv.SenseVoiceConfig(**SV), jax.random.PRNGKey(seed))
    if q8:
        jp = jquantize(jp, bits=8, block=16, min_size=0)
    return jp


def _wh_params(seed=7, q8=False):
    jp = jwh.init_params(jwh.WhisperConfig(**WH), jax.random.PRNGKey(seed))
    if q8:
        jp = jquantize(jp, bits=8, block=16, min_size=0)
    return jp


def _q3_params(seed=3, bits=None, tied=True):
    cfg = jq3.Qwen3Config(**Q3, tie_embeddings=tied)
    jp = jq3.init_params(cfg, jax.random.PRNGKey(seed))
    if bits == 8:
        jp = jquantize(jp, bits=8, block=16, min_size=0)
    elif bits == 4:
        jp = jquantize(jp, bits=4, block=16, min_size=0, pack=True)
    return jq3.fuse_params(jp, cfg)


SPEC_CASES = {
    "sensevoice": (lambda: _sv_params(), "sensevoice_param_specs"),
    "sensevoice_q8": (lambda: _sv_params(q8=True), "sensevoice_param_specs"),
    "whisper": (lambda: _wh_params(), "whisper_param_specs"),
    "whisper_q8": (lambda: _wh_params(q8=True), "whisper_param_specs"),
    "qwen3_fused": (lambda: _q3_params(), "qwen3_param_specs"),
    "qwen3_q8_untied": (lambda: _q3_params(bits=8, tied=False), "qwen3_param_specs"),
    "qwen3_q4": (lambda: _q3_params(bits=4), "qwen3_param_specs"),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_trees_match_jax(case):
    """Exact: the same spec, as a string, at every leaf path."""
    make, fn = SPEC_CASES[case]
    jp = make()
    want = spec_strings(getattr(jmesh, fn)(jp))
    got = spec_strings(getattr(pm, fn)(to_port(jp)))
    assert got == want
    if case in ("whisper_q8", "qwen3_q8_untied", "qwen3_q4"):  # quantized leaves shard too
        assert any("'model'" in v and k.endswith("/w/q") for k, v in got.items())


def test_mesh_shape_and_refusals():
    """A (data, model) grid like JAX's make_mesh (8 positions, as the JAX
    tests' 8 virtual devices); a device may repeat; bad layouts raise."""
    mesh = cpu_mesh(8, tp=2)
    assert mesh.shape == {"data": 4, "model": 2} == dict(jmesh.make_mesh(8, model_parallel=2).shape)
    assert mesh.row(1).shape == {"data": 1, "model": 2}
    assert str(pm.P(None, "model")) == str(jax.sharding.PartitionSpec(None, "model"))
    assert str(pm.P()) == str(jax.sharding.PartitionSpec())
    for n, tp in ((6, 4), (9, 1)):
        with pytest.raises(ValueError, match="cannot lay"):
            pm.make_mesh(n, model_parallel=tp, devices=[CPU] * 8)


def test_sanm_and_qwen_fused_leaves_split_by_heads():
    """Rank r's qkv piece is [q_r | k_r | v_r] (Qwen3: q by q heads, k / v by
    kv heads), gateup [gate_r | up_r], fsmn_w v's channels of rank r; the
    pieces of an int8 leaf split q / scale / zero the same way."""
    tp = 2
    sv = tsv.init_params(tsv.SenseVoiceConfig(**SV), torch.Generator().manual_seed(0))
    lay = pm.shard_params(sv, cpu_mesh(tp, tp), pm.sensevoice_param_specs(sv))
    w, fsmn = sv["encoders"][0]["qkv"]["w"], sv["encoders"][0]["fsmn_w"]
    h = SV["hidden"]
    for r in range(tp):
        blk = lay.local(0, r)["encoders"][0]
        cols = [c for part in range(3) for c in range(part * h + r * h // tp, part * h + (r + 1) * h // tp)]
        assert torch.equal(blk["qkv"]["w"], w[:, cols])
        assert torch.equal(blk["fsmn_w"], fsmn[:, r * h // tp : (r + 1) * h // tp])
        assert blk["fsmn_w"].tp_role == "gather" and blk["out"]["w"].tp_role == "row"
        assert torch.equal(blk["out"]["w"], sv["encoders"][0]["out"]["w"][r * h // tp : (r + 1) * h // tp])
        assert not hasattr(blk["qkv"]["w"], "tp_role")  # a column shard stays local

    jp = _q3_params(bits=8)
    tp_tree = to_port(jp)
    lay = pm.shard_params(tp_tree, cpu_mesh(tp, tp), pm.qwen3_param_specs(tp_tree))
    qkv, gu = tp_tree["layers"][0]["attn"]["qkv"]["w"], tp_tree["layers"][0]["mlp"]["gateup"]["w"]
    qd, kd, f = Q3["num_heads"] * Q3["head_dim"], Q3["num_kv_heads"] * Q3["head_dim"], Q3["ffn_dim"]
    for r in range(tp):
        lay_r = lay.local(0, r)["layers"][0]
        cols = (list(range(r * qd // tp, (r + 1) * qd // tp))
                + list(range(qd + r * kd // tp, qd + (r + 1) * kd // tp))
                + list(range(qd + kd + r * kd // tp, qd + kd + (r + 1) * kd // tp)))
        for field in ("q", "scale", "zero"):
            assert torch.equal(lay_r["attn"]["qkv"]["w"][field], qkv[field][:, cols])
        gcols = list(range(r * f // tp, (r + 1) * f // tp)) + list(range(f + r * f // tp, f + (r + 1) * f // tp))
        assert torch.equal(lay_r["mlp"]["gateup"]["w"].q, gu.q[:, gcols])
        # a quantized row position stays whole (the spec replicates it)
        assert lay_r["attn"]["o"]["w"].q.shape == tp_tree["layers"][0]["attn"]["o"]["w"].q.shape
        assert not hasattr(lay_r["attn"]["o"]["w"], "tp_role")


@pytest.mark.parametrize("tp", [2, 4])
def test_uneven_ctc_head_is_split_and_gathered(tp):
    """63 columns over T ranks: ``tensor_split`` shares, concatenated back by
    the gather to the whole head's output (exact on the CPU). JAX's
    device_put refuses such a split; GSPMD pads it inside a jit."""
    sv = tsv.init_params(tsv.SenseVoiceConfig(**UNEVEN), torch.Generator().manual_seed(1))
    lay = pm.shard_params(sv, cpu_mesh(tp, tp), pm.sensevoice_param_specs(sv))
    widths = [lay.local(0, r)["ctc"]["w"].shape[1] for r in range(tp)]
    assert widths == [t.shape[1] for t in torch.tensor_split(sv["ctc"]["w"], tp, dim=1)]
    assert sum(widths) == UNEVEN["vocab_size"] and len(set(widths)) == 2
    x = torch.randn(3, 5, SV["hidden"], generator=torch.Generator().manual_seed(2))
    from asr_tpu_torch.layers.transformer import dense

    got = pm.run_grid(lay.mesh, lambda d, m: dense(x, lay.local(d, m)["ctc"]))[0]
    want = dense(x, sv["ctc"])
    for g in got:
        close(g, want, 1e-6)


def test_fsmn_memory_is_gathered_before_the_row_sum():
    """One SANM block at T = 2 and 4 equals the unsharded block within
    1e-4 * max; without the FSMN gather the local memory could not join the
    whole row sum (the shapes disagree)."""
    sv = tsv.init_params(tsv.SenseVoiceConfig(**SV), torch.Generator().manual_seed(3))
    blk = sv["encoders"][0]
    x = torch.randn(2, 7, SV["hidden"], generator=torch.Generator().manual_seed(4))
    want = tsanm.sanm_block(x, blk, SV["num_heads"], SV["head_dim"], None, None, residual=True)
    for tp in (2, 4):
        lay = pm.shard_params(sv, cpu_mesh(tp, tp), pm.sensevoice_param_specs(sv))
        outs = pm.run_grid(lay.mesh, lambda d, m: tsanm.sanm_block(
            x, lay.local(d, m)["encoders"][0], SV["num_heads"], SV["head_dim"], None, None, True))[0]
        for o in outs:
            close(o, want, 1e-4)
        assert all(torch.equal(o, outs[0]) for o in outs)


def test_collectives_are_bitwise_the_same_on_every_rank():
    mesh = cpu_mesh(4, tp=4)
    g = torch.Generator().manual_seed(5)
    parts = [torch.randn(3, 7, generator=g) * 10 ** r for r in range(4)]
    out = pm.run_grid(mesh, lambda d, m: (pm.all_reduce(parts[m]), pm.all_gather(parts[m])))[0]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    for red, gat in out:
        assert torch.equal(red, want)
        assert torch.equal(gat, torch.cat(parts, dim=-1))


def test_a_rank_that_raises_aborts_the_others():
    """Rank 1 raises before the collective rank 0 waits in: the error comes
    back at once (a barrier abort), not after the timeout."""
    mesh = cpu_mesh(2, tp=2)
    waited = threading.Event()

    def fn(d, m):
        if m == 1:
            time.sleep(0.2)
            raise KeyError("rank 1 failed")
        waited.set()
        return pm.all_reduce(torch.ones(2))

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 1 failed"):
        pm.run_grid(mesh, fn, timeout=120.0)
    assert waited.is_set() and time.perf_counter() - t0 < 30.0


def _jax_sharded(jp, specs_fn, tp, n=8):
    mesh = jmesh.make_mesh(n, model_parallel=tp)
    return jmesh.shard_params(jp, mesh, getattr(jmesh, specs_fn)(jp))


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4), (4, 2)])
def test_sensevoice_sharded_logits_match_jax_and_unsharded(dp, tp):
    """dp x tp over the runner: logits within 1e-4 * max of JAX's sharded
    forward and of the unsharded port, ids equal."""
    from asr_tpu_torch.parallel.serve import DataParallelRunner

    jcfg, tcfg = jsv.SenseVoiceConfig(**SV), tsv.SenseVoiceConfig(**SV)
    jp = _sv_params(seed=2)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((5, 4800)) * 2000).astype(np.float32)
    valid = np.array([4800, 4000, 3100, 4800, 2000], np.int32)
    lang = np.zeros((5,), np.int32)
    jsh = _jax_sharded(jp, "sensevoice_param_specs", tp)
    jlog, jvalid = jsv.encode_logits(jsh, jcfg, jnp.asarray(audio), jnp.asarray(valid), jnp.asarray(lang))
    tp_tree = to_port(jp)
    with torch.inference_mode():
        want, _ = tsv.encode_logits(tp_tree, tcfg, torch.from_numpy(audio), torch.from_numpy(valid),
                                    torch.from_numpy(lang))
    runner = DataParallelRunner(cpu_mesh(dp * tp, tp), pm.sensevoice_param_specs)
    got, gvalid = runner(lambda p, a, v, li: tsv.encode_logits(p, tcfg, a, v, li),
                         runner.shard_params(tp_tree), audio, valid, lang)
    assert torch.equal(gvalid.to(torch.int32), torch.from_numpy(np.asarray(jvalid)))
    close(got, np.asarray(jlog), 1e-4)
    close(got, want, 1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_sensevoice_q8_row_shards_match_unsharded():
    """q8 SenseVoice at dp 2 x tp 2: out / ffn.w2 sliced by rows at block
    boundaries, qkv / ffn.w1 / the (uneven) CTC head by columns; logits
    within 1e-3 * max of the unsharded q8 port, ids equal."""
    from asr_tpu_torch.parallel.serve import DataParallelRunner

    tcfg = tsv.SenseVoiceConfig(**UNEVEN)
    jp = jquantize(jsv.init_params(jsv.SenseVoiceConfig(**UNEVEN), jax.random.PRNGKey(4)),
                   bits=8, block=16, min_size=0)
    tp_tree = to_port(jp)
    lay_specs = pm.sensevoice_param_specs(tp_tree)
    runner = DataParallelRunner(cpu_mesh(4, 2), lay_specs)
    lay = runner.shard_params(tp_tree)
    out_w = lay.local(0, 1)["encoders"][0]["out"]["w"]
    assert isinstance(out_w, QuantizedLinear) and out_w.tp_role == "row"
    assert out_w.q.shape[0] == SV["hidden"] // 2
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal((4, 4800)) * 2000).astype(np.float32)
    valid = np.full((4,), 4800, np.int32)
    lang = np.zeros((4,), np.int32)
    with torch.inference_mode():
        want, _ = tsv.encode_logits(tp_tree, tcfg, torch.from_numpy(audio), torch.from_numpy(valid),
                                    torch.from_numpy(lang))
    got, _ = runner(lambda p, a, v, li: tsv.encode_logits(p, tcfg, a, v, li), lay, audio, valid, lang)
    close(got, want, 1e-3)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_whisper_tp_encoder_matches_jax_and_unsharded(q8):
    """A (2 data, 4 model) mesh, as JAX's test: the encoder within 1e-4 *
    max (q8: 1e-3) of JAX's sharded encoder and the unsharded port."""
    from asr_tpu_torch.parallel.serve import DataParallelRunner

    jcfg, tcfg = jwh.WhisperConfig(**WH), twh.WhisperConfig(**WH)
    jp = _wh_params(q8=q8)
    mel = np.random.default_rng(2).standard_normal((2, 20, 16)).astype(np.float32)
    tp_tree = to_port(jp)
    with torch.inference_mode():
        want = twh.encode(tp_tree, tcfg, torch.from_numpy(mel))
    runner = DataParallelRunner(cpu_mesh(8, 4), pm.whisper_param_specs)
    got = runner(lambda p, m: twh.encode(p, tcfg, m), runner.shard_params(tp_tree), mel)
    rel = 1e-3 if q8 else 1e-4
    close(got, want, rel)
    if not q8:
        close(got, np.asarray(jwh.encode(_jax_sharded(jp, "whisper_param_specs", 4), jcfg,
                                         jnp.asarray(mel))), rel)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "q8", "q4"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
def test_qwen3_tp_prefill_matches_jax_and_unsharded(bits, tied):
    """A Qwen3 prefill at tp 2 (kv heads 2): logits within 1e-4 * max (q8 /
    q4: 1e-3) of the unsharded port and, f32, of JAX's sharded forward."""
    jcfg, tcfg = jq3.Qwen3Config(**Q3, tie_embeddings=tied), tq3.Qwen3Config(**Q3, tie_embeddings=tied)
    jp = _q3_params(bits=bits, tied=tied)
    ids = np.random.default_rng(5).integers(0, 64, (1, 6))
    t_max = 12

    def jrun(p):
        state = jq3.make_kv_state(jcfg, 1, t_max)
        bias = jq3.causal_prefill_bias(jnp.asarray([6]), 6, t_max)
        hidden, _ = jq3.decoder_pass(p, jcfg, p["embed"][jnp.asarray(ids)], state, jnp.asarray(0, jnp.int32), bias)
        return np.asarray(jq3.logits_from_hidden(p, jcfg, hidden))

    def trun(p):
        state = tq3.make_kv_state(tcfg, 1, t_max)
        bias = tq3.causal_prefill_bias(torch.tensor([6]), 6, t_max)
        hidden, _ = tq3.decoder_pass(p, tcfg, p["embed"][torch.from_numpy(ids)], state, 0, bias)
        return tq3.logits_from_hidden(p, tcfg, hidden)

    tp_tree = to_port(jp)
    with torch.inference_mode():
        want = trun(tp_tree)
    lay = pm.shard_params(tp_tree, cpu_mesh(2, 2), pm.qwen3_param_specs(tp_tree))
    got = pm.run_grid(lay.mesh, lambda d, m: trun(lay.local(d, m)))[0]
    rel = 1e-4 if bits is None else 1e-3
    assert torch.equal(got[0], got[1])
    close(got[0], want, rel)
    assert torch.equal(got[0].argmax(-1), want.argmax(-1))
    if bits is None:
        close(got[0], jrun(_jax_sharded(jp, "qwen3_param_specs", 2)), rel)


def test_positions_on_one_device_take_turns():
    """Rank threads on one device never run at once (each holds the
    device's turn until it waits at a collective), yet a tp group still
    meets at its collectives; the turn is free again afterwards."""
    running, most = [0], [0]
    guard = threading.Lock()

    def fn(d, m):
        for _ in range(3):
            with guard:
                running[0] += 1
                most[0] = max(most[0], running[0])
            time.sleep(0.01)
            with guard:
                running[0] -= 1
            out = pm.all_reduce(torch.ones(1) * m)
        return out

    out = pm.run_grid(cpu_mesh(4, 2), fn)
    assert most[0] == 1
    assert all(torch.equal(o, torch.ones(1)) for row in out for o in row)
    assert pm.device_lock(CPU).acquire(timeout=1)
    pm.device_lock(CPU).release()
