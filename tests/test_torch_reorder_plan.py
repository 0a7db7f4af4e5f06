"""The port's channel reordering (``quant/reorder.py``) and serving plans
(``quant/plan.py``) against the JAX package's: the statistics, the
permutation and the reordered tree bitwise for the four FFN shapes and the
LayerNorm rule on real model trees; ``apply_plans`` bitwise over a plan
table that uses every method and algorithm; plan resolution, validation,
path matching and the JSON round trip both ways.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.quant import plan as jplan, reorder as jre
from asr_tpu.runtime import artifact as jart
from asr_tpu_torch.quant import plan as tplan, reorder as tre
from asr_tpu_torch.runtime import artifact as tart
from tests.test_torch_quant_objectives import xla_order  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads a test: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _model_tree(name: str):
    """A JAX model tree with the FFN shape the name stands for."""
    key = jax.random.PRNGKey(3)
    if name == "sensevoice":  # SANM {w1, b1, w2, b2}
        from asr_tpu.models import sensevoice as m
        from tests.test_loaders import SV_CFG
        return m.init_params(SV_CFG, key)
    if name == "paraformer":  # nested w1/w2 with a norm over the hidden axis
        from asr_tpu.models import paraformer as m
        from tests.test_loaders import PF_CFG
        return m.init_params(PF_CFG, key)
    if name == "firered":  # nested w1/w2 with an input-side norm
        from asr_tpu.models import firered as m
        from tests.test_firered import TINY
        return m.init_params(TINY, key)
    if name == "whisper":  # fc1/fc2
        from asr_tpu.models import whisper as m
        return m.init_params(m.WhisperConfig(vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
                                             num_heads=4, ffn_dim=128, n_mels=16, max_source_positions=24,
                                             max_target_positions=16), key)
    from asr_tpu.layers import qwen3 as m  # gate/up/down
    return m.init_params(m.Qwen3Config(vocab_size=64, hidden=64, num_layers=2, num_heads=2, num_kv_heads=1,
                                       head_dim=32, ffn_dim=96), key)


def _randomized(tree, seed):
    """Distinct channel statistics: random values in every leaf (init
    leaves such as zero biases and unit norms would tie)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                                              * rng.uniform(0.1, 2.0, x.shape[-1:]).astype(np.float32)),
                        tree)


def _assert_same(jtree, ttree):
    jflat, tflat = jart.flatten_pytree(jtree), tart.flatten_pytree(ttree)
    assert list(jflat) == list(tflat)
    for key, want in jflat.items():
        assert tflat[key].dtype == want.dtype and tflat[key].tobytes() == want.tobytes(), key


@pytest.mark.parametrize("stat", ["absmean", "rms", "l4", "std"])
def test_channel_stat_bitwise(stat):
    w = (np.random.default_rng(0).standard_t(3, (96, 40))).astype(np.float32)
    a, b = jre.channel_stat(jnp.asarray(w), stat), tre.channel_stat(torch.from_numpy(w), stat)
    assert a.dtype == b.dtype == np.float64 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("model,pairs", [("sensevoice", 4), ("paraformer", 4), ("firered", 4),
                                         ("whisper", 2), ("qwen3", 2)])
@pytest.mark.parametrize("stat", ["absmean", "std"])
def test_channel_reorder_pytree_bitwise(model, pairs, stat):
    """The reordered tree and the count of FFN pairs, on each model's tree."""
    jtree = _randomized(_model_tree(model), 7)
    ttree = tart.params_from_flat(jart.flatten_pytree(jtree), "cpu")
    jout, jn = jre.channel_reorder_pytree(jtree, stat)
    tout, tn = tre.channel_reorder_pytree(ttree, stat)
    assert jn == tn
    assert tn >= pairs
    _assert_same(jout, tout)
    changed = [k for k, v in tart.flatten_pytree(tout).items()
               if v.tobytes() != tart.flatten_pytree(ttree)[k].tobytes()]
    assert changed


def test_reorder_skips_the_ambiguous_norm_and_keeps_math():
    """hidden == in_dim with a norm over it: skipped by both; an FFN with a
    hidden-axis norm reorders the norm with the hidden axis, and the FFN's
    output is the same up to summation order."""
    rng = np.random.default_rng(1)
    lin = lambda i, o: {"w": rng.standard_normal((i, o)).astype(np.float32),
                        "b": rng.standard_normal(o).astype(np.float32)}
    ln = lambda d: {"scale": rng.uniform(0.5, 2, d).astype(np.float32), "bias": rng.standard_normal(d).astype(np.float32)}
    tree = {"amb": {"w1": lin(32, 32), "w2": lin(32, 32), "norm": ln(32)},
            "ffn": {"w1": lin(32, 48), "w2": lin(48, 32), "norm": ln(48)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = tart.params_from_flat(jart.flatten_pytree(jtree), "cpu")
    jout, jn = jre.channel_reorder_pytree(jtree)
    tout, tn = tre.channel_reorder_pytree(ttree)
    assert jn == tn == 1
    _assert_same(jout, tout)
    assert torch.equal(tout["amb"]["w1"]["w"], ttree["amb"]["w1"]["w"])

    def ffn(p, x):
        h = torch.relu(x @ p["w1"]["w"] + p["w1"]["b"])
        h = torch.nn.functional.layer_norm(h, h.shape[-1:], p["norm"]["scale"], p["norm"]["bias"])
        return h @ p["w2"]["w"] + p["w2"]["b"]

    x = torch.randn(5, 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ffn(tout["ffn"], x), ffn(ttree["ffn"], x), rtol=1e-5, atol=1e-5)


PLAN = {
    "plans": {
        "base": {"method": "q8", "algorithm": "rtn", "block": 64, "min_size": 1024},
        "enc": {"inherit": "base", "algorithm": "kquant", "exclude": ["*/tp_encoders/*"]},
        "q4": {"inherit": "base", "method": "q4", "algorithm": "hqq", "pack": True, "refine_iters": 0},
        "dyn": {"inherit": "base", "algorithm": "dynamic", "embeddings": True},
        "half": {"method": "bf16"},
        "keep": {"method": "f32"},
    },
    "assign": [["encoders0/*", "keep"], ["encoders/*", "enc"], ["tp_encoders/*", "q4"],
               ["ctc/*", "dyn"], ["embed", "dyn"], ["after_norm/*", "half"], ["*", "base"]],
}


def test_apply_plans_bitwise(tmp_path, xla_order):
    """Every method (q8, q4 packed, bf16, f32) and algorithm (rtn, kquant,
    hqq, dynamic) over a tiny SenseVoice tree (every K above 32 rows) with
    an embedding table; bf16 leaves compare as their f32 widening (the
    port's artifacts hold no bf16)."""
    from asr_tpu.models import sensevoice as jsv
    from tests.test_torch_sensevoice import TINY

    jtree = _randomized(jsv.init_params(jsv.SenseVoiceConfig(**TINY), jax.random.PRNGKey(0)), 3)
    jtree["embed"] = jnp.asarray(np.random.default_rng(4).standard_normal((300, 64)).astype(np.float32))
    ttree = tart.params_from_flat(jart.flatten_pytree(jtree), "cpu")
    (tmp_path / "plan.json").write_text(json.dumps(PLAN))
    jout = jplan.apply_plans(jtree, jplan.OptimizerConfig.load(tmp_path / "plan.json"))
    tout = tplan.apply_plans(ttree, tplan.OptimizerConfig.load(tmp_path / "plan.json"))
    assert tout["after_norm"]["scale"].dtype == torch.bfloat16
    assert jout["after_norm"]["scale"].dtype == jnp.bfloat16
    widen = lambda t: {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in t.items()}
    jout["after_norm"] = jax.tree.map(lambda x: x.astype(jnp.float32), jout["after_norm"])
    tout["after_norm"] = widen(tout["after_norm"])
    _assert_same(jout, tout)
    enc, tp, ctc = tout["encoders"][0], tout["tp_encoders"][0], tout["ctc"]["w"]
    assert enc["qkv"]["w"].bits == 8 and tp["ffn"]["w2"].packed and ctc.dynamic
    assert tout["embed"].bits == 8 and isinstance(tout["encoders0"][0]["qkv"]["w"], torch.Tensor)


def test_plan_resolution_validation_and_round_trip(tmp_path):
    (tmp_path / "plan.json").write_text(json.dumps(PLAN))
    jcfg = jplan.OptimizerConfig.load(tmp_path / "plan.json")
    tcfg = tplan.OptimizerConfig.load(tmp_path / "plan.json")
    for name in PLAN["plans"]:
        assert jplan.resolve_plan(jcfg, name).__dict__ == tplan.resolve_plan(tcfg, name).__dict__
    for path in ("encoders/0/qkv/w", "tp_encoders/1/out/w", "embed", "x/y"):
        a, b = jplan.plan_for_path(jcfg, path), tplan.plan_for_path(tcfg, path)
        assert (a and a.__dict__) == (b and b.__dict__)
    assert tplan.resolve_plan(tcfg, "q4").bits == 4
    tcfg.save(tmp_path / "t.json")
    jcfg.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert jplan.OptimizerConfig.load(tmp_path / "t.json") == jcfg
    bad = [{"plans": {"a": {"inherit": "b"}, "b": {"inherit": "a"}}, "assign": [["*", "a"]]},
           {"plans": {"a": {"method": "q3"}}, "assign": [["*", "a"]]},
           {"plans": {"a": {"method": "q8", "pack": True}}, "assign": [["*", "a"]]},
           {"plans": {"a": {"method": "q8", "block": 12}}, "assign": [["*", "a"]]},
           {"plans": {"a": {"method": "q8", "algorithm": "awq"}}, "assign": [["*", "a"]]},
           {"plans": {}, "assign": [["*", "missing"]]}]
    for i, raw in enumerate(bad):
        (tmp_path / f"bad{i}.json").write_text(json.dumps(raw))
        msgs = []
        for pkg in (jplan, tplan):
            with pytest.raises(pkg.PlanError) as err:
                pkg.apply_plans({"w": jnp.zeros((4, 4)) if pkg is jplan else torch.zeros(4, 4)},
                                pkg.OptimizerConfig.load(tmp_path / f"bad{i}.json"))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
