"""PyTorch port: decode strategies and the AR loop against the JAX package.

Greedy and the repetition penalty are compared bitwise. The sampler draws
its noise from a threefry key in JAX; here each test recomputes JAX's draw
(``jax.random.uniform(key, shape, f32, 1e-20, 1.0)`` on the key that
``select_token`` splits off) and feeds the same array to the port, so sampled
ids are bitwise equal too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode import ar as jar
from asr_tpu.decode import strategies as jst
from asr_tpu_torch.decode import ar as tar
from asr_tpu_torch.decode import strategies as tst


def _logits(seed, b=3, v=97):
    return (np.random.default_rng(seed).standard_normal((b, v)) * 3).astype(np.float32)


def test_config_fields_match():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(jar.DecodeConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(tar.DecodeConfig)])
    assert tst.NEG_INF == jst.NEG_INF


@pytest.mark.parametrize("ids", [(), (0,), (3, 5, 96)])
def test_suppress_tokens_matches_jax(ids):
    x = _logits(0)
    want = np.asarray(jst.suppress_tokens(jnp.asarray(x), ids))
    got = tst.suppress_tokens(torch.from_numpy(x), ids).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hist_len,start,rng", [(9, 2, 4), (12, 0, 64), (5, 5, 3)])
def test_repetition_penalty_matches_jax(hist_len, start, rng):
    x = _logits(1)
    hist = np.random.default_rng(2).integers(0, 97, size=(3, 12)).astype(np.int32)
    want = np.asarray(jst.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(hist), hist_len, 1.3,
                                                   rng, hist_start=start))
    got = tst.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(hist), hist_len, 1.3,
                                       rng, hist_start=start).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32, 1e-20, 1.0))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                                     (1.3, 0, 0.8), (0.9, 10, 0.6)])
def test_sampler_with_jax_noise_matches_jax(temperature, top_k, top_p):
    x = _logits(3, b=4)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jst.top_k_top_p_sample(jnp.asarray(x), key, temperature, top_k, top_p))
    got = tst.top_k_top_p_sample(torch.from_numpy(x), torch.from_numpy(_jax_uniform(key, x.shape)),
                                 temperature, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_draws_from_generator_when_no_noise_is_given():
    x = torch.from_numpy(_logits(4, b=2))
    a = tst.top_k_top_p_sample(x, None, 1.0, 8, 0.9, generator=torch.Generator().manual_seed(5))
    b = tst.top_k_top_p_sample(x, None, 1.0, 8, 0.9, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    u = tst.uniform_noise((2, 97), "cpu", torch.Generator().manual_seed(5))
    assert float(u.min()) >= 1e-20 and float(u.max()) < 1.0


class JaxNoise:
    """The port's ``noise`` hook replaying JAX's key chain: ``select_token``
    splits ``(key, sub)`` off its key once per sampling call."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape, device):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(_jax_uniform(sub, shape)).to(device)


# A toy decoder: logits depend on the fed token and the position, from a
# fixed table, so both packages see the same step function.
V, T_TAB = 23, 40
TABLE = (np.random.default_rng(7).standard_normal((V, T_TAB, V)) * 2).astype(np.float32)
TABLE[:, :, 4] += 4.0  # token 4 (the EOT of most cases) wins often, so rows finish early


def _jax_step(state, tok, pos):
    return jnp.asarray(TABLE)[tok[:, 0], pos] + state, state


def _torch_step(state, tok, pos):
    return torch.from_numpy(TABLE)[tok[:, 0], pos] + state, state


@pytest.mark.parametrize("strategy,eot,max_new", [("greedy", 4, 12), ("greedy", -1, 6),
                                                  ("penalty", 4, 12), ("sampling", 4, 10)])
def test_ar_decode_matches_jax(strategy, eot, max_new):
    cfg_kw = dict(max_new_tokens=max_new, eot_id=eot, suppress_ids=(0, 1), strategy=strategy,
                  penalty=1.5 if strategy != "greedy" else 1.0, penalty_range=8,
                  temperature=0.8, top_k=6, top_p=0.9)
    jcfg, tcfg = jar.DecodeConfig(**cfg_kw), tar.DecodeConfig(**cfg_kw)
    b, p_len = 3, 3
    state = np.random.default_rng(8).standard_normal((b, V)).astype(np.float32)
    buf = np.zeros((b, p_len + max_new + 1), np.int32)
    buf[:, :p_len] = np.random.default_rng(9).integers(2, V, size=(b, p_len))
    logits0 = _logits(10, b=b, v=V)
    key = jax.random.PRNGKey(3)
    first, key_after = jar.select_token(jnp.asarray(logits0), jnp.asarray(buf), p_len, jcfg, key,
                                        history_start=p_len)
    want_t, want_n = jar.ar_decode(_jax_step, jnp.asarray(state), jnp.asarray(p_len, jnp.int32), first,
                                   jnp.asarray(buf), jcfg, key_after)
    noise = JaxNoise(key)
    tfirst = tar.select_token(torch.from_numpy(logits0), torch.from_numpy(buf), p_len, tcfg,
                              history_start=p_len, noise=noise)
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(first))
    got_t, got_n = tar.ar_decode(_torch_step, torch.from_numpy(state), p_len, tfirst,
                                 torch.from_numpy(buf), tcfg, noise=noise)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))  # the whole buffer, zeros too
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    if eot >= 0 and strategy == "greedy":
        assert 1 < int(got_n.max()) < max_new + 1  # the stop rule ended the loop early


def test_ar_decode_stops_at_first_token_eot():
    cfg = tar.DecodeConfig(max_new_tokens=5, eot_id=2)
    calls = []

    def step(state, tok, pos):
        calls.append(pos)
        return torch.zeros((1, 4)), state

    buf = torch.zeros((1, 8), dtype=torch.int64)
    toks, counts = tar.ar_decode(step, None, 2, torch.tensor([2]), buf, cfg)
    assert calls == [] and counts.tolist() == [1] and toks[0, 2] == 2
