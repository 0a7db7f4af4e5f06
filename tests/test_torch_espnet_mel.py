"""PyTorch port: the espnet log-mel front end (Dolphin) against the JAX
package's ``asr_tpu/frontend/espnet_mel.py``.

Both run the DFT and the mel bank as f32 matmuls (JAX at ``highest``
precision); the sums run in another order, so the natural-log features
agree to 1e-4 absolute (measured below 6e-5), and the frame counts and the
valid-frame rule exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.frontend import espnet_mel as jem
from asr_tpu_torch.frontend import espnet_mel as tem

TOL = 1e-4


def test_config_and_window_match():
    assert ([(f.name, f.default) for f in dataclasses.fields(jem.EspnetMelConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(tem.EspnetMelConfig)])
    for win in (400, 512):
        np.testing.assert_array_equal(tem.hann_window_periodic(win), jem.hann_window_periodic(win))
    jb, jm = jem._espnet_constants(jem.EspnetMelConfig())
    tb, tm = tem._espnet_constants(tem.EspnetMelConfig())
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("samples", [16000, 7001, 4850])  # the last two are no multiple of hop
@pytest.mark.parametrize("preemphasis", [0.0, 0.97])
def test_log_mel_matches_jax(samples, preemphasis):
    kw = dict(preemphasis=preemphasis, input_scale=1.0 / 32768.0 if preemphasis else 1.0)
    jcfg, tcfg = jem.EspnetMelConfig(**kw), tem.EspnetMelConfig(**kw)
    audio = np.random.default_rng(samples).standard_normal((2, samples)).astype(np.float32)
    audio *= 3000.0 if preemphasis else 0.1
    want = np.asarray(jem.log_mel(jnp.asarray(audio), jcfg))
    got = tem.log_mel(torch.from_numpy(audio), tcfg).numpy()
    assert got.shape == want.shape == (2, 1 + samples // 160, 80)  # the trailing frame is kept
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_one_dimensional_input_and_valid_frames():
    cfg, jcfg = tem.EspnetMelConfig(n_mels=40), jem.EspnetMelConfig(n_mels=40)
    audio = (np.random.default_rng(3).standard_normal(3333) * 0.2).astype(np.float32)
    got = tem.log_mel(torch.from_numpy(audio), cfg).numpy()
    want = np.asarray(jem.log_mel(jnp.asarray(audio), jcfg))
    assert got.shape == (1 + 3333 // 160, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    valid = np.array([0, 159, 160, 3333, 480000])
    np.testing.assert_array_equal(cfg.valid_frames(torch.from_numpy(valid)).numpy(),
                                  np.asarray(jcfg.valid_frames(jnp.asarray(valid))))
    assert cfg.num_frames(480000) == jcfg.num_frames(480000) == 3001
