"""PyTorch port: framing, Kaldi fbank, LFR/CMVN and CTC collapse against
the JAX package on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_tpu.decode import ctc as jctc
from asr_tpu.frontend import framing as jframing
from asr_tpu.frontend import kaldi_fbank as jfb
from asr_tpu.frontend import lfr as jlfr
from asr_tpu_torch.decode import ctc as tctc
from asr_tpu_torch.frontend import framing as tframing
from asr_tpu_torch.frontend import kaldi_fbank as tfb
from asr_tpu_torch.frontend import lfr as tlfr


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg_pair(**kw):
    return jfb.KaldiFbankConfig(**kw), tfb.KaldiFbankConfig(**kw)


def test_fbank_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jfb.KaldiFbankConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tfb.KaldiFbankConfig)]
    assert jf == tf


@pytest.mark.parametrize("n_samples,n_frames", [(4000, 23), (4000, 30), (1000, 5), (16000, 98)])
def test_frame_signal_matches_jax(n_samples, n_frames):
    x = np.random.default_rng(n_samples).standard_normal((2, n_samples)).astype(np.float32)
    want = np.asarray(jframing.frame_signal(jnp.asarray(x), 400, 160, n_frames))
    got = tframing.frame_signal(torch.from_numpy(x), 400, 160, n_frames).numpy()
    np.testing.assert_array_equal(got, want)
    assert tframing.num_frames_snip(n_samples, 400, 160) == jframing.num_frames_snip(n_samples, 400, 160)


@pytest.mark.parametrize("kw", [{}, {"window": "povey", "mel_style": "htk"}, {"input_scale": 32768.0}])
def test_kaldi_constants_match_jax(kw):
    jcfg, tcfg = _cfg_pair(**kw)
    jb, jm = jfb._kaldi_constants(jcfg)
    tb, tm = tfb._kaldi_constants(tcfg)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tm, np.asarray(jm, np.float32))


@pytest.mark.parametrize("kw", [{}, {"window": "povey", "mel_style": "htk"}])
def test_log_mel_fbank_matches_jax(kw):
    jcfg, tcfg = _cfg_pair(**kw)
    x = (np.random.default_rng(1).standard_normal((2, 8000)) * 2000).astype(np.float32)
    n_frames = jcfg.num_frames(x.shape[-1])
    want = np.asarray(jfb.log_mel_fbank(jnp.asarray(x), jcfg, n_frames))
    got = tfb.log_mel_fbank(torch.from_numpy(x), tcfg, n_frames).numpy()
    assert got.shape == want.shape == (2, n_frames, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("valid", [None, 40, [50, 31, 7, 0]])
def test_lfr_stack_matches_jax(valid):
    feats = np.random.default_rng(2).standard_normal((4, 50, 8)).astype(np.float32)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    tv = None if valid is None else torch.tensor(valid)
    want = np.asarray(jlfr.lfr_stack(jnp.asarray(feats), 7, 6, jv))
    got = tlfr.lfr_stack(torch.from_numpy(feats), 7, 6, tv).numpy()
    np.testing.assert_array_equal(got, want)


def test_cmvn_matches_jax():
    rng = np.random.default_rng(3)
    x, m, s = (rng.standard_normal(shape).astype(np.float32) for shape in ((2, 5, 16), (16,), (16,)))
    want = np.asarray(jlfr.apply_cmvn_addmul(jnp.asarray(x), jnp.asarray(m), jnp.asarray(s)))
    got = tlfr.apply_cmvn_addmul(*(torch.from_numpy(a) for a in (x, m, s))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_collapse_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, size=(3, 20)).astype(np.int32)
    valid = np.array([20, 11, 0], np.int32)
    jt, jn = jctc.ctc_greedy_collapse(jnp.asarray(ids), jnp.asarray(valid), blank_id=0)
    tt, tn = tctc.ctc_greedy_collapse(torch.from_numpy(ids), torch.from_numpy(valid), blank_id=0)
    assert tt.dtype == torch.int32 and tn.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
