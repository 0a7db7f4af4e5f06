"""``asr_tpu_torch/runtime/probe.py`` against ``asr_tpu/runtime/probe.py``.

For each of the fifteen session classes, the tiny configuration of
``tests/test_probe_families.py`` builds the JAX session; the port's session
of the same class gets the same configuration and the same weights (through
``runtime/artifact.params_from_flat(flatten_pytree(...))``), and both
``capture_probe`` calls see the same seeded audio. The snapshots agree:
``compare_probes`` finds no drift either way, every stage has the same
shape, and its ``head`` and ``spread`` values and its mean and std agree
within 1e-4 relative (with an absolute floor of 1e-4 of the stage's scale,
``|mean| + std``, as ``compare_probes`` takes it) in f32. Then the port's
own round trip, the localisation of a planted drift to its stage, and the
tail drift that ``spread`` catches, as the JAX tests check them.
"""

import numpy as np
import pytest
import torch

from asr_tpu.runtime import artifact as jart
from asr_tpu.runtime.probe import capture_probe as jcapture
from asr_tpu_torch.runtime import artifact as tart
from asr_tpu_torch.runtime.probe import STAGE_ORDER, capture_probe, compare_probes, summarize
from tests.test_probe_families import _FAMILIES
from tests.test_torch_export import port_config

TOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two torch threads a test: the suite runs several workers at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(tree):
    return tart.params_from_flat(jart.flatten_pytree(tree), "cpu")


def _cfg(cfg):
    return port_config(cfg, type(cfg).__module__.replace("asr_tpu.", "", 1))


def _window(sess) -> dict:
    return {"window_seconds": sess.window_samples / 16000}


def port_session(sess):
    """The port's session of the same class as a JAX session from
    ``test_probe_families``, on the same configuration and weights."""
    from asr_tpu_torch.runtime import (aligner_session, qwen_session, session, streaming_session,
                                       transducer_session, whisper_session)

    name = type(sess).__name__
    if name == "SenseVoiceSession":
        return session.SenseVoiceSession(_tree(sess.params), _cfg(sess.cfg), **_window(sess))
    if name == "WhisperSession":
        return whisper_session.WhisperSession(_tree(sess.params), _cfg(sess.cfg), **_window(sess))
    if name == "NemotronSession":
        return transducer_session.NemotronSession(_tree(sess.params), _cfg(sess.cfg),
                                                  prompt_id=sess.prompt_id, **_window(sess))
    if name in ("FireRedSession", "ParaformerSession", "DolphinSession", "ParakeetSession",
                "FunAsrNanoCtcSession"):
        return getattr(transducer_session, name)(_tree(sess.params), _cfg(sess.cfg), **_window(sess))
    seconds = {"max_seconds": getattr(sess, "max_samples", 0) / 16000}
    if name == "QwenAsrSession":
        return qwen_session.QwenAsrSession(_tree(sess.tower_params), _tree(sess.llm_params),
                                           _cfg(sess.cfg), max_new_tokens=4, **seconds)
    if name == "FunAsrNanoLlmSession":
        return qwen_session.FunAsrNanoLlmSession(_tree(sess.params), _tree(sess.llm_params),
                                                 _cfg(sess.cfg), max_new_tokens=4, **seconds)
    if name == "QwenAlignerSession":
        return aligner_session.QwenAlignerSession(
            _tree(sess.tower_params), _tree(sess.llm_params), _tree(sess.head), _cfg(sess.cfg),
            tokenizer=None, special_ids={"timestamp": sess.timestamp_id,
                                         "audio_start": sess.audio_start_id,
                                         "audio_end": sess.audio_end_id}, **seconds)
    if name == "NemotronStreamingSession":
        return streaming_session.NemotronStreamingSession(_tree(sess.params), _cfg(sess.cfg),
                                                          prompt_id=sess.prompt_id)
    return getattr(streaming_session, name)(_tree(sess.params), _cfg(sess.cfg))


def _stage_close(got: dict, want: dict, where: str):
    assert got["shape"] == want["shape"], where
    scale = max(abs(want["mean"]) + want["std"], 1e-6)
    for field in ("head", "spread"):
        assert (field in got) == (field in want), where
        if field in want:
            np.testing.assert_allclose(got[field], want[field], rtol=TOL, atol=TOL * scale,
                                       err_msg=f"{where} {field}")
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL * scale, err_msg=f"{where} {k}")


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_probe_matches_jax(family):
    jsess, audio = _FAMILIES[family]()
    tsess = port_session(jsess)
    assert type(tsess).__name__ == type(jsess).__name__
    want = jcapture(jsess, audio)
    got = capture_probe(tsess, audio)
    assert got is not None and sorted(got) == sorted(want)
    assert compare_probes(got, want) == [] and compare_probes(want, got) == []
    for stage in want:
        _stage_close(got[stage], want[stage], f"{family}/{stage}")

    # the port's own round trip and the localisation of a planted drift
    assert set(got) <= set(STAGE_ORDER) and "frontend" in got
    assert compare_probes(got, got) == []
    first = next(s for s in STAGE_ORDER if s in got)
    bad = {**got, first: {**got[first], "head": [v + 1.0 for v in got[first]["head"]]}}
    msgs = compare_probes(bad, got)
    assert msgs and f"stage {first!r}" in msgs[0]
    last = [s for s in STAGE_ORDER if s in got][-1]
    if last != first:
        late = {**got, last: {**got[last], "mean": got[last]["mean"] + 10 * (1 + got[last]["std"])}}
        msgs = compare_probes(late, got)
        assert len(msgs) == 1 and f"stage {last!r}" in msgs[0]


def test_probe_of_a_file_and_of_an_unknown_session(tmp_path):
    """A path goes through the port's audio reader at the session's PCM
    scale, as the array does; a class with no probe gives None."""
    import wave

    jsess, _ = _FAMILIES["sensevoice"]()
    tsess = port_session(jsess)
    pcm = (np.random.default_rng(5).standard_normal(8000) * 2000).astype(np.int16)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    from_file = capture_probe(tsess, str(path))
    assert compare_probes(from_file, capture_probe(tsess, pcm.astype(np.float32))) == []
    assert compare_probes(from_file, jcapture(jsess, str(path))) == []
    assert capture_probe(object(), pcm) is None


def test_spread_field_localizes_tail_drift():
    a = np.zeros(4096, np.float32)
    want = summarize(a)
    b = a.copy()
    b[-1] = 50.0  # far past head[48]; mean/std shift is tiny
    msgs = compare_probes({"frontend": summarize(b)}, {"frontend": want})
    assert msgs and "spread" in msgs[0]
