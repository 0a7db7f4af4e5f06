"""Command line: build, transcribe, inspect, quantize, optimize, align,
parity, serve and serve-stream over model artifact folders (``python -m
asr_tpu_torch``).

Counterpart of ``asr_tpu/cli.py`` with the same subcommands' flags and
defaults, for the families the port runs: ``sensevoice``, ``whisper``,
``paraformer``, ``parakeet``, ``nemotron`` (``--language`` resolves to its
prompt id), ``firered``, ``dolphin``, ``qwen_asr``, ``fun_asr_nano`` (the
CTC head), ``fun_asr_nano_llm``, ``qwen_aligner`` and the streaming
families ``paraformer_streaming``, ``nemotron_streaming`` (``--language``
as for ``nemotron``), ``dolphin_streaming`` (with its language catalog) and
``x_asr`` / ``zipformer``. ``serve-stream`` serves a streaming artifact
over chunked HTTP, N streams as one batched step a tick
(``parallel/stream_server.py`` over ``streaming/multistream.py``).
``build`` turns a source checkpoint (FunASR, HF, espnet, NeMo, icefall,
FireRed) into an artifact folder on the host (``export.py``);
``quantize`` (``--algorithm rtn|kquant|hqq|dynamic``, ``--reorder``) and
``optimize`` (a JSON serving plan, ``quant/plan.py``) rewrite an artifact.
``parity`` transcribes the registered fixtures under ``--examples``
(``runtime/examples.py``) in the exact f32 matmul mode and captures or
compares goldens with stage probes (``runtime/probe.py``); its goldens are
the JAX package's, either way. ``transcribe --profile LOGDIR`` writes a
``torch.profiler`` Chrome trace of the run (``runtime/profiling.py``); a
SenseVoice or Whisper run holds the stage spans on the kernels' clock:
``asr.session.transcribe`` around ``asr.session.pack`` / ``upload`` /
``download`` / ``collect`` and the model's ``asr.sv.frontend`` /
``encode`` / ``block`` / ``ctc`` or ``asr.whisper.mel`` / ``encode`` /
``probe`` / ``prompt`` / ``stack`` and ``asr.decode.token`` a step.
``--platform`` picks the torch device of every subcommand but ``build``:
the CUDA card by default (it raises where no card is visible), ``cpu`` when
asked for. ``--quant-mm`` sets the quantized kernels' matmul mode.
``transcribe`` / ``serve --data-parallel N --tensor-parallel T`` lay the
session out on a (data, model) mesh (``parallel/mesh.py``; the mesh's N x T
positions cycle over the visible cards, so one card holds several);
``serve --continuous`` builds N replicas with a T-device sub-mesh each
instead.

Not here: the ``bench`` subcommand and the XLA / TPU options
``--compile-cache`` and ``--quant-kernel``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import shutil
import sys
from pathlib import Path

FAMILIES = ("sensevoice", "whisper", "paraformer", "parakeet", "nemotron", "firered", "dolphin",
            "qwen_asr", "fun_asr_nano", "fun_asr_nano_llm", "qwen_aligner", "paraformer_streaming",
            "nemotron_streaming", "dolphin_streaming", "x_asr", "zipformer")


def _device(platform: str):
    """``--platform`` -> torch device: ``cpu``, or the CUDA card (``cuda``,
    ``gpu``), which must be visible."""
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"--platform {platform}: no CUDA card is visible "
                         "(pass --platform cpu to run on the CPU)")
    return torch.device("cuda")


def _build_tokenizer(folder: Path, meta):
    """The artifact's tokenizer (``runtime/artifact.load_tokenizer``), or None."""
    from asr_tpu_torch.runtime.artifact import load_tokenizer

    return load_tokenizer(folder, meta)


def _prompt_id(meta, language: str | None) -> int:
    """Nemotron's prompt id for ``--language``: the resolved profile's
    ``prompt_token_id``, else its ``index``; 0 without a language."""
    if not language:
        return 0
    prof = meta.resolve_language(language)
    return prof.prompt_token_id if prof.prompt_token_id is not None else (prof.index or 0)


def _stream_config(family: str, cfg_dict: dict):
    """A streaming family's config from the artifact's ``config``: the full
    stream config (``{"base": ...}``) or just the base model's."""
    from asr_tpu_torch.runtime.metadata import config_from_dict

    if family in ("x_asr", "zipformer"):
        from asr_tpu_torch.models.zipformer import ZipformerConfig

        return config_from_dict(ZipformerConfig, cfg_dict)
    if family == "paraformer_streaming":
        from asr_tpu_torch.models.paraformer import ParaformerConfig as Base
        from asr_tpu_torch.streaming.paraformer_online import ParaformerStreamConfig as Stream
    elif family == "nemotron_streaming":
        from asr_tpu_torch.models.nemotron import NemotronConfig as Base
        from asr_tpu_torch.streaming.nemotron_stream import NemotronStreamConfig as Stream
    else:
        from asr_tpu_torch.models.dolphin import DolphinConfig as Base
        from asr_tpu_torch.streaming.dolphin_stream import DolphinStreamConfig as Stream
    if "base" in cfg_dict:
        return config_from_dict(Stream, cfg_dict)
    return Stream(base=config_from_dict(Base, cfg_dict))


def _build_session(folder: Path, language: str | None = None, dtype: str | None = None,
                   device="cuda", mesh=None, tensor_parallel: int = 1):
    """Artifact folder -> a ready session on ``device``, for every family the
    port runs. ``dtype``: serving cast of the plain weights (e.g.
    ``"bfloat16"``; norms and softmax stay f32 inside the models).

    ``mesh``: an optional ``parallel.mesh.Mesh``; the offline (windowed) and
    LLM sessions then run batch data parallel over its ``data`` axis
    (``parallel/serve.py``). ``tensor_parallel`` > 1: its ``model`` axis
    also shards the family's wide matmuls (``parallel.mesh.*_param_specs``),
    wired for sensevoice / whisper / qwen_asr / fun_asr_nano_llm."""
    from asr_tpu_torch.runtime.artifact import load_model
    from asr_tpu_torch.runtime.metadata import config_from_dict

    params, meta = load_model(folder, device)
    if dtype:
        from asr_tpu_torch.quant.quantize import cast_pytree

        params = cast_pytree(params, dtype)
    family = meta.family
    tokenizer = _build_tokenizer(folder, meta)
    cfg_dict = meta.extra.get("config", {})

    tp = int(tensor_parallel or 1)
    if tp > 1 and family not in ("sensevoice", "whisper", "qwen_asr", "fun_asr_nano_llm"):
        raise SystemExit(f"--tensor-parallel has no sharding specs for family {family!r} "
                         "(wired: sensevoice, whisper, qwen_asr, fun_asr_nano_llm)")
    par = {"mesh": mesh} if mesh is not None else {}

    if family == "sensevoice":
        from asr_tpu_torch.models.sensevoice import SenseVoiceConfig
        from asr_tpu_torch.parallel.mesh import sensevoice_param_specs
        from asr_tpu_torch.runtime.session import SenseVoiceSession

        return SenseVoiceSession(params, config_from_dict(SenseVoiceConfig, cfg_dict),
                                 tokenizer=tokenizer, metadata=meta, **par,
                                 param_specs=sensevoice_param_specs if tp > 1 else None)

    if family == "whisper":
        from asr_tpu_torch.models.whisper import WhisperConfig
        from asr_tpu_torch.runtime.whisper_session import WhisperSession, WhisperSessionConfig

        scfg = WhisperSessionConfig(
            suppress_ids=tuple(meta.extra.get("suppress_tokens", [])),
            begin_suppress_ids=tuple(meta.extra.get("begin_suppress_tokens", [])))
        lang_map = {p.code: p.prompt_token_id for p in meta.supported_languages
                    if p.prompt_token_id is not None}
        from asr_tpu_torch.parallel.mesh import whisper_param_specs

        return WhisperSession(params, config_from_dict(WhisperConfig, cfg_dict),
                              tokenizer=tokenizer, session_cfg=scfg, language_id_map=lang_map,
                              **par, param_specs=whisper_param_specs if tp > 1 else None)

    if family == "paraformer":
        from asr_tpu_torch.models.paraformer import ParaformerConfig
        from asr_tpu_torch.runtime.transducer_session import ParaformerSession

        return ParaformerSession(params, config_from_dict(ParaformerConfig, cfg_dict), tokenizer=tokenizer,
                                 **par)

    if family == "paraformer_streaming":
        from asr_tpu_torch.runtime.streaming_session import ParaformerStreamingSession

        return ParaformerStreamingSession(params, _stream_config(family, cfg_dict), tokenizer=tokenizer)

    if family == "nemotron_streaming":
        from asr_tpu_torch.runtime.streaming_session import NemotronStreamingSession

        return NemotronStreamingSession(params, _stream_config(family, cfg_dict), tokenizer=tokenizer,
                                        prompt_id=_prompt_id(meta, language))

    if family == "dolphin_streaming":
        from asr_tpu_torch.runtime.streaming_session import DolphinStreamingSession

        return DolphinStreamingSession(params, _stream_config(family, cfg_dict), tokenizer=tokenizer,
                                       language_catalog=meta.extra.get("dolphin_language_catalog") or {},
                                       language=language)

    if family in ("x_asr", "zipformer"):
        from asr_tpu_torch.runtime.streaming_session import XasrStreamingSession

        return XasrStreamingSession(params, _stream_config(family, cfg_dict), tokenizer=tokenizer)

    if family == "parakeet":
        from asr_tpu_torch.models.parakeet import ParakeetConfig
        from asr_tpu_torch.runtime.transducer_session import ParakeetSession

        return ParakeetSession(params, config_from_dict(ParakeetConfig, cfg_dict), tokenizer=tokenizer,
                               **par)

    if family == "nemotron":
        from asr_tpu_torch.models.nemotron import NemotronConfig
        from asr_tpu_torch.runtime.transducer_session import NemotronSession

        return NemotronSession(params, config_from_dict(NemotronConfig, cfg_dict), tokenizer=tokenizer,
                               prompt_id=_prompt_id(meta, language), **par)

    if family == "firered":
        from asr_tpu_torch.models.firered import FireRedConfig
        from asr_tpu_torch.runtime.transducer_session import FireRedSession

        return FireRedSession(params, config_from_dict(FireRedConfig, cfg_dict), tokenizer=tokenizer,
                              **par)

    if family == "dolphin":
        from asr_tpu_torch.models.dolphin import DolphinConfig
        from asr_tpu_torch.runtime.transducer_session import DolphinSession

        return DolphinSession(params, config_from_dict(DolphinConfig, cfg_dict), tokenizer=tokenizer,
                              language_catalog=meta.extra.get("dolphin_language_catalog") or {},
                              language=language, **par)

    if family == "fun_asr_nano":
        from asr_tpu_torch.models.fun_asr_nano import FunAsrNanoConfig
        from asr_tpu_torch.runtime.transducer_session import FunAsrNanoCtcSession

        return FunAsrNanoCtcSession(params, config_from_dict(FunAsrNanoConfig, cfg_dict),
                                    tokenizer=tokenizer, **par)

    if family == "fun_asr_nano_llm":
        from asr_tpu_torch.models.fun_asr_nano import FunAsrNanoConfig
        from asr_tpu_torch.runtime.qwen_session import FunAsrNanoLlmSession, prompt_template

        return FunAsrNanoLlmSession(params["encoder"], params["llm"],
                                    config_from_dict(FunAsrNanoConfig, cfg_dict),
                                    tokenizer=tokenizer, template=prompt_template(meta), **par)

    if family == "qwen_asr":
        from asr_tpu_torch.models.qwen_asr import QwenAsrConfig
        from asr_tpu_torch.runtime.qwen_session import QwenAsrSession, prompt_template

        return QwenAsrSession(params["tower"], params["llm"], config_from_dict(QwenAsrConfig, cfg_dict),
                              tokenizer=tokenizer, template=prompt_template(meta),
                              language_prompt_ids=meta.extra.get("language_prompt_ids") or {},
                              metadata=meta, **par)

    if family == "qwen_aligner":
        from asr_tpu_torch.models.forced_aligner import ForcedAlignerConfig
        from asr_tpu_torch.runtime.aligner_session import QwenAlignerSession

        return QwenAlignerSession(
            params["tower"], params["llm"], params["head"],
            config_from_dict(ForcedAlignerConfig, cfg_dict), tokenizer=tokenizer,
            special_ids=meta.special_token_ids,
            tokens_per_word=int(meta.extra.get("timestamp_tokens_per_word", 1)))

    raise SystemExit(f"no session wired for family {family!r} yet; the port runs "
                     f"{', '.join(FAMILIES)}")


def _positions(device, n: int) -> list:
    """``n`` mesh positions' devices: the CPU repeated, or the visible cards
    in turn (a card holds several positions where there are fewer cards)."""
    if device.type != "cuda":
        return [device] * n
    from asr_tpu_torch.parallel.mesh import visible_devices

    cards = visible_devices()
    if n > len(cards):
        print(f"{n} mesh positions on {len(cards)} card(s): positions share a card",
              file=sys.stderr)
    return [cards[i % len(cards)] for i in range(n)]


def _mesh_from_args(args):
    """(--data-parallel, --tensor-parallel) -> (Mesh or None, T). An unset
    data axis takes every card over T (at least one position)."""
    dp = getattr(args, "data_parallel", 0) or 0
    tp = getattr(args, "tensor_parallel", 1) or 1
    if not dp and tp <= 1:
        return None, 1
    from asr_tpu_torch.parallel.mesh import make_mesh, visible_devices

    if not dp:
        cards = len(visible_devices()) if args.device.type == "cuda" else 1
        dp = max(cards // tp, 1)
    return make_mesh(dp * tp, model_parallel=tp, devices=_positions(args.device, dp * tp)), tp


def cmd_transcribe(args) -> int:
    import contextlib

    mesh, tp = _mesh_from_args(args)
    sess = _build_session(Path(args.model_dir), language=args.language, dtype=args.dtype,
                          device=args.device, mesh=mesh, tensor_parallel=tp)
    if mesh is not None and getattr(sess, "runner", None) is None:
        raise SystemExit(f"--data-parallel/--tensor-parallel is not wired for "
                         f"{type(sess).__name__}; rerun without it")

    def kwargs(fn):
        if args.language and "language" in inspect.signature(fn).parameters:
            return {"language": args.language}
        return {}

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from asr_tpu_torch.runtime.profiling import trace

        profile_ctx = trace(args.profile, cuda=args.device.type == "cuda")
    with profile_ctx as prof:
        if len(args.audio) > 1 and hasattr(sess, "transcribe_batch"):
            # many files -> one batched forward
            results = sess.transcribe_batch(args.audio, **kwargs(sess.transcribe_batch))
        else:
            results = [sess.transcribe(audio, **kwargs(sess.transcribe)) for audio in args.audio]
    for audio, res in zip(args.audio, results):
        print(f"{audio}\t({res.audio_seconds:.2f}s, RTF {res.rtf:.4f})")
        print(res.text if res.text else res.token_ids)
    if args.profile:
        print(f"trace written to {prof.path} (open it in https://ui.perfetto.dev or chrome://tracing)")
    return 0


def cmd_inspect(args) -> int:
    from asr_tpu_torch.runtime.artifact import WEIGHTS_FILENAME
    from asr_tpu_torch.runtime.metadata import ModelMetadata

    folder = Path(args.model_dir)
    meta = ModelMetadata.load(folder)
    print(json.dumps({
        "family": meta.family,
        "sample_rate": meta.sample_rate,
        "audio_pcm_scale": meta.audio_pcm_scale,
        "special_token_ids": meta.special_token_ids,
        "languages": [p.code for p in meta.supported_languages],
        "weights_bytes": (folder / WEIGHTS_FILENAME).stat().st_size,
    }, indent=2))
    return 0


def cmd_quantize(args) -> int:
    from asr_tpu_torch.quant.quantize import quantize_pytree
    from asr_tpu_torch.runtime.artifact import load_model, save_model

    params, meta = load_model(Path(args.model_dir), args.device)
    if args.reorder:
        from asr_tpu_torch.quant.reorder import channel_reorder_pytree

        params, n = channel_reorder_pytree(params, stat=args.reorder)
        print(f"reordered {n} FFN pairs by {args.reorder}")
    qparams = quantize_pytree(params, bits=args.bits, block=args.block,
                              refine_iters=args.refine_iters, pack=args.pack,
                              objective=args.algorithm, min_size=args.min_size,
                              quantize_embeddings=args.quantize_embeddings)
    dyn = args.algorithm == "dynamic"
    if dyn and (args.bits != 8 or args.pack):
        print("note: --algorithm dynamic is always 8-bit per-column, unpacked "
              "(activations quantize at call time); --bits/--pack ignored")
    # what was applied: dynamic is 8-bit with per-column scales whatever --block says
    bits = 8 if dyn else args.bits
    meta.extra["quantization"] = {"bits": bits, "block": "per_column" if dyn else args.block,
                                  "algorithm": args.algorithm}
    save_model(Path(args.out), qparams, meta)
    _copy_artifact_assets(Path(args.model_dir), Path(args.out))
    blk = "per-column" if dyn else f"block {args.block}"
    print(f"quantized ({bits}-bit {args.algorithm}, {blk}) -> {args.out}")
    return 0


def cmd_optimize(args) -> int:
    from asr_tpu_torch.quant.plan import OptimizerConfig, apply_plans
    from asr_tpu_torch.runtime.artifact import load_model, save_model

    cfg = OptimizerConfig.load(args.plan)
    params, meta = load_model(Path(args.model_dir), args.device)
    qparams = apply_plans(params, cfg)
    meta.extra["optimizer_plan"] = json.loads(Path(args.plan).read_text(encoding="utf-8"))
    save_model(Path(args.out), qparams, meta)
    _copy_artifact_assets(Path(args.model_dir), Path(args.out))
    print(f"applied plan {args.plan} -> {args.out}")
    return 0


def cmd_build(args) -> int:
    """Checkpoint folder or file -> artifact folder, on the host."""
    from asr_tpu_torch import export as ex

    family = args.family
    src, out = args.checkpoint, args.out
    streaming = family.endswith("streaming") or args.streaming
    if family == "sensevoice":
        ex.build_sensevoice_artifact(src, out)
    elif family == "whisper":
        ex.build_whisper_artifact(src, out)
    elif family in ("paraformer", "paraformer_streaming"):
        ex.build_paraformer_artifact(src, out, decode_mode=args.decode_mode, streaming=streaming)
    elif family in ("dolphin", "dolphin_streaming"):
        ex.build_dolphin_artifact(src, out, vocab_path=args.vocab, streaming=streaming)
    elif family in ("nemotron", "nemotron_streaming"):
        ex.build_nemotron_artifact(src, out, streaming=streaming)
    elif family in ("x_asr", "zipformer"):
        ex.build_xasr_artifact(src, out, bpe_model=args.vocab)
    elif family == "parakeet":
        ex.build_parakeet_artifact(src, out)
    elif family == "firered":
        ex.build_firered_artifact(src, out)
    elif family == "qwen_asr":
        ex.build_qwen_asr_artifact(src, out)
    elif family == "qwen_aligner":
        ex.build_qwen_aligner_artifact(src, out)
    elif family in ("fun_asr_nano", "fun_asr_nano_llm"):
        ex.build_fun_asr_nano_artifact(src, out, head="llm" if family.endswith("llm") else "ctc")
    else:
        raise SystemExit(f"no builder wired for family {family!r}")
    print(f"built {family} artifact -> {out}")
    return 0


def _copy_artifact_assets(src: Path, dst: Path) -> None:
    """Carry every companion file (tokenizer, vocab, ...) into a derived
    artifact."""
    skip = {"weights.safetensors", "metadata.json"}
    for f in src.iterdir():
        if f.is_file() and f.name not in skip and not (dst / f.name).exists():
            shutil.copy2(f, dst / f.name)


def cmd_align(args) -> int:
    sess = _build_session(Path(args.model_dir), device=args.device)
    if not hasattr(sess, "align"):
        raise SystemExit("model artifact is not a forced-aligner family")
    for item in sess.align(args.audio, args.text, language=args.language):
        print(f"{item['start_ms']:>8d} {item['end_ms']:>8d}  {item['text']}")
    return 0


def cmd_parity(args) -> int:
    """One-command correctness harness: transcribe the family's registered
    fixtures (``runtime/examples.py``; ``--examples`` is their root) and
    print, capture (``--save-golden``) or compare (``--golden``, rc 1 on
    drift) goldens, with stage probes riding them.

    Goldens are JSON ``{"golden_schema": 2, "fixtures": {fixture:
    {"language", "text", "token_ids", "probe"}}}``; a bare v1 fixture dict
    reads too. The quantized kernels run their exact f32 mode for the run
    (``set_quant_config(mm="f32")``), as in the JAX package, and the earlier
    mode comes back on exit, on an exception too: a mode left at f32 would
    turn off the bf16 routes (the fused decode steps) for the rest of the
    process."""
    from asr_tpu_torch.ops import quant_matmul as qm

    prior_mm = qm._CONFIG["mm"]
    qm.set_quant_config(mm="f32")
    try:
        return _cmd_parity_impl(args)
    finally:
        qm._CONFIG["mm"] = prior_mm


def _cmd_parity_impl(args) -> int:
    from asr_tpu_torch.runtime.examples import model_audio_cases
    from asr_tpu_torch.runtime.metadata import ModelMetadata
    from asr_tpu_torch.runtime.probe import capture_probe, compare_probes

    meta = ModelMetadata.load(Path(args.model_dir))
    sess = _build_session(Path(args.model_dir), device=args.device)
    cases = model_audio_cases(args.family or meta.family, Path(args.examples) if args.examples else None)
    if not cases:
        raise SystemExit(f"no registered fixtures for family {meta.family!r}")
    # --save-golden wins when both flags name the same (possibly not yet
    # existing) file: capture mode never reads --golden
    golden = (json.loads(Path(args.golden).read_text())
              if args.golden and not args.save_golden else None)
    if golden is not None and "golden_schema" in golden:  # v2; v1 is the bare fixture dict
        golden = golden["fixtures"]
    # probes are captured with --save-golden, and recomputed on compare only
    # when the golden carries them (transcript-only goldens keep working)
    want_probes = args.save_golden or (
        golden is not None and any("probe" in w for w in golden.values()))
    results = {}
    for lang, path in cases:
        kwargs = {}
        if "language" in inspect.signature(sess.transcribe).parameters:
            kwargs["language"] = lang
        res = sess.transcribe(str(path), **kwargs)
        results[path.name] = {"language": lang, "text": res.text, "token_ids": res.token_ids}
        if want_probes:
            probe = capture_probe(sess, str(path))
            if probe is not None:
                results[path.name]["probe"] = probe
        print(f"{path.name}\t[{lang}]\tRTF {res.rtf:.4f}\t{res.text}")
    if args.save_golden:
        Path(args.save_golden).write_text(json.dumps(
            {"golden_schema": 2, "fixtures": results}, ensure_ascii=False, indent=2))
        print(f"goldens captured -> {args.save_golden}")
        return 0
    if golden is not None:
        failures = []
        for name, want in golden.items():
            got = results.get(name)
            if got is None:
                failures.append(f"{name}: fixture missing from run")
                continue
            # probe drift first: it names the first drifting stage
            for msg in compare_probes(got.get("probe"), want.get("probe")):
                failures.append(f"{name}: {msg}")
            if want.get("token_ids") and got["token_ids"] != want["token_ids"]:
                failures.append(f"{name}: token ids drifted")
            elif got["text"] != want["text"]:
                failures.append(f"{name}: text {got['text']!r} != {want['text']!r}")
        if failures:
            print("PARITY FAIL:\n  " + "\n  ".join(failures))
            return 1
        print(f"PARITY OK: {len(golden)} fixtures token-for-token")
    return 0


def cmd_serve(args) -> int:
    """HTTP serving: the micro-batched endpoint, or with ``--continuous`` the
    continuous-batching one (LLM and AED families)."""
    if args.continuous:
        # --continuous scales out replica per device group: the session
        # stays unsharded; --data-parallel N builds N batcher replicas behind
        # one admission queue and --tensor-parallel T gives each a T-device
        # sub-mesh
        mesh, tp = None, 1
    else:
        mesh, tp = _mesh_from_args(args)
    sess = _build_session(Path(args.model_dir), language=args.language, device=args.device,
                          mesh=mesh, tensor_parallel=tp)
    if args.continuous:
        if not (hasattr(sess, "prompt_embeds") or hasattr(sess, "continuous_prefill")):
            raise SystemExit(
                f"--continuous serves the LLM families (qwen_asr, fun_asr_nano_llm) and the "
                f"AED families (whisper, firered, dolphin); {type(sess).__name__} has neither "
                "surface — rerun without --continuous")
        from asr_tpu_torch.parallel.llm_server import serve_continuous

        dp = max(args.data_parallel or 1, 1)
        ctp = max(args.tensor_parallel or 1, 1)
        serve_continuous(sess, host=args.host, port=args.port, n_slots=args.slots,
                         language=args.language, context=args.context, kv_dtype=args.kv_dtype,
                         steps_per_tick=max(args.steps_per_tick, 1), data_parallel=dp,
                         tensor_parallel=ctp, devices=_positions(args.device, dp * ctp))
        return 0
    if not hasattr(sess, "_forward"):
        raise SystemExit(f"family {type(sess).__name__} has no batchable window forward; serve "
                         "supports the offline (windowed) and LLM families")
    if mesh is not None and getattr(sess, "runner", None) is None:
        raise SystemExit(f"--data-parallel/--tensor-parallel is not wired for "
                         f"{type(sess).__name__}; rerun without it")
    from asr_tpu_torch.parallel.http_server import serve_forever

    serve_forever(sess, host=args.host, port=args.port, max_batch=args.max_batch,
                  max_wait_ms=args.max_wait_ms, language=args.language)
    return 0


def cmd_serve_stream(args) -> int:
    """Real-time streaming endpoint: N concurrent chunked-HTTP connections,
    one batched step of every stream a tick (``parallel/stream_server.py``).
    Per family: the window, the advance, the PCM scale, the tail pad and the
    drain rule of its session."""
    import numpy as np

    from asr_tpu_torch.parallel.stream_server import serve_streams
    from asr_tpu_torch.runtime.artifact import load_model
    from asr_tpu_torch.streaming import multistream as ms

    params, meta = load_model(Path(args.model_dir), args.device)
    family = meta.family
    cfg_dict = meta.extra.get("config", {})
    n = args.streams
    extract = None
    advance = None
    pcm_scale = 32768.0
    tail_pad = 0
    drain_min = 1

    if family == "paraformer_streaming":
        scfg = _stream_config(family, cfg_dict)
        runner = ms.paraformer_multistream(params, scfg, n)
        chunk = scfg.chunk_samples
    elif family == "nemotron_streaming":
        scfg = _stream_config(family, cfg_dict)
        runner = ms.nemotron_multistream(params, scfg, n)
        chunk = scfg.window_samples
        pcm_scale = 1.0  # the NeMo mel takes [-1, 1] PCM
    elif family in ("x_asr", "zipformer"):
        cfg = _stream_config(family, cfg_dict)
        runner = ms.zipformer_multistream(params, cfg, n)
        chunk, advance = cfg.window_samples, cfg.advance_samples
        # the session's 0.3 s zero tail; stop once a full window no longer
        # fits (the file-mode snip-edges front pad needs lookahead a live
        # stream does not have and is not applied)
        tail_pad = int(0.3 * 16000)
        drain_min = chunk
    elif family == "dolphin_streaming":
        scfg = _stream_config(family, cfg_dict)
        runner = ms.dolphin_multistream(params, scfg, n)
        chunk, advance = scfg.window_samples, scfg.advance_samples
        drain_min = advance  # the session fires while pos + adv <= n
        blank = 0

        def extract(outs, i, st):  # per-slot cross-chunk CTC collapse
            prev = st.get("last", blank)
            new = []
            for t in np.asarray(outs["ctc_ids"][i]):
                t = int(t)
                if t != blank and t != prev:
                    new.append(t)
                prev = t
            st["last"] = prev
            return new
    else:
        raise SystemExit(f"serve-stream supports the streaming families (paraformer_streaming, "
                         f"nemotron_streaming, x_asr, dolphin_streaming); artifact is {family!r}")

    serve_streams(runner, chunk, host=args.host, port=args.port, extract=extract, pcm_scale=pcm_scale,
                  advance_samples=advance, tail_pad_samples=tail_pad, drain_min_samples=drain_min,
                  ticks_per_sync=max(args.ticks_per_sync or 1, 1))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="asr_tpu_torch")
    parser.add_argument("--platform", default="cuda", choices=("cuda", "gpu", "cpu"),
                        help="torch device: the CUDA card (default; fails where none is "
                             "visible) or cpu")
    parser.add_argument("--quant-mm", default=None, choices=("bf16", "f32"),
                        help="matmul mode for quantized weights: bf16 (serving default, "
                             "tensor cores) or f32 (the exact product of x and the "
                             "dequantized weight)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("transcribe", help="transcribe audio files with a model artifact")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--language", default=None)
    p.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                   help="serving cast of the plain weights (norms/softmax stay f32)")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the run (CPU and, on the card, "
                        "CUDA activity, with the sessions' asr.* stage spans) into LOGDIR")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="T",
                   help="shard the model's wide matmuls over T mesh positions (Megatron TP; "
                        "sensevoice/whisper/qwen_asr/fun_asr_nano_llm); composes with "
                        "--data-parallel as a (data, model) mesh")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="split window batches over N data positions (0 = one device)")
    p.add_argument("audio", nargs="+")
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("align", help="forced-align a transcript against audio (word timestamps)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--text", required=True, help="transcript to align")
    p.add_argument("--language", default=None,
                   help="unit-splitter language (e.g. japanese); default space/CJK")
    p.add_argument("audio")
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("inspect", help="print a model artifact's metadata")
    p.add_argument("--model-dir", required=True)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("quantize", help="weight-only quantize an artifact")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--bits", type=int, default=8, choices=(2, 4, 8))
    p.add_argument("--block", type=int, default=128)
    p.add_argument("--refine-iters", type=int, default=2)
    p.add_argument("--quantize-embeddings", action="store_true",
                   help="also quantize embed tables into gather-dequant leaves "
                        "(LLM-decoder families)")
    p.add_argument("--min-size", type=int, default=1 << 16,
                   help="skip linear weights with fewer elements than this")
    p.add_argument("--algorithm", default="rtn", choices=("rtn", "kquant", "hqq", "dynamic"),
                   help="block fit: round-to-nearest, importance-weighted grid search, "
                        "half-quadratic zero points, or dynamic-activation int8")
    p.add_argument("--pack", action="store_true",
                   help="pack 4-bit weights two-per-byte / 2-bit four-per-byte")
    p.add_argument("--reorder", default=None, choices=("absmean", "rms", "l4", "std"),
                   help="exact-math FFN channel reordering before quantization")
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("optimize", help="apply a declarative serving plan (JSON) to an artifact")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--plan", required=True,
                   help="JSON with {plans: {name: {...}}, assign: [[glob, name], ...]}")
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser("parity", help="transcribe registered fixtures; capture/compare goldens")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--family", default=None, help="override the artifact's family for fixture lookup")
    p.add_argument("--examples", default=None, help="Test_Examples root (default: reference fixtures)")
    p.add_argument("--golden", default=None, help="compare against a goldens JSON (rc!=0 on drift)")
    p.add_argument("--save-golden", default=None, help="write transcripts as goldens JSON")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("build", help="build an artifact folder from a source checkpoint")
    p.add_argument("--family", required=True,
                   choices=("sensevoice", "whisper", "paraformer", "paraformer_streaming",
                            "dolphin", "dolphin_streaming", "x_asr", "zipformer", "parakeet",
                            "firered", "qwen_asr", "qwen_aligner", "fun_asr_nano",
                            "fun_asr_nano_llm", "nemotron", "nemotron_streaming"))
    p.add_argument("--checkpoint", required=True, help="source checkpoint dir or file")
    p.add_argument("--out", required=True)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--decode-mode", default="zh", choices=("zh", "en"))
    p.add_argument("--vocab", default=None, help="tokenizer/vocab path for families "
                   "whose checkpoint file does not bundle one (dolphin, x_asr)")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("serve", help="HTTP transcription endpoint (micro-batched)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--language", default=None)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="micro-batches over N data positions; with --continuous, N replicas")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="T",
                   help="Megatron TP over T mesh positions (see transcribe); with "
                        "--continuous, a T-position sub-mesh per LLM replica")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching for the LLM and AED families: requests join "
                        "and leave one running decode batch mid-flight "
                        "(parallel/llm_server.py) instead of lockstep micro-batches")
    p.add_argument("--slots", type=int, default=8, help="concurrent decode slots for --continuous")
    p.add_argument("--kv-dtype", choices=("f32", "bf16"), default="f32", dest="kv_dtype",
                   help="--continuous KV-cache storage dtype; bf16 halves per-step cache traffic")
    p.add_argument("--context", default="", help="fixed hot-word/context prompt for --continuous")
    p.add_argument("--steps-per-tick", type=int, default=1, dest="steps_per_tick",
                   help="--continuous decode steps per host synchronisation")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("serve-stream", help="real-time streaming endpoint: N concurrent chunked-HTTP "
                                            "PCM connections, one batched step a tick")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--streams", type=int, default=8, help="concurrent stream slots (the step's batch)")
    p.add_argument("--ticks-per-sync", type=int, default=1,
                   help="chunk ticks launched back to back before one host read of their outputs; "
                        "results then emit in K-chunk batches (token streams identical)")
    p.set_defaults(fn=cmd_serve_stream)

    args = parser.parse_args(argv)
    if args.quant_mm:
        from asr_tpu_torch.ops.quant_matmul import set_quant_config

        set_quant_config(mm=args.quant_mm)
    args.device = None if args.cmd == "build" else _device(args.platform)  # build is host code
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
