"""Tokenizers/decoders for every family's vocab format.

The reference relies on external packages per family (SURVEY.md §2.7):
SentencePiece (SenseVoice), plain vocab txt (Paraformer), HF tokenizers
(Whisper/Parakeet), tiktoken-style CTC vocab (Fun-ASR-Nano), token tables
(X-ASR). Here each becomes a small self-contained decoder; SentencePiece
``.model`` files are parsed with a minimal protobuf reader (only the
piece list is needed for decoding), so no sentencepiece dependency.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Protocol, Sequence


class TokenDecoder(Protocol):
    def decode(self, ids: Sequence[int]) -> str: ...


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_sentencepiece_model(data: bytes) -> list[tuple[str, float, int]]:
    """Parse a SentencePiece .model protobuf: repeated field 1 =
    SentencePiece{piece: 1 string, score: 2 float, type: 3 enum}.

    Returns [(piece, score, type)] where type 1=NORMAL 2=UNK 3=CONTROL
    4=USER_DEFINED 6=BYTE."""
    pieces: list[tuple[str, float, int]] = []
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            length, pos = _read_varint(data, pos)
            sub = data[pos : pos + length]
            pos += length
            piece, score, ptype = "", 0.0, 1
            sp = 0
            while sp < len(sub):
                stag, sp = _read_varint(sub, sp)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    slen, sp = _read_varint(sub, sp)
                    piece = sub[sp : sp + slen].decode("utf-8", errors="replace")
                    sp += slen
                elif sfield == 2 and swire == 5:
                    import struct

                    score = struct.unpack("<f", sub[sp : sp + 4])[0]
                    sp += 4
                elif sfield == 3 and swire == 0:
                    ptype, sp = _read_varint(sub, sp)
                elif swire == 0:
                    _, sp = _read_varint(sub, sp)
                elif swire == 2:
                    slen, sp = _read_varint(sub, sp)
                    sp += slen
                elif swire == 5:
                    sp += 4
                elif swire == 1:
                    sp += 8
                else:
                    raise ValueError(f"bad wire type {swire}")
            pieces.append((piece, score, ptype))
        elif wire == 2:  # skip other length-delimited fields (trainer/normalizer specs)
            length, pos = _read_varint(data, pos)
            pos += length
        elif wire == 0:
            _, pos = _read_varint(data, pos)
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"bad wire type {wire}")
    return pieces


class SentencePieceDecoder:
    """Decode-only SentencePiece: id -> piece, '▁' -> space, byte pieces."""

    def __init__(self, model_path: str | Path):
        pieces = parse_sentencepiece_model(Path(model_path).read_bytes())
        self.pieces = [p for p, _, _ in pieces]
        self.types = [t for _, _, t in pieces]

    def __len__(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i]

    def decode(self, ids: Sequence[int]) -> str:
        out: list[str] = []
        byte_buf: list[int] = []

        def flush_bytes():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if i < 0 or i >= len(self.pieces):
                continue
            piece, ptype = self.pieces[i], self.types[i]
            if ptype == 6:  # BYTE piece "<0xNN>"
                byte_buf.append(int(piece[1:-1], 16))
                continue
            flush_bytes()
            if ptype in (2, 3):  # UNK / CONTROL kept verbatim (rich tags)
                out.append(piece)
            else:
                out.append(piece.replace("▁", " "))
        flush_bytes()
        return "".join(out)


class VocabTxtDecoder:
    """Paraformer-style one-token-per-line vocab file."""

    def __init__(self, vocab_path: str | Path, decode_mode: str = "zh"):
        self.tokens = Path(vocab_path).read_text(encoding="utf-8").splitlines()
        self.decode_mode = decode_mode

    def __len__(self) -> int:
        return len(self.tokens)

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.tokens[i] for i in ids if 0 <= i < len(self.tokens)]
        toks = [t for t in toks if t not in ("<blank>", "<s>", "</s>", "<unk>")]
        if self.decode_mode == "en":
            text = " ".join(toks).replace("@@ ", "")
            return text.replace("@@", "")
        return "".join(toks)


class TiktokenVocabDecoder:
    """Tiktoken-style CTC vocab (Fun-ASR-Nano): base64 token ranks + the
    multilingual SenseVoice special-token block appended in a fixed order
    (reference ``Fun_ASR_Nano/Inference_Fun_ASR_Nano_ONNX.py:166-230``).

    Decoding needs no BPE merges — each id maps to a byte string; ids at or
    above ``timestamp_begin`` plus blank / no-speech are dropped, the rest
    concatenate and UTF-8 decode. No tiktoken dependency.
    """

    _LANGS = (
        "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl", "ar",
        "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms", "cs", "ro", "da", "hu",
        "ta", "no", "th", "ur", "hr", "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa",
        "lv", "bn", "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne", "mn",
        "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc",
        "ka", "be", "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
        "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw",
        "su", "yue", "minnan", "wuyu", "dialect", "zh/en", "en/zh",
    )
    _AUDIO_EVENTS = ("ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM",
                     "Laughter", "/Laughter", "Applause", "/Applause")
    _EMOTIONS = ("HAPPY", "SAD", "ANGRY", "NEUTRAL")

    def __init__(self, vocab_path: str | Path, num_languages: int = 8749):
        import base64

        self.id_to_bytes: dict[int, bytes] = {}
        for line in Path(vocab_path).read_text().splitlines():
            if not line:
                continue
            token, rank = line.split()
            self.id_to_bytes[int(rank)] = base64.b64decode(token)
        n = len(self.id_to_bytes)
        self.special: dict[int, str] = {}
        specials = [
            "<|endoftext|>", "<|startoftranscript|>",
            *[f"<|{lang}|>" for lang in self._LANGS[:num_languages]],
            *[f"<|{event}|>" for event in self._AUDIO_EVENTS],
            *[f"<|{emotion}|>" for emotion in self._EMOTIONS],
            "<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
            "<|nospeech|>", "<|notimestamps|>",
            *[f"<|SPECIAL_TOKEN_{index}|>" for index in range(1, 51)],
            *[f"<|{index * 0.02:.2f}|>" for index in range(1501)],
        ]
        self.special_to_id: dict[str, int] = {}
        for token in specials:
            self.special[n] = token
            self.special_to_id[token] = n
            n += 1
        self.n_vocab = n
        self.no_speech = self.special_to_id["<|nospeech|>"]
        self.timestamp_begin = self.special_to_id["<|0.00|>"]

    def __len__(self) -> int:
        return self.n_vocab

    def decode(self, ids: Sequence[int], blank_id: int | None = None) -> str:
        out = b""
        for i in ids:
            if i >= self.timestamp_begin or i == self.no_speech:
                continue
            if blank_id is not None and i == blank_id:
                continue
            piece = self.id_to_bytes.get(i)
            if piece is not None:
                out += piece
        return out.decode("utf-8", errors="replace")


class FireRedDictDecoder:
    """FireRedASR ``dict.txt`` decoder (Chinese chars + English SPM pieces).

    Mirrors the reference's standalone ``TokenDict`` +
    ``ChineseCharEnglishSpmTokenizer.detokenize``
    (``FireRedASR/Inference_FireRedASR_AED_ONNX.py:139-216``): dict lines
    are ``word id`` (or bare ``word`` = line number; empty line = literal
    space; ``<space>`` = space), decoding joins the words and converts the
    SPM space marker. The SPM model itself is only needed for *encoding*
    (hotword prompts), not for decode.
    """

    SPM_SPACE = "▁"
    _DROP = ("<unk>", "<sos>", "<eos>", "<pad>", "<blank>")

    def __init__(self, dict_path: str | Path):
        self.id_to_word: dict[int, str] = {}
        for line_number, line in enumerate(
            Path(dict_path).read_text(encoding="utf-8").splitlines()
        ):
            pieces = line.strip().split()
            if len(pieces) >= 2:
                word, index = pieces[0], int(pieces[1])
            elif len(pieces) == 1:
                word, index = pieces[0], line_number
            else:
                word, index = " ", line_number
            self.id_to_word[index] = " " if word == "<space>" else word

    def __len__(self) -> int:
        return len(self.id_to_word)

    def decode(self, ids: Sequence[int]) -> str:
        words = [
            self.id_to_word[i]
            for i in ids
            if i in self.id_to_word and self.id_to_word[i] not in self._DROP
        ]
        return "".join(words).replace(self.SPM_SPACE, " ").strip()


class HFTokenizerDecoder:
    """Wrapper over a tokenizers.json file (Whisper/Parakeet/Qwen)."""

    def __init__(self, tokenizer_json: str | Path):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(str(tokenizer_json))

    def __len__(self) -> int:
        return self.tok.get_vocab_size()

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)

    def encode(self, text: str) -> list[int]:
        return list(self.tok.encode(text, add_special_tokens=False).ids)

    def token_to_id(self, token: str) -> int | None:
        return self.tok.token_to_id(token)


class JsonVocabDecoder:
    """tiktoken-style CTC vocab: JSON mapping of token -> id (Fun-ASR-Nano)."""

    def __init__(self, vocab_json: str | Path):
        table = json.loads(Path(vocab_json).read_text(encoding="utf-8"))
        self.id_to_tok = {v: k for k, v in table.items()}

    def decode(self, ids: Sequence[int]) -> str:
        parts = [self.id_to_tok.get(i, "") for i in ids]
        try:
            return bytes(
                b for p in parts for b in p.encode("latin-1", errors="ignore")
            ).decode("utf-8", errors="replace")
        except Exception:
            return "".join(parts)
