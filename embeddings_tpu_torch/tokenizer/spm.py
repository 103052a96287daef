"""Minimal sentencepiece ``.model`` (ModelProto) reader — pure Python; a copy
of ``embeddings_tpu/tokenizer/spm.py`` for the PyTorch port.

ALBERT / XLM-RoBERTa checkpoints often ship ONLY a sentencepiece model
file (``spiece.model`` / ``sentencepiece.bpe.model``) with no
``tokenizer.json``.  The ``sentencepiece`` package is not a dependency
here, so this module decodes the protobuf wire format directly — the
handful of fields the Unigram tokenizer needs — with no generated code
and no ``protobuf`` runtime.

Schema (field numbers from sentencepiece's ``sentencepiece_model.proto``,
the same schema HF transformers bundles as ``sentencepiece_model_pb2``):

    ModelProto:      pieces = 1 (repeated SentencePiece),
                     trainer_spec = 2, normalizer_spec = 3
    SentencePiece:   piece = 1 (string), score = 2 (float),
                     type = 3 (enum: NORMAL=1, UNKNOWN=2, CONTROL=3,
                     USER_DEFINED=4, UNUSED=5, BYTE=6)
    TrainerSpec:     model_type = 3 (UNIGRAM=1, BPE=2), vocab_size = 4,
                     byte_fallback = 35, unk_id = 40, bos_id = 41,
                     eos_id = 42, pad_id = 43, unk_piece = 45,
                     bos_piece = 46, eos_piece = 47, pad_piece = 48
    NormalizerSpec:  name = 1, precompiled_charsmap = 2,
                     add_dummy_prefix = 3, remove_extra_whitespaces = 4

Unknown fields are skipped per standard proto2 semantics, so files
written by any sentencepiece version parse.  The reference engine has no
sentencepiece support at all (WordPiece only, bert.cpp:199-417); this
enables loading raw HF ALBERT/XLM-R tokenizer files without a one-time
re-export through HF ``tokenizers``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# SentencePiece.type enum
PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_UNUSED = 5
PIECE_BYTE = 6

# TrainerSpec.model_type enum
MODEL_UNIGRAM = 1
MODEL_BPE = 2
MODEL_WORD = 3
MODEL_CHAR = 4


@dataclass
class SpmPiece:
    piece: str
    score: float = 0.0
    type: int = PIECE_NORMAL


@dataclass
class SpmModel:
    pieces: list[SpmPiece] = field(default_factory=list)
    # TrainerSpec (proto2 defaults)
    model_type: int = MODEL_UNIGRAM
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"
    bos_piece: str = "<s>"
    eos_piece: str = "</s>"
    pad_piece: str = "<pad>"
    # NormalizerSpec
    normalizer_name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True


def _varint(data: bytes, i: int) -> tuple[int, int]:
    """Decode one base-128 varint at ``i`` -> (value, next index)."""
    result = 0
    shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint in sentencepiece model")
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 64 bits")


def _signed(v: int) -> int:
    """proto2 int32/int64 negative values arrive as 64-bit two's
    complement varints (e.g. pad_id = -1)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.
    value is int for varints, raw bytes for fixed32/fixed64/length-
    delimited fields."""
    i, n = 0, len(data)
    while i < n:
        tag, i = _varint(data, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _varint(data, i)
        elif wt == 5:  # fixed32
            v, i = data[i:i + 4], i + 4
        elif wt == 1:  # fixed64
            v, i = data[i:i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _varint(data, i)
            v, i = data[i:i + ln], i + ln
            if len(v) != ln:
                raise ValueError("truncated field in sentencepiece model")
        else:  # groups (3/4) were removed long before sentencepiece
            raise ValueError(f"unsupported wire type {wt}")
        if i > n:
            raise ValueError("truncated field in sentencepiece model")
        yield fno, wt, v


def _parse_piece(data: bytes) -> SpmPiece:
    p = SpmPiece(piece="")
    for fno, wt, v in _iter_fields(data):
        if fno == 1 and wt == 2:
            p.piece = v.decode("utf-8")
        elif fno == 2 and wt == 5:
            p.score = struct.unpack("<f", v)[0]
        elif fno == 3 and wt == 0:
            p.type = v
    return p


_TRAINER_STR = {45: "unk_piece", 46: "bos_piece", 47: "eos_piece",
                48: "pad_piece"}
_TRAINER_ID = {40: "unk_id", 41: "bos_id", 42: "eos_id", 43: "pad_id"}


def _parse_trainer(data: bytes, m: SpmModel) -> None:
    for fno, wt, v in _iter_fields(data):
        if fno == 3 and wt == 0:
            m.model_type = v
        elif fno == 35 and wt == 0:
            m.byte_fallback = bool(v)
        elif fno in _TRAINER_ID and wt == 0:
            setattr(m, _TRAINER_ID[fno], _signed(v))
        elif fno in _TRAINER_STR and wt == 2:
            setattr(m, _TRAINER_STR[fno], v.decode("utf-8"))


def _parse_normalizer(data: bytes, m: SpmModel) -> None:
    for fno, wt, v in _iter_fields(data):
        if fno == 1 and wt == 2:
            m.normalizer_name = v.decode("utf-8")
        elif fno == 2 and wt == 2:
            m.precompiled_charsmap = v
        elif fno == 3 and wt == 0:
            m.add_dummy_prefix = bool(v)
        elif fno == 4 and wt == 0:
            m.remove_extra_whitespaces = bool(v)


def parse_model(data: bytes) -> SpmModel:
    """Parse serialized ``ModelProto`` bytes (a ``.model`` file)."""
    m = SpmModel()
    for fno, wt, v in _iter_fields(data):
        if fno == 1 and wt == 2:
            m.pieces.append(_parse_piece(v))
        elif fno == 2 and wt == 2:
            _parse_trainer(v, m)
        elif fno == 3 and wt == 2:
            _parse_normalizer(v, m)
        # 4 self_test_data / 5 denormalizer_spec / unknown: skipped
    if not m.pieces:
        raise ValueError("sentencepiece model contains no pieces "
                         "(not a ModelProto file?)")
    return m
