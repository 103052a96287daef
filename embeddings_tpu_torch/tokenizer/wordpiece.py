"""Multilingual WordPiece tokenizer (BERT-style), HF-conformant.

Re-implements the behavior of the reference's ``bert_tokenize``
(its bert.cpp:199-417) — normalize, isolate punctuation and CJK
characters, whitespace-split, greedy longest-match WordPiece — but with the
*full* HuggingFace BertNormalizer/BertPreTokenizer semantics rather than the
reference's ASCII-only approximation:

- clean_text: drop control characters & U+FFFD, map all unicode whitespace
  to " " (the reference skips this step entirely).
- CJK isolation with the exact HF-rust codepoint ranges, including the
  0x2B920 lower bound that upstream hf-tokenizers uses where Unicode says
  0x2B820 (the reference deliberately copies this quirk, bert.cpp:287).
- lowercase + NFD accent stripping over *all* of Unicode (the reference uses
  a 52-entry Latin accent map, bert.cpp:206-238).
- punctuation splitting on every Unicode P* category char plus the ASCII
  symbol ranges HF treats as punctuation (the reference uses ispunct only).
- greedy longest-match-first WordPiece with the word/##subword vocab split
  (bert.cpp:373-414) and HF's 100-char-per-word [UNK] rule.

Conformance is tested token-for-token against the installed `tokenizers`
rust library (tests/test_tokenizer.py), replicating the reference's golden
test method (examples/test_hf_tokenizer.py + test_tokenizer.cpp).
"""

from __future__ import annotations

import unicodedata

try:
    # pins to the HF rust tokenizers' bundled Unicode tables wherever
    # they differ from this Python's (tools/gen_hf_rust_compat.py)
    from ._hf_rust_compat import (CONTROL_IN_HF_RUST as _HF_CTRL,
                                  PUNCT_IN_HF_RUST as _HF_PUNCT,
                                  TRANSFORM_IN_HF_RUST as _HF_TRANSFORM,
                                  UNASSIGNED_IN_HF_RUST as _HF_UNASSIGNED,
                                  WHITESPACE_IN_HF_RUST as _HF_WS)
except ImportError:  # pragma: no cover - running file standalone
    _HF_CTRL = _HF_PUNCT = _HF_UNASSIGNED = _HF_WS = frozenset()
    _HF_TRANSFORM = {}
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

# HF-rust CJK ranges (normalizers/bert.rs is_chinese_char). The reference
# copies these verbatim at bert.cpp:282-291, including the 0x2B920 quirk.
_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B920, 0x2CEAF),  # hf-rust uses 0x2B920 (unicode block starts 0x2B820)
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
)

# NOTE: the reference *also* spaces out 0x3000-0x303F and 0xFF00-0xFFEF
# (bert.cpp:290-291) which HF does not include in is_chinese_char; HF still
# splits most of those as punctuation. We follow HF (the conformance target).


def _is_cjk(cp: int) -> bool:
    for lo, hi in _CJK_RANGES:
        if lo <= cp <= hi:
            return True
    return False


def _is_whitespace(ch: str) -> bool:
    # hf-rust spaces the Zs/Zl/Zp separator categories (U+2028/U+2029
    # included; Zs-only — the HF *python* BasicTokenizer rule — diverges
    # there; found by fuzzing against the rust oracle). Cc whitespace
    # like VT/FF/NEL is REMOVED by clean_text instead: control is
    # checked first and wins.
    if ch in (" ", "\t", "\n", "\r"):
        return True
    cp = ord(ch)
    if cp in _HF_WS:
        return True
    if cp in _HF_UNASSIGNED:
        return False
    return unicodedata.category(ch) in ("Zs", "Zl", "Zp")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    cp = ord(ch)
    if cp in _HF_CTRL:
        return True
    if cp in _HF_UNASSIGNED:
        return False
    # hf-rust removes Cc/Cf/Co (and surrogates) but KEEPS unassigned (Cn)
    # codepoints — e.g. U+FF00 and U+2B81F flow through to the model
    return unicodedata.category(ch) in ("Cc", "Cf", "Co", "Cs")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges HF treats as punctuation (includes $ + < = > ^ ` | ~).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    if cp in _HF_PUNCT:
        return True
    if cp in _HF_UNASSIGNED:
        return False
    return unicodedata.category(ch).startswith("P")


def normalize(text: str, *, lowercase: bool = True, strip_accents: bool | None = None,
              tokenize_chinese_chars: bool = True, clean_text: bool = True) -> str:
    """BertNormalizer-equivalent string normalization."""
    if strip_accents is None:
        strip_accents = lowercase
    if clean_text:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        text = "".join(out)
    if tokenize_chinese_chars:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        text = "".join(out)
    if lowercase:
        # char-wise, NOT str.lower(): Python's whole-string lower applies
        # Unicode's context-sensitive Final_Sigma rule ('ΛΟΓΟΣ' -> ...ς),
        # while hf-rust (and our native tables) lowercase per character
        # ('Σ' -> σ everywhere). The per-char form matches the oracle.
        # Codepoints unassigned in the rust tables pass through
        # untouched; Unicode-16 mappings Python lacks come from the
        # pinned transform table.
        text = "".join(
            _HF_TRANSFORM.get(ord(c), c) if ord(c) in _HF_TRANSFORM
            or ord(c) in _HF_UNASSIGNED else c.lower()
            for c in text)
    if strip_accents:
        # pinned-punctuation chars are kept even when Python categorizes
        # them Mn (e.g. U+111C9, recategorized Po -> Mn in Unicode 15)
        text = "".join(
            c if ord(c) in _HF_UNASSIGNED or ord(c) in _HF_TRANSFORM
            or ord(c) in _HF_PUNCT else
            "".join(x for x in unicodedata.normalize("NFD", c)
                    if unicodedata.category(x) != "Mn")
            for c in text)
    return text


def pre_tokenize(text: str) -> list[str]:
    """Whitespace split + punctuation isolation (BertPreTokenizer)."""
    words: list[str] = []
    cur: list[str] = []
    for ch in text:
        if _is_whitespace(ch):
            if cur:
                words.append("".join(cur))
                cur = []
        elif _is_punctuation(ch):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


@dataclass
class WordPieceVocab:
    """Token string <-> id maps, with the reference's word vs ``##`` subword
    split (bert.cpp:73-80, 470-495) for O(1) longest-match lookups."""

    token_to_id: dict[str, int]
    word: dict[str, int] = field(init=False)
    subword: dict[str, int] = field(init=False)
    id_to_token: list[str] = field(init=False)

    def __post_init__(self) -> None:
        self.word = {}
        self.subword = {}
        n = max(self.token_to_id.values()) + 1 if self.token_to_id else 0
        self.id_to_token = [""] * n
        for tok, i in self.token_to_id.items():
            self.id_to_token[i] = tok
            if tok.startswith("##"):
                self.subword[tok[2:]] = i
            else:
                self.word[tok] = i

    def __len__(self) -> int:
        return len(self.token_to_id)

    @classmethod
    def from_file(cls, path: str | Path) -> "WordPieceVocab":
        """Load a HF ``vocab.txt`` (one token per line, id = line number)."""
        tok2id: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    tok2id[tok] = i
        return cls(tok2id)

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "WordPieceVocab":
        return cls({t: i for i, t in enumerate(tokens)})


def truncate_pair(a: list[int], b: list[int], budget: int
                  ) -> tuple[list[int], list[int]]:
    """HF longest_first pair truncation: drop one token at a time from
    the end of the LONGER sequence (ties trim the first) until the two
    fit the budget. Shared by every tokenizer's encode_pair."""
    a, b = list(a), list(b)
    while len(a) + len(b) > budget:
        if len(a) >= len(b):
            a.pop()
        else:
            b.pop()
    return a, b


class WordPieceTokenizer:
    """The full tokenizer: normalize -> pre-tokenize -> greedy WordPiece.

    API mirrors the reference's C surface: ``encode`` == ``bert_tokenize``
    (bert.h:44-49), ``id_to_token`` == ``bert_vocab_id_to_token`` (bert.h:88).
    """

    def __init__(self, vocab: WordPieceVocab, *,
                 lowercase: bool = True,
                 strip_accents: bool | None = None,
                 tokenize_chinese_chars: bool = True,
                 max_input_chars_per_word: int = 100,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 unk_token: str = "[UNK]", pad_token: str = "[PAD]",
                 mask_token: str = "[MASK]"):
        self.vocab = vocab
        self.lowercase = lowercase
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.max_input_chars_per_word = max_input_chars_per_word
        get = vocab.token_to_id.get

        def lookup(configured: str, alt: str, fallback: int) -> int:
            # The reference hardcodes 101/102/100 (bert.cpp:304-306); we
            # look ids up from the vocab — trying the RoBERTa-style name
            # too (MPNet ships vocab.txt with <s>/</s>/<pad> specials) —
            # and fall back to those values.
            i = get(configured)
            return i if i is not None else get(alt, fallback)

        self.cls_id = lookup(cls_token, "<s>", 101)
        self.sep_id = lookup(sep_token, "</s>", 102)
        self.unk_id = lookup(unk_token, "<unk>", 100)
        self.pad_id = lookup(pad_token, "<pad>", 0)
        self.mask_id = lookup(mask_token, "<mask>", 103)

    # -- construction helpers ------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "WordPieceTokenizer":
        """Load from a HF model directory (vocab.txt + tokenizer_config.json)."""
        import json
        model_dir = Path(model_dir)
        vocab = WordPieceVocab.from_file(model_dir / "vocab.txt")
        kw: dict = {}
        cfg_path = model_dir / "tokenizer_config.json"
        if cfg_path.exists():
            with open(cfg_path) as f:
                cfg = json.load(f)
            if "do_lower_case" in cfg:
                kw["lowercase"] = bool(cfg["do_lower_case"])
            if cfg.get("strip_accents") is not None:
                kw["strip_accents"] = bool(cfg["strip_accents"])
            if "tokenize_chinese_chars" in cfg:
                kw["tokenize_chinese_chars"] = bool(cfg["tokenize_chinese_chars"])
            for name in ("cls_token", "sep_token", "unk_token", "pad_token", "mask_token"):
                v = cfg.get(name)
                if isinstance(v, dict):
                    v = v.get("content")
                if isinstance(v, str):
                    kw[name] = v
        return cls(vocab, **kw)

    # -- core algorithm ------------------------------------------------------
    def wordpiece(self, word: str) -> list[int]:
        """Greedy longest-match-first WordPiece on one whitespace-free word.

        Same loop as the reference (bert.cpp:373-414) with HF's whole-word
        [UNK] semantics: HF emits [UNK] for the *whole word* if any piece
        fails to match, whereas the reference skips unknown bytes mid-word.
        """
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: list[int] = []
        table = self.vocab.word
        i, n = 0, len(word)
        while i < n:
            j = n
            hit = -1
            while j > i:
                tid = table.get(word[i:j])
                if tid is not None:
                    hit = tid
                    break
                j -= 1
            if hit < 0:
                return [self.unk_id]  # whole-word UNK (HF semantics)
            ids.append(hit)
            i = j
            table = self.vocab.subword
        return ids

    def tokenize_to_ids(self, text: str) -> list[int]:
        """Token ids WITHOUT special tokens."""
        text = normalize(text, lowercase=self.lowercase,
                         strip_accents=self.strip_accents,
                         tokenize_chinese_chars=self.tokenize_chinese_chars)
        ids: list[int] = []
        for w in pre_tokenize(text):
            ids.extend(self.wordpiece(w))
        return ids

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """[CLS] ids [SEP], truncated to max_len (keeping the final [SEP]) —
        the reference truncates at n_max_tokens-1 (bert.cpp:386).
        max_len < 2 cannot hold [CLS]+[SEP] and is rejected (keeps the
        Python and native paths' edge behavior identical)."""
        if max_len is not None and 0 < max_len < 2:
            raise ValueError("max_len must be >= 2 ([CLS] + [SEP])")
        ids = self.tokenize_to_ids(text)
        if max_len is not None and len(ids) > max_len - 2:
            ids = ids[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: Iterable[str], max_len: int | None = None) -> list[list[int]]:
        return [self.encode(t, max_len) for t in texts]

    def encode_pair(self, a: str, b: str, max_len: int | None = None
                    ) -> tuple[list[int], list[int]]:
        """Cross-encoder pair encoding: ``[CLS] a [SEP] b [SEP]`` plus
        token-type ids (0 over the query span incl. its [SEP], 1 over
        the document span) — HF BertTokenizer pair semantics with
        longest_first truncation."""
        ia, ib = self.tokenize_to_ids(a), self.tokenize_to_ids(b)
        if not ib:  # HF collapses an empty second segment entirely
            ids = self.encode(a, max_len)
            return ids, [0] * len(ids)
        if max_len is not None:
            ia, ib = truncate_pair(ia, ib, max_len - 3)
        ids = [self.cls_id] + ia + [self.sep_id] + ib + [self.sep_id]
        types = [0] * (len(ia) + 2) + [1] * (len(ib) + 1)
        return ids, types

    def id_to_token(self, idx: int) -> str:
        return self.vocab.id_to_token[idx]

    def decode(self, ids: Sequence[int]) -> str:
        parts: list[str] = []
        for i in ids:
            tok = self.vocab.id_to_token[i]
            if tok.startswith("##"):
                parts.append(tok[2:])
            else:
                if parts:
                    parts.append(" ")
                parts.append(tok)
        return "".join(parts)
