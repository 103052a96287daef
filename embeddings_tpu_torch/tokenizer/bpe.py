"""Byte-level BPE tokenizer (GPT-2 / RoBERTa / ModernBERT style), a copy of
``embeddings_tpu/tokenizer/bpe.py`` (pure Python) for the PyTorch port.

Text is pre-tokenized with the GPT-2 regex (or a tokenizer.json's own
Split regex), each piece is mapped byte by byte through the
bytes->unicode table, and merges are applied greedily by rank
(vocab.json + merges.txt, or a BPE tokenizer.json). It matches the HF
``tokenizers`` rust ByteLevel + BPE pipeline token for token, and has
WordPieceTokenizer's surface (encode / encode_batch / id_to_token /
decode and the special ids), so the Engine treats both alike.

No normalization is applied. The pre-tokenizer needs the ``regex``
package (for its Unicode property classes); where it is missing,
building a tokenizer raises ImportError.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Iterable, Sequence

try:
    import regex as _re  # supports \p{L}; installed with transformers
except ImportError:  # pragma: no cover - regex ships with transformers
    _re = None

# GPT-2's pre-tokenization pattern (used unchanged by RoBERTa and by the
# rust ByteLevel pre-tokenizer): contraction suffixes, optional-space
# letter runs, digit runs, punctuation runs, then whitespace handling
# where trailing whitespace splits off the last space for the next token.
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d"
                 r"| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                 r"|\s+(?!\S)|\s+")

# Qwen2-family pre-tokenization (tokenizer.json Split regex): case-
# insensitive contractions, optional ANY-non-letter prefix before letter
# runs, single digits, newline-aware punctuation/whitespace handling.
_QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                  r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char table: printable
    ASCII and Latin-1 map to themselves, the other 68 bytes map to
    256+offset so every byte has a visible, non-whitespace symbol."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class ByteLevelBPETokenizer:
    """vocab: token string -> id; merges: ordered (left, right) pairs."""

    def __init__(self, vocab: dict[str, int],
                 merges: Sequence[tuple[str, str]], *,
                 add_prefix_space: bool = False,
                 cls_token: str = "<s>", sep_token: str = "</s>",
                 unk_token: str = "<unk>", pad_token: str = "<pad>",
                 mask_token: str = "<mask>",
                 pattern: str | None = None,
                 special_style: str = "cls_sep"):
        if _re is None:  # pragma: no cover
            raise ImportError("byte-level BPE needs the 'regex' package")
        # pattern: the pre-tokenization regex — GPT-2's by default;
        # Qwen2-family tokenizer.json files carry their own Split regex.
        # special_style: "cls_sep" wraps <s> ... </s> (RoBERTa/ModernBERT
        # semantics); "eos_only" appends the sep/eos token alone
        # (decoder-based embedders: the last token IS the eos).
        assert special_style in ("cls_sep", "eos_only"), special_style
        self.pattern = pattern or _GPT2_PATTERN
        self.special_style = special_style
        self.token_to_id = dict(vocab)
        n = max(self.token_to_id.values()) + 1 if self.token_to_id else 0
        self._id_to_token = [""] * n
        for t, i in self.token_to_id.items():
            self._id_to_token[i] = t
        self.merge_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.add_prefix_space = add_prefix_space
        self._pat = _re.compile(self.pattern)
        get = self.token_to_id.get
        # RoBERTa's <s>/</s> play CLS/SEP's role; default ids 0/2/3/1
        # are the published RoBERTa assignment
        self.cls_id = get(cls_token, 0)
        self.sep_id = get(sep_token, 2)
        self.unk_id = get(unk_token, 3)
        self.pad_id = get(pad_token, 1)
        self.mask_id = get(mask_token, n - 1 if n else 4)
        self._cache: dict[str, tuple[str, ...]] = {}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "ByteLevelBPETokenizer":
        """Load from an HF model directory: vocab.json + merges.txt, or a
        tokenizer.json (rust `tokenizers` serialization) with a ByteLevel
        BPE model."""
        model_dir = Path(model_dir)
        tj = model_dir / "tokenizer.json"
        vj, mt = model_dir / "vocab.json", model_dir / "merges.txt"
        kw: dict = {}
        cfg_path = model_dir / "tokenizer_config.json"
        if cfg_path.exists():
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            if "add_prefix_space" in cfg:
                kw["add_prefix_space"] = bool(cfg["add_prefix_space"])
            for name in ("cls_token", "sep_token", "unk_token",
                         "pad_token", "mask_token"):
                v = cfg.get(name)
                if isinstance(v, dict):
                    v = v.get("content")
                if isinstance(v, str):
                    kw[name] = v
            # decoder-family configs name eos/bos instead of sep/cls
            for src, dst in (("eos_token", "sep_token"),
                             ("bos_token", "cls_token")):
                v = cfg.get(src)
                if isinstance(v, dict):
                    v = v.get("content")
                if isinstance(v, str):
                    kw.setdefault(dst, v)
        if vj.exists() and mt.exists():
            with open(vj, encoding="utf-8") as f:
                vocab = json.load(f)
            merges: list[tuple[str, str]] = []
            with open(mt, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
            return cls(vocab, merges, **kw)
        if tj.exists():
            return cls.from_tokenizer_json(tj, **kw)
        raise FileNotFoundError(
            f"no BPE tokenizer files (vocab.json+merges.txt or "
            f"tokenizer.json) in {model_dir}")

    @classmethod
    def from_tokenizer_json(cls, path: str | Path,
                            **kw) -> "ByteLevelBPETokenizer":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        model = d.get("model", {})
        if model.get("type") != "BPE":
            raise ValueError(f"tokenizer.json model type "
                             f"{model.get('type')!r} is not BPE")
        vocab = model["vocab"]
        merges = []
        for m in model.get("merges", []):
            # old serialization: "a b" strings; new: ["a", "b"] pairs
            if isinstance(m, str):
                a, _, b = m.partition(" ")
                merges.append((a, b))
            else:
                merges.append((m[0], m[1]))
        pre = d.get("pre_tokenizer") or {}
        pres = pre.get("pretokenizers", [pre])
        for p in pres:
            if p.get("type") == "ByteLevel":
                kw.setdefault("add_prefix_space",
                              bool(p.get("add_prefix_space", False)))
            elif p.get("type") == "Split":
                # Qwen2-family: a custom pre-tokenization regex instead
                # of ByteLevel's built-in GPT-2 pattern
                pat = p.get("pattern", {})
                if isinstance(pat, dict) and "Regex" in pat:
                    kw.setdefault("pattern", pat["Regex"])
        # special tokens by content when declared: RoBERTa's <s>-style
        # names or ModernBERT's [CLS]-style names (tokenizer_config.json
        # values, already in kw, take precedence)
        roles = {"<s>": "cls_token", "[CLS]": "cls_token",
                 "</s>": "sep_token", "[SEP]": "sep_token",
                 "<pad>": "pad_token", "[PAD]": "pad_token",
                 "<unk>": "unk_token", "[UNK]": "unk_token",
                 "<mask>": "mask_token", "[MASK]": "mask_token",
                 # Qwen2-family eos doubles as the sep/eos wrap token
                 "<|endoftext|>": "sep_token"}
        for at in d.get("added_tokens", []):
            c = at.get("content", "")
            role = roles.get(c)
            if role is not None:
                vocab.setdefault(c, at["id"])
                kw.setdefault(role, c)
        return cls(vocab, merges, **kw)

    # -- core algorithm ------------------------------------------------------
    def _bpe(self, token: str) -> tuple[str, ...]:
        """Greedy lowest-rank-first pair merging over one pre-token
        (already byte-mapped). Identical to the published GPT-2 merge
        loop; memoized per pre-token string."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        ranks = self.merge_ranks
        while len(word) > 1:
            best_rank = None
            best_i = -1
            prev = word[0]
            for i in range(1, len(word)):
                cur = word[i]
                r = ranks.get((prev, cur))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i - 1
                prev = cur
            if best_rank is None:
                break
            a, b = word[best_i], word[best_i + 1]
            merged = a + b
            out: list[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == a and word[i + 1] == b):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        if len(self._cache) < 50000:  # bound the memo under serving load
            self._cache[token] = word
        return word

    def tokenize_to_ids(self, text: str) -> list[int]:
        """Token ids WITHOUT the <s>/</s> specials."""
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        b2u = bytes_to_unicode()
        vocab = self.token_to_id
        unk = self.unk_id
        ids: list[int] = []
        for piece in self._pat.findall(text):
            mapped = "".join(b2u[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                ids.append(vocab.get(sub, unk))
        return ids

    def tokenize(self, text: str) -> list[str]:
        return [self._id_to_token[i] for i in self.tokenize_to_ids(text)]

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """<s> ids </s> (or ids + eos for special_style="eos_only"),
        truncated to max_len keeping the final </s>/eos — same
        truncation contract as WordPieceTokenizer.encode."""
        n_special = 1 if self.special_style == "eos_only" else 2
        if max_len is not None and 0 < max_len < n_special:
            raise ValueError(f"max_len must be >= {n_special}")
        ids = self.tokenize_to_ids(text)
        if max_len is not None and len(ids) > max_len - n_special:
            ids = ids[: max_len - n_special]
        if self.special_style == "eos_only":
            return ids + [self.sep_id]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: Iterable[str],
                     max_len: int | None = None) -> list[list[int]]:
        return [self.encode(t, max_len) for t in texts]

    def encode_pair(self, a: str, b: str, max_len: int | None = None
                    ) -> tuple[list[int], list[int]]:
        """Cross-encoder pair encoding, RoBERTa convention:
        ``<s> a </s></s> b </s>`` with a single token type (zeros) —
        what bge-reranker-family checkpoints were trained on. HF
        longest_first truncation."""
        from .wordpiece import truncate_pair
        ia, ib = self.tokenize_to_ids(a), self.tokenize_to_ids(b)
        if not ib:  # HF collapses an empty second segment entirely
            ids = self.encode(a, max_len)
            return ids, [0] * len(ids)
        if max_len is not None:
            ia, ib = truncate_pair(ia, ib, max_len - 4)
        ids = ([self.cls_id] + ia + [self.sep_id, self.sep_id]
               + ib + [self.sep_id])
        return ids, [0] * len(ids)

    def id_to_token(self, idx: int) -> str:
        return self._id_to_token[idx]

    def decode(self, ids: Sequence[int]) -> str:
        u2b = unicode_to_bytes()
        specials = {self.cls_id, self.sep_id, self.pad_id}
        buf = bytearray()
        for i in ids:
            if i in specials:
                continue
            for ch in self._id_to_token[i]:
                b = u2b.get(ch)
                if b is not None:
                    buf.append(b)
        return buf.decode("utf-8", errors="replace")
