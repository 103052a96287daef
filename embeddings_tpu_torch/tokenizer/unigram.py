"""Unigram (SentencePiece-style) tokenizer, HF-conformant — pure Python; a
copy of ``embeddings_tpu/tokenizer/unigram.py`` for the PyTorch port.

XLM-RoBERTa-family embedding models (multilingual-e5, bge-m3,
paraphrase-multilingual-*) tokenize with a SentencePiece Unigram model.
The `sentencepiece` package is not a dependency here; instead this module
implements the algorithm the HF rust `tokenizers` library runs for these
models' `tokenizer.json`:

  normalize (NFKC-family) -> Metaspace pre-tokenization (spaces become
  "▁", each piece starts with one) -> per-piece Viterbi segmentation
  maximizing the sum of unigram log-probabilities, with sentencepiece's
  unknown-character penalty and fuse_unk behavior.

Conformance is tested token-for-token against a rust-trained Unigram
oracle (tests/test_unigram_tokenizer.py), the same offline-oracle method
used for WordPiece and BPE.

The reference engine has no analogue (WordPiece only, bert.cpp:199-417);
this is a beyond-reference family addition.

Checkpoints shipping only a raw sentencepiece ``.model`` file (no
tokenizer.json) load through ``from_sentencepiece_model`` via the
pure-Python ModelProto reader in ``spm.py`` — including the
XLM-RoBERTa fairseq id remap and the ALBERT casing/accents
preprocessing, matching what HF's slow->fast converter would produce.

Real XLM-R checkpoints carry a "Precompiled" normalizer (sentencepiece's
frozen nmt_nfkc charsmap, a double-array trie over UTF-8) in their
tokenizer.json / .model; it is applied exactly via ``charsmap.py``,
conformance-tested against the rust ``tokenizers`` Precompiled
normalizer itself. A malformed charsmap falls back to NFKC with a
warning; pass normalizer= explicitly to override either way.
"""

from __future__ import annotations

import json
import logging
import math
import re
import unicodedata
from pathlib import Path
from typing import Iterable, Sequence

logger = logging.getLogger("embeddings_tpu_torch.tokenizer")

SPIECE = "▁"  # the Metaspace marker "▁"


def _parse_charsmap(blob: bytes, origin: str):
    """("precompiled", PrecompiledCharsmap) op, or None (with a warning)
    when the blob is empty/malformed — callers then fall back to NFKC."""
    if not blob:
        return None
    try:
        from .charsmap import PrecompiledCharsmap
        return ("precompiled", PrecompiledCharsmap(blob))
    except ValueError as e:
        logger.warning("malformed precompiled charsmap in %s (%s); "
                       "approximating with NFKC", origin, e)
        return None

# sentencepiece's penalty for characters no vocab piece covers
# (rust tokenizers model/unigram/model.rs K_UNK_PENALTY)
_UNK_PENALTY = 10.0


class UnigramTokenizer:
    """vocab: ordered (piece, log_prob) list; ids are list positions."""

    def __init__(self, vocab: Sequence[tuple[str, float]], *,
                 unk_id: int | None = 0,
                 normalizer: str = "nfkc",
                 fuse_unk: bool = True,
                 byte_fallback: bool = False,
                 prepend_scheme: str = "always",
                 cls_token: str = "<s>", sep_token: str = "</s>",
                 pad_token: str = "<pad>", mask_token: str = "<mask>"):
        self.pieces = [p for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id_model = unk_id
        self.fuse_unk = fuse_unk
        self.byte_fallback = byte_fallback
        if byte_fallback:
            # sentencepiece byte-fallback pieces are "<0xNN>"
            self._byte_ids = [self.piece_to_id.get(f"<0x{b:02X}>")
                              for b in range(256)]
        self.normalizer = normalizer
        self.prepend_scheme = prepend_scheme
        self._max_piece_chars = max((len(p) for p in self.pieces), default=1)
        real_scores = [s for s in self.scores if s < 0] or [0.0]
        self._min_score = min(real_scores)
        get = self.piece_to_id.get
        self.cls_id = get(cls_token, 0)
        self.sep_id = get(sep_token, 2)
        self.pad_id = get(pad_token, 1)
        self.unk_id = unk_id if unk_id is not None else get("<unk>", 3)
        self.mask_id = get(mask_token, len(self.pieces) - 1)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str | Path,
                        **kw) -> "UnigramTokenizer":
        """tokenizer.json if present, else a raw sentencepiece .model
        file (spiece.model / sentencepiece.bpe.model) via the pure-
        Python ModelProto reader — style/casing inferred from
        config.json + tokenizer_config.json when available."""
        model_dir = Path(model_dir)
        tj = model_dir / "tokenizer.json"
        if tj.exists():
            return cls.from_tokenizer_json(tj, **kw)
        spm = next((p for n in ("spiece.model", "sentencepiece.bpe.model",
                                "tokenizer.model")
                    if (p := model_dir / n).exists()), None)
        if spm is None:
            raise FileNotFoundError(
                f"no tokenizer.json or sentencepiece .model file in "
                f"{model_dir}")

        def _cfg(name: str) -> dict:
            p = model_dir / name
            if p.exists():
                with open(p, encoding="utf-8") as f:
                    return json.load(f)
            return {}

        model_type = _cfg("config.json").get("model_type", "")
        tok_cfg = _cfg("tokenizer_config.json")
        if model_type == "xlm-roberta":
            kw.setdefault("style", "xlm-roberta")
        elif model_type == "albert":
            kw.setdefault("style", "albert")
            kw.setdefault("do_lower_case",
                          bool(tok_cfg.get("do_lower_case", True)))
            kw.setdefault("keep_accents",
                          bool(tok_cfg.get("keep_accents", False)))
        return cls.from_sentencepiece_model(spm, **kw)

    @classmethod
    def from_sentencepiece_model(cls, path: str | Path, *,
                                 style: str = "sentencepiece",
                                 do_lower_case: bool = False,
                                 keep_accents: bool = True,
                                 **kw) -> "UnigramTokenizer":
        """Build from a raw sentencepiece ``.model`` file (no
        tokenizer.json needed), mirroring HF's slow->fast conversion
        (transformers convert_slow_tokenizer SpmConverter):

        - ``style="sentencepiece"``: piece ids ARE token ids; specials
          resolved from the trainer spec (preferring in-vocab
          [CLS]/[SEP]/[MASK], the ALBERT convention).
        - ``style="albert"``: plus the AlbertTokenizer preprocessing
          (quote normalization; NFKD+StripAccents unless keep_accents;
          Lowercase when do_lower_case).
        - ``style="xlm-roberta"``: the fairseq id remap — vocab becomes
          <s> <pad> </s> <unk> + pieces[3:] + <mask>, so ids match
          XLMRobertaTokenizer(Fast) exactly.
        """
        from .spm import MODEL_UNIGRAM, parse_model
        m = parse_model(Path(path).read_bytes())
        if m.model_type != MODEL_UNIGRAM:
            raise ValueError(
                f"sentencepiece model_type {m.model_type} is not Unigram "
                f"(=1); BPE-trained sentencepiece models are not "
                f"supported — re-export with HF tokenizers")
        if style == "xlm-roberta":
            # fairseq offset: HF inserts <s> <pad> </s> <unk> at 0-3,
            # drops sp's first three (<unk> <s> </s>), appends <mask>
            vocab = ([("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0),
                      ("<unk>", 0.0)]
                     + [(p.piece, p.score) for p in m.pieces[3:]]
                     + [("<mask>", 0.0)])
            kw.setdefault("unk_id", 3)
            kw.setdefault("cls_token", "<s>")
            kw.setdefault("sep_token", "</s>")
            kw.setdefault("pad_token", "<pad>")
            kw.setdefault("mask_token", "<mask>")
        elif style in ("sentencepiece", "albert"):
            vocab = [(p.piece, p.score) for p in m.pieces]
            names = {p.piece for p in m.pieces}
            kw.setdefault("unk_id", m.unk_id if m.unk_id >= 0 else None)
            kw.setdefault("cls_token",
                          "[CLS]" if "[CLS]" in names else m.bos_piece)
            kw.setdefault("sep_token",
                          "[SEP]" if "[SEP]" in names else m.eos_piece)
            kw.setdefault("pad_token", m.pad_piece)
            kw.setdefault("mask_token",
                          "[MASK]" if "[MASK]" in names else "<mask>")
        else:
            raise ValueError(f"unknown sentencepiece style {style!r}")
        kw.setdefault("byte_fallback", m.byte_fallback)
        kw.setdefault("prepend_scheme",
                      "always" if m.add_dummy_prefix else "never")
        ops: list = []
        if style == "albert":
            ops += [("replace", "``", '"'), ("replace", "''", '"')]
        if not keep_accents:
            ops += ["nfkd", "strip_accents"]
        if do_lower_case:
            ops.append("lowercase")
        name = m.normalizer_name
        charsmap_op = None
        if m.precompiled_charsmap:
            charsmap_op = _parse_charsmap(m.precompiled_charsmap, name)
        if charsmap_op is not None:
            # HF SpmConverter installs ONLY the Precompiled normalizer —
            # the charsmap already encodes the full nmt_nfkc(-cf) rules,
            # casefolding included
            ops.append(charsmap_op)
        elif name in ("nmt_nfkc", "nfkc"):
            ops.append("nfkc")
        elif name in ("nmt_nfkc_cf", "nfkc_cf"):
            ops += ["nfkc", "lowercase"]
        elif name in ("identity", ""):
            pass
        else:
            logger.warning("unknown sentencepiece normalizer %r with no "
                           "charsmap; approximating with NFKC", name)
            ops.append("nfkc")
        if m.remove_extra_whitespaces:
            # HF SpmConverter appends Replace(Regex(" {2,}"), " ")
            ops.append("collapse_spaces")
        kw.setdefault("normalizer", cls._fold_ops(ops))
        return cls(vocab, **kw)

    @staticmethod
    def _fold_ops(ops: list) -> str | list:
        if not ops:
            return "none"
        return ops[0] if len(ops) == 1 and isinstance(ops[0], str) else ops

    @classmethod
    def from_tokenizer_json(cls, path: str | Path,
                            **kw) -> "UnigramTokenizer":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        model = d.get("model", {})
        if model.get("type") != "Unigram":
            raise ValueError(f"tokenizer.json model type "
                             f"{model.get('type')!r} is not Unigram")
        vocab = [(p, float(s)) for p, s in model["vocab"]]
        kw.setdefault("unk_id", model.get("unk_id"))
        kw.setdefault("byte_fallback", bool(model.get("byte_fallback")))
        norm = d.get("normalizer") or {}
        kw.setdefault("normalizer", cls._pick_normalizer(norm))
        pre = d.get("pre_tokenizer") or {}
        pres = pre.get("pretokenizers", [pre])
        for p in pres:
            if p.get("type") == "Metaspace":
                kw.setdefault("prepend_scheme",
                              p.get("prepend_scheme",
                                    "always" if p.get("add_prefix_space",
                                                      True) else "never"))
        return cls(vocab, **kw)

    @staticmethod
    def _pick_normalizer(norm: dict) -> str | list:
        """Map a tokenizer.json normalizer (single or Sequence) onto our
        op list: unicode forms, Lowercase, StripAccents (ALBERT-style
        sentencepiece pipelines), and Replace with a literal pattern.
        Precompiled charsmaps approximate as NFKC with a warning."""
        ops: list = []
        for n in norm.get("normalizers", [norm]):
            k = n.get("type")
            if k in ("NFKC", "NFC", "NFKD", "NFD"):
                ops.append(k.lower())
            elif k == "Lowercase":
                ops.append("lowercase")
            elif k == "StripAccents":
                ops.append("strip_accents")
            elif k == "Replace":
                pat = n.get("pattern", {})
                lit = pat.get("String") if isinstance(pat, dict) else None
                rex = pat.get("Regex") if isinstance(pat, dict) else None
                if lit is not None:
                    ops.append(("replace", lit, n.get("content", "")))
                elif rex == " {2,}" and n.get("content") == " ":
                    # HF SpmConverter's whitespace-collapse step
                    ops.append("collapse_spaces")
                else:
                    logger.warning("ignoring unsupported Replace pattern "
                                   "%r in tokenizer.json", pat)
            elif k == "Precompiled":
                import base64
                blob = base64.b64decode(n.get("precompiled_charsmap")
                                        or "")
                op = _parse_charsmap(blob, "tokenizer.json")
                ops.append("nfkc" if op is None else op)
            elif k is not None:
                logger.warning("ignoring unsupported normalizer %r in "
                               "tokenizer.json", k)
        return UnigramTokenizer._fold_ops(ops)

    # -- pipeline ------------------------------------------------------------
    def _normalize(self, text: str) -> str:
        ops = self.normalizer
        if isinstance(ops, str):
            ops = [] if ops == "none" else [ops]
        for op in ops:
            if isinstance(op, tuple) and op[0] == "precompiled":
                text = op[1].normalize(text)
            elif isinstance(op, tuple):  # ("replace", pattern, content)
                text = text.replace(op[1], op[2])
            elif op == "lowercase":
                # per-char like rust's Lowercase (no Final_Sigma context)
                text = "".join(c.lower() for c in text)
            elif op == "strip_accents":
                # rust StripAccents removes Mn WITHOUT decomposing first
                text = "".join(c for c in text
                               if unicodedata.category(c) != "Mn")
            elif op == "collapse_spaces":
                text = re.sub(" {2,}", " ", text)
            else:
                text = unicodedata.normalize(op.upper(), text)
        return text

    def _metaspace(self, text: str) -> list[str]:
        """Metaspace pre-tokenization: map spaces to the marker, prepend
        one if the text doesn't already start with it, split with each
        piece keeping its leading marker (rust pre_tokenizers/
        metaspace.rs; replacement happens BEFORE the conditional prepend,
        so a leading space suppresses the extra marker)."""
        text = text.replace(" ", SPIECE)
        if self.prepend_scheme != "never" and text \
                and not text.startswith(SPIECE):
            text = SPIECE + text
        pieces: list[str] = []
        start = 0
        for i, ch in enumerate(text):
            if ch == SPIECE and i > start:
                pieces.append(text[start:i])
                start = i
        if text[start:]:
            pieces.append(text[start:])
        return pieces

    def _viterbi(self, chunk: str) -> list[int]:
        """Best segmentation of one pre-token by summed piece log-probs.
        Characters no piece covers take unk with min_score - 10 (then
        byte-fallback pieces or fused unk runs, per config)."""
        n = len(chunk)
        NEG = -math.inf
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        unk_score = self._min_score - _UNK_PENALTY
        p2i, scores = self.piece_to_id, self.scores
        maxlen = self._max_piece_chars
        for end in range(1, n + 1):
            lo = max(0, end - maxlen)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                pid = p2i.get(chunk[start:end])
                if pid is not None:
                    s = best[start] + scores[pid]
                    if s > best[end]:
                        best[end] = s
                        back[end] = (start, pid)
            if back[end] is None and best[end - 1] > NEG:
                # single-char unknown step
                s = best[end - 1] + unk_score
                if s > best[end]:
                    best[end] = s
                    back[end] = (end - 1, -1)
        ids: list[int] = []
        spans: list[tuple[int, int, int]] = []
        i = n
        while i > 0:
            start, pid = back[i]  # type: ignore[misc]
            spans.append((start, i, pid))
            i = start
        spans.reverse()
        unk = self.unk_id_model if self.unk_id_model is not None else -1
        prev_unk = False
        for start, end, pid in spans:
            if pid >= 0:
                ids.append(pid)
                prev_unk = False
            elif self.byte_fallback and self._covers_bytes(chunk[start:end]):
                ids.extend(self._byte_ids[b]  # type: ignore[arg-type]
                           for b in chunk[start:end].encode("utf-8"))
                prev_unk = False
            else:
                if self.fuse_unk and prev_unk:
                    continue  # consecutive unknowns emit one unk
                ids.append(unk)
                prev_unk = True
        return ids

    def _covers_bytes(self, s: str) -> bool:
        return all(self._byte_ids[b] is not None for b in s.encode("utf-8"))

    def tokenize_to_ids(self, text: str) -> list[int]:
        """Token ids WITHOUT the <s>/</s> specials."""
        out: list[int] = []
        for chunk in self._metaspace(self._normalize(text)):
            out.extend(self._viterbi(chunk))
        return out

    def tokenize(self, text: str) -> list[str]:
        return [self.pieces[i] if 0 <= i < len(self.pieces) else "<unk>"
                for i in self.tokenize_to_ids(text)]

    # -- WordPieceTokenizer-compatible surface -------------------------------
    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """<s> ids </s>, truncated keeping the final </s> (same contract
        as the WordPiece/BPE encode)."""
        if max_len is not None and 0 < max_len < 2:
            raise ValueError("max_len must be >= 2 (<s> + </s>)")
        ids = self.tokenize_to_ids(text)
        if max_len is not None and len(ids) > max_len - 2:
            ids = ids[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_batch(self, texts: Iterable[str],
                     max_len: int | None = None) -> list[list[int]]:
        return [self.encode(t, max_len) for t in texts]

    def encode_pair(self, a: str, b: str, max_len: int | None = None
                    ) -> tuple[list[int], list[int]]:
        """Cross-encoder pair encoding, XLM-R convention (same as
        RoBERTa): ``<s> a </s></s> b </s>``, single token type — what
        the bge-reranker family (XLM-R backbones) was trained on."""
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
        return self.pieces[idx]

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.cls_id, self.sep_id, self.pad_id}
        text = "".join(self.pieces[i] for i in ids
                       if i not in specials and 0 <= i < len(self.pieces))
        return text.replace(SPIECE, " ").strip(" ")
