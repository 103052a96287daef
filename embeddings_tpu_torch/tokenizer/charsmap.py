"""SentencePiece "Precompiled" charsmap normalizer — pure Python; a copy of
``embeddings_tpu/tokenizer/charsmap.py`` for the PyTorch port.

SentencePiece freezes its ``nmt_nfkc`` / ``nmt_nfkc_cf`` normalization
rules into a *precompiled charsmap*: a darts-clone double-array trie
mapping UTF-8 byte sequences to replacement strings, serialized as

    [u32 little-endian: trie byte size][trie: u32 units][normalized pool]

where each trie value is a byte offset into the pool and the
replacement is the NUL-terminated UTF-8 string at that offset.

HF's rust ``tokenizers`` applies this blob through the
``spm_precompiled`` crate, whose semantics this module reproduces
exactly (and which differ from sentencepiece's own longest-match
normalizer — see ``PrecompiledCharsmap.normalize``):

  for each extended grapheme cluster of the input:
      if the cluster is < 6 UTF-8 bytes and the trie has any prefix
      match for it, replace the WHOLE cluster with the replacement of
      the FIRST (shortest) match;
      otherwise process the cluster character by character, replacing
      each char that matches and passing the rest through.

Conformance is tested against ``tokenizers.normalizers.Precompiled``
itself on synthetic charsmaps (tests/test_charsmap.py builds real
double-array tries), the same offline-oracle method used for the
WordPiece/BPE/Unigram tokenizers.

The reference engine has no sentencepiece support at all (WordPiece
only, bert.cpp:199-417); this closes the one remaining approximation in
the XLM-R/ALBERT tokenizer path (previously NFKC-with-a-warning).
"""

from __future__ import annotations

import struct
from array import array
from typing import Iterable

try:  # extended grapheme clusters (UAX #29) via the regex module's \X
    import regex as _regex
    _GRAPHEMES = _regex.compile(r"\X")
except ImportError:  # pragma: no cover - regex ships with transformers
    _regex = None
    _GRAPHEMES = None


def _graphemes(text: str) -> Iterable[str]:
    if _GRAPHEMES is not None:
        return _GRAPHEMES.findall(text)
    return list(text)  # degraded: per-codepoint (no cluster grouping)


class PrecompiledCharsmap:
    """Parsed precompiled charsmap: double-array trie + replacement pool.

    Unit layout (darts-clone ``DoubleArrayUnit``):
      label(u)    = u & 0x800000FF         (leaf units never match a byte)
      has_leaf(u) = (u >> 8) & 1
      offset(u)   = (u >> 10) << 8   if u & (1 << 9)
                  = (u >> 10)        otherwise
      leaf value  = u & 0x7FFFFFFF   (unit sits at the node's base)
    """

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled charsmap too short")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size == 0 or trie_size % 4 or trie_size > len(blob) - 4:
            raise ValueError(
                f"precompiled charsmap trie size {trie_size} does not fit "
                f"blob of {len(blob)} bytes")
        units = array("I")
        units.frombytes(blob[4:4 + trie_size])
        if struct.pack("<I", 1) != struct.pack("=I", 1):  # pragma: no cover
            units.byteswap()
        self._units = units
        self._pool = blob[4 + trie_size:]
        self._cache: dict[str, str | None] = {}

    # -- trie -----------------------------------------------------------------
    def _first_match(self, key: bytes) -> int | None:
        """Value of the FIRST (shortest) prefix of ``key`` in the trie —
        spm_precompiled returns ``results[0]`` of its common-prefix
        search, not the longest match."""
        units = self._units
        n = len(units)
        pos = 0
        unit = units[0]
        pos ^= (unit >> 10) << 8 if unit & 0x200 else unit >> 10
        for c in key:
            pos ^= c
            if pos >= n:
                return None
            unit = units[pos]
            if unit & 0x800000FF != c:
                return None
            pos ^= (unit >> 10) << 8 if unit & 0x200 else unit >> 10
            if (unit >> 8) & 1:  # has_leaf: value unit sits at the base
                if pos >= n:
                    return None
                return units[pos] & 0x7FFFFFFF
        return None

    def transform(self, chunk: str) -> str | None:
        """Replacement for ``chunk`` (None = pass through unchanged)."""
        hit = self._cache.get(chunk, False)
        if hit is not False:
            return hit
        value = self._first_match(chunk.encode("utf-8"))
        if value is None:
            out = None
        else:
            end = self._pool.find(b"\0", value)
            if end < 0:
                end = len(self._pool)
            out = self._pool[value:end].decode("utf-8")
        self._cache[chunk] = out
        return out

    # -- normalization --------------------------------------------------------
    def normalize(self, text: str) -> str:
        """Apply the charsmap the way HF ``tokenizers`` does.

        Grapheme-cluster-first with shortest-match replacement of the
        whole cluster (spm_precompiled's documented oddity), falling
        back to per-character replacement. This intentionally matches
        the rust oracle rather than sentencepiece's own
        ``Normalizer::NormalizePrefix`` longest-match walk, because the
        tokenizer pipelines here conform to HF ``tokenizers``.
        """
        out: list[str] = []
        transform = self.transform
        for g in _graphemes(text):
            if len(g.encode("utf-8")) < 6:  # rust &str::len is bytes
                norm = transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)
