"""ctypes binding of the PyTorch port to the native C++ tokenizers
(``native/tokenizer.cpp``, ``bpe.cpp``, ``unigram.cpp``) — the port's
counterpart of ``embeddings_tpu/tokenizer/native.py``.

The same algorithms over the same Unicode tables as the Python
tokenizers, many times faster on long batches. The port builds its own
library at first use: it writes ``unicode_tables.h`` from this
interpreter's ``unicodedata`` (and the ``regex`` module's letter, number
and space classes where it is installed, as the Python BPE uses them),
then compiles copies of the three sources with ``g++`` into
``embeddings_tpu_torch/_build/etok-<hash>/libetok.so`` (git-ignored). The
name carries a hash of the sources, of this file, of ``wordpiece.py``
(whose predicates the tables come from) and of the Unicode and ``regex``
versions, so a stale build is never loaded. Nothing runs at import::

    tok = WordPieceTokenizer(vocab)
    fast = wrap_fast(tok)   # native counterpart, or None (keep Python)
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import shutil
import threading
import unicodedata
from pathlib import Path

from ..utils.gxx import build_once

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
SOURCES = ("tokenizer.cpp", "bpe.cpp", "unigram.cpp")
BUILD_DIR = _PKG / "_build"

log = logging.getLogger("embeddings_tpu_torch.native")

_lock = threading.Lock()
_lib = None
_lib_error: str | None = None  # why the library could not be built


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def _regex_version() -> str:
    try:
        import regex
    except ImportError:
        return "none"
    return getattr(regex, "__version__", "?")


def target() -> Path:
    """Where the library for these sources and this interpreter lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(Path(__file__).read_bytes())  # the table generator below
    # the predicates the tables are made from
    h.update((Path(__file__).parent / "wordpiece.py").read_bytes())
    h.update(f"{unicodedata.unidata_version} {_regex_version()}".encode())
    return BUILD_DIR / f"etok-{h.hexdigest()[:12]}" / "libetok.so"


def _ranges(pred, max_cp: int = 0x110000) -> list[tuple[int, int]]:
    out, start = [], None
    for cp in range(max_cp):
        ok = pred(chr(cp))
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            out.append((start, cp - 1))
            start = None
    if start is not None:
        out.append((start, max_cp - 1))
    return out


# the White_Space property (what ``regex`` matches as \s)
_WHITE_SPACE = frozenset({0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680,
                          *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                          0x205F, 0x3000})


def bpe_classes(use_regex: bool = True) -> list:
    """Predicates for the BPE scanner's \\p{L}, \\p{N} and \\s: the
    ``regex`` module's (the Python BPE's engine) when it is installed
    and asked for, else from ``unicodedata``."""
    if use_regex:
        try:
            import regex
        except ImportError:
            pass
        else:
            return [lambda ch, p=regex.compile(p): p.match(ch) is not None
                    for p in (r"\p{L}", r"\p{N}", r"\s")]
    return [lambda ch: unicodedata.category(ch)[0] == "L",
            lambda ch: unicodedata.category(ch)[0] == "N",
            lambda ch: ord(ch) in _WHITE_SPACE]


def write_unicode_tables(path: Path) -> None:
    """Write ``unicode_tables.h`` (what ``native/gen_tables.py`` writes)
    from the port's own copies of the WordPiece predicates: the
    lowercase + NFD + strip-Mn transform of each code point, the
    whitespace, control and punctuation ranges, and the BPE scanner's
    letter, number and space classes — from ``regex`` as the Python BPE
    matches them, or where it is not installed from ``unicodedata``
    (categories L*, N* and the White_Space property: the same on every
    code point this interpreter's Unicode version assigns)."""
    from .wordpiece import (_is_control, _is_punctuation, _is_whitespace,
                            normalize)
    transforms = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        t = normalize(ch, lowercase=True, strip_accents=True,
                      tokenize_chinese_chars=False, clean_text=False)
        if t != ch:
            cps = [ord(c) for c in t]
            assert len(cps) <= 4, (hex(cp), t)
            transforms.append((cp, cps))
    tables = [("Ws", _ranges(_is_whitespace)), ("Ctrl", _ranges(_is_control)),
              ("Punct", _ranges(_is_punctuation))]
    tables += [(name, _ranges(pred)) for name, pred in
               zip(("Letter", "Numeric", "RegexWs"), bpe_classes())]
    ws, ctrl, punct = (rs for _, rs in tables[:3])
    lines = ["// Generated by embeddings_tpu_torch/tokenizer/native.py — "
             "do not edit.", "#pragma once", "#include <cstdint>", "",
             f'static const char kUnidataVersion[] = '
             f'"{unicodedata.unidata_version}";',
             f"// {len(transforms)} transform entries, {len(ws)} ws / "
             f"{len(ctrl)} ctrl / {len(punct)} punct ranges",
             "struct TransformEntry { uint32_t cp; uint32_t out[4]; "
             "uint8_t n; };",
             "static const TransformEntry kTransforms[] = {"]
    for cp, cps in transforms:
        p = cps + [0] * (4 - len(cps))
        lines.append(f"  {{{cp}u, {{{p[0]}u,{p[1]}u,{p[2]}u,{p[3]}u}}, "
                     f"{len(cps)}}},")
    lines += ["};", f"static const uint32_t kNumTransforms = "
              f"{len(transforms)}u;", ""]
    for name, rs in tables:
        lines.append(f"static const uint32_t k{name}Ranges[][2] = {{")
        lines += [f"  {{{lo}u, {hi}u}}," for lo, hi in rs]
        lines += ["};", f"static const uint32_t kNum{name}Ranges = "
                  f"{len(rs)}u;", ""]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def build() -> Path:
    """Build the library if it is not built yet (one process at a time:
    others wait on a file lock and then load the result); returns its
    path. Raises RuntimeError when the compiler fails or is missing."""
    def stage(tmp: Path) -> list[str]:
        for name in SOURCES:
            shutil.copyfile(NATIVE_DIR / name, tmp / name)
        write_unicode_tables(tmp / "unicode_tables.h")
        return ["-O2", "-std=c++17", "-fPIC", "-shared",
                *(str(tmp / n) for n in SOURCES)]
    # the tables stay beside the library they were compiled into
    return build_once(target(), stage, "native tokenizer",
                      keep=("unicode_tables.h",))


def _bind(lib) -> None:
    lib.etok_new.restype = ctypes.c_void_p
    lib.etok_new.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                             ctypes.c_int32, ctypes.c_int32]
    lib.etok_free.argtypes = [ctypes.c_void_p]
    lib.etok_encode.restype = ctypes.c_int32
    lib.etok_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32]
    for name in ("cls", "sep", "unk", "pad"):
        fn = getattr(lib, f"etok_{name}_id")
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    lib.etok_unidata_version.restype = ctypes.c_char_p
    lib.ebpe_new.restype = ctypes.c_void_p
    lib.ebpe_new.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.ebpe_free.argtypes = [ctypes.c_void_p]
    lib.ebpe_encode.restype = ctypes.c_int32
    lib.ebpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.euni_new.restype = ctypes.c_void_p
    lib.euni_new.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.euni_free.argtypes = [ctypes.c_void_p]
    lib.euni_encode.restype = ctypes.c_int32
    lib.euni_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]


def _load_lib():
    """The loaded library, built at the first call; None (with one
    warning) when it cannot be built, and the Python tokenizers serve."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            built = lib.etok_unidata_version().decode()
            if built != unicodedata.unidata_version:
                raise RuntimeError(f"tables of Unicode {built}, interpreter "
                                   f"{unicodedata.unidata_version}")
        except (OSError, RuntimeError) as exc:
            _lib_error = str(exc)
            log.warning("native tokenizer unavailable, the Python "
                        "tokenizers serve: %s", exc)
            return None
        _lib = lib
        return lib


def available() -> bool:
    return _load_lib() is not None


class _Scratch:
    """Per-thread id buffers: ctypes releases the GIL during a call, and
    the serving layer tokenizes from several worker threads at once."""

    def _scratch(self):
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = (ctypes.c_int32 * 8192)()
            self._tls.buf = buf
        return buf

    def encode_batch(self, texts, max_len: int | None = None):
        return [self.encode(t, max_len) for t in texts]


class NativeWordPieceTokenizer(_Scratch):
    """Same interface subset as WordPieceTokenizer (encode/encode_batch)."""

    def __init__(self, tokens: list[str], *, lowercase: bool = True,
                 tokenize_chinese_chars: bool = True):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native tokenizer not built: {_lib_error}")
        self._lib = lib
        arr = (ctypes.c_char_p * len(tokens))(
            *[t.encode("utf-8") for t in tokens])
        self._ctx = lib.etok_new(arr, len(tokens), int(lowercase),
                                 int(tokenize_chinese_chars))
        self.cls_id = lib.etok_cls_id(self._ctx)
        self.sep_id = lib.etok_sep_id(self._ctx)
        self.unk_id = lib.etok_unk_id(self._ctx)
        self.pad_id = lib.etok_pad_id(self._ctx)
        self._tls = threading.local()

    @classmethod
    def wrap(cls, tok) -> "NativeWordPieceTokenizer | None":
        """Build from a WordPieceTokenizer if the library is available AND
        the tokenizer's config is representable natively; otherwise None
        (the caller keeps the Python implementation). The C++ side couples
        accent stripping to lowercasing, hardcodes 100 characters a word
        and resolves special tokens by their default literal names —
        configs that deviate must not silently get different ids."""
        from .wordpiece import WordPieceTokenizer
        if not isinstance(tok, WordPieceTokenizer):
            return None
        if not available():
            return None
        sa = tok.strip_accents
        if sa is not None and bool(sa) != bool(tok.lowercase):
            return None
        if getattr(tok, "max_input_chars_per_word", 100) != 100:
            return None
        nt = cls(tok.vocab.id_to_token, lowercase=tok.lowercase,
                 tokenize_chinese_chars=tok.tokenize_chinese_chars)
        if (nt.cls_id, nt.sep_id, nt.unk_id, nt.pad_id) != \
                (tok.cls_id, tok.sep_id, tok.unk_id, tok.pad_id):
            return None
        return nt

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        if max_len is not None and 0 < max_len < 2:
            raise ValueError("max_len must be >= 2 ([CLS] + [SEP])")
        data = text.encode("utf-8")
        buf = self._scratch()
        n = self._lib.etok_encode(self._ctx, data, len(data), buf,
                                  len(buf), max_len or -1)
        if n < 0:
            big = (ctypes.c_int32 * (len(data) + 2))()
            n = self._lib.etok_encode(self._ctx, data, len(data), big,
                                      len(big), max_len or -1)
            return list(big[:n])
        return list(buf[:n])

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._lib.etok_free(self._ctx)
        except Exception:
            pass


class NativeBPETokenizer(_Scratch):
    """Fast path for ByteLevelBPETokenizer.encode (same contract:
    specials wrapped per special_style, same truncation)."""

    def __init__(self, tok):
        from .bpe import _GPT2_PATTERN, _QWEN2_PATTERN
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native tokenizer not built: {_lib_error}")
        self._lib = lib
        pattern = {_GPT2_PATTERN: 0, _QWEN2_PATTERN: 1}[tok.pattern]
        items = list(tok.token_to_id.items())
        toks = (ctypes.c_char_p * len(items))(
            *[t.encode("utf-8") for t, _ in items])
        ids = (ctypes.c_int32 * len(items))(*[i for _, i in items])
        merges = sorted(tok.merge_ranks.items(), key=lambda kv: kv[1])
        marr = (ctypes.c_char_p * len(merges))(
            *[f"{a}\x01{b}".encode("utf-8") for (a, b), _ in merges])
        self._ctx = lib.ebpe_new(toks, ids, len(items), marr, len(merges),
                                 pattern, int(tok.add_prefix_space),
                                 tok.unk_id)
        self.cls_id = tok.cls_id
        self.sep_id = tok.sep_id
        self.unk_id = tok.unk_id
        self.pad_id = tok.pad_id
        self.special_style = tok.special_style
        self._tls = threading.local()

    @classmethod
    def wrap(cls, tok) -> "NativeBPETokenizer | None":
        """Build from a ByteLevelBPETokenizer when the library is
        available and the pre-tokenization pattern is one the C++ scanner
        implements (GPT-2 or Qwen2); otherwise None."""
        from .bpe import ByteLevelBPETokenizer, _GPT2_PATTERN, \
            _QWEN2_PATTERN
        if not isinstance(tok, ByteLevelBPETokenizer):
            return None
        if tok.pattern not in (_GPT2_PATTERN, _QWEN2_PATTERN):
            return None  # custom regex: keep the Python engine
        if not available():
            return None
        return cls(tok)

    def _raw(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        buf = self._scratch()
        n = self._lib.ebpe_encode(self._ctx, data, len(data), buf, len(buf))
        if n < 0:
            big = (ctypes.c_int32 * (-n))()
            n = self._lib.ebpe_encode(self._ctx, data, len(data), big,
                                      len(big))
            return list(big[:n])
        return list(buf[:n])

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        n_special = 1 if self.special_style == "eos_only" else 2
        if max_len is not None and 0 < max_len < n_special:
            raise ValueError(f"max_len must be >= {n_special}")
        ids = self._raw(text)
        if max_len is not None and len(ids) > max_len - n_special:
            ids = ids[: max_len - n_special]
        if self.special_style == "eos_only":
            return ids + [self.sep_id]
        return [self.cls_id] + ids + [self.sep_id]

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._lib.ebpe_free(self._ctx)
        except Exception:
            pass


class NativeUnigramTokenizer(_Scratch):
    """Fast path for UnigramTokenizer.encode: metaspace + Viterbi +
    unk/byte-fallback emission in C++. The normalizer (NFKC / precompiled
    charsmap / lowercase chains) stays on the wrapped Python tokenizer:
    it is the small, conformance-critical part, so only the Viterbi loop
    crosses the FFI."""

    def __init__(self, tok):
        from .unigram import _UNK_PENALTY
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native tokenizer not built: {_lib_error}")
        self._lib = lib
        self._py = tok  # normalization + special ids stay authoritative
        pieces = (ctypes.c_char_p * len(tok.pieces))(
            *[p.encode("utf-8") for p in tok.pieces])
        scores = (ctypes.c_double * len(tok.scores))(*tok.scores)
        byte_ids = None
        if tok.byte_fallback:
            byte_ids = (ctypes.c_int32 * 256)(
                *[(-1 if i is None else i) for i in tok._byte_ids])
        unk_emit = tok.unk_id_model if tok.unk_id_model is not None else -1
        self._ctx = lib.euni_new(
            pieces, scores, len(tok.pieces), unk_emit,
            float(tok._min_score - _UNK_PENALTY), int(tok.fuse_unk),
            byte_ids, int(tok.prepend_scheme != "never"))
        self.cls_id = tok.cls_id
        self.sep_id = tok.sep_id
        self.unk_id = tok.unk_id
        self.pad_id = tok.pad_id
        self._tls = threading.local()

    @classmethod
    def wrap(cls, tok) -> "NativeUnigramTokenizer | None":
        from .unigram import UnigramTokenizer
        if not isinstance(tok, UnigramTokenizer):
            return None
        if not available():
            return None
        return cls(tok)

    def tokenize_to_ids(self, text: str) -> list[int]:
        data = self._py._normalize(text).encode("utf-8")
        buf = self._scratch()
        n = self._lib.euni_encode(self._ctx, data, len(data), buf, len(buf))
        if n < 0:
            big = (ctypes.c_int32 * (-n))()
            n = self._lib.euni_encode(self._ctx, data, len(data), big,
                                      len(big))
            return list(big[:n])
        return list(buf[:n])

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        if max_len is not None and 0 < max_len < 2:
            raise ValueError("max_len must be >= 2 (<s> + </s>)")
        ids = self.tokenize_to_ids(text)
        if max_len is not None and len(ids) > max_len - 2:
            ids = ids[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def encode_pair(self, a: str, b: str, max_len: int | None = None):
        """Same XLM-R pair layout as UnigramTokenizer.encode_pair
        (<s> a </s></s> b </s>), both segmentations native."""
        from .wordpiece import truncate_pair
        ia, ib = self.tokenize_to_ids(a), self.tokenize_to_ids(b)
        if not ib:
            ids = self.encode(a, max_len)
            return ids, [0] * len(ids)
        if max_len is not None:
            ia, ib = truncate_pair(ia, ib, max_len - 4)
        ids = ([self.cls_id] + ia + [self.sep_id, self.sep_id]
               + ib + [self.sep_id])
        return ids, [0] * len(ids)

    def __del__(self):
        try:
            if getattr(self, "_ctx", None):
                self._lib.euni_free(self._ctx)
        except Exception:
            pass


def wrap_fast(tok):
    """The Engine's fast-tokenizer dispatcher: the native WordPiece,
    BPE, or Unigram implementation matching ``tok``, or None (keep
    Python)."""
    for cls in (NativeWordPieceTokenizer, NativeBPETokenizer,
                NativeUnigramTokenizer):
        fast = cls.wrap(tok)
        if fast is not None:
            return fast
    return None
