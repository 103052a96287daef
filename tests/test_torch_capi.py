"""The port's C ABI host (``embeddings_tpu_torch/csrc/capi.cpp``, built by
``embeddings_tpu_torch.capi``) on the CPU: the reference's dlopen demo
(``examples/capi_demo.cpp``) against the port's library, with
``tests/test_capi.py``'s checkpoint and assertions; the library loaded in
this process through ctypes, its ``et_encode_batch`` held to the JAX
``Engine.encode_batch`` on the same ``.npz`` (f32 within 1e-5 max abs;
q4_0 packed, the kernels' plain versions against JAX's XLA path, within
2e-3); and without a device, ``et_load_from_file`` returns NULL with an
error that names it. Both binaries are built in a temporary directory;
the tests skip where ``g++`` or a shared libpython is missing, as
``tests/test_capi.py`` does."""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from embeddings_tpu_torch import capi

PROMPTS = ["hello world", "the quick brown fox", "a b c d e f",
           "hello world", "embedding model test sentence"]


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    build_dir = tmp_path_factory.mktemp("_build")
    try:
        return capi.build(build_dir), capi.build_demo(build_dir)
    except RuntimeError as exc:
        pytest.skip(f"C ABI host did not build: {str(exc)[-500:]}")


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory, small_vocab):
    """``tests/test_capi.py``'s checkpoint, written by the JAX package."""
    from embeddings_tpu.config import BertConfig
    from embeddings_tpu.models import params as P
    d = tmp_path_factory.mktemp("capi_model")
    (d / "vocab.txt").write_text("\n".join(small_vocab))
    cfg = BertConfig(vocab_size=len(small_vocab), hidden_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=64)
    P.save_native(str(d / "tiny.npz"), P.init_params(cfg, rng=0), cfg)
    return d / "tiny.npz"


def _env(device: str | None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != capi.DEVICE_VAR}
    if device is not None:
        env[capi.DEVICE_VAR] = device
    return env


def test_capi_end_to_end(binaries, tiny_checkpoint):
    lib, demo = binaries
    r = subprocess.run(
        [str(demo), str(lib), str(tiny_checkpoint), "f32",
         "hello world", "the quick brown fox"],
        capture_output=True, text=True, timeout=300, env=_env("cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "n_embd=64" in out
    # tokenizer path: [CLS] ... [SEP] visible through et_id_to_token
    assert "[CLS]" in out and "[SEP]" in out
    # embeddings are unit-norm
    assert out.count("|x|=1.0000") == 2, out
    # pre-tokenized et_forward matches et_encode
    m = re.search(r"forward parity: max\|[^|]*\| = ([0-9.e+-]+)", out)
    assert m, out
    assert float(m.group(1)) < 1e-4, out
    # capacity edges: cap=0 -> error (no write), cap=4 -> <=4 ids written
    m = re.search(r"tokenize caps: rc\(cap=0\)=(-?\d+) rc\(cap=4\)=(-?\d+) "
                  r"n_tiny=(\d+)", out)
    assert m, out
    assert int(m.group(1)) == -1 and int(m.group(2)) == 0, out
    assert 0 < int(m.group(3)) <= 4, out


def test_capi_error_reporting(binaries):
    lib, demo = binaries
    r = subprocess.run([str(demo), str(lib), "/nonexistent/model.npz"],
                       capture_output=True, text=True, timeout=300,
                       env=_env("cpu"))
    assert r.returncode != 0
    assert "load failed" in r.stderr, r.stderr[-2000:]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="this machine has a CUDA device")
def test_capi_without_a_device_names_it(binaries, tiny_checkpoint):
    """No CUDA device and the variable unset: et_load_from_file returns
    NULL, and the error names the device (no CPU fallback)."""
    lib, demo = binaries
    r = subprocess.run([str(demo), str(lib), str(tiny_checkpoint)],
                       capture_output=True, text=True, timeout=300,
                       env=_env(None))
    assert r.returncode != 0
    assert "load failed" in r.stderr and "no CUDA device" in r.stderr \
        and capi.DEVICE_VAR in r.stderr, r.stderr[-2000:]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.et_load_from_file.restype = ctypes.c_void_p
    lib.et_load_from_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.et_last_error.restype = ctypes.c_char_p
    lib.et_n_embd.argtypes = [ctypes.c_void_p]
    lib.et_free.argtypes = [ctypes.c_void_p]
    lib.et_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    return lib


def et_encode_batch(lib, ctx, texts, n_embd: int, batch: int = 0):
    out = np.zeros((len(texts), n_embd), np.float32)
    arr = (ctypes.c_char_p * len(texts))(*[t.encode() for t in texts])
    rows = (ctypes.POINTER(ctypes.c_float) * len(texts))(
        *[out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
          for i in range(len(texts))])
    assert lib.et_encode_batch(ctx, batch, len(texts), arr, rows) == 0, \
        lib.et_last_error()
    return out


@pytest.fixture(scope="module")
def in_process(binaries):
    """The library loaded into this interpreter (it then uses it, as a
    Python application's ctypes binding would), with the CPU asked for."""
    old = os.environ.get(capi.DEVICE_VAR)
    os.environ[capi.DEVICE_VAR] = "cpu"
    try:
        yield _bind(ctypes.CDLL(str(binaries[0])))
    finally:
        if old is None:
            os.environ.pop(capi.DEVICE_VAR)
        else:
            os.environ[capi.DEVICE_VAR] = old


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-5), ("q4_0", 2e-3)])
def test_in_process_matches_jax_engine(in_process, tiny_checkpoint, dtype,
                                       atol):
    """et_encode_batch in this process against the JAX Engine on the same
    file: f32 within 1e-5; q4_0 (packed: K1's plain version, bf16-rounded
    x) within 2e-3 of JAX's XLA path on these unit vectors."""
    from embeddings_tpu.runtime.engine import load_model as jax_load
    lib = in_process
    ctx = lib.et_load_from_file(str(tiny_checkpoint).encode(),
                                dtype.encode())
    assert ctx, lib.et_last_error()
    try:
        n = lib.et_n_embd(ctx)
        got = et_encode_batch(lib, ctx, PROMPTS, n, batch=2)
        ref = jax_load(tiny_checkpoint, dtype=dtype).encode_batch(PROMPTS)
        assert got.shape == ref.shape == (len(PROMPTS), 64)
        assert np.abs(got - ref).max() <= atol
        np.testing.assert_array_equal(got[0], got[3])
    finally:
        lib.et_free(ctx)
    assert "embeddings_tpu_torch" in sys.modules
