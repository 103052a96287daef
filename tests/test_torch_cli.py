"""The port's CLI (``embeddings_tpu_torch.cli``) on the CPU: the JAX CLI's
cases (``tests/test_cli.py``) with ``--device cpu``; ``convert`` writing
the JAX CLI's files for the same source (``.bin`` / ``.gguf`` the same
bytes, ``.npz`` the same arrays: a zip holds its write time); ``rerank``
against the JAX CLI on the same checkpoint (the same order, scores within
1e-4); ``bench``'s JSON line; the refusals (no CUDA device without
``--device cpu``, --sp with --tp); and ``serve`` answering
over TCP v2 and HTTP."""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from embeddings_tpu_torch.cli import main
from embeddings_tpu_torch.config import BertConfig
from embeddings_tpu_torch.models import params as P

ROOT = Path(__file__).resolve().parent.parent
HF_DIR = ROOT / "benchmarks" / "fixtures" / "tiny_trained" / "model"


@pytest.fixture(scope="module")
def model_npz(tmp_path_factory, small_vocab):
    """A native checkpoint + vocab.txt, as `convert` would produce."""
    d = tmp_path_factory.mktemp("model")
    cfg = BertConfig(vocab_size=len(small_vocab), hidden_size=64,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=64)
    path = d / "model.npz"
    P.save_native(path, P.init_params(cfg, 0), cfg)
    (d / "vocab.txt").write_text("\n".join(small_vocab) + "\n",
                                 encoding="utf-8")
    return str(path)


# ---------------------------------------------------------------------------
# the JAX CLI's cases, on the CPU
# ---------------------------------------------------------------------------

def test_encode(model_npz, capsys):
    rc = main(["encode", "-m", model_npz, "-p", "hello world",
               "--format", "json", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    emb = np.asarray(out["embeddings"])
    assert emb.shape == (1, 64)
    np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-5)


def test_encode_multiple_prompts_quantized(model_npz, capsys):
    rc = main(["encode", "-m", model_npz, "-p", "hello", "-p", "world",
               "--dtype", "q4_0", "--device", "cpu"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]
    assert len(lines) == 2
    assert len(lines[0].split()) == 64


def test_tokenize(model_npz, capsys):
    rc = main(["tokenize", "-m", model_npz, "-p", "hello world",
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[CLS]" in out and "[SEP]" in out


def test_quantize_roundtrip(model_npz, tmp_path, capsys):
    out = str(tmp_path / "model-q4.npz")
    rc = main(["quantize", model_npz, out, "--dtype", "q4_0"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "nibble histogram" in text
    # 4-bit codes, two a byte: well under the f32 weights' size
    assert os.path.getsize(out) < os.path.getsize(model_npz) * 0.6
    shutil.copy(Path(model_npz).parent / "vocab.txt", tmp_path / "vocab.txt")
    rc = main(["encode", "-m", out, "-p", "hello world", "--format", "json",
               "--device", "cpu"])
    assert rc == 0


def test_bad_args(model_npz):
    with pytest.raises(SystemExit):
        main(["encode"])  # missing -m
    with pytest.raises(SystemExit):
        main(["quantize", model_npz, "x.npz"])  # missing --dtype
    with pytest.raises(SystemExit):
        main(["nonsense"])


# ---------------------------------------------------------------------------
# beyond the JAX CLI's cases
# ---------------------------------------------------------------------------

def test_quantize_histogram_equals_jax(model_npz, tmp_path, capsys):
    """The port's walk of its parameter tree counts JAX's nibbles."""
    from embeddings_tpu.cli import main as jax_main
    main(["quantize", model_npz, str(tmp_path / "p.npz"), "--dtype", "q4_0"])
    ours = capsys.readouterr().out.splitlines()[0]
    jax_main(["quantize", model_npz, str(tmp_path / "j.npz"),
              "--dtype", "q4_0"])
    assert ours == capsys.readouterr().out.splitlines()[0]


@pytest.mark.parametrize("name,dtype", [
    ("m.npz", "f32"), ("m.npz", "q4_0"), ("m.bin", "f32"), ("m.bin", "q4_0"),
    ("m.gguf", "q4_0"), ("m.gguf", "f16")])
def test_convert_writes_the_jax_cli_files(tmp_path, capsys, name, dtype):
    from embeddings_tpu.cli import main as jax_main
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    ours, theirs = tmp_path / "p" / name, tmp_path / "j" / name
    assert main(["convert", str(HF_DIR), str(ours), "--dtype", dtype]) == 0
    assert jax_main(["convert", str(HF_DIR), str(theirs),
                     "--dtype", dtype]) == 0
    if name.endswith(".npz"):
        a, b = np.load(ours, allow_pickle=True), \
            np.load(theirs, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (tmp_path / "p" / "vocab.txt").read_bytes() == \
            (tmp_path / "j" / "vocab.txt").read_bytes()
    else:
        assert ours.read_bytes() == theirs.read_bytes()
    rc = main(["encode", "-m", str(ours), "-p", "hello world",
               "--format", "json", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    emb = np.asarray(json.loads(out[out.index("{"):])["embeddings"])
    assert emb.shape == (1, 128) and np.isfinite(emb).all()


def test_rerank_matches_jax_cli(model_npz, tmp_path, capsys):
    from embeddings_tpu.cli import main as jax_main
    params, cfg = P.load_native(model_npz)
    rng = np.random.default_rng(0)
    params["cls_head"] = {
        "pooler": {"w": torch.from_numpy(
            rng.standard_normal((64, 64)).astype(np.float32) * 0.05),
            "b": torch.zeros(64)},
        "out": {"w": torch.from_numpy(
            rng.standard_normal((64, 1)).astype(np.float32) * 0.05),
            "b": torch.zeros(1)}}
    path = tmp_path / "reranker.npz"
    P.save_native(path, params, cfg)
    shutil.copy(Path(model_npz).parent / "vocab.txt", tmp_path / "vocab.txt")
    docs = ["hello world", "water fire", "hello", "the quick brown fox"]
    args = ["rerank", "-m", str(path), "-q", "hello world", *docs,
            "--format", "json"]
    assert main(args + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out)["results"]
    assert jax_main(args) == 0
    theirs = json.loads(capsys.readouterr().out)["results"]
    assert [r["index"] for r in ours] == [r["index"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert a["document"] == b["document"] == docs[a["index"]]
        assert abs(a["relevance_score"] - b["relevance_score"]) < 1e-4


def test_bench_prints_its_json_line(model_npz, tmp_path, capsys):
    rc = main(["bench", "-m", model_npz, "--device", "cpu", "--batch", "4",
               "--seq", "16", "--profile", str(tmp_path / "trace")])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "sentences/sec/chip f32 seq16 batch4"
    assert line["unit"] == "sentences/s" and line["value"] > 0
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))


def test_refusals(model_npz, capsys):
    """Without a CUDA device the CLI fails with resolve_device's error
    (no CPU fallback); a ("data", "model") mesh runs (``--tp 2``: the
    single-device embeddings); --sp and --tp together are refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["encode", "-m", model_npz, "-p", "hello"])
    outs = []
    for extra in ([], ["--tp", "2"]):
        assert main(["encode", "-m", model_npz, "-p", "x", "--format",
                     "json", "--device", "cpu", *extra]) == 0
        outs.append(np.asarray(json.loads(capsys.readouterr().out)[
            "embeddings"]))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["encode", "-m", model_npz, "-p", "x", "--device", "cpu",
              "--tp", "2", "--sp", "2"])


def test_encode_packed_and_context_parallel(model_npz, capsys):
    """--packed and --sp 2 (a 1 x 2 mesh naming the CPU twice) give the
    bucketed single-device embeddings."""
    texts = ["hello world", "the quick brown fox", "a b c d e f"]
    outs = []
    for extra in ([], ["--packed"], ["--sp", "2"]):
        argv = ["encode", "-m", model_npz, "--format", "json",
                "--device", "cpu", *extra]
        for t in texts:
            argv += ["-p", t]
        assert main(argv) == 0
        outs.append(np.asarray(json.loads(capsys.readouterr().out)[
            "embeddings"]))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)
    np.testing.assert_allclose(outs[2], outs[0], atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_answers_tcp_v2_and_http(model_npz):
    from embeddings_tpu_torch.runtime.client import HttpClient, TcpClient
    from embeddings_tpu_torch.runtime.engine import load_model
    tcp, http = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "embeddings_tpu_torch.cli", "serve", "-m",
         model_npz, "--device", "cpu", "--host", "127.0.0.1", "--port",
         str(tcp), "--http-port", str(http), "--max-seq", "32",
         "--batch-size", "4"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        client = HttpClient(f"http://127.0.0.1:{http}", timeout=5)
        deadline = time.time() + 60
        while True:
            try:
                assert client.healthz()["n_embd"] == 64
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, \
                    proc.stderr.read().decode()
                time.sleep(0.2)
        eng = load_model(model_npz, device="cpu")
        with TcpClient("127.0.0.1", tcp, framing="v2") as c:
            np.testing.assert_allclose(c.embed("hello world"),
                                       eng.encode("hello world"), atol=1e-5)
        np.testing.assert_allclose(client.embed("hello"),
                                   eng.encode("hello"), atol=1e-5)
    finally:
        proc.terminate()
        proc.wait(30)
