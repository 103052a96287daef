"""Several processes on torch.distributed in the port
(``embeddings_tpu_torch/parallel/multihost.py``, ``mesh.py``'s
``initialize_distributed``, ``global_devices`` and meshes whose axes
cross processes) against the JAX package's multi-host helpers on the CPU:

(a) ``process_shard`` equal to JAX's, the single-process no-ops, the
    settings' resolution order, the device a process defaults to;
(b) the mesh's backend rule and its refusals, with a faked world;
(c) one process: ``distributed_encode_batch`` equal to ``encode_batch``
    and to JAX's ``distributed_encode_batch`` on the same weights;
(d) two real processes over gloo (``tests/helpers/torch_multihost_worker
    .py``, spawned once for the module): the distributed encode bit for
    bit equal to the local one on both; the global (data=2, model=2)
    mesh at JAX's mesh-worker shapes against JAX's ``encode_tokens`` on
    the same ids; a model axis and a seq axis across the processes, each
    equal to the one-process mesh of its shape and close to JAX.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from embeddings_tpu.config import BertConfig as JConfig
from embeddings_tpu.config import EngineConfig as JEngineConfig
from embeddings_tpu.models import bert as jbert
from embeddings_tpu.models import params as JP
from embeddings_tpu.parallel import multihost as jmh
from embeddings_tpu.runtime.engine import Engine as JEngine

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.parallel import (auto_initialize,
                                           distributed_encode_batch,
                                           initialize_distributed,
                                           process_shard)
from embeddings_tpu_torch.parallel import mesh as tmesh
from embeddings_tpu_torch.parallel import multihost as tmh
from embeddings_tpu_torch.parallel.mesh import Mesh, ProcessDevice
from embeddings_tpu_torch.runtime.engine import Engine, resolve_device
from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, WordPieceVocab

WORKER = Path(__file__).parent / "helpers" / "torch_multihost_worker.py"
# the JAX package's mesh worker's model and batch
MESH_CFG = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=32)
ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
CPU = torch.device("cpu")


def _mesh_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, MESH_CFG["vocab_size"], (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[0, 10:] = 0
    return ids, mask


@pytest.fixture
def no_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# (a) shard math, no-ops, resolution order, a process's device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 16, 100])
def test_process_shard_matches_jax(n):
    for count in (1, 2, 3, 8):
        for index in range(count):
            ours = process_shard(n, count=count, index=index)
            assert ours == jmh.process_shard(n, count=count, index=index)
    # defaults: one process before torch.distributed is up
    assert process_shard(n) == slice(0, n)


def test_single_process_noops(no_env):
    assert auto_initialize(num_processes=1) is False
    assert auto_initialize() is False  # no settings anywhere
    assert initialize_distributed() is None
    assert initialize_distributed("127.0.0.1:1", 1, 0) is None
    assert not torch.distributed.is_initialized()


def test_auto_initialize_resolution_order(no_env, monkeypatch):
    """Each setting: explicit > the JAX package's variables > torchrun's;
    a job of one process is not initialized."""
    calls = []
    monkeypatch.setattr(tmh, "initialize_distributed",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(tmh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(tmh.dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert auto_initialize() is True
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.2:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert auto_initialize() is True
    assert auto_initialize("h:1", 3, 2) is True
    assert auto_initialize(num_processes=1) is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert auto_initialize() is False
    assert calls == [("10.0.0.1:29500", 4, 3), ("10.0.0.2:1234", 2, 1),
                     ("h:1", 3, 2)]
    # a second call once up is a no-op that reports the job
    monkeypatch.setattr(tmh.dist, "is_initialized", lambda: True)
    assert auto_initialize("h:1", 3, 2) is True and len(calls) == 3


def test_a_process_device(no_env, monkeypatch):
    """Under torchrun a process's default card is cuda:LOCAL_RANK, and a
    rank past the card count raises instead of wrapping around; a device
    the caller names wins; no card raises unless the CPU is asked for."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device(None) == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == CPU
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="sees 2 CUDA device"):
        resolve_device(None)


# ---------------------------------------------------------------------------
# (b) the backend rule and the layout rules, with a faked world
# ---------------------------------------------------------------------------

@pytest.fixture
def two_process_world(monkeypatch):
    """This process as rank 0 of 2; groups recorded, not made; the card
    entries taken as given."""
    groups = []
    monkeypatch.setattr(tmesh, "world", lambda: (2, 0))
    monkeypatch.setattr(tmesh.dist, "new_group",
                        lambda ranks, backend: groups.append(
                            (list(ranks), backend)) or len(groups))
    monkeypatch.setattr(tmesh, "resolve_mesh_device", torch.device)
    return groups


def _entries(*spec):
    return [ProcessDevice(r, torch.device(d), k) for r, d, k in spec]


@pytest.mark.parametrize("devices,backend", [
    (_entries((0, "cpu", "h/cpu"), (1, "cpu", "h/cpu")), "gloo"),
    # two processes on one card: NCCL refuses it, gloo through the host
    (_entries((0, "cuda:0", "h/u0"), (1, "cuda:0", "h/u0")), "gloo+host"),
    (_entries((0, "cuda:0", "h/u0"), (1, "cuda:1", "h/u1")), "nccl"),
    (_entries((0, "cuda:0", "a/u0"), (1, "cuda:0", "b/u0")), "nccl")])
def test_mesh_backend_rule(two_process_world, devices, backend):
    groups = two_process_world
    mesh = Mesh([devices], ("data", "model"))
    assert mesh.backend == backend and mesh.spans_processes
    assert mesh.ranks.tolist() == [[0, 1]]
    assert mesh.row(0)[:2] == ([devices[0].device], 0)
    # the host exchange over gloo, then the row's group by the rule
    want = "cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo"
    assert groups == [([0, 1], "gloo"), ([0, 1], want)]
    assert mesh.row(0)[2].staged == (backend != "nccl")
    # data across the processes: no row crosses, so no row group
    groups.clear()
    across = Mesh([[d] for d in devices], ("data", "model"))
    assert groups == [([0, 1], "gloo")] and across.row(0)[2] is None
    assert across.local_rows() == [0] and across.home_index == (0, 0)


def test_mesh_layout_rules(two_process_world):
    e = _entries((0, "cpu", "h/cpu"), (1, "cpu", "h/cpu"),
                 (0, "cpu", "h/cpu"), (1, "cpu", "h/cpu"))
    with pytest.raises(ValueError, match="consecutive entries"):
        Mesh([e[:2] + e[2:]], ("data", "model"))   # ranks 0, 1, 0, 1
    with pytest.raises(ValueError, match="consecutive entries"):
        Mesh([[e[0], e[2], e[0], e[1]]], ("data", "model"))  # 0, 0, 0, 1
    with pytest.raises(ValueError, match="owns no entry"):
        Mesh([[e[1], e[3]]], ("data", "model"))
    Mesh([[e[0], e[2], e[1], e[3]]], ("data", "model"))  # 0, 0, 1, 1
    Mesh([[e[0], e[2]], [e[1], e[3]]], ("data", "model"))


def test_mesh_spans_every_process(monkeypatch):
    monkeypatch.setattr(tmesh, "world", lambda: (3, 0))
    monkeypatch.setattr(tmesh.dist, "new_group", lambda *a, **k: None)
    with pytest.raises(ValueError, match="spans all 3"):
        Mesh([_entries((0, "cpu", "h/cpu"), (1, "cpu", "h/cpu"))],
             ("data", "model"))


def test_one_process_mesh_unchanged():
    mesh = tmesh.make_mesh(2, 2, [CPU] * 4)
    assert not mesh.spans_processes and mesh.backend == "local"
    assert mesh.ranks.tolist() == [[0, 0], [0, 0]]
    assert mesh.home == CPU and mesh.local_rows() == [0, 1]
    assert mesh.row(1) == ([CPU, CPU], 0, None)
    # before initialize_distributed: this process's devices
    assert tmesh.global_devices([CPU]) == [
        ProcessDevice(0, CPU, f"{socket.gethostname()}/cpu")]


# ---------------------------------------------------------------------------
# (c) one process
# ---------------------------------------------------------------------------

def test_distributed_encode_one_process_matches(small_vocab, no_env):
    """One process: encode_batch's result, and JAX's
    distributed_encode_batch's on the same weights (f32: 2e-5 max abs)."""
    kw = dict(vocab_size=len(small_vocab), hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=64)
    ec = dict(seq_buckets=(16, 32), max_seq_len=32, batch_size=8,
              batch_buckets=(1, 2, 4, 8), compute_dtype="float32")
    jcfg = JConfig(**kw)
    jp = JP.init_params(jcfg, rng=0)
    vocab = WordPieceVocab.from_tokens(small_vocab)
    eng = Engine(P.from_jax_params(jp), BertConfig(**kw),
                 WordPieceTokenizer(vocab), EngineConfig(**ec),
                 device="cpu")
    texts = ["hello world", "the quick brown fox", "a lazy dog"] * 3
    got = distributed_encode_batch(eng, texts)
    np.testing.assert_array_equal(got, eng.encode_batch(texts))
    from embeddings_tpu.tokenizer import WordPieceTokenizer as JTok
    from embeddings_tpu.tokenizer import WordPieceVocab as JVocab
    jeng = JEngine(jp, jcfg, JTok(JVocab.from_tokens(small_vocab)),
                   JEngineConfig(**ec))
    ref = jmh.distributed_encode_batch(jeng, texts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# (d) two real processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Spawn the worker twice (ranks 0 and 1 on a localhost coordinator,
    each killed after 120 s), with the JAX package's mesh-worker tree;
    returns each rank's outputs and log, and JAX's single-device forwards
    on the same ids (bf16 and f32)."""
    work = tmp_path_factory.mktemp("torch_multihost")
    jcfg = JConfig(**MESH_CFG)
    jp = JP.init_params(jcfg, rng=0)
    torch.save(P.from_jax_params(jp), work / "tree.pt")
    (work / "config.json").write_text(json.dumps(MESH_CFG))
    ids, mask = _mesh_batch()
    np.savez(work / "batch.npz", ids=ids, mask=mask)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-u", str(WORKER), str(i), "2", str(port),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "TORCH_MULTIHOST_OK" in log, log[-3000:]
    fused = JP.fuse_qkv(jp)
    refs = {name: np.asarray(jax.jit(lambda p, i, m, dt=dt:
                                     jbert.encode_tokens(
                                         p, jcfg, i, m, compute_dtype=dt))(
        fused, jnp.asarray(ids), jnp.asarray(mask)))
        for name, dt in (("bf16", "bfloat16"), ("f32", None))}
    return [dict(np.load(work / f"out_{r}.npz")) for r in (0, 1)], logs, refs


def test_two_process_distributed_encode(two_processes):
    """Both processes return the whole matrix, bit for bit the local
    encode (JAX's worker demands 0 too)."""
    outs, _, _ = two_processes
    for out in outs:
        assert out["encode"].shape == (7, 64)
        np.testing.assert_array_equal(out["encode"], out["encode_local"])


def test_two_process_global_mesh_forward(two_processes):
    """A global (data=2, model=2) mesh, data across the processes and TP
    within each (CPU tensors: gloo): both processes return the whole
    [4, 64], equal to each other and to the mesh's Engine.forward, and
    within 1e-2 max abs (bf16; JAX's own mesh worker allows 5e-2) of
    JAX's single-device forward, at cosine >= 0.9999."""
    outs, logs, refs = two_processes
    assert all('"global_mesh": "gloo"' in log for log in logs), logs
    np.testing.assert_array_equal(outs[0]["global_mesh"],
                                  outs[1]["global_mesh"])
    for out in outs:
        got = out["global_mesh"]
        assert got.shape == (4, 64)
        np.testing.assert_array_equal(out["global_mesh_engine"], got)
        np.testing.assert_allclose(got, refs["bf16"], rtol=0, atol=1e-2)
        assert (got * refs["bf16"]).sum(-1).min() >= 0.9999


@pytest.mark.parametrize("axis", ["model", "seq"])
def test_two_process_axis_across_processes(two_processes, axis):
    """A (data=1, model=2) or (data=1, seq=2) mesh with one shard a
    process (f32, gloo): the one-process mesh of that shape within 1e-6
    max abs (two parts add in either order to the same bits), and JAX's
    single-device f32 forward within 3e-5."""
    outs, logs, refs = two_processes
    assert all(f'"{axis}": "gloo"' in log for log in logs), logs
    for out in outs:
        got = out[axis]
        assert got.shape == (4, 64)
        np.testing.assert_allclose(got, out[f"{axis}_local"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got, refs["f32"], rtol=0, atol=3e-5)
