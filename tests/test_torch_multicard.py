"""Four processes and four cards in the port: the card rule of
``parallel/mesh.py`` (``card_rule``, ``initialize_distributed``,
``process_card``), the backend rule over four cards, the CLI's mesh
device list (``cli.mesh_layout``), and four real processes over gloo on
the CPU (``tests/helpers/torch_multihost_worker.py`` with NPROC 4,
spawned once for the module):

(a) the card rule with a faked world and faked host names: four processes
    on one host with four cards take cards 0-3; two hosts of two take 0,
    1, 0, 1; four processes on two cards share one, and a mesh over them
    stages through the host;
(b) four distinct cards: NCCL;
(c) ``--device cuda`` spreads a mesh over the visible cards as
    ``make_mesh(dp, tp)`` does; ``--device cpu`` / ``cuda:N`` repeat it;
(d) the distributed encode over four processes bit for bit each
    process's local encode of every share; (data=1, model=4) and (data=1,
    seq=4) meshes across them within 1e-6 of the one-process mesh of that
    shape and 3e-5 of JAX's mesh forward on four of its 8 virtual CPU
    devices; the (data=2, model=2) mesh across them against JAX's
    single-device bf16 forward.
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

from embeddings_tpu import parallel as jpar
from embeddings_tpu.config import BertConfig as JConfig
from embeddings_tpu.models import bert as jbert
from embeddings_tpu.models import params as JP
from embeddings_tpu.parallel import context as jctx

from embeddings_tpu_torch.cli import mesh_layout
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.parallel import initialize_distributed
from embeddings_tpu_torch.parallel import mesh as tmesh
from embeddings_tpu_torch.parallel.mesh import (Mesh, ProcessDevice,
                                                card_rule, make_mesh,
                                                mesh_backend)
from embeddings_tpu_torch.runtime.engine import resolve_device

WORKER = Path(__file__).parent / "helpers" / "torch_multihost_worker.py"
NPROC = 4
# the JAX package's mesh worker's model and batch (as the two-process test)
MESH_CFG = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=32)
ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


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
# (a) the card rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,cards,want", [
    (["h"] * 4, 4, [0, 1, 2, 3]),
    (["a", "a", "b", "b"], 2, [0, 1, 0, 1]),
    (["a", "b", "a", "b"], 2, [0, 0, 1, 1]),
    (["h"] * 4, 8, [0, 1, 2, 3]),
    (["h"] * 4, 2, [None] * 4)])
def test_card_rule(hosts, cards, want):
    """A process's card is its index among its host's processes, where
    the host has a card for each (JAX's one chip per local process);
    else none: they share."""
    assert [card_rule(hosts, r, cards) for r in range(len(hosts))] == want


@pytest.mark.parametrize("hosts,cards,want", [
    (["h"] * 4, 4, [0, 1, 2, 3]),
    (["a", "a", "b", "b"], 2, [0, 1, 0, 1]),
    (["h"] * 4, 2, [None] * 4)])
def test_initialize_distributed_takes_the_card(no_env, monkeypatch, hosts,
                                               cards, want):
    """``initialize_distributed`` outside torchrun, in a faked world of
    four processes: one gather of host names, then set_device to the
    rule's card, which ``resolve_device(None)`` and ``global_devices``
    name; with more processes than cards none is set and the processes
    share the default card, so their mesh stages through the host."""
    monkeypatch.setattr(tmesh, "_process_card", None)
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got, set_to, entries = [], [], []
    for rank in range(len(hosts)):
        monkeypatch.setattr(tmesh.dist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(tmesh.dist, "all_gather_object",
                            lambda out, obj: out.__setitem__(
                                slice(None), hosts))
        monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
        initialize_distributed("127.0.0.1:1", len(hosts), rank)
        got.append(tmesh.process_card())
        dev = resolve_device(None)
        assert dev == (torch.device("cuda") if got[-1] is None
                       else torch.device("cuda", got[-1]))
        # the card's identity as device_key gives it: host and card
        card = 0 if got[-1] is None else got[-1]
        entries.append(ProcessDevice(rank, torch.device("cuda", card),
                                     f"{hosts[rank]}/u{card}"))
    assert got == want
    assert set_to == [torch.device("cuda", c) for c in want if c is not None]
    assert mesh_backend(entries) == ("gloo+host" if None in want
                                     else "nccl")


def test_torchrun_local_rank_wins(no_env, monkeypatch):
    """Under torchrun the card is cuda:LOCAL_RANK, with no gather."""
    monkeypatch.setattr(tmesh, "_process_card", None)
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda *a, **k: None)
    monkeypatch.setattr(tmesh.dist, "all_gather_object",
                        lambda *a: pytest.fail("gathered host names"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    set_to = []
    monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
    initialize_distributed("127.0.0.1:1", 4, 2)
    assert set_to == [torch.device("cuda", 2)]
    assert tmesh.process_card() is None


# ---------------------------------------------------------------------------
# (b) the backend rule over four cards
# ---------------------------------------------------------------------------

def test_four_distinct_cards_use_nccl(monkeypatch):
    """Four processes, each its own card: NCCL, and every row's group is
    made with the NCCL backend for CUDA tensors (recorded, not made)."""
    groups = []
    monkeypatch.setattr(tmesh, "world", lambda: (4, 0))
    monkeypatch.setattr(tmesh.dist, "new_group",
                        lambda ranks, backend: groups.append(
                            (list(ranks), backend)) or len(groups))
    monkeypatch.setattr(tmesh, "resolve_mesh_device", torch.device)
    entries = [ProcessDevice(r, torch.device("cuda", r), f"h/u{r}")
               for r in range(4)]
    assert mesh_backend(entries) == "nccl"
    mesh = Mesh([entries[:2], entries[2:]], ("data", "model"))
    assert mesh.backend == "nccl"
    assert groups == [([0, 1, 2, 3], "gloo"), ([0, 1], "cpu:gloo,cuda:nccl"),
                      ([2, 3], "cpu:gloo,cuda:nccl")]
    shared = [e._replace(key="h/u0") for e in entries]
    assert mesh_backend(shared) == "gloo+host"


# ---------------------------------------------------------------------------
# (c) the CLI's mesh device list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,width", [(None, 2), (2, 2), (None, 4),
                                      (4, 1), (None, 1)])
def test_cli_default_device_spreads_the_mesh(dp, width):
    """``--device cuda`` (unindexed): the visible cards, as
    ``make_mesh(dp, tp)`` lays them out (dp defaults to cards // tp)."""
    cards = [torch.device("cuda", i) for i in range(4)]
    got_dp, devices = mesh_layout("cuda", dp, width, cards)
    assert got_dp == 4 // width and devices == cards
    mesh = make_mesh(got_dp, width, [torch.device("cpu")] * 4)
    assert mesh.devices.shape == (got_dp, width)


def test_cli_default_device_refuses_a_wrong_count():
    cards = [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(ValueError, match=r"dp\(3\) x 2 != device count 4"):
        mesh_layout("cuda", 3, 2, cards)
    with pytest.raises(ValueError, match="device count 4"):
        mesh_layout("cuda", None, 3, cards)


@pytest.mark.parametrize("device", ["cpu", "cuda:1", "cuda:0"])
@pytest.mark.parametrize("dp,width", [(None, 2), (2, 2), (3, 1)])
def test_cli_explicit_device_repeats(device, dp, width):
    """An explicit device names itself dp * width times (dp default 1),
    whatever cards are visible: the port's deviation from JAX."""
    got_dp, devices = mesh_layout(device, dp, width,
                                  [torch.device("cuda", 0)] * 4)
    assert got_dp == (dp or 1)
    assert devices == [torch.device(device)] * (got_dp * width)


# ---------------------------------------------------------------------------
# (d) four real processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_processes(tmp_path_factory):
    """Spawn the worker four times (ranks 0-3 on a localhost coordinator,
    each killed after 120 s) with the JAX package's mesh-worker tree;
    returns each rank's outputs and log, JAX's single-device bf16 forward,
    and JAX's f32 (data=1, model=4) and (data=1, seq=4) mesh forwards on
    four of its virtual devices, on the same ids."""
    work = tmp_path_factory.mktemp("torch_multicard")
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
        [sys.executable, "-u", str(WORKER), str(i), str(NPROC), str(port),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(NPROC)]
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
    jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
    devices = jax.devices()[:NPROC]
    tp_mesh = jpar.make_mesh(dp=1, tp=NPROC, devices=devices)
    refs = {
        "bf16": np.asarray(jax.jit(lambda p, i, m: jbert.encode_tokens(
            p, jcfg, i, m, compute_dtype="bfloat16"))(
            JP.fuse_qkv(jp), jids, jmask)),
        "model": np.asarray(jpar.make_sharded_forward(jcfg, tp_mesh)(
            jpar.shard_params(jp, jcfg, tp_mesh), jids, jmask)),
        "seq": np.asarray(jctx.make_cp_forward(jcfg, jctx.make_mesh_cp(
            dp=1, sp=NPROC, devices=devices))(jp, jids, jmask))}
    return [dict(np.load(work / f"out_{r}.npz")) for r in range(NPROC)], \
        logs, refs


def test_four_process_distributed_encode(four_processes):
    """Every process returns the whole matrix, the same bits, and bit for
    bit its own encode of each process's share (each batched as that
    process batched it). The local encode of all seven texts batches them
    otherwise (4 + 3 rows, not 2 + 2 + 2 + 1), and the CPU's f32 products
    round by their row count: within 1e-6 of it (measured 3e-8)."""
    outs, _, _ = four_processes
    for out in outs:
        assert out["encode"].shape == (7, 64)
        np.testing.assert_array_equal(out["encode"], outs[0]["encode"])
        np.testing.assert_array_equal(out["encode"], out["encode_shares"])
        np.testing.assert_allclose(out["encode"], out["encode_local"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("axis", ["model", "seq"])
def test_four_process_axis_across_processes(four_processes, axis):
    """A (data=1, model=4) or (data=1, seq=4) mesh, one shard a process
    (f32, gloo): every process the same bits; the one-process mesh of that
    shape within 1e-6 max abs (four parts reassociate in gloo's reduction:
    the measured gap is 3e-8, one f32 ulp of the unit-norm rows), and
    JAX's mesh forward on four virtual devices within 3e-5."""
    outs, logs, refs = four_processes
    assert all(f'"{axis}": "gloo"' in log for log in logs), logs
    for out in outs:
        got = out[axis]
        assert got.shape == (4, 64)
        np.testing.assert_array_equal(got, outs[0][axis])
        np.testing.assert_allclose(got, out[f"{axis}_local"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got, refs[axis], rtol=0, atol=3e-5)


def test_four_process_global_mesh(four_processes):
    """A (data=2, model=2) mesh with both axes across the four processes
    (bf16): every process the whole [4, 64], equal to each other and to
    the mesh's Engine.forward, within 1e-2 (bf16) of JAX's single-device
    forward at cosine >= 0.9999."""
    outs, logs, refs = four_processes
    assert all('"global_mesh": "gloo"' in log for log in logs), logs
    for out in outs:
        got = out["global_mesh"]
        np.testing.assert_array_equal(got, outs[0]["global_mesh"])
        np.testing.assert_array_equal(out["global_mesh_engine"], got)
        np.testing.assert_allclose(got, refs["bf16"], rtol=0, atol=1e-2)
        assert (got * refs["bf16"]).sum(-1).min() >= 0.9999
