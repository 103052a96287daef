"""Worker for the port's two- and four-process tests (spawned by
tests/test_torch_multihost.py with NPROC 2, tests/test_torch_multicard.py
with NPROC 4): brings up torch.distributed over gloo on a localhost
coordinator and runs, on the CPU,

(1) distributed_encode_batch at the JAX package's worker shapes
    (tests/helpers/multihost_worker.py), beside this process's local
    encode_batch of all the texts and of each process's share;
(2) a global (data=2, model=2) mesh at the JAX package's mesh-worker
    shapes (tests/helpers/multihost_mesh_worker.py), in bf16, and the
    same mesh through Engine.forward: with two processes the data axis
    across them and the model axis within each, with four both axes
    across them (one shard a process);
(3) a (data=1, model=NPROC) mesh and (4) a (data=1, seq=NPROC) mesh, one
    shard a process, in f32, each beside the one-process mesh of the same
    shape.

    python torch_multihost_worker.py RANK NPROC PORT DIR

DIR holds the parent's tree.pt, config.json and batch.npz; the worker
writes out_RANK.npz there. Imports nothing of JAX.
"""
import json
import pathlib
import sys

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
work = pathlib.Path(sys.argv[4])
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch
import torch.distributed as dist

from embeddings_tpu_torch.config import BertConfig, EngineConfig
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.parallel import (auto_initialize,
                                           distributed_encode_batch,
                                           global_devices, make_cp_forward,
                                           make_mesh, make_mesh_cp,
                                           make_sharded_forward,
                                           process_shard)
from embeddings_tpu_torch.runtime.engine import Engine
from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, WordPieceVocab

ok = auto_initialize(coordinator=f"127.0.0.1:{port}", num_processes=nproc,
                     process_id=rank)
if not (ok and dist.get_world_size() == nproc and dist.get_rank() == rank):
    raise SystemExit(f"torch.distributed not up: {ok}")
cpu = torch.device("cpu")
out, backends = {}, {}

# (1) the distributed encode
toks = (["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
        + "hello world the quick brown fox".split()
        + [chr(c) for c in range(ord("a"), ord("z") + 1)])
tok = WordPieceTokenizer(WordPieceVocab.from_tokens(toks))
cfg = BertConfig(vocab_size=len(toks), hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=64)
eng = Engine(P.init_params(cfg, 0), cfg, tok,
             EngineConfig(seq_buckets=(16, 32), max_seq_len=32, batch_size=4,
                          batch_buckets=(1, 2, 4)), device="cpu")
texts = ["hello world", "the quick brown fox", "fox fox fox", "hello",
         "world the fox", "quick brown", "the the the"]
out["encode"] = distributed_encode_batch(eng, texts)
out["encode_local"] = eng.encode_batch(texts)
# this process's encode of each process's share, batched as that process
# batched it
out["encode_shares"] = np.concatenate([eng.encode_batch(texts[
    process_shard(len(texts), count=nproc, index=p)]) for p in range(nproc)])

# (2)-(4) the meshes, on the parent's tree (the JAX package's init)
mcfg = BertConfig(**json.loads((work / "config.json").read_text()))
tree = torch.load(work / "tree.pt", weights_only=True)
batch = np.load(work / "batch.npz")
ids, mask = batch["ids"], batch["mask"]

mesh = make_mesh(2, 2, global_devices([cpu] * (4 // nproc)))
backends["global_mesh"] = mesh.backend
out["global_mesh"] = make_sharded_forward(
    mcfg, mesh, compute_dtype=torch.bfloat16)(tree, ids, mask).numpy()
out["global_mesh_engine"] = Engine(
    tree, mcfg, tok, EngineConfig(compute_dtype="bfloat16"),
    mesh=mesh).forward(ids, mask)

for name, across, local in (
        ("model", make_mesh(1, nproc, global_devices([cpu])),
         make_mesh(1, nproc, [cpu] * nproc)),
        ("seq", make_mesh_cp(1, nproc, global_devices([cpu])),
         make_mesh_cp(1, nproc, [cpu] * nproc))):
    fwd = make_sharded_forward if name == "model" else make_cp_forward
    backends[name] = across.backend
    out[name] = fwd(mcfg, across)(tree, ids, mask).numpy()
    out[f"{name}_local"] = fwd(mcfg, local)(tree, ids, mask).numpy()

np.savez(work / f"out_{rank}.npz", **out)
print(f"proc {rank}/{nproc}: backends {json.dumps(backends)}", flush=True)
print(f"proc {rank}: TORCH_MULTIHOST_OK", flush=True)
dist.destroy_process_group()
