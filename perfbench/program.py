"""The system under test, as the benchmark drives it: an
``embeddings_tpu_torch`` Engine built through the port's own loader
steps (the HF config and state dict mapped, q4_0 quantized and packed,
the Engine on the device), and the recorder the traced runs wrap around
the Engine's forwards. The only module of the benchmark that imports the
port.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import numpy as np
from torch.profiler import record_function

from embeddings_tpu_torch import BertConfig, EngineConfig
from embeddings_tpu_torch.models import params as P
from embeddings_tpu_torch.ops import _cuda
from embeddings_tpu_torch.ops import attention as A
from embeddings_tpu_torch.ops import qmatmul as Q
from embeddings_tpu_torch.ops.moe import moe_ffn_ragged
from embeddings_tpu_torch.runtime.engine import Engine

# the attention entries that launch ``attn_sm90_kernel``
_ATTENTION = (A.fused_attention, A.fused_attention_segmented,
              A.fused_attention_segmented_blockskip, A.fused_attention_stream,
              A.fused_attention_bias, A.fused_attention_window)


def build_kernels() -> dict:
    """Compile the port's CUDA libraries that are not built yet (all
    together, into the checkout's build directory); seconds a source."""
    return _cuda.build("qmatmul", "attention_sm90")


@dataclasses.dataclass
class Ids:
    """The special ids an Engine reads from its tokenizer. The traffic is
    token ids already, so the Engine gets no text tokenizer."""
    cls_id: int
    sep_id: int
    pad_id: int
    unk_id: int


def build_engine(model: dict, sd: dict[str, np.ndarray], device,
                 int8_compute: bool = False) -> Engine:
    """An Engine from a configuration file's ``model`` block and an HF
    state dict (numpy), as ``load_model`` builds one from a checkpoint
    directory: the config mapped from the HF keys, the tree mapped,
    quantized and packed, the special ids set."""
    tok = model["tokens"]
    ids = Ids(tok["cls"], tok["sep"], tok["pad"], tok["unk"])
    cfg = BertConfig.from_hf_dict(model["hf_config"])
    params = P.from_hf_state_dict(sd, cfg)
    params = P.pack_q4_params(P.quantize_params(params, model["dtype"]))
    cfg = dataclasses.replace(
        cfg, pooling=model["pooling"],
        normalize_embeddings=model["normalize"], cls_token_id=ids.cls_id,
        sep_token_id=ids.sep_id, unk_token_id=ids.unk_id,
        pad_token_id=ids.pad_id)
    ec = EngineConfig(**{**model["engine"], "int8_compute": int8_compute})
    return Engine(params, cfg, ids, ec, device=device)


def _attention_launches() -> int:
    return sum(f.launches for f in _ATTENTION)


class ForwardRecorder:
    """Wraps an Engine's two forwards (bucketed and packed) while active:
    each call is recorded with its device shape, its sequences' real
    lengths and the launches it enqueued (K1 by (K, N, epilogue) from
    ``qmatmul.shapes``, attention from the entries' ``launches``), under
    the span ``engine.forward``."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.forwards: list[dict] = []
        self._moe0 = (0, 0)

    def _wrap(self, fn, packed: bool):
        def call(ids, *rest):
            k1 = collections.Counter(Q.qmatmul.shapes)
            attn = _attention_launches()
            with record_function("engine.forward"):
                out = fn(ids, *rest)
            if packed:
                seg = rest[0]
                lengths = [int(n) for row in seg
                           for n in np.bincount(row[row >= 0])]
            else:
                lengths = [int(n) for n in rest[0].sum(1) if n]
            self.forwards.append({
                "packed": packed, "B": int(ids.shape[0]),
                "L": int(ids.shape[1]), "lengths": lengths,
                "k1": {key: n - k1.get(key, 0)
                       for key, n in Q.qmatmul.shapes.items()
                       if n - k1.get(key, 0)},
                "attention": _attention_launches() - attn})
            return out
        return call

    @contextlib.contextmanager
    def active(self):
        eng = self.engine
        self._moe0 = (moe_ffn_ragged.host_reads, moe_ffn_ragged.expert_gemms)
        eng._forward = self._wrap(Engine._forward.__get__(eng), False)
        eng._forward_packed = self._wrap(Engine._forward_packed.__get__(eng),
                                         True)
        try:
            yield self
        finally:
            del eng._forward, eng._forward_packed
        if not self.forwards:
            raise RuntimeError("no Engine forward ran through the recorder: "
                               "the entry no longer calls Engine._forward "
                               "or _forward_packed")

    def counters(self) -> dict:
        """The MoE route's host reads and expert products since
        ``active`` began."""
        return {"moe_host_reads": moe_ffn_ragged.host_reads - self._moe0[0],
                "moe_expert_gemms":
                    moe_ffn_ragged.expert_gemms - self._moe0[1]}
