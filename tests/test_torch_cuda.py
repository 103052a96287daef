"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; on the
H100 run them without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: kernel and plain version round the same
bf16 operands and accumulate in f32 in different orders, so outputs
differ by bf16 rounding flips (K1: 2^-7 relative + 1e-3 of the output
RMS; K2, whose probabilities are also rounded to bf16: 2^-6 + 1e-2).
K3 as K1: its int8 operands equal the plain version's bit for bit and
its s32 sums are exact, so only the last f32 bits of the activation and
the bf16 rounding of the output differ. K4-K7, K6w, K6c and K6ca as K2;
K6c's and K6ca's query rows that see fewer than 64 keys (the first rows
of every sequence) also allow one bf16 flip of a probability, which
moves an output by at most 2^-6 of the largest |v| among those keys
(``_causal_close``); K6c at MLA's widths (DeepSeek-V2's q and k heads
192 wide, v 128) the same against the plain f32 attention. Every
attention kernel (K2, K2i8, K4, K5, K7, K6,
K6w, K6c, K6ca, K8a and K8b) runs on the Hopper library
(``csrc/attention_sm90.cu``): ``test_sm90_attention_matches_plain``
holds each of its prefix-masked modes at lengths on its tile edges and
checks the launches' route; so do the K4, K5, K6w, K2i8 and CP tests and
the emission tests for K2e and K4e, its emitting modes. K3 is K1's wgmma
kernel on int8 operands: ``test_int8_operands_bit_for_bit`` holds its
kept weight and its row quantization to the plain version's bits,
``test_qmatmul_int8_tiles_match_plain`` its tile configurations
(``k3_tile``) at main-path sizes. The MoE combine
(``csrc/moe_combine.cu``) repeats its plain version's rounded f32
operations in the same order: within one step of the output dtype.
``test_encoder_family_forward_matches_plain`` runs RoBERTa, DistilBERT,
RoFormer and ALBERT forwards on K1 and K2 against the plain f32 forward.
"""

import numpy as np
import pytest
import torch

from embeddings_tpu_torch.ops import attention as A
from embeddings_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_ref)
from embeddings_tpu_torch.ops.qmatmul import EPILOGUES, qmatmul, \
    qmatmul_int8, qmatmul_int8_ref, qmatmul_ref
from embeddings_tpu_torch.ops.quant import quantize

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rtol, atol_rms):
    g, r = got.float(), ref.float()
    rms = r.square().mean().sqrt()
    assert torch.isfinite(g).all()
    assert ((g - r).abs() <= rtol * r.abs() + atol_rms * rms).all(), \
        (g - r).abs().max().item()


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("kind,packed", [
    ("q4_0", False), ("q4_0", True), ("q4_1", True), ("q8_0", False),
    ("nf4", True)])
@pytest.mark.parametrize("M,K,N", [(40, 128, 136), (300, 768, 768),
                                   (70, 256, 1024)])
def test_qmatmul_kernel_matches_plain(cuda, kind, packed, epilogue, M, K, N):
    rng = np.random.default_rng(M + K)
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, kind, pack4=packed).map(lambda t: t.to(cuda))

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(cuda)

    x = f32(M, K).to(torch.bfloat16)
    kw = dict(kind=kind, epilogue=epilogue, packed=packed)
    if epilogue == "bias_residual_ln":
        kw.update(residual=f32(M, N).to(torch.bfloat16),
                  ln_scale=1 + f32(N, scale=0.1), ln_bias=f32(N, scale=0.1))
    args = (x, qt.codes, qt.scales, qt.mins, f32(N, scale=0.1))
    before = qmatmul.launches
    got = qmatmul(*args, **kw)
    assert qmatmul.launches == before + 1
    _close(got, qmatmul_ref(*args, **kw), 2 ** -7, 1e-3)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("kind,packed", [
    ("q4_0", False), ("q4_0", True), ("q4_1", True), ("q8_0", False),
    ("nf4", True)])
@pytest.mark.parametrize("M,K,N", [(40, 128, 136), (300, 768, 768),
                                   (70, 256, 1024)])
def test_qmatmul_int8_kernel_matches_plain(cuda, kind, packed, epilogue, M,
                                           K, N):
    rng = np.random.default_rng(M + K + 1)
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, kind, pack4=packed).map(lambda t: t.to(cuda))

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(cuda)

    x = f32(M, K).to(torch.bfloat16)
    kw = dict(kind=kind, epilogue=epilogue, packed=packed)
    if epilogue == "bias_residual_ln":
        kw.update(residual=f32(M, N).to(torch.bfloat16),
                  ln_scale=1 + f32(N, scale=0.1), ln_bias=f32(N, scale=0.1))
    args = (x, qt.codes, qt.scales, qt.mins, f32(N, scale=0.1))
    before = qmatmul_int8.launches
    got = qmatmul_int8(*args, **kw)
    assert qmatmul_int8.launches == before + 1
    _close(got, qmatmul_int8_ref(*args, **kw), 2 ** -7, 1e-3)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0", "nf4"])
def test_qmatmul_int8_kernel_k_tail(cuda, kind):
    """K = 96: the kernel's one 128-value chunk of K is a quarter empty
    (K % 32 == 0 is all the unpacked int8 mode needs)."""
    rng = np.random.default_rng(96)
    w = rng.standard_normal((96, 256), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, kind).map(lambda t: t.to(cuda))
    x = torch.from_numpy(rng.standard_normal(
        (50, 96), dtype=np.float32)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(256, dtype=np.float32)).to(
        cuda)
    args = (x, qt.codes, qt.scales, qt.mins, bias)
    kw = dict(kind=kind, epilogue="bias_gelu")
    _close(qmatmul(*args, int8_compute=True, **kw),
           qmatmul_int8_ref(*args, **kw), 2 ** -7, 1e-3)


def test_qmatmul_int8_ragged_lanes_run_k1(cuda):
    """N = 136 is not lane-aligned: int8_compute runs K1, as the JAX
    package falls back to bf16 compute."""
    rng = np.random.default_rng(136)
    w = rng.standard_normal((128, 136), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, "q4_0", pack4=True).map(lambda t: t.to(cuda))
    x = torch.from_numpy(rng.standard_normal(
        (24, 128), dtype=np.float32)).to(cuda, torch.bfloat16)
    k1, k3 = qmatmul.launches, qmatmul_int8.launches
    got = qmatmul(x, qt.codes, qt.scales, packed=True, int8_compute=True)
    assert (qmatmul.launches, qmatmul_int8.launches) == (k1 + 1, k3)
    _close(got, qmatmul_ref(x, qt.codes, qt.scales, packed=True), 2 ** -7,
           1e-3)


def _segments(B, L, rng):
    """Packed rows: random segment lengths (some past a 128-block), the
    tail of each row pad, and one all-pad row."""
    seg = np.full((B, L), -1, np.int32)
    for b in range(B - 1):
        pos, s = 0, 0
        while True:
            n = int(rng.integers(1, 100))
            if pos + n > L - int(rng.integers(0, 20)):
                break
            seg[b, pos:pos + n] = s
            pos, s = pos + n, s + 1
    return seg


@pytest.mark.parametrize("B,L,H,D", [(3, 128, 12, 64), (2, 72, 4, 32),
                                     (2, 256, 2, 128), (2, 640, 12, 64),
                                     (3, 64, 12, 64), (2, 640, 4, 128)])
def test_segmented_attention_kernel_matches_plain(cuda, B, L, H, D):
    """K4 on the Hopper kernel (mode 1: one consumer warpgroup at L <= 64,
    five key tiles at L=640), K2's tolerance; pad query rows give 0."""
    rng = np.random.default_rng(L + 1)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    seg = torch.from_numpy(_segments(B, L, rng)).to(cuda)
    before = (A.fused_attention_segmented.launches,
              dict(A.fused_attention_segmented.routes))
    got = A.fused_attention_segmented(qkv, seg, B=B, L=L, H=H, D=D)
    assert A.fused_attention_segmented.launches == before[0] + 1
    _one_sm90_launch(A.fused_attention_segmented, before[1])
    _close(got, A.fused_attention_segmented_ref(qkv, seg, B=B, L=L, H=H,
                                                D=D), 2 ** -6, 1e-2)
    assert (got[seg.reshape(-1) < 0] == 0).all()


@pytest.mark.parametrize("window", [0, 1, 3])
@pytest.mark.parametrize("B,L,H,D", [(3, 256, 2, 64), (2, 640, 12, 64),
                                     (2, 384, 4, 32)])
def test_blockskip_attention_kernel_matches_plain(cuda, B, L, H, D, window):
    """K5 on the Hopper kernel (mode 2: every head of a 128-row query
    block in one block, its key tiles kbs .. min(kbs + W - 1, kbe) only),
    K2's tolerance; pad query rows give 0."""
    rng = np.random.default_rng(L + window)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    seg = torch.from_numpy(_segments(B, L, rng)).to(cuda)
    kw = dict(B=B, L=L, H=H, D=D, window=window)
    wrapper = A.fused_attention_segmented_blockskip
    before = (wrapper.launches, dict(wrapper.routes))
    got = wrapper(qkv, seg, **kw)
    assert wrapper.launches == before[0] + 1
    _one_sm90_launch(wrapper, before[1])
    _close(got, A.fused_attention_segmented_blockskip_ref(qkv, seg, **kw),
           2 ** -6, 1e-2)
    assert (got[seg.reshape(-1) < 0] == 0).all()


@pytest.mark.parametrize("D", [32, 64, 128])
def test_blockskip_attention_kernel_empty_ranges(cuda, D):
    """K5 where the window drops key blocks (segments spanning 3 blocks,
    W=1) and where query blocks are all pad (the empty range (nK, -1)):
    those give exact zeros, and the ring stays in step across them."""
    B, L, H = 4, 512, 4
    rng = np.random.default_rng(D)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    seg = np.full((B, L), -1, np.int32)
    for b, edges in [(0, [0, 200, 330, 512]), (1, [0, 40, 256]),
                     (3, [0, 300, 400])]:
        for s_, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            seg[b, lo:hi] = s_
    seg = torch.from_numpy(seg).to(cuda)
    kbs, kbe = A.block_ranges(seg, L)
    assert (kbe < kbs).sum() >= 6
    kw = dict(B=B, L=L, H=H, D=D, window=1)
    got = A.fused_attention_segmented_blockskip(qkv, seg, **kw)
    _close(got, A.fused_attention_segmented_blockskip_ref(qkv, seg, **kw),
           2 ** -6, 1e-2)
    assert (got[seg.reshape(-1) < 0] == 0).all()


@pytest.mark.parametrize("B,L,H,D", [(3, 16, 12, 64), (2, 72, 4, 32),
                                     (2, 128, 2, 128), (4, 512, 12, 64),
                                     (3, 512, 12, 128)])
def test_fused_attention_kernel_matches_plain(cuda, B, L, H, D):
    rng = np.random.default_rng(L)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lengths = rng.integers(1, L + 1, B)
    lengths[0] = 0
    lens = torch.from_numpy(lengths.astype(np.int32)).to(cuda)
    before = fused_attention.launches
    got = fused_attention(qkv, lens, B=B, L=L, H=H, D=D)
    assert fused_attention.launches == before + 1
    _close(got, fused_attention_ref(qkv, lens, B=B, L=L, H=H, D=D),
           2 ** -6, 1e-2)
    assert (got.reshape(B, L, -1)[0] == 0).all()


def _bias(kind, L, H, rng, dev):
    """[1, H, L, L] f32 logit bias: a random table-like one or ALiBi."""
    from embeddings_tpu_torch.models.bert import alibi_attention_bias
    from embeddings_tpu_torch.ops.alibi import alibi_slopes
    if kind == "table":
        return torch.from_numpy(rng.standard_normal(
            (1, H, L, L), dtype=np.float32) * np.float32(2.0)).to(dev)
    slopes = torch.tensor(alibi_slopes(H), dtype=torch.float32, device=dev)
    return alibi_attention_bias(slopes, torch.arange(L, device=dev)[None])


def _ragged(rng, B, L, dev):
    lengths = rng.integers(1, L + 1, B)
    lengths[0], lengths[-1] = 0, L
    return torch.from_numpy(lengths.astype(np.int32)).to(dev)


@pytest.mark.parametrize("kind", ["table", "alibi"])
@pytest.mark.parametrize("B,L,H,D", [(3, 16, 12, 64), (2, 72, 4, 32),
                                     (2, 128, 2, 128), (4, 256, 12, 64),
                                     (2, 1024, 12, 64)])
def test_bias_attention_kernel_matches_plain(cuda, B, L, H, D, kind):
    rng = np.random.default_rng(L + H)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = _ragged(rng, B, L, cuda)
    bias = A.prepare_attention_bias(_bias(kind, L, H, rng, cuda), L)
    kw = dict(B=B, L=L, H=H, D=D)
    before = A.fused_attention_bias.launches
    got = A.fused_attention_bias(qkv, lens, bias, **kw)
    assert A.fused_attention_bias.launches == before + 1
    _close(got, A.fused_attention_bias_ref(qkv, lens, bias, **kw), 2 ** -6,
           1e-2)
    assert (got.reshape(B, L, -1)[0] == 0).all()


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("B,L,H,D,BK", [(2, 256, 4, 32, 128),
                                        (2, 384, 2, 128, 128),
                                        (3, 512, 12, 64, 512),
                                        (2, 2048, 12, 64, 512),
                                        (2, 1024, 12, 128, 512)])
def test_stream_attention_kernel_matches_plain(cuda, B, L, H, D, BK, alibi):
    from embeddings_tpu_torch.ops.alibi import alibi_slopes
    rng = np.random.default_rng(L + BK)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = _ragged(rng, B, L, cuda)
    slopes = (torch.tensor(alibi_slopes(H), dtype=torch.float32,
                           device=cuda) if alibi else None)
    kw = dict(B=B, L=L, H=H, D=D, BK=BK, alibi_slopes=slopes)
    before = A.fused_attention_stream.launches
    got = A.fused_attention_stream(qkv, lens, **kw)
    assert A.fused_attention_stream.launches == before + 1
    _close(got, A.fused_attention_stream_ref(qkv, lens, **kw), 2 ** -6, 1e-2)
    assert (got.reshape(B, L, -1)[0] == 0).all()


@pytest.mark.parametrize("B,L,H,D,window", [(2, 128, 4, 32, 8),
                                            (2, 256, 2, 64, 128),
                                            (3, 384, 12, 64, 128),
                                            (2, 512, 2, 128, 8),
                                            (1, 1024, 12, 64, 384),
                                            (4, 1024, 12, 64, 128),
                                            (2, 512, 12, 64, 2048)])
def test_window_attention_kernel_matches_plain(cuda, B, L, H, D, window):
    """K6w on the Hopper kernel (mode 6), K2's tolerance, one launch on
    the "sm90" route; the all-pad row gives 0."""
    rng = np.random.default_rng(L + window)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = _ragged(rng, B, L, cuda)
    kw = dict(B=B, L=L, H=H, D=D, window=window)
    wrapper = A.fused_attention_window
    before = (wrapper.launches, dict(wrapper.routes))
    got = wrapper(qkv, lens, **kw)
    assert wrapper.launches == before[0] + 1
    _one_sm90_launch(wrapper, before[1])
    _close(got, A.fused_attention_window_ref(qkv, lens, **kw), 2 ** -6, 1e-2)
    if B > 1:
        assert (got.reshape(B, L, -1)[0] == 0).all()


def _window_close(got, ref, qkv, lens, B, L, H, D, window):
    """K6w against its plain version on the query rows i < len[b] (K2's
    tolerance); pad query rows finite, those past len[b] + window // 2
    (which see no key) exactly 0. A pad row that still sees a few keys is
    never read, and one bf16 flip of a probability there moves it by up
    to 2^-8 of a key's value: it is not held to K2's tolerance."""
    i = torch.arange(L, device=got.device)[None, :]
    real = (i < lens[:, None]).reshape(-1)
    none = (i >= lens[:, None] + window // 2).reshape(-1)
    _close(got[real], ref[real], 2 ** -6, 1e-2)
    assert torch.isfinite(got.float()).all()
    assert (got[none] == 0).all()


@pytest.mark.parametrize("window", [8, 128, 384])
@pytest.mark.parametrize("L,H,D", [(256, 4, 32), (384, 2, 128),
                                   (512, 12, 64)])
def test_window_attention_kernel_tile_edges(cuda, L, H, D, window):
    """K6w at D = 32, 64 and 128 with lengths on the kernel's tile edges
    (64-row warpgroups, 128-key tiles) and a full row."""
    rng = np.random.default_rng(L + D + window)
    lengths = [min(n, L) for n in EDGES] + [L]
    B = len(lengths)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(B=B, L=L, H=H, D=D, window=window)
    before = dict(A.fused_attention_window.routes)
    got = A.fused_attention_window(qkv, lens, **kw)
    _one_sm90_launch(A.fused_attention_window, before)
    _window_close(got, A.fused_attention_window_ref(qkv, lens, **kw), qkv,
                  lens, B, L, H, D, window)
    assert (got.reshape(B, L, -1)[0] == 0).all()


@pytest.mark.parametrize("D", [32, 64, 128])
def test_window_attention_kernel_blocks_past_the_band(cuda, D):
    """Query blocks wholly past len + window // 2 (their key-tile range is
    empty: no tile is walked) and blocks whose band ends inside their
    first warpgroup's tiles: those rows are exactly 0, the ring stays in
    step across them and the rows that see keys match the plain
    version."""
    B, L, H, window = 4, 1024, 4, 128
    rng = np.random.default_rng(D)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = torch.tensor([100, 300, 0, 700], dtype=torch.int32, device=cuda)
    W = A.band_half(window, L)
    empty = [(b, qb) for b, n in enumerate(lens.tolist())
             for qb in range(L // 128)
             if A.band_tiles(qb * 128, 128, W, n)[1] == 0]
    assert len(empty) >= 16
    kw = dict(B=B, L=L, H=H, D=D, window=window)
    got = A.fused_attention_window(qkv, lens, **kw)
    _window_close(got, A.fused_attention_window_ref(qkv, lens, **kw), qkv,
                  lens, B, L, H, D, window)
    rows = got.reshape(B, L // 128, 128, H * D)
    for b, qb in empty:
        assert (rows[b, qb] == 0).all()


def _causal_close(got, ref, qkv, lens, B, L, H, D):
    """K2's tolerance, plus one bf16 probability flip on the query rows
    that see 1-63 keys; rows that see no key exactly 0."""
    i = torch.arange(L, device=got.device)
    nkeys = torch.minimum(i[None, :] + 1, lens[:, None].long())  # [B, L]
    v = qkv.float().reshape(B, L, 3, H, D)[:, :64, 2]
    vmax = v.abs().amax(dim=(1, 3))                              # [B, H]
    few = ((nkeys > 0) & (nkeys < 64)).float()
    extra = (few[:, :, None] * vmax[:, None, :])[..., None].expand(
        B, L, H, D).reshape(B * L, H * D)
    g, r = got.float(), ref.float()
    rms = r.square().mean().sqrt()
    assert torch.isfinite(g).all()
    assert ((g - r).abs() <= 2 ** -6 * r.abs() + 1e-2 * rms
            + 2 ** -6 * extra).all(), (g - r).abs().max().item()
    assert (got[(nkeys == 0).reshape(-1)] == 0).all()


@pytest.mark.parametrize("B,L", [(8, 128), (8, 1024), (8, 4096)])
def test_mla_attention_kernel_matches_plain(cuda, B, L):
    """K6c at MLA's widths (DeepSeek-V2-Lite: 16 heads, q and k 192 wide,
    v 128, softmax scale 0.1147) against the plain f32 attention at the
    cell's bucket shapes: the reference's masked softmax, not the
    kernel's plain version, so the tolerance is K2's plus one bf16
    probability flip on rows that see few keys, as ``_causal_close``."""
    H, D, dv, scale = 16, 192, 128, 0.11472
    rng = np.random.default_rng(L)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, H * (2 * D + dv)), dtype=np.float32)).to(cuda,
                                                          torch.bfloat16)
    lens = torch.tensor([L, L - 37, 1, 0, L // 2, 129, L - 1, 64][:B],
                        dtype=torch.int32, device=cuda).clamp_max(L)
    before = (A.fused_attention_stream.mla_launches,
              A.fused_attention_stream.causal_launches)
    got = A.fused_attention_stream(qkv, lens, B=B, L=L, H=H, D=D,
                                   BK=A.pick_bk(L), causal=True, dv=dv,
                                   scale=scale)
    assert (A.fused_attention_stream.mla_launches,
            A.fused_attention_stream.causal_launches) == (before[0] + 1,
                                                          before[1] + 1)
    x = qkv.float().reshape(B, L, -1)
    q, k, v = (t.reshape(B, L, H, -1).transpose(1, 2)
               for t in x.split([H * D, H * D, H * dv], -1))
    i = torch.arange(L, device=cuda)
    ok = (i[None, :] <= i[:, None])[None, None] \
        & (i[None, :] < lens[:, None])[:, None, None, :]
    want = torch.zeros(B, H, L, dv, device=cuda)
    for q0 in range(0, L, 512):  # [B, H, 512, L] f32 scores a step
        s = (q[:, :, q0:q0 + 512] @ k.transpose(-1, -2)) * scale
        s = s.masked_fill(~ok[:, :, q0:q0 + 512], float("-inf"))
        p = torch.softmax(s, -1).nan_to_num(0.0)
        want[:, :, q0:q0 + 512] = p @ v
    want = want.transpose(1, 2).reshape(B * L, H * dv)
    nkeys = torch.minimum(i[None, :] + 1, lens[:, None].long())  # [B, L]
    vmax = v[:, :, :64].abs().amax(dim=(2, 3))                   # [B, H]
    few = ((nkeys > 0) & (nkeys < 64)).float()
    extra = (few[:, :, None] * vmax[:, None, :])[..., None].expand(
        B, L, H, dv).reshape(B * L, H * dv)
    g = got.float()
    rms = want.square().mean().sqrt()
    assert torch.isfinite(g).all()
    assert ((g - want).abs() <= 2 ** -6 * want.abs() + 1e-2 * rms
            + 2 ** -6 * extra).all(), (g - want).abs().max().item()
    assert (got[(nkeys == 0).reshape(-1)] == 0).all()


@pytest.mark.parametrize("rows", [8 * 1024 * 6, 8 * 4096 * 6])
def test_grouped_expert_product_matches_per_expert(cuda, rows):
    """DeepSeek-V2's routed-expert product on the card (``ops.moe``'s
    grouped product: 64 experts 2,048 x 1,408, bf16) against one
    ``torch.mm`` an expert, at the (token, expert) pairs of a 1,024 and a
    4,096 bucket (B=8, top-6), two experts empty and one with one row.
    Both sum in f32 and round once to bf16: one bf16 step apart."""
    from embeddings_tpu_torch.ops.moe import _grouped
    rng = np.random.default_rng(rows)
    counts = torch.from_numpy(rng.multinomial(rows, np.full(64, 1 / 64)))
    counts[[5, 40]] = 0
    counts[7] = 1
    a = torch.randn(int(counts.sum()), 2048, device=cuda,
                    dtype=torch.bfloat16)
    w = torch.randn(64, 2048, 1408, device=cuda, dtype=torch.bfloat16) * 0.02
    got = _grouped(counts.to(cuda), torch.bfloat16)(a, w)
    want = torch.cat([x.float() @ w[e].float()
                      for e, x in enumerate(a.split(counts.tolist()))])
    _close(got, want, 2 ** -7, 1e-3)


def _combine_inputs(dev, T, k, D, E, dtype, extras, seed=0):
    """A combine's inputs on the card: each token routed to k distinct
    experts of E (experts 2 and 5 never: no rows), weights on a 1/8 grid
    (ties), y [T*k, D] in expert order; ``extras`` names the optional
    operands to pass (down_b, bias, shared)."""
    rng = np.random.default_rng(seed)
    live = np.array([e for e in range(E) if e not in (2, 5)])
    top_e = torch.from_numpy(np.argsort(rng.random((T, len(live))), -1)
                             [:, :k]).to(dev)
    top_e = torch.from_numpy(live).to(dev)[top_e]
    top_w = torch.from_numpy(rng.integers(1, 8, (T, k)).astype(np.float32)
                             / 8).to(dev)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    y = torch.randn(T * k, D, device=dev).to(dtype)
    ops = {"down_b": torch.randn(E, D, device=dev) * 0.1,
           "bias": torch.randn(D, device=dev) * 0.1,
           "shared": torch.randn(T, D, device=dev).to(dtype)}
    return y, top_w, flat_e, order, {n: ops[n] for n in extras}


@pytest.mark.parametrize("T,k,D,E,dtype,extras", [
    (8192, 6, 2048, 64, torch.bfloat16, ("shared",)),      # DeepSeek-V2
    (32768, 2, 768, 8, torch.bfloat16, ("down_b", "bias")),  # nomic
    (1000, 3, 100, 8, torch.bfloat16, ("down_b", "bias", "shared")),
    (513, 2, 768, 8, torch.float32, ("down_b", "bias")),   # the f32 path
    (300, 9, 64, 12, torch.float16, ("shared",))])
def test_moe_combine_matches_plain(cuda, T, k, D, E, dtype, extras):
    """The hand-written combine (``csrc/moe_combine.cu``) against its
    plain version on the card: the same rounded f32 products and adds in
    the same order, so within one step of the output dtype (bit for bit
    as written); two launches bit for bit (no atomics); one count a
    launch. D = 100 takes the scalar path, k = 9 two chunks of loads."""
    from embeddings_tpu_torch.ops.moe import _combine_plain, \
        combine_experts, moe_ffn_ragged
    y, top_w, flat_e, order, kw = _combine_inputs(cuda, T, k, D, E, dtype,
                                                  extras, seed=T)
    n0 = moe_ffn_ragged.combines
    got = combine_experts(y, top_w, flat_e, order, **kw)
    again = combine_experts(y, top_w, flat_e, order, **kw)
    want = _combine_plain(y, top_w, flat_e, order, **kw)
    torch.cuda.synchronize()
    assert moe_ffn_ragged.combines == n0 + 2
    assert got.dtype == dtype and torch.equal(got, again)
    step = torch.finfo(dtype).eps
    g, r = got.float(), want.float()
    assert ((g - r).abs() <= step * r.abs() + 1e-30).all(), \
        (g - r).abs().max().item()


def test_moe_combine_counts_a_launch_per_moe_layer(cuda):
    """A forward of the trained nomic-style fixture on the card launches
    one combine a MoE layer and embeds as the CPU does."""
    from pathlib import Path
    from embeddings_tpu_torch.ops.moe import moe_ffn_ragged
    from embeddings_tpu_torch.runtime.engine import load_model
    path = (Path(__file__).resolve().parent.parent / "benchmarks"
            / "fixtures" / "tiny_trained_moe" / "model")
    eng = load_model(path, dtype="q4_0", device=cuda)
    n_moe = eng.params["layers"]["moe"]["mlp"]["router"]["w"].shape[0]
    rng = np.random.default_rng(1)
    ids = rng.integers(5, eng.config.vocab_size, (4, 32)).astype(np.int32)
    mask = np.ones_like(ids)
    n0 = moe_ffn_ragged.combines
    emb = eng.forward(ids, mask)
    torch.cuda.synchronize()
    assert moe_ffn_ragged.combines == n0 + n_moe
    cpu = load_model(path, dtype="q4_0", device="cpu").forward(ids, mask)
    assert ((emb * cpu).sum(-1) / np.linalg.norm(emb, axis=-1)
            / np.linalg.norm(cpu, axis=-1)).min() >= 0.999


@pytest.mark.parametrize("B,L,H,D,BK", [(4, 256, 4, 32, 256),
                                        (4, 512, 12, 64, 512),
                                        (4, 384, 2, 128, 128),
                                        (4, 1024, 12, 128, 512),
                                        (2, 4096, 12, 128, 512)])
def test_causal_attention_kernel_matches_plain(cuda, B, L, H, D, BK):
    rng = np.random.default_rng(L + D)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = torch.tensor([L, L - 37, 1, 0] if B == 4 else [L, 0],
                        dtype=torch.int32, device=cuda)
    kw = dict(B=B, L=L, H=H, D=D, BK=BK, causal=True)
    plain = A.fused_attention_stream.launches
    before = A.fused_attention_stream.causal_launches
    got = A.fused_attention_stream(qkv, lens, **kw)
    assert A.fused_attention_stream.causal_launches == before + 1
    assert A.fused_attention_stream.launches == plain
    _causal_close(got, A.fused_attention_stream_ref(qkv, lens, **kw), qkv,
                  lens, B, L, H, D)


@pytest.mark.parametrize("B,L,H,D,BK", [(4, 256, 4, 32, 256),
                                        (4, 512, 12, 64, 512),
                                        (4, 384, 2, 128, 128),
                                        (2, 8192, 12, 64, 512)])
def test_causal_alibi_attention_kernel_matches_plain(cuda, B, L, H, D, BK):
    """K6ca (causal with ALiBi, mode 8) against its plain version, counted
    apart from K6 and K6c."""
    from embeddings_tpu_torch.ops.alibi import alibi_slopes
    rng = np.random.default_rng(L + H)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = torch.tensor([L, L - 37, 40, 0] if B == 4 else [L, L - 37],
                        dtype=torch.int32, device=cuda)
    kw = dict(B=B, L=L, H=H, D=D, BK=BK, causal=True,
              alibi_slopes=alibi_slopes(H))
    counts = (A.fused_attention_stream.launches,
              A.fused_attention_stream.causal_launches)
    before = A.fused_attention_stream.causal_alibi_launches
    got = A.fused_attention_stream(qkv, lens, **kw)
    assert A.fused_attention_stream.causal_alibi_launches == before + 1
    assert (A.fused_attention_stream.launches,
            A.fused_attention_stream.causal_launches) == counts
    _causal_close(got, A.fused_attention_stream_ref(qkv, lens, **kw), qkv,
                  lens, B, L, H, D)


def _one_sm90_launch(wrapper, before):
    """The wrapper's route counts gained one launch, on the Hopper
    kernel, and no other."""
    assert wrapper.routes["sm90"] == before.get("sm90", 0) + 1
    assert sum(wrapper.routes.values()) == sum(before.values()) + 1


# lengths on the Hopper attention kernel's tile edges (64 queries, 128
# keys), clipped to L, and a full row
EDGES = (0, 1, 63, 64, 65, 127, 128, 129)
SM90_CASES = [(0, 16), (0, 72), (0, 200), (0, 512), (4, 384), (5, 384),
              (7, 384), (8, 384), (4, 512), (7, 512), (3, 48), (3, 200),
              (3, 384)]


@pytest.mark.parametrize("H,D", [(4, 32), (2, 64), (16, 64), (12, 128)])
@pytest.mark.parametrize("mode,L", SM90_CASES)
def test_sm90_attention_matches_plain(cuda, mode, L, H, D):
    """The Hopper kernel (csrc/attention_sm90.cu) in each of its modes, K2
    (0), K7 (3, with a table bias), K6 plain (4) and ALiBi (5), K6c (7),
    K6ca (8), against its plain version at lengths on its tile edges,
    counted on the "sm90" route."""
    from embeddings_tpu_torch.ops.alibi import alibi_slopes
    rng = np.random.default_rng(L + D + mode)
    lengths = [min(n, L) for n in EDGES] + [L]
    B = len(lengths)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    assert A.attention_kernel(mode, D) == "sm90"
    if mode == 0:
        wrapper, kw = fused_attention, dict(B=B, L=L, H=H, D=D)
        plain = fused_attention_ref
    elif mode == 3:
        bias = A.prepare_attention_bias(_bias("table", L, H, rng, cuda), L)
        wrapper, plain = A.fused_attention_bias, A.fused_attention_bias_ref
        kw = dict(B=B, L=L, H=H, D=D)
        qkv = (qkv, lens, bias)
    else:
        wrapper, plain = A.fused_attention_stream, \
            A.fused_attention_stream_ref
        kw = dict(B=B, L=L, H=H, D=D, BK=128, causal=mode in (7, 8),
                  alibi_slopes=alibi_slopes(H) if mode in (5, 8) else None)
    ops = qkv if mode == 3 else (qkv, lens)
    before = dict(wrapper.routes)
    got = wrapper(*ops, **kw)
    _one_sm90_launch(wrapper, before)
    ref = plain(*ops, **kw)
    if mode in (7, 8):
        _causal_close(got, ref, qkv, lens, B, L, H, D)
    else:
        _close(got, ref, 2 ** -6, 1e-2)
        assert (got.reshape(B, L, -1)[0] == 0).all()


@pytest.mark.parametrize("M,K,N,epilogue,emit", [
    (32768, 768, 2304, "bias", "no"),
    (32768 + 40, 768, 768, "bias_residual_ln", "no"),
    (32768 + 40, 3072, 768, "bias_residual_ln", "no"),
    (32768 + 40, 768, 3072, "bias_gelu", "no"),
    (4096, 768, 768, "bias_residual_ln", "no"),
    (8192, 1024, 2048, "bias_residual_ln", "no"),
    (4096, 768, 768, "bias_residual_ln", "both"),
    (300, 1024, 1024, "bias_residual_ln", "only"),
    (4096, 768, 3072, "bias_gelu", "only")])
def test_qmatmul_tiles_match_plain(cuda, M, K, N, epilogue, emit):
    """K1's tile configurations (``k1_tile``: 256 or 128 rows, LayerNorm
    clusters of 6, 8 and 16 blocks) at main-path sizes, ragged M, and the
    emission modes, against the plain version; codes within one step,
    scales within 1e-4 relative."""
    from embeddings_tpu_torch.ops.qmatmul import k1_route
    rng = np.random.default_rng(M + N)
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, "q4_0", pack4=True).map(lambda t: t.to(cuda))

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(cuda)

    kw = dict(kind="q4_0", epilogue=epilogue, packed=True,
              emit_quantized=emit)
    if epilogue == "bias_residual_ln":
        kw.update(residual=f32(M, N).to(torch.bfloat16),
                  ln_scale=1 + f32(N, scale=0.1), ln_bias=f32(N, scale=0.1))
    args = (f32(M, K).to(torch.bfloat16), qt.codes, qt.scales, qt.mins,
            f32(N, scale=0.1))
    route = k1_route(M, N, epilogue, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    before = qmatmul.routes[route]
    got = qmatmul(*args, **kw)
    ref = qmatmul_ref(*args, **kw)
    assert qmatmul.routes[route] == before + 1
    if emit == "no":
        _close(got, ref, 2 ** -7, 1e-3)
        return
    if emit == "both":
        _close(got[0], ref[0], 2 ** -7, 1e-3)
    assert (got[-2].int() - ref[-2].int()).abs().max() <= 1
    assert ((got[-1] - ref[-1]).abs() / ref[-1]).max() <= 1e-4


@pytest.mark.parametrize("kind,packed", [
    ("q4_0", False), ("q4_0", True), ("q4_1", False), ("q4_1", True),
    ("q8_0", False), ("nf4", False), ("nf4", True)])
def test_int8_operands_bit_for_bit(cuda, kind, packed):
    """K3's operands on the card equal the plain version's bit for bit:
    the kept weight (``requantize_int8``: w8t [N, K], cs [N]) against
    ``requantize_weight``, the rows (``quantize_rows_int8``) against
    ``quantize_rows``, at K off the kernel's 128-value chunk (K = 160;
    192 packed) and a ragged N and M."""
    from embeddings_tpu_torch.ops.qmatmul import quantize_rows, \
        quantize_rows_int8, requantize_int8, requantize_weight
    rng = np.random.default_rng(7)
    K, N, M = (192 if packed else 160), 136, 257
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, kind, pack4=packed).map(lambda t: t.to(cuda))
    w8t, cs = requantize_int8(qt.codes, qt.scales, qt.mins, kind=kind,
                              packed=packed)
    w8, rcs = requantize_weight(qt.codes, qt.scales, qt.mins, kind, packed)
    assert torch.equal(w8t, w8.t()) and torch.equal(cs, rcs.reshape(-1))
    x = torch.from_numpy(rng.standard_normal(
        (M, K), dtype=np.float32)).to(cuda, torch.bfloat16)
    q, sx = quantize_rows_int8(x)
    rq, rsx = quantize_rows(x)
    assert torch.equal(q, rq) and torch.equal(sx, rsx.reshape(-1))


@pytest.mark.parametrize("M,K,N,epilogue,emit,x8", [
    (32768, 768, 2304, "bias", "no", False),
    (32768 + 40, 768, 768, "bias_residual_ln", "no", False),
    (32768 + 40, 3072, 768, "bias_residual_ln", "both", True),
    (32768 + 40, 768, 3072, "bias_gelu", "only", True),
    (4096, 768, 768, "bias_residual_ln", "no", True),
    (8192, 1024, 2048, "bias_residual_ln", "no", False),
    (8192, 1024, 1536, "bias_residual_ln", "both", False),
    (300, 4096, 1024, "bias_silu", "no", False)])
def test_qmatmul_int8_tiles_match_plain(cuda, M, K, N, epilogue, emit, x8):
    """K3's tile configurations (``k3_tile``: 256 or 128 rows, LayerNorm
    clusters of 6, 12 and 16 blocks) at main-path sizes with the weight
    kept as the Engine keeps it, ragged M, int8 x (K3x) and the emission
    modes (K3e), against the plain version; one launch, no
    requantization; codes within one step, scales within 1e-4."""
    from embeddings_tpu_torch.ops.qmatmul import k3_route, \
        keep_int8_weight, quantize_rows, requantize_int8
    rng = np.random.default_rng(M + N + K)
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = keep_int8_weight(quantize(w, "q4_0", pack4=True).map(
        lambda t: t.to(cuda)))

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(cuda)

    kw = dict(kind="q4_0", epilogue=epilogue, packed=True,
              emit_quantized=emit)
    if epilogue == "bias_residual_ln":
        kw.update(residual=f32(M, N).to(torch.bfloat16),
                  ln_scale=1 + f32(N, scale=0.1), ln_bias=f32(N, scale=0.1))
    x = f32(M, K).to(torch.bfloat16)
    if x8:
        q, sx = quantize_rows(x)
        x, kw["x_scale"] = q, sx.reshape(M)
    args = (x, qt.codes, qt.scales, qt.mins, f32(N, scale=0.1))
    route = k3_route(M, N, epilogue, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    before = (qmatmul_int8.routes[route], qmatmul_int8.launches,
              requantize_int8.launches)
    got = qmatmul(*args, int8_compute=True, int8_weight=qt.int8, **kw)
    assert (qmatmul_int8.routes[route], qmatmul_int8.launches,
            requantize_int8.launches) == (before[0] + 1, before[1] + 1,
                                          before[2])
    ref = qmatmul_int8_ref(*args, **kw)
    if emit == "no":
        _close(got, ref, 2 ** -7, 1e-3)
        return
    if emit == "both":
        _close(got[0], ref[0], 2 ** -7, 1e-3)
    assert (got[-2].int() - ref[-2].int()).abs().max() <= 1
    assert ((got[-1] - ref[-1]).abs() / ref[-1]).max() <= 1e-4


def test_qmatmul_refuses_too_wide_layernorm(cuda):
    """A residual-LayerNorm row wider than one cluster of 16 x 128 columns
    is refused by name, not sent to another kernel."""
    rng = np.random.default_rng(0)
    K, N = 128, 2176
    qt = quantize(rng.standard_normal((K, N), dtype=np.float32),
                  "q4_0", pack4=True).map(lambda t: t.to(cuda))
    x = torch.zeros(8, K, dtype=torch.bfloat16, device=cuda)
    kw = dict(kind="q4_0", epilogue="bias_residual_ln", packed=True,
              residual=torch.zeros(8, N, dtype=torch.bfloat16, device=cuda),
              ln_scale=torch.ones(N, device=cuda),
              ln_bias=torch.zeros(N, device=cuda))
    with pytest.raises(ValueError, match="at most 2048 columns"):
        qmatmul(x, qt.codes, qt.scales, None,
                torch.zeros(N, device=cuda), **kw)


def test_kernels_raise_on_wrong_dtype(cuda):
    qt = quantize(np.zeros((64, 64), np.float32), "q4_0").map(
        lambda t: t.to(cuda))
    with pytest.raises(TypeError):
        qmatmul(torch.zeros(8, 64, device=cuda), qt.codes, qt.scales)
    with pytest.raises(TypeError):
        fused_attention(torch.zeros(16, 384, device=cuda),
                        torch.ones(1, dtype=torch.int32, device=cuda),
                        B=1, L=16, H=2, D=64)
    with pytest.raises(TypeError):
        qmatmul_int8(torch.zeros(8, 64, device=cuda), qt.codes, qt.scales)
    with pytest.raises(TypeError):
        A.fused_attention_segmented(
            torch.zeros(16, 384, device=cuda, dtype=torch.bfloat16),
            torch.zeros(1, 16, dtype=torch.int64, device=cuda),
            B=1, L=16, H=2, D=64)
    qkv = torch.zeros(128, 384, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        A.fused_attention_bias(qkv, lens, torch.zeros(2, 128, 128,
                                                      device=cuda),
                               B=1, L=128, H=2, D=64)
    with pytest.raises(TypeError):
        A.fused_attention_stream(qkv, lens, B=1, L=128, H=2, D=64, BK=128)
    with pytest.raises(TypeError):
        A.fused_attention_window(qkv, lens, B=1, L=128, H=2, D=64, window=8)
    with pytest.raises(TypeError):
        A.fused_attention_stream(qkv, lens, B=1, L=128, H=2, D=64, BK=128,
                                 causal=True)
    with pytest.raises(ValueError):  # the bias on the host
        A.fused_attention_bias(qkv.to(torch.bfloat16), lens,
                               torch.zeros(2, 128, 128), B=1, L=128, H=2,
                               D=64)


# ---------------------------------------------------------------------------
# the chained-int8 modes: K1e / K3e (emission), K3x (int8 x), K2e / K4e
# (attention emission), K2i8 (int8 scores)
# ---------------------------------------------------------------------------

def _emit_close(got, ref, emit, rtol=2 ** -7, atol_rms=1e-3):
    """Emission against its plain version: the bf16 output ("both") at
    K1's tolerance, codes at most one step apart, row scales to 1e-4."""
    if emit == "both":
        _close(got[0], ref[0], rtol, atol_rms)
        got, ref = got[1:], ref[1:]
    assert got[0].dtype == torch.int8 and got[1].shape == (got[0].shape[0], 1)
    assert (got[0].int() - ref[0].int()).abs().max() <= 1
    assert ((got[1] - ref[1]).abs() <= 1e-4 * ref[1]).all()


@pytest.mark.parametrize("emit", ["both", "only"])
@pytest.mark.parametrize("epilogue", ["bias", "bias_gelu",
                                      "bias_residual_ln"])
@pytest.mark.parametrize("int8_x", [False, True])
@pytest.mark.parametrize("M,K,N", [(40, 128, 256), (300, 768, 768),
                                   (70, 256, 1024)])
def test_qmatmul_emission_kernels_match_plain(cuda, M, K, N, int8_x,
                                              epilogue, emit):
    """K1e and K3e, and K3x + K3e with an int8 x and its row scales."""
    from embeddings_tpu_torch.ops.qmatmul import quantize_rows
    rng = np.random.default_rng(M + N)
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, "q4_0", pack4=True).map(lambda t: t.to(cuda))
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(
        cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(N, dtype=np.float32)).to(cuda)
    kw = dict(epilogue=epilogue, packed=True, emit_quantized=emit)
    if epilogue == "bias_residual_ln":
        kw.update(residual=torch.randn(M, N, device=cuda).to(torch.bfloat16),
                  ln_scale=torch.ones(N, device=cuda),
                  ln_bias=torch.zeros(N, device=cuda))
    if int8_x:
        q8, sx = quantize_rows(x)
        args = (q8, qt.codes, qt.scales, None, bias)
        before = qmatmul_int8.x8_launches
        got = qmatmul(*args, int8_compute=True, x_scale=sx.reshape(M), **kw)
        assert qmatmul_int8.x8_launches == before + 1
        _emit_close(got, qmatmul_int8_ref(*args, x_scale=sx, **kw), emit)
        return
    args = (x, qt.codes, qt.scales, None, bias)
    before = qmatmul.launches, getattr(qmatmul, f"{emit}_launches")
    got = qmatmul(*args, **kw)
    assert (qmatmul.launches, getattr(qmatmul, f"{emit}_launches")) == (
        before[0] + 1, before[1] + 1)
    _emit_close(got, qmatmul_ref(*args, **kw), emit)
    _emit_close(qmatmul_int8(*args, **kw), qmatmul_int8_ref(*args, **kw),
                emit)


def _attn_emit_close(got, ref, emit):
    """Attention emission: the context at K2's tolerance; codes
    dequantized within K2's tolerance plus one step of each side. With
    "both", the codes and scales are also exactly the plain quantization
    of the kernel's own bf16 context."""
    if emit == "both":
        _close(got[0], ref[0], 2 ** -6, 1e-2)
        o8, so = A._emit_int8_rows(got[0].float())
        assert torch.equal(got[1], o8) and torch.equal(got[2], so)
        got, ref = got[1:], ref[1:]
    deq, rdeq = got[0].float() * got[1], ref[0].float() * ref[1]
    tol = (2 ** -6 * rdeq.abs() + 1e-2 * rdeq.square().mean().sqrt()
           + got[1] + ref[1])
    assert ((deq - rdeq).abs() <= tol).all()


def _sm90_emit_launch(wrapper, emit, call):
    """call() on the card, checking it made one emitting launch on the
    Hopper kernel."""
    before = (getattr(wrapper, f"{emit}_launches"), wrapper.routes["sm90"])
    got = call()
    torch.cuda.synchronize()
    assert (getattr(wrapper, f"{emit}_launches"),
            wrapper.routes["sm90"]) == (before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("emit", ["both", "only"])
@pytest.mark.parametrize("B,L,H,D", [(4, 256, 12, 64), (3, 72, 2, 64),
                                     (2, 128, 4, 128), (2, 64, 16, 32),
                                     (3, 48, 12, 32), (4, 200, 12, 128),
                                     (3, 384, 16, 64)])
def test_attention_emission_matches_plain(cuda, B, L, H, D, emit):
    """K2e on the Hopper kernel (every head of a query tile in one block):
    one consumer warpgroup (L <= 64) and two, ragged L, D 32 / 64 / 128,
    H up to 16; ragged lengths with a len-0 row, which gives codes 0 and
    the scale 1e-30 / 127."""
    rng = np.random.default_rng(L + H)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = rng.integers(1, L + 1, B)
    lens[0], lens[1] = 0, L
    lens = torch.tensor(lens.tolist(), dtype=torch.int32, device=cuda)
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized=emit)
    got = _sm90_emit_launch(fused_attention, emit,
                            lambda: fused_attention(qkv, lens, **kw))
    _attn_emit_close(got, fused_attention_ref(qkv, lens, **kw), emit)
    o8 = got[-2].reshape(B, L, H * D)
    assert (o8[0] == 0).all()
    np.testing.assert_array_equal(got[-1].reshape(B, L)[0].cpu().numpy(),
                                  np.float32(1e-30) * np.float32(1 / 127))


@pytest.mark.parametrize("emit", ["both", "only"])
@pytest.mark.parametrize("B,L,H,D", [(3, 128, 12, 64), (2, 256, 4, 32),
                                     (2, 72, 16, 32), (2, 200, 12, 128),
                                     (3, 48, 2, 64)])
def test_segmented_emission_matches_plain(cuda, B, L, H, D, emit):
    """K4e on the Hopper kernel: packed rows whose segments cross the
    128-key tile edge and end in pads (a pad row gives codes 0), one
    consumer warpgroup (L <= 64) and two, ragged L, D 32 / 64 / 128."""
    rng = np.random.default_rng(7 + L)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    seg = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos, s = 0, 0
        while pos < L - 16:
            n = int(rng.integers(3, max(4, L // 2)))
            seg[b, pos:min(pos + n, L - 8)] = s
            pos, s = pos + n, s + 1
    seg = torch.from_numpy(seg).to(cuda)
    kw = dict(B=B, L=L, H=H, D=D, emit_quantized=emit)
    got = _sm90_emit_launch(
        A.fused_attention_segmented, emit,
        lambda: A.fused_attention_segmented(qkv, seg, **kw))
    _attn_emit_close(got, A.fused_attention_segmented_ref(qkv, seg, **kw),
                     emit)
    pad = (seg < 0).reshape(-1)
    assert (got[-2][pad] == 0).all()


@pytest.mark.parametrize("emit", ["no", "only", "both"])
@pytest.mark.parametrize("B,L,H,D", [(4, 256, 12, 64), (2, 1024, 12, 64),
                                     (3, 72, 4, 32), (2, 192, 4, 128),
                                     (3, 48, 12, 64), (2, 200, 16, 128),
                                     (2, 640, 4, 32)])
def test_int8_scores_match_plain(cuda, B, L, H, D, emit):
    """K2i8 on the Hopper library (its own kernel: one consumer
    warpgroup at L <= 64, a first score pass over the key tiles): integer
    products and the same f32 steps, so it meets K2's tolerance; a len-0
    row (every key at p8 = 127) stays finite; one launch on the "sm90"
    route."""
    rng = np.random.default_rng(L + D)
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda, torch.bfloat16)
    lens = torch.from_numpy(rng.integers(1, L + 1, B).astype(np.int32)).to(
        cuda)
    lens[0] = 0
    kw = dict(B=B, L=L, H=H, D=D, int8_scores=True, emit_quantized=emit)
    before = (fused_attention.i8s_launches, dict(fused_attention.routes))
    got = fused_attention(qkv, lens, **kw)
    assert fused_attention.i8s_launches == before[0] + 1
    _one_sm90_launch(fused_attention, before[1])
    ref = fused_attention_ref(qkv, lens, **kw)
    if emit == "no":
        _close(got, ref, 2 ** -6, 1e-2)
        assert torch.isfinite(got).all()
        # the control: K2's bf16 softmax fails that tolerance on the rows
        # with keys, so the check tells K2i8 from plain K2
        seen = (lens > 0).repeat_interleave(L)
        plain = fused_attention(qkv, lens, B=B, L=L, H=H, D=D)[seen].float()
        r = ref[seen].float()
        assert not ((plain - r).abs()
                    <= 2 ** -6 * r.abs() + 1e-2 * r.square().mean().sqrt()
                    ).all()
    else:
        _attn_emit_close(got, ref, emit)


# ---------------------------------------------------------------------------
# context parallelism: K8a / K8b and the CP forward
# ---------------------------------------------------------------------------

def _cp_operands(rng, B, Lc, L, H, D, dev, in_place):
    """bf16 q [B*Lc, E] (``in_place``: a column view of a [B*Lc, 3E]
    projection, row stride 3E), gathered kv [B*L, 2E], ragged lengths."""
    E = H * D
    src = torch.from_numpy(rng.standard_normal(
        (B * Lc, 3 * E if in_place else E), dtype=np.float32)).to(
        dev, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal(
        (B * L, 2 * E), dtype=np.float32)).to(dev, torch.bfloat16)
    return src[:, :E], kv, _ragged(rng, B, L, dev)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("B,Lc,L,H,D", [(2, 16, 64, 2, 64), (3, 8, 32, 4, 32),
                                        (4, 256, 512, 12, 64),
                                        (2, 72, 144, 2, 128)])
def test_cp_attention_kernel_matches_plain(cuda, B, Lc, L, H, D, in_place):
    """K8a: local queries against gathered K/V (Lc < L), K2's tolerance,
    on the Hopper kernel (the CP layout); a len-0 row gives exactly 0."""
    rng = np.random.default_rng(L + Lc)
    q, kv, lens = _cp_operands(rng, B, Lc, L, H, D, cuda, in_place)
    kw = dict(B=B, Lc=Lc, L=L, H=H, D=D)
    before = A.fused_attention_cp.launches, dict(A.fused_attention_cp.routes)
    got = A.fused_attention_cp(q, kv, lens, **kw)
    assert A.fused_attention_cp.launches == before[0] + 1
    _one_sm90_launch(A.fused_attention_cp, before[1])
    _close(got, A.fused_attention_cp_ref(q, kv, lens, **kw), 2 ** -6, 1e-2)
    assert (got.reshape(B, Lc, -1)[0] == 0).all()


@pytest.mark.parametrize("B,Lc,L,H,D,BK", [(2, 128, 256, 4, 32, 128),
                                           (2, 512, 2048, 12, 64, 512),
                                           (1, 256, 1024, 2, 128, 512)])
def test_cp_stream_attention_kernel_matches_plain(cuda, B, Lc, L, H, D, BK):
    """K8b: the streamed CP kernel against its block-walking plain
    version."""
    rng = np.random.default_rng(L + BK)
    q, kv, lens = _cp_operands(rng, B, Lc, L, H, D, cuda, False)
    kw = dict(B=B, Lc=Lc, L=L, H=H, D=D, BK=BK)
    wrapper = A.fused_attention_cp_stream
    before = wrapper.launches, dict(wrapper.routes)
    got = wrapper(q, kv, lens, **kw)
    assert wrapper.launches == before[0] + 1
    _one_sm90_launch(wrapper, before[1])
    _close(got, A.fused_attention_cp_stream_ref(q, kv, lens, **kw), 2 ** -6,
           1e-2)


@pytest.mark.parametrize("stream,B,Lc,L,H,D", [
    (True, 4, 512, 2048, 12, 64),    # nomic's shard
    (False, 16, 256, 512, 12, 64),   # bge's shard
    (False, 3, 256, 640, 4, 128),    # 5 key tiles
    (False, 2, 72, 200, 4, 32)])
def test_cp_lengths_end_inside_a_key_tile(cuda, stream, B, Lc, L, H, D):
    """K8a / K8b with each shard's lengths ending inside a 128-key tile
    (and a len-0 row): K2's tolerance, the len-0 row exactly 0."""
    rng = np.random.default_rng(L + B)
    q, kv, _ = _cp_operands(rng, B, Lc, L, H, D, cuda, not stream)
    ends = [0] + [min(L - 1, 128 * int(k) + 1 + int(rng.integers(0, 126)))
                  for k in rng.integers(0, -(-L // 128), B - 1)]
    lens = torch.tensor(ends, dtype=torch.int32, device=cuda)
    kw = dict(B=B, Lc=Lc, L=L, H=H, D=D)
    if stream:
        kw["BK"] = A.pick_bk(L)
        wrapper, plain = A.fused_attention_cp_stream, \
            A.fused_attention_cp_stream_ref
    else:
        wrapper, plain = A.fused_attention_cp, A.fused_attention_cp_ref
    got = wrapper(q, kv, lens, **kw)
    _close(got, plain(q, kv, lens, **kw), 2 ** -6, 1e-2)
    assert (got.reshape(B, Lc, -1)[0] == 0).all()


def test_cp_attention_kernel_refuses_bad_operands(cuda):
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    kv = torch.zeros(2 * 64, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        A.fused_attention_cp(torch.zeros(32, 128, device=cuda), kv, lens,
                             B=2, Lc=16, L=64, H=2, D=64)
    with pytest.raises(ValueError):  # a column stride that is not 1
        q = torch.zeros(128, 32, device=cuda, dtype=torch.bfloat16).t()
        A.fused_attention_cp(q, kv, lens, B=2, Lc=16, L=64, H=2, D=64)


def test_cp_forward_matches_single_device(cuda):
    """A small CP forward on a 2 x 2 mesh of the card (K8a on every layer
    of every shard) against the single-device forward (K2), bf16."""
    from embeddings_tpu_torch.config import BertConfig
    from embeddings_tpu_torch.models import bert, params as P
    from embeddings_tpu_torch.parallel import make_cp_forward, make_mesh_cp
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128, pooling="mean")
    tree = P.to_device(P.pack_q4_params(P.quantize_params(
        P.init_params(cfg, 0), "q4_0")), cuda)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, 512, (4, 128)).astype(np.int32))
    mask = torch.ones(4, 128, dtype=torch.int32)
    mask[1, 40:] = 0
    fwd = make_cp_forward(cfg, make_mesh_cp(2, 2, [cuda] * 4),
                          compute_dtype=torch.bfloat16)
    before = A.fused_attention_cp.launches
    got = fwd(tree, ids, mask)
    assert A.fused_attention_cp.launches == before + 2 * 4
    ref = bert.encode_tokens(P.fuse_qkv(tree), cfg, ids.to(cuda),
                             mask.to(cuda), compute_dtype=torch.bfloat16)
    cos = (got * ref).sum(-1)
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_tp_forward_matches_single_device(cuda, dp, tp):
    """A small Megatron TP forward on a dp x tp mesh of the card (every
    shard: K1 on its column and row slices, the row-parallel ones with no
    epilogue, and K2 on its H/tp heads) against the single-device
    forward, bf16."""
    from embeddings_tpu_torch.config import BertConfig
    from embeddings_tpu_torch.models import bert, params as P
    from embeddings_tpu_torch.parallel import make_mesh, make_sharded_forward
    cfg = BertConfig(vocab_size=512, hidden_size=512, num_hidden_layers=2,
                     num_attention_heads=8, intermediate_size=1024,
                     max_position_embeddings=128, pooling="mean")
    tree = P.pack_q4_params(P.quantize_params(P.init_params(cfg, 0),
                                              "q4_0"))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(5, 512, (4, 128)).astype(np.int32))
    mask = torch.ones(4, 128, dtype=torch.int32)
    mask[1, 40:] = 0
    fwd = make_sharded_forward(cfg, make_mesh(dp, tp, [cuda] * (dp * tp)),
                               compute_dtype=torch.bfloat16)
    k1, k2 = qmatmul.launches, fused_attention.launches
    got = fwd(tree, ids, mask)
    assert qmatmul.launches == k1 + 2 * 6 * dp * tp
    assert fused_attention.launches == k2 + 2 * dp * tp
    ref = bert.encode_tokens(P.to_device(P.fuse_qkv(tree), cuda), cfg,
                             ids.to(cuda), mask.to(cuda),
                             compute_dtype=torch.bfloat16)
    cos = (got * ref).sum(-1)
    assert cos.min() >= 0.999, cos


ENCODER_FAMILIES = {
    "roberta": dict(max_position_embeddings=130, type_vocab_size=1,
                    position_offset=2),
    "distilbert": dict(type_vocab_size=1),
    "roformer": dict(position_embedding_type="rotary",
                     rotary_interleaved=True),
    "albert": dict(num_hidden_layers=3, embedding_size=64,
                   shared_layers=True, hidden_act="gelu_tanh"),
}


@pytest.mark.parametrize("family", list(ENCODER_FAMILIES))
def test_encoder_family_forward_matches_plain(cuda, family):
    """RoBERTa, DistilBERT, RoFormer and ALBERT (one shared layer applied
    three times, its 64-wide embeddings projected): the card's forward
    (K1 and K2 on every layer application, bf16) against the plain f32
    forward on the CPU, the same q4_0 tree."""
    from embeddings_tpu_torch.config import BertConfig
    from embeddings_tpu_torch.models import bert, params as P
    cfg = BertConfig(**{"vocab_size": 512, "hidden_size": 256,
                        "num_hidden_layers": 2, "num_attention_heads": 4,
                        "intermediate_size": 512,
                        "max_position_embeddings": 256, "pooling": "mean",
                        **ENCODER_FAMILIES[family]})
    tree = P.fuse_qkv(P.pack_q4_params(P.quantize_params(
        P.init_params(cfg, 0), "q4_0")))
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(5, 512, (4, 128)).astype(np.int32))
    mask = torch.ones(4, 128, dtype=torch.int32)
    mask[1, 40:] = 0
    mask[2, 1:] = 0
    before = (qmatmul.launches, fused_attention.launches)
    got = bert.encode_tokens(P.to_device(tree, cuda), cfg, ids.to(cuda),
                             mask.to(cuda), compute_dtype=torch.bfloat16)
    NL = cfg.num_hidden_layers
    assert (qmatmul.launches - before[0],
            fused_attention.launches - before[1]) == (4 * NL, NL)
    ref = bert.encode_tokens(tree, cfg, ids, mask, use_kernels=False)
    cos = (got.cpu() * ref).sum(-1)
    assert torch.isfinite(got).all() and cos.min() >= 0.999, cos


def _file_tree(cfg):
    from embeddings_tpu_torch.models import params as P
    return P.init_params(cfg, 0)


@pytest.mark.parametrize("fmt,file_dtype,load_dtype", [
    ("gguf", "q4_0", "q4_0"), ("gguf", "q4_0", "f32"), ("gguf", "q8_0", "f32"),
    ("bin", "q4_1", "f32")])
def test_file_loaded_engine_matches_plain(cuda, tmp_path, fmt, file_dtype,
                                          load_dtype):
    """An engine loaded from the port's own .bin / .gguf file: each
    quantized weight reaches K1 as the file gave it (packed for a q4
    dtype, int8 codes otherwise), 4 K1 + 1 K2 a layer, against the plain
    f32 forward of the same loaded tree."""
    from embeddings_tpu_torch.config import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import ggml_io, gguf_io
    from embeddings_tpu_torch.ops.quant import PACK4_KINDS
    from embeddings_tpu_torch.runtime.engine import Engine, load_model
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128, pooling="cls")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(507)]
    path = tmp_path / f"m.{fmt}"
    (ggml_io.write_ggml if fmt == "bin" else gguf_io.write_gguf)(
        path, _file_tree(cfg), cfg, vocab, dtype=file_dtype)
    eng = load_model(path, dtype=load_dtype, pooling="cls", device=cuda)
    w = eng.params["layers"]["attn"]["qkv"]["w"]
    assert w.kind == file_dtype and w.packed == (load_dtype in PACK4_KINDS)
    rng = np.random.default_rng(3)
    ids = rng.integers(5, 512, (4, 128)).astype(np.int32)
    mask = np.ones((4, 128), np.int32)
    mask[1, 40:] = 0
    before = (qmatmul.launches, fused_attention.launches)
    got = eng.forward(ids, mask)
    assert (qmatmul.launches - before[0],
            fused_attention.launches - before[1]) == (8, 2)
    plain = Engine(eng.params, eng.config, eng.tokenizer,
                   EngineConfig(use_pallas="never", compute_dtype="float32"),
                   device=cuda)
    cos = (got * plain.forward(ids, mask)).sum(-1)
    assert np.isfinite(got).all() and cos.min() >= 0.999, cos


def test_reranker_matches_plain(cuda):
    """A q4_0 cross-encoder (RoBERTa-style head) through Engine.rerank:
    4 K1 + 1 K2 a layer; its logits against the plain f32 path's at
    Pearson >= 0.99 (random-init logits vary little across documents:
    see chip_smoke.RERANK_PEARSON)."""
    from embeddings_tpu_torch.config import BertConfig, EngineConfig
    from embeddings_tpu_torch.models import params as P
    from embeddings_tpu_torch.runtime.engine import Engine
    from embeddings_tpu_torch.tokenizer import WordPieceTokenizer, \
        WordPieceVocab
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128)
    tree = P.init_params(cfg, 0)
    rng = np.random.default_rng(4)

    def lin(n):
        return {"w": torch.from_numpy(rng.standard_normal(
            (256, n), dtype=np.float32) * np.float32(0.05)),
            "b": torch.zeros(n)}

    tree["cls_head"] = {"dense": lin(256), "out": lin(1)}
    tree = P.fuse_qkv(P.pack_q4_params(P.quantize_params(tree, "q4_0")))
    tok = WordPieceTokenizer(WordPieceVocab.from_tokens(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"w{i}" for i in range(507)]))
    docs = [" ".join(f"w{j}" for j in rng.integers(0, 507, int(k)))
            for k in rng.integers(3, 60, 64)]
    eng = Engine(tree, cfg, tok, EngineConfig(batch_size=64), device=cuda)
    plain = Engine(tree, cfg, tok, EngineConfig(
        batch_size=64, use_pallas="never", compute_dtype="float32"),
        device=cuda)
    before = (qmatmul.launches, fused_attention.launches)
    got = eng.rerank("w1 w2 w3", docs)
    n = (fused_attention.launches - before[1]) // 2
    assert n >= 1 and (qmatmul.launches - before[0]) == 8 * n
    ref = plain.rerank("w1 w2 w3", docs)
    assert np.isfinite(got).all() and got.shape == (64,)
    assert np.corrcoef(got, ref)[0, 1] >= 0.99


# ---------------------------------------------------------------------------
# a launch on its operands' card, another than the current one
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda1(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.parametrize("epilogue", ["bias", "bias_residual_ln"])
def test_k1_on_another_card(cuda1, epilogue):
    """K1 on cuda:1 while cuda:0 is current: it launches there (its
    device guard) and matches its plain version; an operand left on
    cuda:0 is refused by name."""
    rng = np.random.default_rng(21)
    M, K, N = 300, 768, 768
    w = rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)
    qt = quantize(w, "q4_0", pack4=True).map(lambda t: t.to(cuda1))

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(cuda1)

    kw = dict(kind="q4_0", epilogue=epilogue, packed=True)
    if epilogue == "bias_residual_ln":
        kw.update(residual=f32(M, N).to(torch.bfloat16),
                  ln_scale=1 + f32(N, scale=0.1), ln_bias=f32(N, scale=0.1))
    args = (f32(M, K).to(torch.bfloat16), qt.codes, qt.scales, None,
            f32(N, scale=0.1))
    before = qmatmul.launches
    got = qmatmul(*args, **kw)
    assert qmatmul.launches == before + 1 and got.device == cuda1
    assert torch.cuda.current_device() == 0
    _close(got, qmatmul_ref(*args, **kw), 2 ** -7, 1e-3)
    with pytest.raises(ValueError, match="operand bias is on cuda:0"):
        qmatmul(*args[:4], args[4].to("cuda:0"), **kw)


def test_k2_on_another_card(cuda1):
    """K2 on cuda:1 while cuda:0 is current, against its plain version;
    lengths on cuda:0 are refused by name."""
    rng = np.random.default_rng(22)
    B, L, H, D = 8, 256, 12, 64
    qkv = torch.from_numpy(rng.standard_normal(
        (B * L, 3 * H * D), dtype=np.float32)).to(cuda1, torch.bfloat16)
    lens = torch.tensor([0, 1, 63, 64, 129, 200, 255, 256],
                        dtype=torch.int32, device=cuda1)
    got = fused_attention(qkv, lens, B=B, L=L, H=H, D=D)
    assert got.device == cuda1 and torch.cuda.current_device() == 0
    _close(got, fused_attention_ref(qkv, lens, B=B, L=L, H=H, D=D),
           2 ** -6, 1e-2)
    with pytest.raises(ValueError, match="operand lengths is on cuda:0"):
        fused_attention(qkv, lens.to("cuda:0"), B=B, L=L, H=H, D=D)
