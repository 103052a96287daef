"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; on the
H100 run them without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: kernel and plain version round the same
bf16 operands and accumulate in f32 in different orders, so outputs
differ by bf16 rounding flips (K1: 2^-7 relative + 1e-3 of the output
RMS; K2, whose probabilities are also rounded to bf16: 2^-6 + 1e-2).
"""

import numpy as np
import pytest
import torch

from embeddings_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_ref)
from embeddings_tpu_torch.ops.qmatmul import EPILOGUES, qmatmul, \
    qmatmul_ref
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


@pytest.mark.parametrize("B,L,H,D", [(3, 16, 12, 64), (2, 72, 4, 32),
                                     (2, 128, 2, 128), (4, 512, 12, 64)])
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


def test_kernels_raise_on_wrong_dtype(cuda):
    qt = quantize(np.zeros((64, 64), np.float32), "q4_0").map(
        lambda t: t.to(cuda))
    with pytest.raises(TypeError):
        qmatmul(torch.zeros(8, 64, device=cuda), qt.codes, qt.scales)
    with pytest.raises(TypeError):
        fused_attention(torch.zeros(16, 384, device=cuda),
                        torch.ones(1, dtype=torch.int32, device=cuda),
                        B=1, L=16, H=2, D=64)
