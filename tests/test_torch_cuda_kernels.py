"""The CUDA kernels of ray_tpu_torch against their plain PyTorch versions,
on a card. They have no CPU mode, so every test here skips where CUDA is
absent. This file imports no jax, so that it runs where jax is missing:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerance: 1e-5 in f32 (same arithmetic, sums in another order); 2^-7
in bf16 (both round an f32 result to bf16 once, so they differ by at
most one bf16 ulp of outputs below 2).
"""

import pytest
import torch

from ray_tpu_torch.ops import decode_attention as tdec
from ray_tpu_torch.ops import paged_decode_attention as tpaged

B, H, KV, D, NB, BS, MBS = 6, 8, 2, 128, 20, 16, 4
LENGTHS = [0, 1, BS, 37, MBS * BS, MBS * BS + 1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(device, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=gen, device=device).to(dtype)
    kp = torch.randn(NB, BS, KV, D, generator=gen, device=device).to(dtype)
    vp = torch.randn(NB, BS, KV, D, generator=gen, device=device).to(dtype)
    perm = torch.randperm(NB - 1, generator=gen, device=device) + 1
    tables = torch.zeros(B, MBS, dtype=torch.int32, device=device)
    for b, n in enumerate(LENGTHS):
        nblk = min(-(-n // BS), MBS)
        tables[b, :nblk] = perm[(b * MBS) % (NB - MBS):][:nblk]
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    return q, kp, vp, tables, lengths


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(cuda_device, dtype):
    q, kp, vp, tables, lengths = _inputs(cuda_device, dtype)
    n = tpaged.paged_decode_attention.launches
    got = tpaged.paged_decode_attention(q, kp, vp, tables, lengths,
                                        scale=D ** -0.5)
    torch.cuda.synchronize()
    assert tpaged.paged_decode_attention.launches == n + 1
    want = tpaged.paged_attention_reference(q, kp, vp, tables, lengths,
                                            scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.count_nonzero(got[0]) == 0          # length 0 → 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_kernel_matches_plain(cuda_device, dtype):
    q, kp, _, _, lengths = _inputs(cuda_device, dtype, seed=1)
    kc = kp[:B].contiguous()                 # S = BS; lengths reach S + 1
    vc = kp[B:2 * B].contiguous()
    n = tdec.decode_attention.launches
    got = tdec.decode_attention(q, kc, vc, lengths, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n + 1
    want = tdec.decode_attention_reference(q, kc, vc, lengths,
                                           scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.cuda
def test_kernels_refuse_unsupported_dtype(cuda_device):
    q, kp, vp, tables, lengths = _inputs(cuda_device, torch.float16)
    with pytest.raises(TypeError):
        tpaged.paged_decode_attention(q, kp, vp, tables, lengths, scale=1.0)
    with pytest.raises(TypeError):
        tdec.decode_attention(q, kp[:B], vp[:B], lengths, scale=1.0)
