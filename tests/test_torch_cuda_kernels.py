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

from _torch_isolation import _module_isolation_guard  # noqa: F401

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


# K3 is split-KV: a split is blocks_per_split(bs) pool blocks, and the
# lengths below end on a split boundary, one past it, inside the first
# split, at the table's capacity (every split) and past it (a stale slot).
SPLIT_CASES = [  # B, H, KV, D, bs, MBS
    (7, 8, 2, 128, 16, 24),            # group 4, three splits of 8 blocks
    (7, 8, 8, 64, 64, 6),              # group 1, three splits of 2 blocks
    (7, 16, 2, 128, 32, 12),           # group 8
    (7, 16, 2, 64, 64, 5),             # group 8, a short last split
    (1, 8, 1, 128, 64, 32),            # one slot, full: sixteen splits
]


def _split_inputs(device, dtype, B, H, KV, D, bs, MBS, seed=0):
    split = tpaged.blocks_per_split(bs) * bs
    cap = MBS * bs
    lengths = ([split, split + 1, 0, 1, cap, cap + 1, 2 * split - 1][:B]
               if B > 1 else [cap])
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = B * MBS + 1
    perm = torch.randperm(nb - 1, generator=gen, device=device) + 1
    tables = torch.zeros(B, MBS, dtype=torch.int32, device=device)
    for b, n in enumerate(lengths):
        nblk = min(-(-n // bs), MBS)
        tables[b, :nblk] = perm[b * MBS:b * MBS + nblk]

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return (rand(B, 1, H, D), rand(nb, bs, KV, D), rand(nb, bs, KV, D),
            tables, torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_split_kernel_matches_plain(cuda_device, dtype, case):
    q, kp, vp, tables, lengths = _split_inputs(cuda_device, dtype, *case)
    D = case[3]
    got = tpaged.paged_decode_attention(q, kp, vp, tables, lengths,
                                        scale=D ** -0.5)
    torch.cuda.synchronize()
    want = tpaged.paged_attention_reference(q, kp, vp, tables, lengths,
                                            scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    for b, n in enumerate(lengths.tolist()):
        if n == 0:
            assert torch.count_nonzero(got[b]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_kernel_deterministic(cuda_device, dtype):
    """The splits' partials are combined in split order, whichever split
    finishes last: two runs agree bit for bit."""
    args = _split_inputs(cuda_device, dtype, *SPLIT_CASES[0])
    first = tpaged.paged_decode_attention(*args, scale=0.1)
    second = tpaged.paged_decode_attention(*args, scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# K4 shares K3's split-KV body over contiguous rows: splits of SPLIT_ROWS
# rows of the (B, S, KV, D) cache. Lengths end on a split boundary, either
# side of it, inside the first split, at S (every split) and past it (a
# stale slot reads S rows).
SLOT_SPLIT_CASES = [  # H, KV, D, S
    (8, 8, 16, 300),                   # group 1, three splits, a short last
    (8, 4, 32, 256),                   # group 2
    (8, 2, 64, 384),                   # group 4
    (16, 2, 128, 300),                 # group 8
    (32, 8, 128, 2048),                # 8b's heads and cache: sixteen splits
    (32, 8, 64, 2048),                 # the 1b draft's heads and cache
]


def _slot_split_inputs(device, dtype, H, KV, D, S, seed=0):
    split = tdec.SPLIT_ROWS
    lengths = [split - 1, split, split + 1, 0, 1, S, S + 1, 2 * split + 1]
    B = len(lengths)
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return (rand(B, 1, H, D), rand(B, S, KV, D), rand(B, S, KV, D),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SLOT_SPLIT_CASES)
def test_slot_split_kernel_matches_plain(cuda_device, dtype, case):
    """K4 against its plain version at split-boundary lengths, and bit for
    bit equal to itself in a second run (splits combine in split order)."""
    q, kc, vc, lengths = _slot_split_inputs(cuda_device, dtype, *case)
    D = case[2]
    n = tdec.decode_attention.launches
    got = tdec.decode_attention(q, kc, vc, lengths, scale=D ** -0.5)
    again = tdec.decode_attention(q, kc, vc, lengths, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n + 2
    assert torch.equal(got, again)
    want = tdec.decode_attention_reference(q, kc, vc, lengths,
                                           scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.count_nonzero(got[lengths.tolist().index(0)]) == 0


@pytest.mark.cuda
def test_kernels_refuse_unsupported_dtype(cuda_device):
    q, kp, vp, tables, lengths = _inputs(cuda_device, torch.float16)
    with pytest.raises(TypeError):
        tpaged.paged_decode_attention(q, kp, vp, tables, lengths, scale=1.0)
    with pytest.raises(TypeError):
        tdec.decode_attention(q, kp[:B], vp[:B], lengths, scale=1.0)


# ------------------------------------------------------------ flash (K1, K2)
# Tolerance: row by row (one position of one head), ||got_r - want_r|| <=
# rtol ||want_r|| + atol rms_r, as ops/flash_attention.py's TOLERANCE states
# with its reasons (in bf16 the kernels round P, and in the backward dS, to
# bf16 for the tensor cores where the plain version keeps f32). The
# backward is one kernel in bf16 (flash_bwd_kernel) and two in f32 (K2a,
# K2b).

FLASH_CASES = [  # B, Hq, Hkv, Sq, Skv, D, causal
    (2, 4, 2, 128, 128, 64, True),
    (1, 2, 1, 80, 80, 32, True),       # ragged tile tails
    (1, 2, 2, 100, 77, 128, False),    # Sq != Skv, group 1
    (2, 4, 1, 33, 33, 16, True),
    (1, 8, 2, 200, 200, 64, True),     # group 4, ragged past two kv tiles
]
BWD_KERNELS = {torch.float32: ("dq", "dkv"), torch.bfloat16: ("bwd",)}


def _flash_inputs(device, dtype, B, Hq, Hkv, Sq, Skv, D, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return (rand(B, Hq, Sq, D), rand(B, Hkv, Skv, D), rand(B, Hkv, Skv, D),
            rand(B, Hq, Sq, D))


def _close(got, want):
    from ray_tpu_torch.ops import flash_attention as tfa

    res = tfa.mismatch(got, want)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, dtype, case):
    from ray_tpu_torch.ops import flash_attention as tfa

    B, Hq, Hkv, Sq, Skv, D, causal = case
    q, k, v, do = _flash_inputs(cuda_device, dtype, B, Hq, Hkv, Sq, Skv, D)
    scale = D ** -0.5
    n_fwd = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == n_fwd + 1
    want_out, want_lse = tfa.flash_attention_fwd_reference(
        q, k, v, causal=causal, scale=scale)
    _close(out, want_out)
    _close(lse, want_lse)                    # f32 in both dtypes
    delta = (do.float() * want_out.float()).sum(-1)
    n = dict(tfa.flash_attention_bwd.launches)
    got = tfa.flash_attention_bwd(q, k, v, want_lse, delta, do,
                                  causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == {
        key: count + (key in BWD_KERNELS[dtype]) for key, count in n.items()}
    want = tfa.flash_attention_bwd_reference(q, k, v, want_lse, delta, do,
                                             causal=causal, scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_bf16_matches_plain(cuda_device, causal):
    """flash_attention_with_lse in bf16 (K1, then K2a and K2b through its
    autograd function) against the plain versions on the same tensors,
    with a loss that reads lse so that dlse reaches delta."""
    from ray_tpu_torch.ops import attention as tattn
    from ray_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    q, k, v = (rand(2, 200, h, 64).bfloat16().requires_grad_()
               for h in (4, 2, 2))
    w, wl = rand(2, 200, 4, 64).bfloat16(), rand(2, 4, 200)
    out, lse = tattn.flash_attention_with_lse(q, k, v, causal=causal)
    ((out.float() * w.float()).sum() + (lse * wl).sum()).backward()
    qh, kh, vh, dout = (t.detach().transpose(1, 2).contiguous()
                        for t in (q, k, v, w))
    out, lse = out.detach().transpose(1, 2), lse.detach()
    kw = dict(causal=causal, scale=64 ** -0.5)
    out_r, lse_r = tfa.flash_attention_fwd_reference(qh, kh, vh, **kw)
    _close(out, out_r)
    _close(lse, lse_r)
    delta = (dout.float() * out.float()).sum(-1) - wl
    want = tfa.flash_attention_bwd_reference(qh, kh, vh, lse, delta, dout,
                                             **kw)
    for t, r in zip((q, k, v), want):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad, r.transpose(1, 2))


@pytest.mark.cuda
def test_flash_bwd_bf16_dk_dv_deterministic(cuda_device):
    """dK and dV sum their GQA group in registers, in a fixed order: two
    runs agree bit for bit. (dQ is summed across kv tiles by reduce-adds
    in L2, in no fixed order, so only its tolerance holds.)"""
    from ray_tpu_torch.ops import flash_attention as tfa

    q, k, v, do = _flash_inputs(cuda_device, torch.bfloat16, 2, 8, 2, 300,
                                300, 64)
    kw = dict(causal=True, scale=64 ** -0.5)
    out, lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    first = tfa.flash_attention_bwd(q, k, v, lse, delta, do, **kw)
    second = tfa.flash_attention_bwd(q, k, v, lse, delta, do, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    want = tfa.flash_attention_bwd_reference(q, k, v, lse, delta, do, **kw)
    for a, b, w in zip(first, second, want):
        _close(a, w)
        _close(b, w)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_fwd_bf16_matches_plain(cuda_device, D, causal, group):
    """The bf16 forward (128 q rows a block, 128 kv rows a tile) at every
    head dim, with q and kv lengths that are no multiple of either tile
    (Sq != Skv without the causal mask)."""
    from ray_tpu_torch.ops import flash_attention as tfa

    Sq, Skv = (200, 200) if causal else (150, 263)
    q, k, v, _ = _flash_inputs(cuda_device, torch.bfloat16, 1, 2 * group, 2,
                               Sq, Skv, D)
    kw = dict(causal=causal, scale=D ** -0.5)
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    _close(out, want_out)
    _close(lse, want_lse)


def _fwd_matches_plain(device, dtype, D, causal, group, Sq, Skv):
    from ray_tpu_torch.ops import flash_attention as tfa

    q, k, v, _ = _flash_inputs(device, dtype, 1, 2 * group, 2, Sq, Skv, D)
    kw = dict(causal=causal, scale=D ** -0.5)
    n = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == n + 1
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want_out)
    _close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_fwd_f32_matches_plain(cuda_device, D, causal, group):
    """The f32 forward (flash_fwd_f32_kernel: 64 x 64 tiles) at every head
    dim, with q and kv lengths that are no multiple of a tile (Sq != Skv
    without the causal mask)."""
    Sq, Skv = (200, 200) if causal else (150, 263)
    _fwd_matches_plain(cuda_device, torch.float32, D, causal, group, Sq, Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(150, 263), (263, 150)])
def test_flash_fwd_f32_causal_uneven_lengths(cuda_device, Sq, Skv):
    """Top-left causal with Sq != Skv: rows past Skv see every kv row, and
    the kv tiles past Sq are never read."""
    _fwd_matches_plain(cuda_device, torch.float32, 64, True, 4, Sq, Skv)


@pytest.mark.cuda
def test_flash_fwd_f32_deterministic(cuda_device):
    from ray_tpu_torch.ops import flash_attention as tfa

    q, k, v, _ = _flash_inputs(cuda_device, torch.float32, 2, 8, 2, 300,
                               300, 64)
    kw = dict(causal=True, scale=64 ** -0.5)
    first = tfa.flash_attention_fwd(q, k, v, **kw)
    second = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    want = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    for a, w in zip(first, want):
        _close(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_bwd_f32_matches_plain(cuda_device, D, causal, group):
    """The f32 backward (K2a dq, K2b dk/dv: 64 x 64 tiles) at every head
    dim, with lengths that are no multiple of a tile (Sq != Skv without
    the causal mask), against the plain version, and bit for bit equal to
    itself in a second run."""
    from ray_tpu_torch.ops import flash_attention as tfa

    Sq, Skv = (200, 200) if causal else (150, 263)
    q, k, v, do = _flash_inputs(cuda_device, torch.float32, 1, 2 * group, 2,
                                Sq, Skv, D)
    kw = dict(causal=causal, scale=D ** -0.5)
    out, lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do * out).sum(-1)
    n = dict(tfa.flash_attention_bwd.launches)
    first = tfa.flash_attention_bwd(q, k, v, lse, delta, do, **kw)
    second = tfa.flash_attention_bwd(q, k, v, lse, delta, do, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == {
        "bwd": n["bwd"], "dq": n["dq"] + 2, "dkv": n["dkv"] + 2}
    want = tfa.flash_attention_bwd_reference(q, k, v, lse, delta, do, **kw)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        _close(a, w)


@pytest.mark.cuda
def test_flash_fwd_bf16_deterministic(cuda_device):
    from ray_tpu_torch.ops import flash_attention as tfa

    q, k, v, _ = _flash_inputs(cuda_device, torch.bfloat16, 2, 8, 2, 300,
                               300, 64)
    kw = dict(causal=True, scale=64 ** -0.5)
    first = tfa.flash_attention_fwd(q, k, v, **kw)
    second = tfa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_kernels_refuse_operands(cuda_device):
    from ray_tpu_torch.ops import flash_attention as tfa

    q, k, v, _ = _flash_inputs(cuda_device, torch.float16, 1, 2, 1, 16, 16,
                               32)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, k, v, causal=True, scale=1.0)
    q, k, v, _ = _flash_inputs(cuda_device, torch.float32, 1, 2, 1, 16, 16,
                               48)
    with pytest.raises(ValueError):                  # head_dim 48
        tfa.flash_attention_fwd(q, k, v, causal=True, scale=1.0)
    q, k, v, _ = _flash_inputs(cuda_device, torch.float32, 1, 3, 2, 16, 16,
                               32)
    with pytest.raises(ValueError):                  # 3 heads over 2
        tfa.flash_attention_fwd(q, k, v, causal=True, scale=1.0)
    q, k, v, _ = _flash_inputs(cuda_device, torch.float32, 1, 2, 1, 16, 16,
                               32)
    with pytest.raises(ValueError):                  # not contiguous
        tfa.flash_attention_fwd(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v, causal=True,
                                scale=1.0)
