"""The decode-attention ops of ray_tpu_torch (ports of TPU kernels K3,
paged decode, and K4, slot decode) on the CPU, where their wrappers take
the plain versions: held against the JAX Pallas kernels run in interpret
mode, as the JAX package's own tests run them, and against the JAX gather
oracle. The CUDA kernels themselves are held against the plain versions on
a card by tests/test_torch_cuda_kernels.py.

Tolerance: 1e-5 absolute and relative in f32 — the same softmax computed
in one pass (plain) and as an online recurrence over blocks (kernel),
whose sums differ in order only. The bf16 case holds the port's plain
version to the JAX oracle on identical bf16 inputs to one bf16 rounding
of the output (2^-7 relative), since both work in f32 and round once.
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import decode_attention as jdec
from ray_tpu.ops.pallas import paged_decode_attention as jpaged
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import decode_attention as tdec
from ray_tpu_torch.ops import paged_decode_attention as tpaged

from _torch_isolation import _module_isolation_guard  # noqa: F401

B, H, KV, D, NB, BS, MBS = 6, 4, 2, 16, 11, 8, 3
# lengths: empty slot, 1, one block, a non-multiple, full, stale (> MBS*bs)
PAGED_LENGTHS = [0, 1, BS, 13, MBS * BS, MBS * BS + 1]
# non-contiguous, out-of-order tables; the empty slot's row is the null
# block, and rows past each prefix name block 0
TABLES = [[0, 0, 0], [7, 0, 0], [2, 9, 0], [10, 1, 0], [5, 3, 8],
          [4, 6, 1]]


def _paged_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    return (q, kp, vp, np.asarray(TABLES, np.int32),
            np.asarray(PAGED_LENGTHS, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_paged_plain_matches_jax_kernel_interpret():
    q, kp, vp, tables, lengths = _paged_inputs()
    want = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths), scale=D ** -0.5,
        interpret=True)
    got = tpaged.paged_decode_attention(*_torch(q, kp, vp, tables, lengths),
                                        scale=D ** -0.5)
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[0] == 0.0)     # length 0 → 0 (l_safe)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_plain_matches_jax_reference(dtype):
    """Against the JAX gather oracle, for every slot of nonzero length
    (the oracle averages V over an empty slot; both kernels give 0)."""
    q, kp, vp, tables, lengths = _paged_inputs(1)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = jpaged.paged_attention_reference(
        jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        jnp.asarray(tables), jnp.asarray(lengths), scale=D ** -0.5)
    qt, kt, vt, tt, lt = _torch(q, kp, vp, tables, lengths)
    got = tpaged.paged_attention_reference(
        qt.to(td), kt.to(td), vt.to(td), tt, lt, scale=D ** -0.5)
    assert got.dtype == td
    want = np.asarray(want.astype(jnp.float32))[1:]
    got = got.float().numpy()[1:]
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("group", [1, 2])
def test_slot_plain_matches_jax_kernel_interpret(group):
    S, block_s = 144, 48
    h = KV * group
    rng = np.random.default_rng(2)
    # empty, 1, a non-multiple, either side of the kernel's first split
    # boundary (SPLIT_ROWS = 128), full, stale (S + 1)
    lengths = np.asarray([0, 1, 21, 127, 128, 129, S, S + 1], np.int32)
    assert tdec.SPLIT_ROWS == 128
    n = len(lengths)
    q = rng.standard_normal((n, 1, h, D)).astype(np.float32)
    kc = rng.standard_normal((n, S, KV, D)).astype(np.float32)
    vc = rng.standard_normal((n, S, KV, D)).astype(np.float32)
    want = jdec.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), scale=D ** -0.5, block_s=block_s,
        interpret=True)
    got = tdec.decode_attention(*_torch(q, kc, vc, lengths),
                                scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[0] == 0.0)


def test_slot_plain_equals_paged_plain_on_same_rows():
    """A contiguous cache is a paged pool whose table is the identity:
    the two plain versions agree."""
    q, kp, vp, _, _ = _paged_inputs(3)
    lengths = np.asarray([1, 5, 8, 17, 24, 0], np.int32)
    # slot b owns blocks [3b/2 ...]: build both layouts from one pool
    tables = np.arange(B * MBS, dtype=np.int32).reshape(B, MBS) % NB
    kc = kp[tables].reshape(B, MBS * BS, KV, D)
    vc = vp[tables].reshape(B, MBS * BS, KV, D)
    a = tpaged.paged_attention_reference(*_torch(q, kp, vp, tables, lengths),
                                         scale=0.3)
    b = tdec.decode_attention_reference(*_torch(q, kc, vc, lengths),
                                        scale=0.3)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, kp, vp, tables, lengths = _paged_inputs()
    before = (tpaged.paged_decode_attention.launches,
              tdec.decode_attention.launches)
    tpaged.paged_decode_attention(*_torch(q, kp, vp, tables, lengths),
                                  scale=1.0)
    kc = torch.zeros(B, 8, KV, D)
    tdec.decode_attention(torch.from_numpy(q), kc, kc,
                          torch.from_numpy(lengths), scale=1.0)
    assert (tpaged.paged_decode_attention.launches,
            tdec.decode_attention.launches) == before


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 1, 2, 16, device="meta")
    kv = torch.zeros(1, 4, 1, 16, device="meta")
    n = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_attention(q, kv, kv, n, scale=1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tpaged.paged_decode_attention(
            q, kv, kv, torch.zeros(1, 1, dtype=torch.int32, device="meta"),
            n, scale=1.0)


@pytest.mark.parametrize("case,exc", [
    ("fp16", TypeError), ("mixed", TypeError), ("strided", ValueError),
    ("int64_index", TypeError), ("head_bytes", ValueError)])
def test_kernel_operand_checks(case, exc):
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    lens = torch.zeros(2, dtype=torch.int32)
    D = 16
    if case == "fp16":
        q, k = q.half(), k.half()
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "strided":
        k = torch.zeros(2, 8, 2, 32)[..., ::2]
    elif case == "int64_index":
        lens = lens.long()
    elif case == "head_bytes":
        q, k, D = q[..., :2].contiguous(), k[..., :2].contiguous(), 2
    with pytest.raises(exc):
        tdec.check_operands(q, k, k, (lens,), D)
    assert tdec.check_operands(torch.zeros(2, 1, 4, 16),
                               torch.zeros(2, 8, 2, 16),
                               torch.zeros(2, 8, 2, 16),
                               (torch.zeros(2, dtype=torch.int32),), 16) == 0


def test_launch_argtypes_match_cuda_source():
    """The ctypes signatures of both decode wrappers against the
    ``extern "C"`` launch functions of ``csrc/decode_attention.cu``: a
    pointer in an int's place would be cut to 32 bits, and only the card
    could show it."""
    from test_torch_flash_attention import _launch_params

    with open(os.path.join(_build.CSRC, "decode_attention.cu")) as f:
        params = _launch_params(f.read())
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    argtypes = {**tdec.ARGTYPES, **tpaged.ARGTYPES}
    assert set(params) == set(argtypes)
    for name, types in argtypes.items():
        assert [kind[t] for t in types] == params[name], name
    # both take their workspace (partials, arrivals) after out
    assert params["paged_decode_attention_launch"][:8] == ["ptr"] * 8
    assert params["decode_attention_launch"][:7] == ["ptr"] * 7


def test_paged_split_workspace_is_kept_and_grown():
    """K3's splits are whole pool blocks of about SPLIT_ROWS rows, K4's
    SPLIT_ROWS rows; both kernels share one workspace, allocated once per
    device and grown, never shrunk, whose new arrival tickets start at
    zero, sized B·KV tickets and B·H·splits·(D+2) partials."""
    assert tpaged.SPLIT_ROWS is tdec.SPLIT_ROWS
    assert [tpaged.blocks_per_split(bs) for bs in (16, 64, 128, 256)] == \
        [8, 2, 1, 1]
    assert [tdec.slot_splits(S) for S in (1, 128, 129, 2048, 2049)] == \
        [1, 1, 2, 16, 17]
    dev = torch.device("cpu")
    saved = tdec._scratch.pop(dev, None)
    try:
        # K4 at B=3, H=8, KV=2, D=16, S=300: three splits a slot
        arrivals, partials = tdec.workspace(dev, 3, 8, 2, 16,
                                            tdec.slot_splits(300))
        assert arrivals.numel() == 3 * 2 and not arrivals.any()
        assert partials.numel() == 3 * 8 * 3 * 18
        # a smaller call, from either wrapper, takes the same tensors
        again = tpaged.workspace(dev, 1, 8, 2, 16, 1)
        assert again[0] is arrivals and again[1] is partials
        # a larger one grows them; new tickets start at zero
        grown, same = tdec.workspace(dev, 4, 8, 2, 16, 1)
        assert grown.numel() == 8 and not grown.any() and same is partials
    finally:
        tdec._scratch.pop(dev, None)
        if saved is not None:
            tdec._scratch[dev] = saved


@pytest.mark.parametrize("D,group,ok", [
    (16, 1, True), (128, 8, True), (64, 4, True), (32, 2, True),
    (256, 4, False), (8, 1, False), (48, 2, False), (64, 3, False),
    (128, 16, False)])
def test_decode_kernels_refuse_unsupported_shapes(D, group, ok):
    """Both decode wrappers ask check_supported before a launch: head dims
    16-128 and groups 1-8 have an instantiation, anything else raises."""
    for kernel in ("decode_attention_kernel", "paged_decode_attention_kernel"):
        if ok:
            tdec.check_supported(D, group, kernel)
        else:
            with pytest.raises(ValueError, match=kernel):
                tdec.check_supported(D, group, kernel)


def test_build_reports_compiler_failure(tmp_path, monkeypatch):
    """The build runs nvcc per stale source and raises with its output;
    no partial library is left behind."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    assert "decode_attention" in _build.sources()
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(["decode_attention"])
    assert list((tmp_path / "build").iterdir()) == []
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("decode_attention")
