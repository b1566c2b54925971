"""ray_tpu_torch flash attention against the JAX package on the CPU.

The port's plain forward and backward (what its wrappers compute on CPU
tensors, and what the card's kernels are held to) against the Pallas TPU
kernels run in interpret mode, at the small ragged shapes of
``tests/test_ops.py`` (S=80, D=32, GQA group 1 and 2, causal and not) and
at group 4, D=64; the differentiable ``flash_attention_with_lse`` against
``jax.grad`` of the JAX frontend, with a loss that uses lse so that the
dlse cotangent is exercised; and, without a card, what the kernels'
bindings promise: the wrappers' ctypes signatures against the
``extern "C"`` launch functions of ``csrc/flash_attention.cu``, and which
dtype reaches which kernel.

Tolerance: f32 to 1e-5 (the same f32 formulas, summed in another order
and over other tiles).
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops.pallas.flash_attention import (flash_attention_bwd_pallas,
                                                flash_attention_fwd_pallas)
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tfa

from _torch_isolation import _module_isolation_guard  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(hkv, seed=0, b=1, s=80, hq=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check_plain_against_pallas(causal, hkv, hq=2, d=32, s=80):
    q, k, v, do = _inputs(hkv, hq=hq, d=d, s=s)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = flash_attention_fwd_pallas(
        jq, jk, jv, causal=causal, scale=scale, block_q=32, block_kv=32,
        interpret=True)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    n = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(*_t(q, k, v), causal=causal,
                                       scale=scale)
    assert tfa.flash_attention_fwd.launches == n
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)

    delta = (do * np.asarray(jout)).sum(-1)
    want = flash_attention_bwd_pallas(
        jq, jk, jv, jlse, jnp.asarray(delta), jdo, causal=causal,
        scale=scale, block_q=32, block_kv=32, interpret=True)
    n = dict(tfa.flash_attention_bwd.launches)
    got = tfa.flash_attention_bwd(
        *_t(q, k, v), torch.from_numpy(np.array(jlse)),
        torch.from_numpy(delta), torch.from_numpy(do), causal=causal,
        scale=scale, block=32)
    assert tfa.flash_attention_bwd.launches == n
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [2, 1])
def test_plain_fwd_bwd_match_pallas_interpret(causal, hkv):
    _check_plain_against_pallas(causal, hkv)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_fwd_bwd_match_pallas_interpret_group4_d64(causal):
    """GQA group 4 at the training head dim, ragged S: dk and dv sum four
    q heads."""
    _check_plain_against_pallas(causal, hkv=1, hq=4, d=64, s=48)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_grads_match_jax(causal):
    """(B, S, H, D) frontend: out and lse, and the gradients of a loss
    that reads both (so the backward takes a nonzero dlse)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 48, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 48, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
    wl = rng.standard_normal((2, 4, 48)).astype(np.float32)

    def jloss(q, k, v):
        out, lse = jattn.flash_attention_with_lse(q, k, v, causal=causal,
                                                  block=16)
        return jnp.sum(out * w) + jnp.sum(jnp.sin(lse) * wl)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                              block=16)
    loss = (out * torch.from_numpy(w)).sum() \
        + (torch.sin(lse) * torch.from_numpy(wl)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL)

    # flash_attention (out only) matches mha_reference, the serving oracle
    got = tattn.flash_attention(*_t(q, k, v), causal=causal)
    ref = tattn.mha_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_wrappers_refuse_bad_gqa():
    q, k, v, do = _t(*_inputs(hkv=2, hq=3))
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, v, causal=True, scale=1.0)
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(q, k, v, lse, lse, do, causal=True,
                                scale=1.0)


def _launch_params(source: str) -> dict:
    """name -> parameter kinds ("ptr", "int", "float") of every
    ``extern "C" int name(...)`` in a CUDA source."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   source):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("ptr" if "*" in p else p.rsplit(" ", 1)[0])
        out[name] = kinds
    return out


def test_launch_argtypes_match_cuda_source():
    """Each ctypes signature the wrappers set has the pointer, int and
    float parameters of its extern "C" function in the same places (a
    mismatch would pass a pointer cut to 32 bits, or a float as an int,
    and only the card could show it)."""
    path = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        params = _launch_params(f.read())
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    assert set(params) == set(tfa.ARGTYPES)
    for name, argtypes in tfa.ARGTYPES.items():
        assert [kind[t] for t in argtypes] == params[name], name
    # the backward: bfloat16 takes flash_bwd_launch, which has no dtype
    # argument; the split pair keeps it (and refuses anything but f32)
    assert params["flash_bwd_launch"][-3:] == ["float", "int", "ptr"]
    assert params["flash_bwd_dq_launch"][-4:] == ["float", "int", "int", "ptr"]


def test_bf16_wrappers_on_cpu_are_the_plain_versions():
    """bf16 CPU tensors take the plain versions, bit for bit, and launch
    nothing (group 4, ragged S)."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(hkv=1, hq=4, s=40, d=16))
    kw = dict(causal=True, scale=0.25)
    n_fwd, n_bwd = (tfa.flash_attention_fwd.launches,
                    dict(tfa.flash_attention_bwd.launches))
    out, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = (do.float() * out.float()).sum(-1)
    got = tfa.flash_attention_bwd(q, k, v, lse, delta, do, **kw)
    want = tfa.flash_attention_bwd_reference(q, k, v, lse, delta, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    assert tfa.flash_attention_fwd.launches == n_fwd == 0
    assert tfa.flash_attention_bwd.launches == n_bwd
    assert set(n_bwd.values()) == {0}


def test_backward_kernels_refuse_the_other_dtype():
    """bf16 never reaches the split f32 kernels, nor f32 the bf16 one: the
    wrappers refuse before loading any library."""
    q, k, v, do = _t(*_inputs(hkv=1))
    lse = torch.zeros(q.shape[:3])
    kw = dict(causal=True, scale=1.0)
    with pytest.raises(TypeError):
        tfa.bwd_fused(q, k, v, lse, lse, do, **kw)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    with pytest.raises(TypeError):
        tfa.bwd_dq(qb, kb, vb, lse, lse, dob, **kw)
    with pytest.raises(TypeError):
        tfa.bwd_dkv(qb, kb, vb, lse, lse, dob, **kw)
