"""ray_tpu_torch flash attention against the JAX package on the CPU.

The port's plain forward and backward (what its wrappers compute on CPU
tensors, and what the card's kernels are held to) against the Pallas TPU
kernels run in interpret mode, at the small ragged shapes of
``tests/test_ops.py`` (S=80, D=32, GQA group 1 and 2, causal and not); and
the differentiable ``flash_attention_with_lse`` against ``jax.grad`` of
the JAX frontend, with a loss that uses lse so that the dlse cotangent
is exercised.

Tolerance: f32 to 1e-5 (the same f32 formulas, summed in another order
and over other tiles).
"""

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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [2, 1])
def test_plain_fwd_bwd_match_pallas_interpret(causal, hkv):
    q, k, v, do = _inputs(hkv)
    scale = 32 ** -0.5
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
