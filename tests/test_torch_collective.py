"""ray_tpu_torch.collective's quantization, in-program (NCCL) group and
quantized KV wire against the JAX package on the CPU.

- the numpy codec (quantize, dequantize, the allreduce simulation and its
  error bound, the payload codec) bit-equal to ``ray_tpu``'s at
  tests/test_quantized_collective.py's sizes, in f32 and f64;
- ``quantize_blocks_torch`` equal to ``quantize_blocks_jnp``: codes,
  scales and offsets bit for bit;
- ``XlaGroup`` over 8 CPU slabs against the JAX package's ``XlaGroup``
  on its 8 virtual devices: the exact ops to rtol 1e-6
  (tests/test_quantized_collective.py's tolerance), the quantized
  allreduce and reducescatter within ``allreduce_error_bound`` and within
  one code step (``scale2``) of JAX's quantized output, MAX and int32 on
  the exact path, the same errors for the same misuse;
- ``XlaGroup(devices=None)`` refuses where there is no CUDA;
- the KV group's quantized wire: the two-member scenario of
  tests/test_quantized_collective.py through both packages' ``KVGroup``
  with bit-equal outputs and equal ``wire_put_bytes``, at least 3x fewer
  bytes than the exact wire, and ``broadcast`` exact.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.collective import quantization as jq
from ray_tpu.collective.kv_group import KVGroup as JKVGroup
from ray_tpu.collective.types import ReduceOp as JReduceOp
from ray_tpu.collective.xla_group import XlaGroup as JXlaGroup
from ray_tpu.common.config import GLOBAL_CONFIG as JCONFIG
from ray_tpu_torch.collective import quantization as tq
from ray_tpu_torch.collective.kv_group import KVGroup as TKVGroup
from ray_tpu_torch.collective.types import ReduceOp as TReduceOp
from ray_tpu_torch.collective.xla_group import XlaGroup as TXlaGroup
from ray_tpu_torch.common.config import GLOBAL_CONFIG as TCONFIG

from _torch_dist import MemoryKV
from _torch_isolation import _module_isolation_guard  # noqa: F401

EXACT_RTOL = 1e-6     # tests/test_quantized_collective.py:88
BLOCK = 256
W = 8
SIZES = [1, 7, 77, 256, 513, 4096]


@pytest.fixture
def quantized_on():
    for cfg in (JCONFIG, TCONFIG):
        cfg.set_system_config_value("quantized_collectives", True)
    yield
    for cfg in (JCONFIG, TCONFIG):
        cfg.set_system_config_value("quantized_collectives", False)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------------------ codec

def test_flags_match_jax():
    for name in ("quantized_collectives", "quantized_collectives_block"):
        assert TCONFIG.get(name) == JCONFIG.get(name)
    assert TCONFIG.get("quantized_collectives") is False
    assert TCONFIG.get("quantized_collectives_block") == 256


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_codec_bit_equal_to_jax(n, dtype):
    rng = np.random.RandomState(n)
    arr = (rng.randn(n) * 3).astype(dtype)
    got, want = tq.quantize_blocks_np(arr, BLOCK), \
        jq.quantize_blocks_np(arr, BLOCK)
    for g, w in zip(got, want):
        _bits_equal(g, w)
    _bits_equal(tq.dequantize_blocks_np(*got, n),
                jq.dequantize_blocks_np(*want, n))
    members = [(rng.randn(n) * (i + 1)).astype(dtype) for i in range(4)]
    _bits_equal(tq.simulate_quantized_allreduce_np(members, BLOCK),
                jq.simulate_quantized_allreduce_np(members, BLOCK))
    _bits_equal(tq.allreduce_error_bound(members, BLOCK),
                jq.allreduce_error_bound(members, BLOCK))
    msg, jmsg = tq.encode_payload(arr, BLOCK), jq.encode_payload(arr, BLOCK)
    assert tq.is_quantized_payload(msg) and set(msg) == set(jmsg)
    _bits_equal(tq.decode_payload(msg), jq.decode_payload(jmsg))
    assert tq.wire_bytes(n, 4, BLOCK) == jq.wire_bytes(n, 4, BLOCK)
    assert tq.padded_size(n, BLOCK) == jq.padded_size(n, BLOCK)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_torch_quantize_equals_jnp(dtype):
    rng = np.random.RandomState(5)
    blocks = (rng.randn(3, 9, BLOCK) * 2).astype(dtype)
    blocks[1, 4] = 2.5                     # a constant block: scale 1.0
    blocks[2, 0, :3] = [0.5, 1.5, 2.5]     # exact halves round to even
    if dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)
    try:
        want = jq.quantize_blocks_jnp(jnp.asarray(blocks))
        want = [np.asarray(w) for w in want]
        jdeq = np.asarray(jq.dequantize_blocks_jnp(
            *[jnp.asarray(w) for w in want], jnp.asarray(blocks).dtype))
    finally:
        if dtype == np.float64:
            jax.config.update("jax_enable_x64", False)
    got = tq.quantize_blocks_torch(torch.from_numpy(blocks))
    assert got[0].dtype == torch.uint8
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w)
    assert float(got[1][1, 4, 0]) == 1.0
    _bits_equal(tq.dequantize_blocks_torch(*got, got[1].dtype).numpy(),
                jdeq)
    # the tensor payload codec decodes to the numpy codec's values
    arr = blocks.reshape(-1)[:1000]
    msg = tq.encode_payload(torch.from_numpy(arr), BLOCK)
    _bits_equal(tq.decode_payload(msg).numpy(),
                tq.decode_payload(tq.encode_payload(arr, BLOCK)))


# ------------------------------------------------------------- XlaGroup

def _jax_shard_map(self, body, out_spec, check_rep=True):
    """``ray_tpu``'s ``XlaGroup._shard_map`` for jax releases that renamed
    ``check_rep`` to ``check_vma``: its fallback drops the keyword, and
    its quantized programs (whose all_to_all/all_gather outputs are
    replicated by construction) then fail shard_map's replication check.
    The test passes the keyword under its new name; nothing else of the
    reference changes."""
    import jax
    from jax.sharding import PartitionSpec as P

    return jax.shard_map(body, mesh=self.mesh, in_specs=P(self.axis),
                         out_specs=out_spec, check_vma=check_rep)


@pytest.fixture(scope="module")
def groups():
    import inspect

    import jax

    jg = JXlaGroup(world_size=W)
    if "check_vma" in inspect.signature(jax.shard_map).parameters:
        jg._shard_map = _jax_shard_map.__get__(jg)
    return TXlaGroup(W, devices=[torch.device("cpu")] * W), jg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_exact_ops_match_jax(groups, op, dtype):
    tg, jg = groups
    rng = np.random.RandomState(2)
    stacked = (rng.randn(W, 6, 5) * 4).astype(dtype)
    got = tg.allreduce(stacked, getattr(TReduceOp, op))
    want = jg.allreduce(stacked, getattr(JReduceOp, op))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=EXACT_RTOL)
    np.testing.assert_allclose(
        _np(tg.reduce(stacked, 3, getattr(TReduceOp, op))),
        np.asarray(jg.reduce(stacked, 3, getattr(JReduceOp, op))),
        rtol=EXACT_RTOL)


def test_broadcast_allgather_reducescatter_match_jax(groups):
    tg, jg = groups
    rng = np.random.RandomState(3)
    stacked = (rng.randn(W, 16, 3) * 2).astype(np.float32)
    _bits_equal(_np(tg.broadcast(stacked, 5)),
                np.asarray(jg.broadcast(stacked, 5)))
    got, want = tg.allgather(stacked), jg.allgather(stacked)
    assert len(got) == len(want) == W
    for g, w in zip(got, want):
        _bits_equal(_np(g), np.asarray(w))
    got, want = tg.reducescatter(stacked), jg.reducescatter(stacked)
    assert tuple(got.shape) == want.shape == (W, 2, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=EXACT_RTOL)
    # torch tensors in, torch tensors out; the input left as it was
    t = torch.from_numpy(stacked.copy())
    out = tg.allreduce(t)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), stacked)
    tg.barrier()


def test_misuse_raises_as_jax(groups):
    tg, jg = groups
    for g, ops in ((tg, TReduceOp), (jg, JReduceOp)):
        with pytest.raises(ValueError, match="leading"):
            g.allreduce(np.zeros((W - 1, 4), np.float32))
        with pytest.raises(ValueError, match="unsupported"):
            g.allreduce(np.zeros((W, 4), np.float32), ops.PRODUCT)
        with pytest.raises(ValueError, match="SUM only"):
            g.reducescatter(np.zeros((W, W), np.float32), ops.MAX)
        with pytest.raises(ValueError, match="not divisible"):
            g.reducescatter(np.zeros((W, W + 1), np.float32))
    with pytest.raises(ValueError, match="exceeds"):
        TXlaGroup(9, devices=[torch.device("cpu")] * W)
    with pytest.raises(ValueError, match="exceeds"):
        JXlaGroup(world_size=9)


def test_devices_none_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TXlaGroup(1)


def _scale2(stacked_rows):
    """Per element, the code step of the phase-2 requantization of the
    chunk sums: ``allreduce_error_bound``'s second term, doubled."""
    members = list(stacked_rows)
    n = members[0].size
    npad = tq.padded_size(n, BLOCK)
    acc = np.zeros(npad, np.float64)
    for m in members:
        codes, scale, lo = tq.quantize_blocks_np(m, BLOCK)
        acc += tq.dequantize_blocks_np(codes, scale, lo, npad)
    _, scale2, _ = tq.quantize_blocks_np(acc, BLOCK)
    return np.repeat(scale2, BLOCK)[:n].reshape(members[0].shape)


@pytest.mark.parametrize("n", [77, 513, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantized_allreduce_matches_jax(groups, quantized_on, n, dtype):
    tg, jg = groups
    rng = np.random.RandomState(n)
    stacked = (rng.randn(W, n) * 2).astype(dtype)
    got = _np(tg.allreduce(stacked)).astype(np.float64)
    want = np.asarray(jg.allreduce(stacked)).astype(np.float64)
    exact = stacked.astype(np.float64).sum(axis=0)
    bound = jq.allreduce_error_bound(list(stacked), BLOCK)
    err = np.abs(got - exact)
    # the group's blocks lie inside its W chunks, not where the bound's
    # whole-vector blocks lie: held in max, as the JAX package's test does
    assert err.max() <= bound.max() + 1e-5
    assert err.max() > 0                   # the quantized path engaged
    # JAX's XlaGroup chunks the same way: the two differ by at most the
    # requantization's step where the chunk sums round apart
    chunk = -(-n // W)
    rows = np.pad(stacked, ((0, 0), (0, W * chunk - n))).reshape(W, W, chunk)
    step = np.concatenate([_scale2_chunk(rows[:, c])
                           for c in range(W)])[:n]
    assert np.all(np.abs(got - want) <= step + 1e-6)


def _scale2_chunk(member_chunks):
    """The phase-2 code step over one destination chunk: the chunk padded
    to blocks, as XlaGroup's ``_phase1`` pads it."""
    chunk = member_chunks.shape[1]
    cpad = tq.padded_size(chunk, BLOCK)
    padded = np.pad(member_chunks, ((0, 0), (0, cpad - chunk)))
    return _scale2(padded)[:chunk]


def test_quantized_reducescatter_matches_jax(groups, quantized_on):
    tg, jg = groups
    rng = np.random.RandomState(5)
    stacked = (rng.randn(W, 16, 5) * 3).astype(np.float32)
    got = _np(tg.reducescatter(stacked))
    want = np.asarray(jg.reducescatter(stacked))
    assert got.shape == want.shape == (W, 2, 5)
    exact = stacked.sum(axis=0).reshape(W, 2, 5)
    rows = stacked.reshape(W, W, -1)       # member, dest, payload
    bound = sum(np.ptp(rows[m], axis=1) / 255 / 2 for m in range(W))
    err = np.abs(got - exact).reshape(W, -1).max(axis=1)
    assert np.all(err <= bound + 1e-5)
    assert err.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_quantized_routes_only_float_sum(groups, quantized_on):
    tg, jg = groups
    stacked = np.random.RandomState(2).randn(W, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tg.allreduce(stacked, TReduceOp.MAX)),
        np.asarray(jg.allreduce(stacked, JReduceOp.MAX)), rtol=EXACT_RTOL)
    ints = np.arange(W * 16, dtype=np.int32).reshape(W, 16)
    np.testing.assert_array_equal(_np(tg.allreduce(ints)),
                                  ints.sum(axis=0))


# ------------------------------------------------------- KV quantized wire

def _run_members(world, fn):
    results, errors = [None] * world, []

    def runner(r):
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return results


def _kv_scenario(cls, op, quantized, payload):
    """The two-member scenario of tests/test_quantized_collective.py:
    each member's result and group."""
    kv, groups = MemoryKV(), {}

    def member(rank):
        g = cls(kv, 2, rank, "g", quantized=quantized)
        groups[rank] = g
        return np.asarray(getattr(g, op)(payload[rank]))

    return _run_members(2, member), groups


@pytest.mark.parametrize("op", ["allreduce", "reducescatter"])
def test_kv_quantized_wire_matches_jax(op):
    rng = np.random.RandomState(9)
    payload = [(rng.randn(1 << 16) * 2).astype(np.float32) for _ in range(2)]
    t_out, t_g = _kv_scenario(TKVGroup, op, True, payload)
    j_out, j_g = _kv_scenario(JKVGroup, op, True, payload)
    for t, j in zip(t_out, j_out):
        _bits_equal(t, j)
    for r in range(2):
        assert t_g[r].wire_put_bytes == j_g[r].wire_put_bytes
        assert t_g[r].wire_get_bytes == j_g[r].wire_get_bytes
        assert t_g[r].quantized and t_g[r].quantized_block == BLOCK
    exact = payload[0] + payload[1]
    bound = jq.allreduce_error_bound(payload, BLOCK)
    got = np.concatenate(t_out) if op == "reducescatter" else t_out[0]
    assert np.all(np.abs(got - exact) <= bound + 1e-5)
    e_out, e_g = _kv_scenario(TKVGroup, op, False, payload)
    assert e_g[0].wire_put_bytes / t_g[0].wire_put_bytes >= 3.0
    # the flag is read when quantized= is left None
    assert TKVGroup(MemoryKV(), 1, 0, "f").quantized is False


def test_kv_quantized_tensor_payload():
    rng = np.random.RandomState(4)
    payload = [torch.from_numpy((rng.randn(3000) * 2).astype(np.float32))
               for _ in range(2)]
    out, _ = _kv_scenario(TKVGroup, "allreduce", True, payload)
    want = tq.simulate_quantized_allreduce_np(
        [p.numpy() for p in payload], BLOCK)
    bound = jq.allreduce_error_bound([p.numpy() for p in payload], BLOCK)
    exact = (payload[0] + payload[1]).numpy()
    assert np.all(np.abs(out[0] - exact) <= bound + 1e-5)
    # one quantization per member, then the exact sum: within the first
    # phase of the bound of the simulation
    assert np.abs(out[0] - want).max() <= bound.max()


def test_kv_broadcast_stays_exact():
    src = np.random.RandomState(3).randn(1000).astype(np.float32)
    for cls in (TKVGroup, JKVGroup):
        kv = MemoryKV()

        def member(rank, cls=cls, kv=kv):
            g = cls(kv, 2, rank, "b", quantized=True)
            return np.asarray(g.broadcast(
                src if rank == 0 else np.zeros_like(src), src_rank=0))

        for out in _run_members(2, member):
            np.testing.assert_array_equal(out, src)
