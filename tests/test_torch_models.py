"""ray_tpu_torch models against the JAX package on the CPU: weight
conversion, the block allocator (mirroring tests/test_paged_cache.py),
and the paged and slot prefill + decode pipelines on converted ``debug``
weights.

Tolerances: f32 logits within 1e-4 absolute (same f32 math; sums in
another order over two layers and a 256-way head), greedy tokens
identical. bf16 logits within 0.05 absolute: the largest logits are
about 3.4, where one bf16 ulp is 2^-6, so that is three ulps (the two
frameworks round bf16 activations at different points — e.g. SiLU — and
the hidden states differ by a few ulps; the largest difference seen is
0.036);
the bf16 run is teacher-forced with the JAX tokens so both see the same
inputs at every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decoding as jdecoding
from ray_tpu.models import llama as jllama
from ray_tpu.models import paged_cache as jpaged
from ray_tpu_torch.models import decoding as tdecoding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import paged_cache as tpaged
from ray_tpu_torch.models.convert import params_from_jax

from _torch_isolation import _module_isolation_guard  # noqa: F401

STEPS = 8


def _configs(dtype):
    jc = jllama.CONFIGS["debug"]
    tc = tllama.CONFIGS["debug"]
    if dtype == "bf16":
        jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    out = {}
    for dtype in ("f32", "bf16"):
        jc, tc = _configs(dtype)
        jp = jllama.init_params(jc, jax.random.key(0))
        out[dtype] = (jc, tc, jp,
                      params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return out


# ------------------------------------------------------------ conversion

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_roundtrip_is_bit_exact(weights, dtype):
    _, tc, jp, tp = weights[dtype]
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        t = tl[name]
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == tc.dtype, name
        if dtype == "bf16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), a), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_params_layout_and_rules(weights, dtype):
    """The port's own init has the JAX layout (so either loads into the
    other's code), truncates at 3σ, scales residual projections, and
    zeroes the norms."""
    _, tc, _, tp = weights[dtype]
    gen = torch.Generator().manual_seed(0)
    mine = tllama.init_params(tc, gen, "cpu")
    ml, tl = dict(_leaves(mine)), dict(_leaves(tp))
    assert ml.keys() == tl.keys()
    for name in ml:
        assert ml[name].shape == tl[name].shape and \
            ml[name].dtype == tl[name].dtype, name
    std = tc.hidden ** -0.5
    out_std = std / (2 * tc.n_layers) ** 0.5
    for name, s in (("/embed", std), ("/layers/wq", std),
                    ("/layers/wo", out_std), ("/layers/w_down", out_std)):
        w = ml[name].float()
        assert w.abs().max() <= 3 * s * 1.01, name
        assert 0.7 * s < w.std() < 1.0 * s, name
    for name in ("/layers/attn_norm", "/layers/mlp_norm", "/final_norm"):
        assert torch.count_nonzero(ml[name]) == 0


def test_params_from_jax_places_on_device(weights):
    _, _, jp, _ = weights["f32"]
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    assert tp["layers"]["wq"].device.type == "cpu"


# ------------------------------------------------------------ allocator

class TestAllocator:
    """Mirrors tests/test_paged_cache.py::TestAllocator on the port."""

    def test_alloc_release_cycle(self):
        page = tpaged.PagedConfig(num_blocks=9, block_size=4, max_seq=32)
        al = tpaged.BlockAllocator(page, num_slots=2)
        assert al.free_blocks() == 8
        assert al.ensure(0, 10)
        assert al.free_blocks() == 5
        assert al.ensure(0, 12)
        assert al.free_blocks() == 5
        assert al.ensure(0, 13)
        assert al.free_blocks() == 4
        ids = al.tables[0, :4]
        assert len(set(ids.tolist())) == 4 and 0 not in ids
        al.release(0)
        assert al.free_blocks() == 8
        assert (al.tables[0] == 0).all()
        al.check_invariants()

    def test_pool_exhaustion_refused(self):
        page = tpaged.PagedConfig(num_blocks=5, block_size=4, max_seq=64)
        al = tpaged.BlockAllocator(page, num_slots=2)
        assert al.ensure(0, 16)
        assert not al.ensure(1, 4)
        assert al.free_blocks() == 0
        al.release(0)
        assert al.ensure(1, 4)

    def test_max_seq_cap(self):
        page = tpaged.PagedConfig(num_blocks=64, block_size=4, max_seq=16)
        al = tpaged.BlockAllocator(page, num_slots=1)
        assert not al.ensure(0, 17)

    def test_pad_to_block_bucket(self):
        assert tpaged.pad_to_block_bucket(3, 64) == 64
        assert tpaged.pad_to_block_bucket(65, 64) == 128
        assert tpaged.pad_to_block_bucket(4000, 64) == 4096
        assert tdecoding.pad_to_bucket(33) == 64
        assert tdecoding.pad_to_bucket(3000) == 3072

    def test_refcounts_adopt_cow_and_device_tables(self):
        page = tpaged.PagedConfig(num_blocks=8, block_size=4, max_seq=32)
        al = tpaged.BlockAllocator(page, num_slots=2)
        assert al.ensure(0, 8)
        shared = [int(b) for b in al.tables[0, :2]]
        al.ref_blocks(shared)                  # an external holder
        al.adopt(1, shared)
        assert [al.refcount(b) for b in shared] == [3, 3]
        t = al.device_tables()
        assert al.device_tables() is t         # cached until a change
        src, dst = al.cow(1, 1)
        assert src == shared[1] and al.tables[1, 1] == dst
        assert al.device_tables() is not t
        assert torch.equal(al.device_tables(), torch.from_numpy(al.tables))
        al.release(0)
        al.release(1)
        assert al.unref_blocks(shared) == shared
        assert al.free_blocks() == 7
        al.check_invariants()


# ------------------------------------------------------------ pipelines

PROMPTS = [list(range(1, 13)), [7, 3, 250, 11, 16, 40, 2]]


def _run(pkg, cfg, params, paged: bool, force=None):
    """Prefill two slots (fragmented, out-of-order blocks when paged),
    then STEPS decode steps. Returns per-step logits (2, vocab) as
    numpy f32 and each slot's greedy tokens."""
    j = pkg == "jax"
    mod_p, mod_d = (jpaged, jdecoding) if j else (tpaged, tdecoding)
    arr = jnp.asarray if j else (lambda a: a)
    num_slots = 2
    if paged:
        page = mod_p.PagedConfig(num_blocks=17, block_size=16, max_seq=128)
        al = mod_p.BlockAllocator(page, num_slots)
        al.ensure(1, 3 * page.block_size)    # fragment the free list
        al.ensure(0, len(PROMPTS[0]) + 1)
        al.release(1)
        al.ensure(1, len(PROMPTS[1]) + 1)
        cache = mod_p.init_paged_cache(cfg, page, num_slots)
        prefill = mod_p.make_paged_prefill(params, cfg, page)
        decode = mod_p.make_paged_decode_step(params, cfg, page)
    else:
        cache = mod_d.init_cache(cfg, num_slots, max_seq=128)
        prefill = mod_d.make_prefill(params, cfg)
        decode = mod_d.make_decode_step(params, cfg)
    first, steps = [], []
    for slot, prompt in enumerate(PROMPTS):
        tokens = np.zeros((1, 16), np.int32)
        tokens[0, :len(prompt)] = prompt
        if paged:
            cache, lg = prefill(cache, al.tables[slot], arr(tokens),
                                len(prompt), slot)
        else:
            cache, lg = prefill(cache, arr(tokens), len(prompt), slot)
        first.append(np.asarray(lg, np.float32) if j
                     else lg.float().numpy())
    toks = [[int(np.argmax(f))] for f in first]
    active = np.ones(num_slots, bool)
    for s in range(STEPS):
        last = np.array([t[-1] for t in toks], np.int32)
        if force is not None:
            last = np.array([f[s] for f in force], np.int32)
        if paged:
            for slot in range(num_slots):
                al.ensure(slot, len(PROMPTS[slot]) + s + 2)
            cache, lg = decode(cache, al.device_tables(), arr(last),
                               arr(active))
        else:
            cache, lg = decode(cache, arr(last), arr(active))
        lg = np.asarray(lg, np.float32) if j else lg.float().numpy()
        steps.append(lg)
        for slot in range(num_slots):
            toks[slot].append(int(np.argmax(lg[slot])))
    return np.stack(first), steps, toks


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_f32_pipeline_matches_jax(weights, paged):
    jc, tc, jp, tp = weights["f32"]
    jf, js, jt = _run("jax", jc, jp, paged)
    with torch.inference_mode():
        tf, ts, tt = _run("torch", tc, tp, paged)
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert tt == jt


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_bf16_pipeline_matches_jax(weights, paged):
    jc, tc, jp, tp = weights["bf16"]
    jf, js, jt = _run("jax", jc, jp, paged)
    tf, ts, _ = _run("torch", tc, tp, paged, force=jt)
    np.testing.assert_allclose(tf, jf, atol=0.05)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, atol=0.05)


def test_port_paged_equals_port_slot(weights):
    _, tc, _, tp = weights["f32"]
    pf, ps, pt = _run("torch", tc, tp, paged=True)
    sf, ss, st = _run("torch", tc, tp, paged=False)
    assert pt == st
    np.testing.assert_allclose(pf, sf, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- chunked prefill, KV I/O

PROMPT = list(range(3, 43))                       # 40 tokens
# (start, true_len) of each chunk of 16: the second resumes mid-block
SCHEDULE = [(0, 5), (5, 16), (21, 16), (37, 3)]


def _pool_setup(mod_p, num_slots=2):
    page = mod_p.PagedConfig(num_blocks=17, block_size=16, max_seq=128)
    al = mod_p.BlockAllocator(page, num_slots)
    al.ensure(1, 3 * page.block_size)             # fragment the free list
    al.ensure(0, len(PROMPT) + 1)
    al.release(1)
    return page, al


def _chunked(pkg, cfg, params, paged: bool):
    """Prefill PROMPT into slot 0 chunk by chunk (SCHEDULE); returns each
    chunk's logits, the cache as numpy, and the whole-prompt prefill's
    logits and cache on a fresh cache."""
    j = pkg == "jax"
    mod_p, mod_d = (jpaged, jdecoding) if j else (tpaged, tdecoding)
    arr = jnp.asarray if j else (lambda a: a)

    def host(t):
        return np.asarray(t) if j else t.float().numpy()

    if paged:
        page, al = _pool_setup(mod_p)
        fresh = lambda: mod_p.init_paged_cache(cfg, page, 2)  # noqa: E731
        chunk = mod_p.make_chunked_paged_prefill(params, cfg, page)
        whole = mod_p.make_paged_prefill(params, cfg, page)
    else:
        fresh = lambda: mod_d.init_cache(cfg, 2, max_seq=128)  # noqa: E731
        chunk = mod_d.make_chunked_prefill(params, cfg)
        whole = mod_d.make_prefill(params, cfg)
    cache, logits = fresh(), []
    for start, n in SCHEDULE:
        buf = np.zeros((1, 16), np.int32)
        buf[0, :n] = PROMPT[start:start + n]
        args = (al.tables[0],) if paged else ()
        cache, lg = chunk(cache, *args, arr(buf), n, start, 0)
        logits.append(host(lg))
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, :len(PROMPT)] = PROMPT
    args = (al.tables[0],) if paged else ()
    ref, ref_lg = whole(fresh(), *args, arr(tokens), len(PROMPT), 0)
    return (logits, {k: host(v) for k, v in cache.items()}, host(ref_lg),
            {k: host(v) for k, v in ref.items()})


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_chunked_prefill_matches_jax(weights, paged):
    """f32 debug, chunks of 16 from positions 0, 5 (mid-block), 21 and 37:
    each chunk's logits within 1e-4 of the JAX chunk's, the cache after
    (every pool block, lengths) within 1e-5; and the last chunk's logits
    and the prompt's cached rows within 1e-4 of the whole-prompt prefill's
    (the same rows, attention summed in another order)."""
    jc, tc, jp, tp = weights["f32"]
    jl, jcache, _, _ = _chunked("jax", jc, jp, paged)
    with torch.inference_mode():
        tl, tcache, wl, wcache = _chunked("torch", tc, tp, paged)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    for key in ("k", "v", "length"):
        np.testing.assert_allclose(tcache[key], jcache[key], rtol=1e-5,
                                   atol=1e-5)
    assert tcache["length"][0] == len(PROMPT)
    np.testing.assert_allclose(tl[-1], wl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["k"], wcache["k"], rtol=1e-4,
                               atol=1e-4)


def test_paged_chunk_must_be_block_multiple(weights):
    _, tc, _, tp = weights["f32"]
    page, al = _pool_setup(tpaged)
    chunk = tpaged.make_chunked_paged_prefill(tp, tc, page)
    with pytest.raises(ValueError, match="multiple of block_size"):
        chunk(tpaged.init_paged_cache(tc, page, 2), al.tables[0],
              np.zeros((1, 24), np.int32), 3, 0, 0)


def _random_kv(cfg, rows, true_len, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, rows, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    k[:, true_len:] = 0
    v[:, true_len:] = 0
    if dtype == "bf16":
        import ml_dtypes

        k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    return k, v


def _as_numpy(cache, j):
    if j:
        return {key: np.asarray(t) for key, t in cache.items()}
    from ray_tpu_torch.models.convert import host_array

    return {key: host_array(t) for key, t in cache.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_inject_matches_jax(weights, paged, dtype):
    """Host KV (rows past true_len zero; bf16 as ml_dtypes arrays) injected
    into slot 1: both packages' caches are the same bits, blocks past
    true_len going to the null block only."""
    jc, tc, _, _ = weights[dtype]
    true_len = 37
    k, v = _random_kv(jc, 64, true_len, dtype)
    out = []
    for j in (True, False):
        mod_p, mod_d = (jpaged, jdecoding) if j else (tpaged, tdecoding)
        cfg = jc if j else tc
        if paged:
            page, al = _pool_setup(mod_p)
            al.ensure(1, true_len)
            cache = mod_p.init_paged_cache(cfg, page, 2)
            cache = mod_p.make_paged_inject(cfg, page)(
                cache, al.tables[1], k, v, true_len, 1)
        else:
            cache = mod_d.init_cache(cfg, 2, max_seq=128)
            args = (jnp.asarray(k), jnp.asarray(v)) if j else (k, v)
            cache = mod_d.make_inject(cfg)(cache, *args, true_len, 1)
        out.append(_as_numpy(cache, j))
    want, got = out
    for key in ("k", "v", "length"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    assert got["length"][1] == true_len
    if paged:
        page, al = _pool_setup(tpaged)
        with pytest.raises(ValueError, match="multiple of block_size"):
            tpaged.make_paged_inject(tc, page)(
                tpaged.init_paged_cache(tc, page, 2), al.tables[0],
                k[:, :40], v[:, :40], 37, 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_extract_kv_and_block_copy_match_jax(weights, dtype):
    """The same random pool in both packages: ``make_block_copy`` gives
    the same pool, and ``extract_kv`` of a slot over fragmented blocks the
    same host arrays, in the same dtype (bf16 as ml_dtypes.bfloat16)."""
    from ray_tpu_torch.models.convert import tensor_from_host

    jc, tc, _, _ = weights[dtype]
    rng = np.random.default_rng(1)
    shape = (jc.n_layers, 17, 16, jc.n_kv_heads, jc.head_dim)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    if dtype == "bf16":
        import ml_dtypes

        pools = [p.astype(ml_dtypes.bfloat16) for p in pools]
    out = []
    for j in (True, False):
        mod_p = jpaged if j else tpaged
        cfg = jc if j else tc
        page, al = _pool_setup(mod_p)
        al.ensure(1, 29)
        to = jnp.asarray if j else tensor_from_host
        cache = {"k": to(pools[0]), "v": to(pools[1]),
                 "length": to(np.zeros(2, np.int32))}
        cache = mod_p.make_block_copy(cfg, page)(cache, 3, 5)
        k, v = mod_p.extract_kv(cache, al, 1, 29)
        out.append((k, v, _as_numpy(cache, j)))
    (jk, jv, jcache), (tk, tv, tcache) = out
    for got, want in ((tk, jk), (tv, jv), (tcache["k"], jcache["k"]),
                      (tcache["v"], jcache["v"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tk.shape == (tc.n_layers, 29, tc.n_kv_heads, tc.head_dim)
