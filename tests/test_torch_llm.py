"""The port's LLMEngine (device="cpu") against ray_tpu's LLMEngine on the
same converted ``debug`` weights: greedy outputs must be token-identical
in both cache modes, with mid-stream admission (6 requests on 3 slots)
and under a pool small enough to force recompute preemption, and with
chunked prefill (mirroring tests/test_llm.py::TestChunkedPrefill). Also
the engine surface: the reference's keywords, stats keys and prefix
digest with every optional feature off, speculation on a paged cache,
bad prefix modes and chunk sizes raise ValueError as in the reference, and
the default device is the card."""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

from _torch_isolation import _module_isolation_guard  # noqa: F401

REQUESTS = [([5, 17, 99, 3, 42], 10), (list(range(2, 18)), 12),
            ([200, 1], 6), (list(range(30, 51)), 9), ([9] * 7, 14),
            ([1, 2, 3], 8)]


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jllama.CONFIGS["debug"], jax.random.key(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    from ray_tpu_torch.models.convert import params_from_jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _submit_all(eng, requests, timeout_s=120):
    rids = [eng.submit(p, max_tokens=n) for p, n in requests]
    outs = {i: [] for i in range(len(rids))}
    deadline = time.monotonic() + timeout_s
    pending = set(range(len(rids)))
    while pending:
        assert time.monotonic() < deadline, "engine did not finish"
        for i in list(pending):
            st = eng.poll(rids[i])
            outs[i] += st["chunks"]
            if st["done"]:
                pending.discard(i)
        time.sleep(0.002)
    return outs


def _threads(eng, n, prompt_of, max_tokens):
    outs = {}

    def run(i):
        outs[i] = eng.generate(prompt_of(i), max_tokens=max_tokens,
                               timeout_s=120)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=150)
        assert not t.is_alive()
    return outs


def _both(jparams, tparams, fn, **kw):
    res = []
    for eng in (JaxEngine(model="debug", params=jparams, **kw),
                LLMEngine(model="debug", params=tparams, device="cpu",
                          **kw)):
        try:
            res.append((fn(eng), eng.stats()))
        finally:
            eng.shutdown()
    return res


@pytest.mark.parametrize("kv_cache", ["paged", "slot"])
def test_six_requests_on_three_slots_match_jax(jparams, tparams, kv_cache):
    (want, _), (got, st) = _both(
        jparams, tparams, lambda e: _submit_all(e, REQUESTS),
        num_slots=3, max_seq=128, kv_cache=kv_cache, kv_block_size=16)
    assert [len(got[i]) for i in range(6)] == [n for _, n in REQUESTS]
    assert got == want
    assert st["kv_cache"] == kv_cache and st["device"] == "cpu"


def test_preemption_matches_jax(jparams, tparams):
    (want, jst), (got, st) = _both(
        jparams, tparams,
        lambda e: _threads(e, 3, lambda i: [2 + i, 9, 4], 40),
        num_slots=3, max_seq=128, kv_cache="paged", kv_block_size=16,
        kv_pool_tokens=96)
    assert sorted(got) == [0, 1, 2]
    assert all(len(v) == 40 for v in got.values())
    assert st["preemptions"] >= 1 and jst["preemptions"] >= 1
    assert got == want


def test_preempted_output_equals_unpressured(tparams):
    eng = LLMEngine(model="debug", params=tparams, device="cpu",
                    num_slots=1, max_seq=128, kv_block_size=16)
    try:
        want = eng.generate([5, 6, 7], max_tokens=40, timeout_s=60)
    finally:
        eng.shutdown()
    eng = LLMEngine(model="debug", params=tparams, device="cpu",
                    num_slots=3, max_seq=128, kv_block_size=16,
                    kv_pool_tokens=96)
    try:
        outs = _threads(eng, 3, lambda i: [5, 6, 7], 40)
        assert eng.stats()["preemptions"] >= 1
        eng._alloc.check_invariants()
    finally:
        eng.shutdown()
    assert all(outs[i] == want for i in range(3))


def test_oversize_prompt_fails_cleanly(tparams):
    eng = LLMEngine(model="debug", params=tparams, device="cpu",
                    num_slots=2, max_seq=128, kv_block_size=16,
                    kv_pool_tokens=64)
    try:
        with pytest.raises(RuntimeError, match="exceeds KV pool"):
            eng.generate(list(range(1, 100)), max_tokens=8, timeout_s=60)
        assert len(eng.generate([4, 5], max_tokens=4, timeout_s=60)) == 4
        with pytest.raises(ValueError, match="out of vocab"):
            eng.generate([256], max_tokens=2)
        with pytest.raises(ValueError, match="exceeds max_seq"):
            eng.generate([1] * 100, max_tokens=40)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw,what", [
    ({"speculation": "ngram", "kv_cache": "paged"}, "speculation")])
def test_unported_options_raise(kw, what):
    """Speculation runs on the slot cache only, in both packages: on a
    paged cache both raise the reference's ValueError."""
    for make in (JaxEngine, lambda **k: LLMEngine(device="cpu", **k)):
        with pytest.raises(ValueError, match=f"{what}.*kv_cache='slot'"):
            make(model="debug", **kw)


@pytest.mark.parametrize("kv_cache", ["paged", "slot"])
def test_engine_surface_matches_jax(jparams, tparams, kv_cache):
    """With every optional feature off, the port's engine and server have
    the reference's surface: the same constructor keywords (the port adds
    ``device``), the same ``stats()`` keys (the port adds ``device``), the
    off values of the features it lacks, and an empty prefix digest."""
    import inspect

    from ray_tpu.serve.llm import LLMServer as JaxServer

    def keywords(cls):
        return set(inspect.signature(cls.__init__).parameters) - {"self"}

    assert keywords(LLMEngine) - {"device"} == keywords(JaxEngine)
    kw = dict(model="debug", num_slots=2, max_seq=128, kv_cache=kv_cache,
              kv_block_size=16)
    servers = (JaxServer(params=jparams, **kw),
               LLMServer(params=tparams, device="cpu", **kw))
    try:
        (jst, jdig), (st, dig) = [
            (s.stats(), (s.prefix_digest(), s.engine.prefix_digest()))
            for s in servers]
        assert set(st) - {"device"} == set(jst)
        assert dig == jdig == ([], [])
        for key in ("prefix_cache", "speculation", "spec_proposed",
                    "spec_accepted", "spec_acceptance_rate", "prefix_hits",
                    "prefix_misses", "prefill_chunks_run",
                    "prefilling_slots"):
            assert st[key] == jst[key], key
        eng = servers[1].engine
        assert (eng.speculation, eng.spec_k, eng.prefill_chunk) == (
            None, 4, None)
    finally:
        for s in servers:
            s.engine.shutdown()
    eng = LLMEngine(params=tparams, device="cpu", spec_k=7, **kw)
    try:
        assert eng.spec_k == 7
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw", [{"prefix_cache": "lru"},
                                {"prefix_cache": "radix", "kv_cache": "slot"}])
@pytest.mark.parametrize("engine", ["jax", "torch"])
def test_bad_prefix_modes_raise_value_error(engine, kw):
    with pytest.raises(ValueError, match="prefix_cache="):
        if engine == "jax":
            JaxEngine(model="debug", **kw)
        else:
            LLMEngine(model="debug", device="cpu", **kw)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(model="debug")


def test_server_surface(tparams):
    srv = LLMServer(model="debug", params=tparams, device="cpu",
                    num_slots=2, max_seq=128, kv_block_size=16)
    try:
        out = srv([5, 17, 99], max_tokens=5)
        assert len(out) == 5
        rid = srv.submit([5, 17, 99], max_tokens=5)
        got = []
        for _ in range(5000):
            st = srv.poll(rid)
            got += st["chunks"]
            if st["done"]:
                break
            time.sleep(0.002)
        assert got == out
        assert srv.poll(rid) == {"chunks": [], "done": True}
        assert not srv.cancel(rid)
        rid = srv.submit([1, 2], max_tokens=100)
        assert srv.cancel(rid)
        assert srv.stats()["kv_cache"] == "paged"
        # a proxy Request's JSON body, and the SSE stream's items (single
        # tokens or SSEBatch bursts), give the same greedy tokens
        from ray_tpu_torch.serve.proxy import Request, SSEBatch

        body = json.dumps({"prompt": [5, 17, 99], "max_tokens": 5}).encode()
        assert srv(Request("POST", "/llm", {}, {}, body)) == out
        streamed = []
        for item in srv.stream([5, 17, 99], max_tokens=5):
            streamed += item if isinstance(item, SSEBatch) else [item]
        assert streamed == out
        with pytest.raises(ValueError, match="prefilled KV shape"):
            srv.engine.submit_prefilled([1], np.zeros((1, 1)),
                                        np.zeros((1, 1)), np.zeros(256))
    finally:
        srv.engine.shutdown()


# ------------------------------------------------------ chunked prefill

CHUNK_PROMPTS = [list(range(1, 60)), [5, 6, 7], list(range(20, 55))]


def _engine(tparams, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("kv_block_size", 16)
    return LLMEngine(model="debug", params=tparams, device="cpu", **kw)


def _generate_each(eng, prompts, max_tokens=8):
    try:
        return [eng.generate(p, max_tokens=max_tokens, timeout_s=120)
                for p in prompts], eng.stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kv_cache", ["paged", "slot"])
def test_chunked_prefill_matches_unchunked_and_jax(jparams, tparams,
                                                   kv_cache):
    """Chunks of 16: 59 tokens run 4 chunks, 35 run 3, the 3-token prompt
    none. Greedy tokens equal the port's unchunked engine's and the JAX
    chunked engine's; both count the same chunks."""
    kw = dict(kv_cache=kv_cache, prefill_chunk=16)
    want, jst = _generate_each(
        JaxEngine(model="debug", params=jparams, num_slots=4,
                  kv_block_size=16, **kw), CHUNK_PROMPTS)
    base, _ = _generate_each(_engine(tparams, kv_cache=kv_cache),
                             CHUNK_PROMPTS)
    got, st = _generate_each(_engine(tparams, **kw), CHUNK_PROMPTS)
    assert got == base == want
    assert st["prefill_chunks_run"] == jst["prefill_chunks_run"] == 7
    assert st["prefilling_slots"] == 0


@pytest.mark.parametrize("kv_cache", ["paged", "slot"])
def test_chunked_long_and_short_concurrent(tparams, kv_cache):
    """A long prompt prefills chunk by chunk while a short one decodes
    beside it: both equal the unchunked engine's tokens."""
    prompts = [list(range(2, 50)), [9, 8, 7]]
    base, _ = _generate_each(_engine(tparams, kv_cache=kv_cache), prompts,
                             max_tokens=6)
    eng = _engine(tparams, kv_cache=kv_cache, prefill_chunk=16)
    try:
        outs = _submit_all(eng, [(p, 6) for p in prompts])
        st = eng.stats()
    finally:
        eng.shutdown()
    assert [outs[0], outs[1]] == base
    assert st["prefill_chunks_run"] == 3 and st["prefilling_slots"] == 0


@pytest.mark.parametrize("kw,match", [
    ({"kv_cache": "paged", "prefill_chunk": 24}, "multiple of"),
    ({"kv_cache": "slot", "prefill_chunk": 0}, "positive")])
@pytest.mark.parametrize("engine", ["jax", "torch"])
def test_bad_prefill_chunk_raises_value_error(engine, kw, match):
    with pytest.raises(ValueError, match=match):
        if engine == "jax":
            JaxEngine(model="debug", kv_block_size=16, **kw)
        else:
            LLMEngine(model="debug", device="cpu", kv_block_size=16, **kw)


def test_slot_chunk_past_the_cache_end_equals_unchunked(jparams, tparams):
    """max_seq=128, chunks of 48, a 110-token prompt: the last chunk
    starts at 96 and its padded end, 144, runs past the cache. The port
    writes only the chunk's 14 valid rows, so its tokens equal its own
    unchunked tokens, which equal the JAX engine's unchunked tokens. The
    JAX chunked engine differs here: it writes the padded chunk with
    ``dynamic_update_slice`` (``ray_tpu/models/decoding.py:248-256``),
    which XLA clamps to start at 128 - 48 = 80, so the chunk's rows land
    16 rows early, over the prefix (ROADMAP.md, C)."""
    prompt = np.random.default_rng(0).integers(1, 256, 110).tolist()
    kw = dict(num_slots=2, max_seq=128, kv_cache="slot")
    want, _ = _generate_each(JaxEngine(model="debug", params=jparams, **kw),
                             [prompt])
    base, _ = _generate_each(_engine(tparams, **kw), [prompt])
    got, st = _generate_each(_engine(tparams, prefill_chunk=48, **kw),
                             [prompt])
    assert got == base == want
    assert st["prefill_chunks_run"] == 3
