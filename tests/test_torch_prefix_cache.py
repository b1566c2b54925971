"""The port's radix prefix cache, legacy prefix cache and PD handoff
against ray_tpu's, on the CPU (mirroring tests/test_prefix_cache.py).

- The tree alone: the same match, insert, evict and digest sequence on
  both packages' ``RadixPrefixCache`` (each bound to its own
  ``BlockAllocator``) gives the same matches, counters, refcounts, free
  lists and digests; the digest and ``prefix_hashes`` equal the router's
  ``_RouterState._prefix_hashes``.
- The engine, on the same converted ``debug`` weights (f32): greedy tokens
  equal the JAX engine's token for token; for the same sequential request
  sequence ``stats()["prefix_cache"]`` and ``prefix_digest()`` equal the
  JAX engine's. Under pool pressure with cancels the allocator's
  invariants hold (no referenced block was evicted) and dropping the tree
  frees the whole pool. Faults armed on the port's own hook degrade to a
  cold prefill with a typed counter.
- PD: a JAX engine's ``_extract_kv`` handed to the port's
  ``submit_prefilled`` gives the JAX engine's tokens.
"""

import threading
import time

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.models import paged_cache as jpaged
from ray_tpu.models import prefix_cache as jprefix
from ray_tpu.serve.handle import _RouterState
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch.common import faults
from ray_tpu_torch.models import paged_cache as tpaged
from ray_tpu_torch.models import prefix_cache as tprefix
from ray_tpu_torch.serve.llm import LLMEngine

from _torch_isolation import _module_isolation_guard  # noqa: F401

# 24-token shared "system prompt" (3 blocks at kv_block_size=8) + tails
SYSTEM = list(range(1, 25))
TAILS = [[30, 31, 32, 33], [40, 41], [50, 51, 52, 53, 54, 55], [60],
         [70, 71, 72], [80, 81, 82, 83, 84]]
PROMPTS = [SYSTEM + t for t in TAILS]
LENS = [14, 6, 10, 8, 12, 5]
COW_A = SYSTEM + [30, 31, 32, 33, 34, 35, 36, 37]      # 32 = 4 blocks
COW_B = COW_A[:27] + [99, 98, 97, 96, 95]               # diverges at 27


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jllama.CONFIGS["debug"], jax.random.key(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    from ray_tpu_torch.models.convert import params_from_jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _kw(kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("kv_block_size", 8)
    return kw


def _jax(jparams, **kw):
    return JaxEngine(model="debug", params=jparams, seed=0, **_kw(kw))


def _port(tparams, **kw):
    return LLMEngine(model="debug", params=tparams, device="cpu", **_kw(kw))


def _sequential(eng, prompts, lens):
    """Each request to completion in turn; the engine's outputs, stats and
    digest, its allocator checked. Shuts the engine down."""
    try:
        outs = [eng.generate(p, max_tokens=n, timeout_s=120)
                for p, n in zip(prompts, lens)]
        if eng.kv_cache == "paged":
            eng._alloc.check_invariants()
        return outs, eng.stats(), eng.prefix_digest()
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def baseline(jparams):
    """want(prompts, lens): the JAX engine's tokens with its prefix cache
    off (greedy, so n tokens are the first n of 14)."""
    prompts = PROMPTS + [COW_B]
    outs, _, _ = _sequential(_jax(jparams, prefix_cache="off"), prompts,
                             [max(LENS)] * len(prompts))
    table = dict(zip(map(tuple, prompts), outs))

    def want(prompts, lens):
        return [table[tuple(p)][:n] for p, n in zip(prompts, lens)]

    return want


# ------------------------------------------------------------ the tree

def _trees(num_blocks=34, block_size=16, budget_blocks=16):
    out = []
    for mod_p, mod_t in ((jpaged, jprefix), (tpaged, tprefix)):
        page = mod_p.PagedConfig(num_blocks=num_blocks,
                                 block_size=block_size, max_seq=128)
        al = mod_p.BlockAllocator(page, 3)
        out.append((al, mod_t.RadixPrefixCache(
            al, bytes_per_block=10, budget_bytes=10 * budget_blocks)))
    return out


def _state(al, tree):
    return (tree.stats(), dict(tree.tenant_blocks), tree.digest(),
            list(al._free), al._ref.tolist(), al.tables.tolist())


def _play(al, tree, script):
    """Run a script of tree operations; returns every result."""
    res = []
    for op, *args in script:
        if op == "ensure":
            res.append(al.ensure(*args))
        elif op == "insert":
            slot, toks, tenant = args
            res.append(tree.insert(toks, list(al._owned[slot]), tenant=tenant))
        elif op == "match":
            m = tree.match(args[0])
            res.append((m.blocks, m.matched, m.cow))
        elif op == "release":
            res.append(al.release(args[0]))
        elif op == "evict_for":
            res.append(tree.evict_for(args[0]))
        elif op == "clear":
            res.append(tree.clear())
        res.append(_state(al, tree))
    return res


BASE = list(range(100, 148))                   # 3 blocks of 16
SCRIPTS = {
    "share_and_diverge": [
        ("ensure", 0, 48), ("insert", 0, BASE, None),
        ("match", BASE[:47]), ("match", BASE[:20] + [1] * 10),
        ("match", [7] * 40), ("release", 0), ("match", BASE),
        ("evict_for", 1), ("match", BASE), ("clear",)],
    "budget_and_pins": [
        ("ensure", 0, 64), ("insert", 0, list(range(64)), "a"),
        ("ensure", 1, 64), ("insert", 1, list(range(1000, 1064)), "b"),
        ("ensure", 2, 48),
        ("insert", 2, list(range(64))[:32] + list(range(500, 516)), "a"),
        ("release", 0), ("release", 1),
        ("ensure", 0, 64), ("insert", 0, list(range(2000, 2064)), None),
        ("evict_for", 3), ("release", 2), ("clear",)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tree_matches_jax(name):
    """The same operations on both packages' trees: the same matches,
    inserts, evictions, counters, tenant attribution, digests, free lists,
    refcounts and tables after every step."""
    (jal, jtree), (tal, ttree) = _trees(budget_blocks=6 if "budget" in name
                                        else 16)
    want = _play(jal, jtree, SCRIPTS[name])
    got = _play(tal, ttree, SCRIPTS[name])
    assert got == want
    tal.check_invariants()


def test_digest_equals_router_hashes():
    (_, _), (al, tree) = _trees(block_size=16, budget_blocks=4)
    toks = list(range(48))
    assert al.ensure(0, 48)
    tree.insert(toks, list(al._owned[0]))
    want = _RouterState._prefix_hashes(toks)         # cuts 48, 32, 16
    assert set(want) <= set(tree.digest())
    # the router hashes Python ints; numpy ints must not change a hash
    assert tprefix.prefix_hashes(np.array(toks)) == want
    for key in (list(range(300)), tuple(range(20)), "a system prompt" * 9,
                b"\x00\x01" * 70, []):
        assert tprefix.prefix_hashes(key) == _RouterState._prefix_hashes(key)


# ------------------------------------------------------------ the engine

def test_shared_prefix_matches_jax(jparams, tparams, baseline):
    """Four prompts with a shared 24-token system prompt, one after
    another: every repeat hits; tokens, prefix stats and digest equal the
    JAX engine's."""
    lens = [10] * 4
    want, jst, jdig = _sequential(_jax(jparams, prefix_cache="radix"),
                                  PROMPTS[:4], lens)
    got, st, dig = _sequential(_port(tparams, prefix_cache="radix"),
                               PROMPTS[:4], lens)
    assert got == want
    assert got == baseline(PROMPTS[:4], lens)
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert (st["prefix_hits"], st["prefix_misses"]) == (
        jst["prefix_hits"], jst["prefix_misses"])
    assert st["prefix_hits"] >= 3
    assert st["prefix_cache"]["hit_tokens"] >= 3 * 24
    assert dig == jdig and dig


def test_six_requests_three_slots(tparams, baseline):
    """Six staggered threaded requests on 3 slots: admission, finish and
    insert race with the other slots' decode; radix on equals the JAX
    engine with the cache off, token for token."""
    eng = _port(tparams, prefix_cache="radix")
    got, errs = {}, []

    def client(i):
        try:
            got[i] = eng.generate(PROMPTS[i], max_tokens=LENS[i],
                                  timeout_s=120)
        except Exception as e:  # noqa: BLE001
            errs.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150)
        st = eng.stats()
        eng._alloc.check_invariants()
    finally:
        eng.shutdown()
    assert not errs, errs
    assert [got[i] for i in range(6)] == baseline(PROMPTS, LENS)
    assert st["prefix_hits"] >= 1


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_cow_midblock_divergence_matches_jax(jparams, tparams, baseline,
                                             prefill_chunk):
    """The second prompt diverges inside a cached block: the engine copies
    the divergence block and resumes prefill mid-block (one call, or
    chunks of 8), while the cached original serves the first prompt
    again unchanged."""
    seq, lens = [COW_A, COW_B, COW_A], [8, 8, 8]
    kw = dict(prefix_cache="radix", prefill_chunk=prefill_chunk)
    want, jst, jdig = _sequential(_jax(jparams, **kw), seq, lens)
    got, st, dig = _sequential(_port(tparams, **kw), seq, lens)
    assert got == want
    assert got[1] == baseline([COW_B], [8])[0]
    assert st["prefix_cache"]["cow_hits"] >= 1
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefill_chunks_run"] == jst["prefill_chunks_run"]
    assert dig == jdig


def test_pool_pressure_preemption_and_abort(tparams):
    """A tiny pool: admission evicts tree blocks under pressure, decode
    growth preempts slots whose blocks the tree still shares, and two
    requests are cancelled in flight. The allocator's invariants hold, and
    clearing the tree returns every block."""
    eng = _port(tparams, prefix_cache="radix", kv_pool_tokens=96)
    try:
        rids = [eng.submit(p, max_tokens=12) for p in PROMPTS]
        eng.cancel(rids[2])
        eng.cancel(rids[4])
        deadline = time.monotonic() + 120
        pending = set(rids)
        while pending:
            assert time.monotonic() < deadline, "engine did not finish"
            for rid in list(pending):
                if eng.poll(rid)["done"]:
                    pending.discard(rid)
            time.sleep(0.005)
        eng._alloc.check_invariants()
        assert eng.stats()["active_slots"] == 0
        eng._radix.clear()
        eng._alloc.check_invariants()
        assert eng._alloc.free_blocks() == eng._page.num_blocks - 1
    finally:
        eng.shutdown()


def test_match_fault_degrades_to_cold_prefill(tparams, baseline):
    eng = _port(tparams, prefix_cache="radix")
    try:
        faults.inject("serve.llm.prefix_match", "always")
        got, st, _ = _sequential(eng, PROMPTS[:3], [8] * 3)
        assert faults.fired("serve.llm.prefix_match") == 3
    finally:
        faults.clear()
    assert got == baseline(PROMPTS[:3], [8] * 3)
    assert st["prefix_cache"]["match_faults"] == 3
    assert st["prefix_hits"] == 0


def test_insert_fault_skips_whole_insert(tparams, baseline):
    eng = _port(tparams, prefix_cache="radix")
    try:
        faults.inject("serve.llm.prefix_insert", "always")
        got, st, dig = _sequential(eng, PROMPTS[:2], [8, 8])
    finally:
        faults.clear()
    assert got == baseline(PROMPTS[:2], [8, 8])
    assert st["prefix_cache"]["insert_faults"] >= 2
    assert st["prefix_cache"]["cached_blocks"] == 0 and dig == []


def test_fault_schedules():
    try:
        faults.inject("serve.llm.prefix_match", "nth:2")
        fired = []
        for _ in range(4):
            try:
                faults.fault_point("serve.llm.prefix_match")
                fired.append(False)
            except faults.FaultInjected:
                fired.append(True)
        assert fired == [False, True, False, False]
        assert faults.hits("serve.llm.prefix_match") == 4
        with pytest.raises(ValueError, match="unknown fault point"):
            faults.inject("no.such.point")
        with pytest.raises(ValueError, match="unknown fault schedule"):
            faults.inject("serve.llm.prefix_insert", "sometimes")
    finally:
        faults.clear()
    faults.fault_point("serve.llm.prefix_match")        # disarmed: no-op


@pytest.mark.parametrize("kv_cache", ["paged", "slot"])
def test_legacy_matches_jax(jparams, tparams, baseline, kv_cache):
    """The exact-match host cache: the repeat hits and re-injects the
    extracted KV; tokens, prefix stats (entries, host bytes) and digest
    equal the JAX engine's."""
    p = PROMPTS[0]
    kw = dict(prefix_cache="legacy", prefix_cache_size=4, kv_cache=kv_cache)
    want, jst, jdig = _sequential(_jax(jparams, **kw), [p, p], [8, 8])
    got, st, dig = _sequential(_port(tparams, **kw), [p, p], [8, 8])
    assert got == want == baseline([p, p], [8, 8])
    assert st["prefix_cache"]["mode"] == "legacy"
    assert st["prefix_hits"] == 1 and st["prefix_misses"] == 1
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert dig == jdig and dig


def test_legacy_byte_budget(tparams, monkeypatch):
    """The legacy cache is bounded by bytes, not only by entries: a budget
    sized for one entry holds one entry. The mode comes from
    RT_prefix_cache here."""
    monkeypatch.setenv("RT_prefix_cache", "legacy")
    eng = _port(tparams, prefix_cache_size=64, num_slots=2)
    try:
        eng.generate(PROMPTS[0], max_tokens=2)
        one = eng._prefix_cache_hostbytes
        assert one > 0 and eng.stats()["prefix_cache"]["mode"] == "legacy"
    finally:
        eng.shutdown()
    eng = _port(tparams, prefix_cache_size=64, num_slots=2,
                prefix_cache_bytes=int(one * 1.5))
    try:
        for p in PROMPTS[:4]:
            eng.generate(p, max_tokens=2)
        assert len(eng._prefix_cache) == 1
        assert eng._prefix_cache_hostbytes <= one * 1.5
    finally:
        eng.shutdown()


# ------------------------------------------------------------ PD handoff

def _poll_all(eng, rid, timeout_s=60):
    out, deadline = [], time.monotonic() + timeout_s
    while True:
        r = eng.poll(rid)
        out += r["chunks"]
        if r["done"]:
            return out
        assert time.monotonic() < deadline, "engine did not finish"
        time.sleep(0.002)


@pytest.mark.parametrize("dst", ["paged", "slot"])
def test_pd_handoff_from_jax(jparams, tparams, dst):
    """A JAX paged engine's ``_extract_kv`` (through its legacy cache)
    into the port's ``submit_prefilled``: the port decodes the JAX
    engine's tokens; a KV of the wrong shape is refused in the caller's
    thread."""
    prompt = PROMPTS[2]
    src = _jax(jparams, prefix_cache="legacy", kv_cache="paged")
    try:
        want = src.generate(prompt, max_tokens=10)
        ent = src._prefix_cache[tuple(prompt)]
    finally:
        src.shutdown()
    assert ent["k"].shape[1] == len(prompt)
    eng = _port(tparams, kv_cache=dst)
    try:
        rid = eng.submit_prefilled(prompt, ent["k"], ent["v"], ent["logits"],
                                   max_tokens=10)
        assert _poll_all(eng, rid) == want
        with pytest.raises(ValueError, match="prefilled KV shape"):
            eng.submit_prefilled(prompt, ent["k"][:, :-1], ent["v"],
                                 ent["logits"], max_tokens=10)
        assert eng.stats()["prefix_cache"]["mode"] == "off"
    finally:
        eng.shutdown()
