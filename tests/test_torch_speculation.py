"""The port's speculative decoding against ray_tpu's, on the CPU
(mirroring tests/test_speculation.py), on converted ``debug`` weights.

- Host code: ``propose_ngram``, ``accept_greedy``, ``accept_speculative``
  and ``SpeculationConfig`` give exactly the reference's results (and
  errors) on the same seeded numpy inputs; the acceptance rule makes the
  same ``rng`` calls (the generators end in the same state).
- Layers: the batched verify and the KV ingest against the JAX ones, f32,
  windows of 0, 1, 3 and 5 tokens, one ending at ``max_seq`` with its
  padding past it: logits of the valid rows within 1e-4, the cache within
  1e-5 and its lengths exact (the chunked-prefill layer tests'
  tolerances); the ingest writes the verify's cache bit for bit.
  ``sample_token``: greedy equals argmax and JAX's; above temperature 0,
  seeded draws repeat, stay in range and follow the softmax.
- The engine: greedy tokens equal the JAX engine's and the port's plain
  engine's, sequentially (with the same ``spec_*`` stats as the JAX
  engine) and 6 requests on 3 slots threaded, for ngram, a draft of the
  target's weights and a draft of other weights; the reference's edge
  cases; speculation with chunked prefill, the legacy prefix cache and
  ``submit_prefilled``.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decoding as jdecoding
from ray_tpu.models import llama as jllama
from ray_tpu.models import speculation as jspec
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch.models import decoding as tdecoding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import speculation as tspec
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve.llm import LLMEngine

from _torch_isolation import _module_isolation_guard  # noqa: F401

JCFG = jllama.CONFIGS["debug"]
TCFG = tllama.CONFIGS["debug"]

# prompts with n-gram structure (lookup hits) and without
PROMPTS = [
    [3, 4, 5, 6, 3, 4, 5, 6, 3, 4],
    [11, 23, 7, 91, 2, 57],
    [9, 9, 9, 9, 9, 9, 9, 9],
    [100, 2, 3],
    [42, 17, 42, 17, 42, 17, 42],
    [7],
]
LENS = [14, 6, 10, 8, 12, 5]
SPECS = ["ngram", "draft-same", "draft-other"]


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) of the target (key 0) and of another
    draft (key 7)."""
    out = {}
    for name, key in (("target", 0), ("other", 7)):
        jp = jllama.init_params(JCFG, jax.random.key(key))
        out[name] = (jp, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp)))
    return out


def _spec(weights, name, pkg):
    """The engine's ``speculation`` for ``name`` in package ``pkg``."""
    if name == "ngram":
        return "ngram"
    i = 0 if pkg == "jax" else 1
    cfg = JCFG if pkg == "jax" else TCFG
    params = weights["target" if name == "draft-same" else "other"][i]
    return {"method": "draft", "k": 4 if name == "draft-same" else 3,
            "draft_config": cfg, "draft_params": params}


def _jax(weights, **kw):
    kw.setdefault("num_slots", 4)
    return JaxEngine(config=JCFG, params=weights["target"][0],
                     kv_cache="slot", seed=0, **kw)


def _port(weights, **kw):
    kw.setdefault("num_slots", 4)
    return LLMEngine(config=TCFG, params=weights["target"][1],
                     kv_cache="slot", seed=0, device="cpu", **kw)


def _sequential(eng, prompts, max_tokens=12, **gen_kw):
    try:
        return [eng.generate(p, max_tokens=max_tokens, timeout_s=120,
                             **gen_kw) for p in prompts], eng.stats()
    finally:
        eng.shutdown()


def _threaded(eng):
    """PROMPTS with LENS, one thread each: slots free up and re-admit
    while other slots are mid-speculation."""
    got, errs = {}, []

    def client(i):
        try:
            got[i] = eng.generate(PROMPTS[i], max_tokens=LENS[i],
                                  timeout_s=120)
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150)
            assert not t.is_alive()
        return got, eng.stats()
    finally:
        eng.shutdown()
        assert not errs, errs


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engine's sequential speculative runs (tokens, stats) on
    PROMPTS[:3], per proposer, and its plain tokens for each of PROMPTS at
    LENS."""
    runs = {name: _sequential(_jax(weights, speculation=_spec(
        weights, name, "jax")), PROMPTS[:3]) for name in SPECS}
    eng = _jax(weights, num_slots=3)
    try:
        runs["plain"] = {i: eng.generate(p, max_tokens=LENS[i])
                         for i, p in enumerate(PROMPTS)}
    finally:
        eng.shutdown()
    return runs


@pytest.fixture(scope="module")
def port_plain(weights):
    """The port's plain engine: ``generate(prompt, max_tokens)``, cached."""
    eng = _port(weights)
    memo = {}

    def generate(prompt, max_tokens, eos_token=None):
        key = (tuple(prompt), max_tokens, eos_token)
        if key not in memo:
            memo[key] = eng.generate(prompt, max_tokens=max_tokens,
                                     eos_token=eos_token, timeout_s=120)
        return memo[key]

    yield generate
    eng.shutdown()


# ------------------------------------------------------------ host code

def test_ngram_lookup_matches_reference():
    assert tspec.propose_ngram([1, 2, 3, 4, 1, 2], 3) == [3, 4, 1]
    assert tspec.propose_ngram([1, 2, 3, 4, 5, 6], 3) is None
    assert tspec.propose_ngram([1, 2], 3) is None
    assert tspec.propose_ngram([1, 2, 3], 0) is None
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(300):
        ctx = rng.integers(0, 6, int(rng.integers(0, 30))).tolist()
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 4))
        want = jspec.propose_ngram(ctx, k, n)
        assert tspec.propose_ngram(ctx, k, n) == want, (ctx, k, n)
        hits += want is not None
    assert hits > 50


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acceptance_matches_reference(temperature, seed):
    """Same logits, proposals and rng seed: the same emitted tokens and
    accepted counts, and both generators end in the same state. Half the
    proposals follow the argmax chain (long accepted runs), the rest are
    drawn at random; logits are scaled so some rows are near deltas."""
    rng = np.random.default_rng(seed)
    V = 32
    j_rng, t_rng = (np.random.default_rng(100 + seed) for _ in range(2))
    runs = 0
    for trial in range(40):
        m = int(rng.integers(0, 6))
        logits = (rng.standard_normal((m + 1, V))
                  * rng.choice([0.5, 3.0, 30.0])).astype(np.float32)
        if trial % 2:
            prop = [int(t) for t in logits[:m].argmax(-1)]
        else:
            prop = rng.integers(0, V, m).tolist()
        want = jspec.accept_speculative(logits, prop, temperature, j_rng)
        got = tspec.accept_speculative(logits, prop, temperature, t_rng)
        assert got == want, (trial, got, want)
        if temperature == 0.0:
            assert tspec.accept_greedy(logits.argmax(-1), prop) == \
                jspec.accept_greedy(logits.argmax(-1), prop) == want
        runs += want[1]
    assert j_rng.random() == t_rng.random()
    assert runs > 0


@pytest.mark.parametrize("spec", [
    "ngram", "draft", {"method": "ngram", "k": 2, "ngram": 3},
    {"method": "draft", "k": 2, "draft_model": "debug"},
    {"method": "draft", "draft_model": "1b", "draft_seed": 5},
    {"k": 7}])
def test_config_parse_matches_reference(spec):
    def parse(mod):
        try:
            return mod.SpeculationConfig.parse(spec, default_k=3).to_dict()
        except ValueError as e:
            # the port's messages name its own config table
            return "ValueError: " + str(e).replace("ray_tpu_torch.",
                                                   "ray_tpu.")

    assert parse(tspec) == parse(jspec)


@pytest.mark.parametrize("spec,match", [
    ("medusa", "one of"), ({"method": "ngram", "krazy": 1}, "unknown fields"),
    ({"method": "ngram", "k": 0}, "positive"),
    ({"method": "ngram", "ngram": 0}, "positive"),
    ("draft", "draft_model"), (3, "method string or dict"),
    ({"method": "ngram", "enabled": False}, "unknown fields")])
def test_config_errors_match_reference(spec, match):
    for mod in (jspec, tspec):
        with pytest.raises(ValueError, match=match):
            mod.SpeculationConfig.parse(spec)


def test_draft_vocab_mismatch_and_unknown_model_raise(weights):
    bad = dataclasses.replace(TCFG, vocab_size=TCFG.vocab_size // 2)
    with pytest.raises(ValueError, match="tokenizer mismatch"):
        _port(weights, speculation={"method": "draft", "draft_config": bad,
                                    "draft_params": None})
    with pytest.raises(ValueError, match="not in"):
        _port(weights, speculation={"method": "draft",
                                    "draft_model": "debugg"})


# ------------------------------------------------------------ layers

# slots at 4, 2, 3 and 27 cached tokens; windows of 3, 0, 1 and 5 tokens
# in a buffer of 6, the last ending exactly at max_seq = 32 with a padding
# row past it
LAYER_PROMPTS = [[5, 6, 7, 8], [1, 2], [9, 9, 9], list(range(40, 67))]
WINDOWS = [[4, 2, 0], [], [13], [3, 1, 7, 7, 2]]
MAX_SEQ = 32


def _window_run(pkg, params, ingest_only=False):
    j = pkg == "jax"
    mod = jdecoding if j else tdecoding
    cfg = JCFG if j else TCFG
    arr = jnp.asarray if j else (lambda a: a)
    cache = mod.init_cache(cfg, 4, MAX_SEQ)
    prefill = mod.make_prefill(params, cfg)
    for slot, toks in enumerate(LAYER_PROMPTS):
        buf = np.zeros((1, 32), np.int32)
        buf[0, :len(toks)] = toks
        cache, _ = prefill(cache, arr(buf), len(toks), slot)
    tokens = np.zeros((4, 6), np.int32)
    for slot, w in enumerate(WINDOWS):
        tokens[slot, :len(w)] = w
    lens = np.array([len(w) for w in WINDOWS], np.int32)
    starts = np.array([len(p) for p in LAYER_PROMPTS], np.int32)
    if ingest_only:
        cache, logits = mod.make_kv_ingest(params, cfg)(
            cache, arr(tokens), lens, starts), None
    else:
        cache, logits = mod.make_batched_spec_verify(params, cfg)(
            cache, arr(tokens), lens, starts)
    host = np.asarray if j else (lambda t: t.numpy())
    return ({k: host(v) for k, v in cache.items()},
            None if logits is None else host(logits))


def test_verify_and_ingest_match_jax(weights):
    (jp, tp) = weights["target"]
    jcache, jlogits = _window_run("jax", jp)
    jing, _ = _window_run("jax", jp, ingest_only=True)
    with torch.inference_mode():
        tcache, tlogits = _window_run("torch", tp)
        ting, _ = _window_run("torch", tp, ingest_only=True)
    assert tlogits.shape == jlogits.shape == (4, 6, TCFG.vocab_size)
    for slot, w in enumerate(WINDOWS):
        np.testing.assert_allclose(tlogits[slot, :len(w)],
                                   jlogits[slot, :len(w)], rtol=1e-4,
                                   atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key], jcache[key], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ting[key], jing[key], rtol=1e-5,
                                   atol=1e-5)
    want_len = [4 + 3, 2, 3 + 1, MAX_SEQ]
    assert tcache["length"].tolist() == jcache["length"].tolist() == want_len
    # the ingest writes the verify's rows, bit for bit
    for key in ("k", "v", "length"):
        assert np.array_equal(ting[key], tcache[key]), key


def test_verify_rows_equal_decode_steps(weights):
    """A window of the next five greedy tokens, from a slot at 27 cached
    tokens to the cache's end (max_seq 32, padding past it), gives the
    logits and K/V rows of five plain decode steps (f32: within 1e-4 and
    1e-5); the other slot stays untouched."""
    _, tp = weights["target"]
    prompt = LAYER_PROMPTS[3]
    with torch.inference_mode():
        cache = tdecoding.init_cache(TCFG, 2, MAX_SEQ)
        buf = np.zeros((1, 32), np.int32)
        buf[0, :len(prompt)] = prompt
        cache, lg = tdecoding.make_prefill(tp, TCFG)(cache, buf,
                                                      len(prompt), 1)
        start = {k: v.clone() for k, v in cache.items()}
        step = tdecoding.make_decode_step(tp, TCFG)
        toks, rows = [int(lg.argmax())], []
        for _ in range(5):
            cache, lg = step(cache, np.array([0, toks[-1]], np.int32),
                             np.array([False, True]))
            rows.append(lg[1])
            toks.append(int(lg[1].argmax()))
        win = np.zeros((2, 6), np.int32)
        win[1, :5] = toks[:5]
        got, logits = tdecoding.make_batched_spec_verify(tp, TCFG)(
            start, win, np.array([0, 5]), np.array([0, len(prompt)]))
    np.testing.assert_allclose(logits[1, :5].numpy(),
                               torch.stack(rows).numpy(), rtol=1e-4,
                               atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key].numpy(), cache[key].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert got["length"].tolist() == cache["length"].tolist() == [0, MAX_SEQ]


def test_sampling_params_match_reference():
    assert dataclasses.asdict(tdecoding.SamplingParams()) == \
        dataclasses.asdict(jdecoding.SamplingParams())


def test_sample_token_greedy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 64)).astype(np.float32)
    logits[0, 0, [7, 9]] = 100.0            # a tie: the first index wins
    want, _ = jdecoding.sample_token(jnp.asarray(logits), 0.0,
                                     jax.random.key(0))
    got, gen = tdecoding.sample_token(torch.from_numpy(logits), 0.0, None)
    assert gen is None and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), logits.argmax(-1))
    assert got[0, 0] == 7


def test_sample_token_temperature_draws():
    """Seeded draws repeat; tokens lie in the vocab; over 40000 draws each
    token's frequency is within 0.01 of softmax(logits / T) (the standard
    error is at most 0.0025)."""
    logits = torch.tensor([1.0, 2.0, 0.5, -1.0, 1.5])
    rows = logits.expand(40000, 5)
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        tok, gen2 = tdecoding.sample_token(rows, 0.8, gen)
        assert gen2 is gen and tok.dtype == torch.int32
        draws.append(tok)
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < 5
    freq = torch.bincount(draws[0].long(), minlength=5).double() / 40000
    want = torch.softmax(logits.double() / 0.8, -1)
    assert (freq - want).abs().max() < 0.01, (freq, want)
    again, _ = tdecoding.sample_token(rows[:10], 0.8, gen)
    assert not torch.equal(again, draws[0][:10])   # the generator advanced


# ------------------------------------------------------------ engine

@pytest.mark.parametrize("name", SPECS)
def test_sequential_matches_jax_and_plain(weights, jax_runs, port_plain,
                                          name):
    want, jst = jax_runs[name]
    got, st = _sequential(_port(weights, speculation=_spec(
        weights, name, "torch")), PROMPTS[:3])
    assert got == want == [port_plain(p, 12) for p in PROMPTS[:3]]
    spec_keys = {k for k in jst if k.startswith("spec")} | {"steps"}
    assert {k: st[k] for k in spec_keys} == {k: jst[k] for k in spec_keys}
    assert st["spec_proposed"] > 0
    if name == "draft-same":     # the all-k acceptance path and catch-up
        assert st["spec_accepted"] == st["spec_proposed"]
        assert st["spec_draft_steps"] > 0


@pytest.mark.parametrize("name", SPECS)
def test_stats_surface_with_speculation(weights, jax_runs, name):
    """With speculation on, ``stats()`` has the reference's keys (the port
    adds ``device``), and the engine the reference's attributes."""
    eng = _port(weights, speculation=_spec(weights, name, "torch"))
    try:
        st = eng.stats()
        assert (eng.speculation, eng.spec_k) == (
            "ngram" if name == "ngram" else "draft",
            {"ngram": 4, "draft-same": 4, "draft-other": 3}[name])
    finally:
        eng.shutdown()
    assert set(st) - {"device"} == set(jax_runs[name][1])
    assert (st["spec_proposed"], st["spec_acceptance_rate"]) == (0, None)


@pytest.mark.parametrize("name", SPECS)
def test_threaded_six_on_three_slots(weights, jax_runs, port_plain, name):
    got, st = _threaded(_port(weights, num_slots=3, speculation=_spec(
        weights, name, "torch")))
    assert got == jax_runs["plain"]
    assert got == {i: port_plain(p, LENS[i]) for i, p in enumerate(PROMPTS)}
    assert st["spec_proposed"] > 0
    assert st["spec_acceptance_rate"] is not None


def test_ingest_catch_up_equals_verify_catch_up(weights, port_plain):
    """A draft whose catch-up rides the full verify (the reference's path
    before its KV-only ingest) gives the same tokens as the ingest."""
    outs = []
    for patch in (True, False):
        eng = _port(weights, speculation=_spec(weights, "draft-other",
                                               "torch"))
        prop = eng._proposer
        if patch:
            verify = tdecoding.make_batched_spec_verify(prop.params,
                                                        prop.config)
            prop._ingest = lambda *a: verify(*a)[0]
        outs.append(_sequential(eng, PROMPTS[:4])[0])
    assert outs[0] == outs[1] == [port_plain(p, 12) for p in PROMPTS[:4]]


@pytest.mark.parametrize("name", ["ngram", "draft-same"])
def test_eos_inside_the_window(weights, port_plain, name):
    full = port_plain(PROMPTS[0], 12)
    # the first token at index >= 1 not seen before it: with k=4 it lands
    # inside the first speculative window, not on its boundary
    idx = next(i for i in range(1, 5) if full[i] not in full[:i])
    eos = full[idx]
    want = port_plain(PROMPTS[0], 12, eos_token=eos)
    assert want == full[:idx + 1]
    got, _ = _sequential(_port(weights, speculation=_spec(
        weights, name, "torch")), [PROMPTS[0]], eos_token=eos)
    assert got[0] == want


def test_max_tokens_inside_an_accepted_run(weights, port_plain):
    """max_tokens=3 with k=4 and a draft of the target: the first window
    would emit 5 tokens. The emitted tokens stop at 3, and the next
    request on the reused slot is right."""
    eng = _port(weights, speculation=_spec(weights, "draft-same", "torch"))
    try:
        got = eng.generate(PROMPTS[0], max_tokens=3)
        again = eng.generate(PROMPTS[1], max_tokens=8)
    finally:
        eng.shutdown()
    assert got == port_plain(PROMPTS[0], 12)[:3]
    assert again == port_plain(PROMPTS[1], 8)


@pytest.mark.parametrize("name", ["draft-same", "ngram"])
def test_window_filling_the_cache_to_max_seq(weights, name):
    """prompt + max_tokens == max_seq: the last window ends exactly at the
    cache's end, its padding past it."""
    prompt = PROMPTS[0]
    mtok = MAX_SEQ - len(prompt)
    want, _ = _sequential(_port(weights, max_seq=MAX_SEQ), [prompt], mtok)
    got, st = _sequential(_port(weights, max_seq=MAX_SEQ, speculation=_spec(
        weights, name, "torch")), [prompt], mtok)
    assert got == want and len(got[0]) == mtok
    assert st["spec_proposed"] > 0


@pytest.mark.parametrize("name", ["ngram", "draft-other"])
def test_temperature_same_seed_determinism(weights, name):
    outs = []
    for _ in range(2):
        toks, _ = _sequential(_port(weights, speculation=_spec(
            weights, name, "torch")), PROMPTS[:3], 10, temperature=0.8)
        outs.append(toks)
    assert outs[0] == outs[1]
    for toks in outs[0]:
        assert len(toks) == 10
        assert all(0 <= t < TCFG.vocab_size for t in toks)


def test_per_request_opt_out_and_k_override(weights, port_plain):
    eng = _port(weights, speculation="ngram")
    try:
        off = eng.generate(PROMPTS[0], max_tokens=12, speculation=False)
        st_off = eng.stats()
        k1 = eng.generate(PROMPTS[0], max_tokens=12, speculation={"k": 1})
        mixed = eng.generate(PROMPTS[1], max_tokens=12)
        with pytest.raises(ValueError, match="unknown fields"):
            eng.generate(PROMPTS[0], speculation={"nope": 1})
    finally:
        eng.shutdown()
    assert off == k1 == port_plain(PROMPTS[0], 12)
    assert st_off["spec_proposed"] == 0
    assert mixed == port_plain(PROMPTS[1], 12)


def test_rejections_keep_state_consistent(weights, port_plain):
    """Near-zero acceptance (another draft on a structureless prompt):
    rejected rows past the length stay invisible."""
    got, st = _sequential(_port(weights, speculation=_spec(
        weights, "draft-other", "torch")), [PROMPTS[1]], 14)
    assert got[0] == port_plain(PROMPTS[1], 14)
    assert st["spec_proposed"] > 0


def test_out_of_vocab_prompt_rejected(weights, port_plain):
    eng = _port(weights, speculation="ngram")
    try:
        bad = TCFG.vocab_size + 7
        with pytest.raises(ValueError, match="vocab range"):
            eng.generate([bad, 2, bad, 2, bad], max_tokens=4,
                         temperature=0.8)
        ok = eng.generate(PROMPTS[1], max_tokens=6)
    finally:
        eng.shutdown()
    assert ok == port_plain(PROMPTS[1], 6)


# ------------------------------------- with chunked prefill, legacy, PD

CHUNK_PROMPTS = [list(range(1, 30)) * 2, [5, 6, 7, 5, 6], [8, 9] * 20]


@pytest.mark.parametrize("name", ["ngram", "draft-other"])
def test_with_chunked_prefill_matches_jax(weights, name):
    """Chunks of 16 (59 tokens run 4 chunks, 40 run 3): the proposer
    admits the slot after its last chunk."""
    kw = dict(prefill_chunk=16)
    want, jst = _sequential(_jax(weights, speculation=_spec(
        weights, name, "jax"), **kw), CHUNK_PROMPTS, 10)
    got, st = _sequential(_port(weights, speculation=_spec(
        weights, name, "torch"), **kw), CHUNK_PROMPTS, 10)
    assert got == want
    assert st["prefill_chunks_run"] == jst["prefill_chunks_run"] == 7
    assert st["spec_proposed"] == jst["spec_proposed"] > 0
    assert st["spec_accepted"] == jst["spec_accepted"]


def test_with_legacy_prefix_cache_matches_jax(weights):
    """The repeat hits the legacy cache and injects its KV; the draft
    admits the slot on the hit."""
    p = PROMPTS[0]
    kw = dict(prefix_cache="legacy", prefix_cache_size=4)
    want, jst = _sequential(_jax(weights, speculation=_spec(
        weights, "draft-other", "jax"), **kw), [p, p])
    got, st = _sequential(_port(weights, speculation=_spec(
        weights, "draft-other", "torch"), **kw), [p, p])
    assert got == want and got[0] == got[1]
    assert st["prefix_hits"] == jst["prefix_hits"] == 1
    assert st["spec_proposed"] == jst["spec_proposed"] > 0


def test_submit_prefilled_with_draft_matches_jax(weights):
    """A JAX engine's extracted KV into the port's speculative engine
    (``submit_prefilled``): the draft admits the slot, and the tokens are
    the JAX engine's."""
    prompt = PROMPTS[4]
    src = _jax(weights, prefix_cache="legacy")
    try:
        want = src.generate(prompt, max_tokens=10)
        ent = src._prefix_cache[tuple(prompt)]
    finally:
        src.shutdown()
    eng = _port(weights, speculation=_spec(weights, "draft-same", "torch"))
    try:
        rid = eng.submit_prefilled(prompt, ent["k"], ent["v"], ent["logits"],
                                   max_tokens=10)
        got, deadline = [], time.monotonic() + 60
        while True:
            r = eng.poll(rid)
            got += r["chunks"]
            if r["done"]:
                break
            assert time.monotonic() < deadline, "engine did not finish"
            time.sleep(0.002)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == want
    assert st["spec_accepted"] == st["spec_proposed"] > 0
