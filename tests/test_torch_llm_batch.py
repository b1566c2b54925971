"""The port's batch LLM inference (``ray_tpu_torch.llm``) against
``ray_tpu.llm`` on the CPU. The JAX package's ``debug`` weights go two
ways: saved as the JAX package's own checkpoint, and converted
(``models/convert.py``) and saved as the port's ``Checkpoint``; each
package's engine stage reads its own through ``params_path``.

The reference is the JAX package's engine stage (``ray_tpu.llm.batch.
_EngineStage``, what its processor runs in each pool actor), built in this
process from the JAX checkpoint and called on the same batches the JAX
processor would hand it (the same blocks, batch size and Arrow-to-numpy
conversion). The port goes through its whole processor
(``build_llm_processor``: preprocess, the actor-pool engine stage,
postprocess) on a port cluster, with ``device="cpu"``. Held equal
(tolerance: none): the greedy ``generated_tokens`` and ``generated_text``
of every row from a ``prompt`` column and from a ``prompt_tokens`` column,
and the missing-column error's message. With ``device=None`` the port's
stage means the card and raises where there is none.

(No JAX cluster runs here: a JAX engine actor lives for seconds, and under
the parallel tier-1 run another JAX test file's teardown ``pkill``s it,
ROADMAP.md C.2; ``tests/test_llm_batch.py`` runs the JAX processor.)
"""

import pickle
import threading

import numpy as np
import pytest

from _torch_isolation import _module_isolation_guard  # noqa: F401

MISSING = "engine stage needs a 'prompt' or 'prompt_tokens' column"
QUESTIONS = [f"Q{i}: {'ab' * i}?" for i in range(6)]
TOKEN_LENGTHS = (3, 9, 1, 17, 5)
# name: (rows, num_blocks, batch_size, max_tokens, num_slots)
CASES = {
    "prompt": ([{"question": q} for q in QUESTIONS], 2, 4, 8, 4),
    "tokens": ([{"prompt_tokens": [int(x) for x in np.random.default_rng(
        3).integers(0, 256, n)]} for n in TOKEN_LENGTHS], 2, 3, 6, 2),
    "missing": ([{"oops": 1}], 1, 16, 32, 8),
}


def _pre(row):
    return {**row, "prompt": "Answer " + row["question"]}


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """The JAX ``debug`` weights as each package's checkpoint."""
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.train.checkpoint import Checkpoint as TCheckpoint

    jparams = jllama.init_params(jllama.CONFIGS["debug"], jax.random.key(0))
    root = tmp_path_factory.mktemp("llm_batch")
    JCheckpoint.from_pytree(str(root / "jax"), jparams)
    TCheckpoint.from_pytree(str(root / "port"), params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    return {"ray_tpu": str(root / "jax"), "ray_tpu_torch": str(root / "port")}


def _jax_case(path, name):
    """The JAX engine stage over ``name``'s rows, block by block and batch
    by batch as the JAX processor feeds its pool actor: the output rows,
    or the error it raised."""
    from ray_tpu.data import block as jblock
    from ray_tpu.llm import ProcessorConfig
    from ray_tpu.llm.batch import _EngineStage

    rows, num_blocks, batch_size, max_tokens, num_slots = CASES[name]
    if name == "prompt":
        rows = [_pre(r) for r in rows]
    stage = _EngineStage(pickle.dumps(ProcessorConfig(
        model="debug", params_path=path, batch_size=batch_size,
        max_tokens=max_tokens, num_slots=num_slots)))
    try:
        per = -(-len(rows) // num_blocks)
        out = []
        for i in range(num_blocks):
            batch = jblock.block_to_batch(
                jblock.block_from_rows(rows[i * per:(i + 1) * per]))
            n = len(next(iter(batch.values())))
            for lo in range(0, n, batch_size):
                res = stage({k: v[lo:lo + batch_size]
                             for k, v in batch.items()})
                out += [dict(zip(res, vals)) for vals in zip(*res.values())]
        return out
    except Exception as e:  # noqa: BLE001 — the error is the result
        return e
    finally:
        stage.engine.shutdown()


@pytest.fixture(scope="module")
def jax_reference(params_path):
    """Each case through the JAX engine stage, one after another (JAX
    engines built side by side in one process crashed it)."""
    return {name: _jax_case(params_path["ray_tpu"], name) for name in CASES}


@pytest.fixture(scope="module")
def port_runs(params_path):
    """Each case through the port's whole processor on a port cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data, llm

    rt.init(num_cpus=4, num_gpus=1)
    out = {}

    def run(name):
        rows, num_blocks, batch_size, max_tokens, num_slots = CASES[name]
        processor = llm.build_llm_processor(
            llm.ProcessorConfig(
                model="debug", params_path=params_path["ray_tpu_torch"],
                concurrency=1, batch_size=batch_size, max_tokens=max_tokens,
                num_slots=num_slots, device="cpu"),
            # made here, whole, so cloudpickle ships it by value (_pre's)
            preprocess=(lambda row: {**row, "prompt": "Answer "
                                     + row["question"]})
            if name == "prompt" else None)
        try:
            out[name] = processor(data.from_items(
                rows, num_blocks=num_blocks)).take_all()
        except Exception as e:  # noqa: BLE001 — the error is the result
            out[name] = e

    try:
        threads = [threading.Thread(target=run, args=(n,)) for n in CASES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        yield out
    finally:
        rt.shutdown()


def _cols(rows, *cols):
    return [tuple(r[c] if c == "generated_text" else
                  [int(t) for t in r[c]] for c in cols) for r in rows]


def test_prompt_column_greedy_tokens(port_runs, jax_reference):
    got, want = port_runs["prompt"], jax_reference["prompt"]
    assert isinstance(got, list) and isinstance(want, list), (got, want)
    assert len(got) == len(QUESTIONS)
    assert all(len(r["generated_tokens"]) == 8 for r in got)
    assert [r["question"] for r in got] == [r["question"] for r in want]
    assert _cols(got, "generated_tokens", "generated_text") == _cols(
        want, "generated_tokens", "generated_text")


def test_prompt_tokens_column_greedy_tokens(port_runs, jax_reference):
    got, want = port_runs["tokens"], jax_reference["tokens"]
    assert isinstance(got, list) and isinstance(want, list), (got, want)
    assert len(got) == len(TOKEN_LENGTHS)
    assert all(len(r["generated_tokens"]) == 6 for r in got)
    assert _cols(got, "prompt_tokens", "generated_tokens") == _cols(
        want, "prompt_tokens", "generated_tokens")


def test_missing_prompt_column_error(port_runs, jax_reference):
    got, want = port_runs["missing"], jax_reference["missing"]
    assert isinstance(want, KeyError) and MISSING in str(want), want
    assert isinstance(got, Exception) and MISSING in str(got), got


def test_engine_stage_on_the_card_by_default(monkeypatch):
    """``ProcessorConfig(device=None)`` is the card: without CUDA the stage
    raises instead of running on the CPU."""
    import torch

    from ray_tpu_torch.llm import ProcessorConfig
    from ray_tpu_torch.llm.batch import _EngineStage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ProcessorConfig().device is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _EngineStage(pickle.dumps(ProcessorConfig(model="debug")))
