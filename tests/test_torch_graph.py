"""The port's compiled graphs (``ray_tpu_torch.graph``: DAG nodes, the
RPC and channel forms of ``experimental_compile``, shm and device
channels, collective nodes) against ``ray_tpu.graph`` on the CPU: one
module-scoped cluster per package (one at a time), and one scenario
program run through both packages' graph APIs, taken from
tests/test_graph.py, test_graph_collective.py and test_channels.py. Each
part's results are held to stated values and, for the port, to what
``ray_tpu`` gave on the same part:

- eager: a function chain, an actor pipeline, multi-output with input
  fields; a compiled (RPC) DAG reusing one actor;
- channels: a diamond whose last stage fans in two stage outputs and an
  input field, twelve items in flight, and a missing field that comes
  back as the item's typed error;
- collectives: eager allreduce (sum and mean) and allreduce between
  channel stages;
- the rejections those files hold;
- stage errors: a raising stage comes back typed and the pipeline lives
  on; a killed stage surfaces as ``PipelineStageError`` within its
  deadline;
- the device channel carrying bf16 and f32 CPU tensors (jax arrays in
  ``ray_tpu``), and the mutable channel's primitives in this process;
- a stage bound with an ObjectRef argument: the port's stage sees the
  value in every form, ``ray_tpu``'s channel form hands it the reference.

Then the ``debug`` Llama as a two-stage pipeline in both packages, on
seeded weights of the JAX init's shapes (converted for the port), over shm and over device
channels: the port's logits within ``rtol=atol=1e-4`` of ``ray_tpu``'s
(the tolerance of tests/test_torch_models.py's forward) and within 1e-6
of the port's own ``forward``.

In this process, with no cluster: the port's stage exec loop follows
``pipeline_overlap`` (its prefetch thread reads ahead, or not), and the
port's KV collective group, its ranks on threads over an in-memory KV,
gives ``ray_tpu``'s results op for op on numpy operands and tensors of
the operand's dtype on tensor operands; ``split_params`` copies shards.

Only ``ray_tpu``'s side runs a part once more, on a fresh cluster, when
it fails: tests/conftest.py's module guard ends every JAX-package test
file with a machine-wide ``pkill`` of ``ray_tpu``'s worker command lines,
so under xdist another file's teardown can kill this file's ``ray_tpu``
workers (ROADMAP.md C.2). The port's workers cannot be reached that way,
so the port fails on its first error.
"""

import importlib
import pickle
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama

from _torch_dist import MemoryKV
from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
TIMEOUT = 60
JAX_ATTEMPTS = 3
KILL_DEADLINE_S = 15.0
LOGITS_TOL = 1e-4     # tests/test_torch_models.py's forward tolerance
# what ray_tpu gave on each part, for the port's run to equal
_RESULTS = {}


class _Pkg:
    """One package's runtime and graph API."""

    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.graph = importlib.import_module(f"{name}.graph")
        self.compiled = importlib.import_module(f"{name}.graph.compiled")
        self.channels = importlib.import_module(f"{name}.graph.channels")
        self.port = name == "ray_tpu_torch"

    def start(self):
        if self.port:
            self.rt.init(num_cpus=4, num_gpus=0)
        else:
            self.rt.init(num_cpus=4, num_tpus=0)

    def stop(self):
        self.rt.shutdown()


@pytest.fixture(scope="module", params=PACKAGES)
def pkg(request):
    p = _Pkg(request.param)
    p.start()
    yield p
    p.stop()


def _run(p, part):
    """``part(p)``; for ``ray_tpu`` only, again on a fresh cluster when it
    fails (see the module docstring)."""
    if p.port:
        return part(p)
    for attempt in range(JAX_ATTEMPTS):
        try:
            return part(p)
        except Exception:  # noqa: BLE001 — the last attempt re-raises
            if attempt == JAX_ATTEMPTS - 1:
                raise
            p.stop()
            p.start()


# ---------------------------------------------------------------- classes
# Made inside functions so cloudpickle ships them by value: the workers
# need not import this test module.

def _classes():
    class Stage:
        def __init__(self, offset):
            self.offset = offset
            self.calls = 0

        def step(self, x):
            self.calls += 1
            return x + self.offset

        def count(self):
            return self.calls

    class Arith:
        def __init__(self, k=1):
            self.k = k

        def add(self, x):
            return x + self.k

        def mul(self, x):
            return x * self.k

        def combine(self, a, b, offset):
            return (a, b, offset)

        def checked(self, x):
            if x < 0:
                raise ValueError(f"boom on {x}")
            return x + self.k

    class GradWorker:
        def __init__(self, scale):
            self.scale = scale

        def grad(self, x):
            return np.asarray(x, np.float32) * self.scale

        def norm(self, g):
            return float(np.sum(g))

    return Stage, Arith, GradWorker


def _scale_class(port):
    """A stage multiplying a tensor (a jax array in ray_tpu) by ``k``; it
    imports its array library as it is made, so the stages load theirs
    side by side, not one after the other on the first item."""
    if port:
        class Scale:
            def __init__(self, k):
                import torch as _torch

                self.k, self.lib = k, _torch

            def mul(self, x):
                return self.lib.as_tensor(x) * self.k
    else:
        class Scale:
            def __init__(self, k):
                import jax.numpy as _jnp

                self.k, self.lib = k, _jnp

            def mul(self, x):
                return self.lib.asarray(x) * self.k
    return Scale


# ------------------------------------------------------------- the parts

def _eager(p):
    rt, g = p.rt, p.graph
    Stage, _, _ = _classes()

    @rt.remote
    def double(x):
        return 2 * x

    out = {}
    with g.InputNode() as inp:
        dag = double.bind(double.bind(inp))
    out["function_chain"] = rt.get(dag.execute(3), timeout=TIMEOUT)
    S = rt.remote(Stage)
    with g.InputNode() as inp:
        dag = S.bind(100).step.bind(S.bind(10).step.bind(inp))
    out["actor_pipeline"] = rt.get(dag.execute(1), timeout=TIMEOUT)
    with g.InputNode() as inp:
        dag = g.MultiOutputNode([double.bind(inp.x), double.bind(inp[1])])
    out["multi_output_fields"] = rt.get(dag.execute(0, 7, x=3),
                                        timeout=TIMEOUT)
    with g.InputNode() as inp:
        dag = S.options(num_cpus=0).bind(1).step.bind(inp)
    compiled = dag.experimental_compile()
    try:
        out["compiled_reuse"] = [rt.get(compiled.execute(i), timeout=TIMEOUT)
                                 for i in range(5)]
        [handle] = compiled._owned_actors
        out["compiled_one_actor_calls"] = rt.get(handle.count.remote(),
                                                 timeout=TIMEOUT)
    finally:
        compiled.teardown()
    return out


def _channels(p):
    """input → A → (B, C) → D(b, c, input field): fan-out by the
    channel's broadcast, fan-in of two stage outputs and a field."""
    g = p.graph
    _, Arith, _ = _classes()
    A = p.rt.remote(Arith)
    with g.InputNode() as inp:
        a = A.bind(10).add.bind(inp[0])
        b = A.bind(2).mul.bind(a)
        c = A.bind(100).add.bind(a)
        dag = A.bind().combine.bind(b, c, inp[1])
    compiled = dag.experimental_compile(channels=True)
    out = {}
    try:
        futs = [compiled.execute(i, -i) for i in range(12)]
        out["diamond"] = [list(f.get(timeout_s=TIMEOUT)) for f in futs]
        first, second = (compiled.execute(i, 0) for i in (1, 2))
        out["out_of_order"] = [list(f.get(timeout_s=TIMEOUT))
                               for f in (second, first)]
        try:
            compiled.execute(5).get(timeout_s=TIMEOUT)  # no field 1
            out["missing_field"] = None
        except p.compiled.PipelineStageError as e:
            out["missing_field"] = ("PipelineStageError",
                                    "IndexError" in str(e))
        out["after_error"] = list(compiled.execute(1, 2).get(
            timeout_s=TIMEOUT))
    finally:
        compiled.teardown()
    return out


def _collectives(p):
    g = p.graph
    _, _, GradWorker = _classes()
    W = p.rt.remote(GradWorker)
    out = {}
    workers = [W.bind(s) for s in (1.0, 2.0, 3.0)]
    with g.InputNode() as inp:
        outs = [w.grad.bind(inp) for w in workers]
        dag = g.MultiOutputNode(g.allreduce.bind(outs)
                                + g.allreduce.bind(outs, op="mean"))
    vals = p.rt.get(dag.execute(np.ones(4, np.float32)), timeout=TIMEOUT)
    out["eager_sum_mean"] = [np.asarray(v).tolist() for v in vals]
    workers = [W.bind(s) for s in (1.0, 2.0)]
    with g.InputNode() as inp:
        outs = [w.grad.bind(inp) for w in workers]
        dag = W.bind(0.0).norm.bind(g.allreduce.bind(outs)[0])
    compiled = dag.experimental_compile(channels=True)
    try:
        out["channel_allreduce"] = [
            compiled.execute(np.full(8, k, np.float32)).get(timeout_s=TIMEOUT)
            for k in (1.0, 2.0, 3.0)]
    finally:
        compiled.teardown()
    return out


def _refused(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return [type(e).__name__, str(e)]
    return None


def _rejections(p):
    g = p.graph
    _, Arith, GradWorker = _classes()
    A, W = p.rt.remote(Arith), p.rt.remote(GradWorker)

    @p.rt.remote
    def double(x):
        return 2 * x

    out = {}
    with g.InputNode() as i1:
        pass
    with g.InputNode() as i2:
        pass
    dag = g.MultiOutputNode([double.bind(i1), double.bind(i2)])
    out["two_input_nodes"] = _refused(dag.experimental_compile)
    with g.InputNode() as inp:
        outs = [W.bind(1.0).grad.bind(inp), W.bind(2.0).grad.bind(inp)]
        dag = g.MultiOutputNode([g.allreduce.bind(outs)[0], outs[0]])
    out["collective_consumed_directly"] = _refused(
        lambda: dag.experimental_compile(channels=True))
    with g.InputNode() as inp:
        dag = g.MultiOutputNode([A.bind().add.bind(inp),
                                 A.bind().add.bind(inp[0])])
    out["bare_input_and_field"] = _refused(
        lambda: dag.experimental_compile(channels=True))
    with g.InputNode() as inp:
        dag = g.MultiOutputNode([A.bind().add.bind(inp[0]), inp[1]])
    out["input_as_output"] = _refused(
        lambda: dag.experimental_compile(channels=True))
    with g.InputNode() as inp:
        dag = A.bind().add.bind(inp)
    out["channel_kind"] = _refused(
        lambda: dag.experimental_compile(channels=True, channel_kind="nvl"))
    out["function_stage"] = _refused(
        lambda: double.bind(inp).experimental_compile(channels=True))
    out["allreduce_op"] = _refused(
        lambda: g.allreduce.bind(outs, op="max"))
    return out


def _stage_errors(p):
    g = p.graph
    _, Arith, _ = _classes()
    A = p.rt.remote(Arith)
    with g.InputNode() as inp:
        dag = A.bind(2).checked.bind(A.bind(1).add.bind(inp))
    compiled = dag.experimental_compile(channels=True)
    out = {}
    try:
        out["warm"] = compiled.execute(0).get(timeout_s=TIMEOUT)
        try:
            compiled.execute(-5).get(timeout_s=TIMEOUT)
            out["raised"] = None
        except p.compiled.PipelineStageError as e:
            out["raised"] = ("PipelineStageError", "boom on -4" in str(e))
        out["lives_on"] = compiled.execute(7).get(timeout_s=TIMEOUT)
        p.rt.kill(compiled._owned_actors[0])
        t = time.monotonic()
        try:
            # the kill may land while the driver still has channel
            # credit, so drive a few items: the first blocked read fails
            for i in range(8):
                compiled.execute(i).get(timeout_s=30)
            out["killed"] = None
        except p.compiled.PipelineStageError:
            out["killed"] = ("PipelineStageError",
                             time.monotonic() - t < KILL_DEADLINE_S)
    finally:
        compiled.teardown()
    return out


def _device_channel(p):
    g = p.graph
    S = p.rt.remote(_scale_class(p.port))
    with g.InputNode() as inp:
        dag = S.bind(3.0).mul.bind(S.bind(2.0).mul.bind(inp))
    compiled = dag.experimental_compile(channels=True, channel_kind="device",
                                        channel_capacity=8 << 20)
    out = {"channels": sorted({type(c).__name__ for c in compiled._channels})}
    payload = np.arange(64, dtype=np.float32).reshape(8, 8) / 7
    try:
        for name in ("bfloat16", "float32"):
            if p.port:
                x = torch.tensor(payload).to(getattr(torch, name))
            else:
                x = jnp.asarray(payload, dtype=getattr(jnp, name))
            y = compiled.execute(x).get(timeout_s=TIMEOUT)
            host = y.float().numpy() if p.port else \
                np.asarray(y).astype(np.float32)
            out[name] = [str(y.dtype).removeprefix("torch."),
                         list(y.shape), host.tolist()]
    finally:
        compiled.teardown()
    return out


def _shm_channel(p):
    """The mutable channel's own primitives in this process: depth-1
    backpressure, ``read_nowait``'s sentinel, closure, pickling by name."""
    ch_mod = p.channels
    name = f"/rtg_{uuid.uuid4().hex[:8]}"
    ch = ch_mod.ShmChannel(name, capacity=1 << 16, num_readers=1)
    ch._handle()
    reader = pickle.loads(pickle.dumps(ch))   # opens the segment by name
    out = {"empty_poll": reader.read_nowait() is ch_mod.NO_MESSAGE}
    ch.write({"a": 1}, timeout_s=1)
    try:
        ch.write(2, timeout_s=0.05)
        out["backpressure"] = False
    except TimeoutError:
        out["backpressure"] = True
    out["read"] = reader.read(timeout_s=1)
    ch.write(None, timeout_s=1)
    out["none_is_a_value"] = reader.read_nowait() is None
    ch.close()
    try:
        reader.read(timeout_s=1)
        out["closed"] = None
    except ch_mod.ChannelClosed:
        out["closed"] = "ChannelClosed"
    ch.unlink()
    return out


EXPECTED = {
    "function_chain": 12, "actor_pipeline": 111,
    "multi_output_fields": [6, 14], "compiled_reuse": [1, 2, 3, 4, 5],
    "compiled_one_actor_calls": 5,
    "diamond": [[(i + 10) * 2, i + 10 + 100, -i] for i in range(12)],
    "out_of_order": [[24, 112, 0], [22, 111, 0]],
    "missing_field": ("PipelineStageError", True),
    "after_error": [22, 111, 2],
    "eager_sum_mean": [[6.0] * 4] * 3 + [[2.0] * 4] * 3,
    "channel_allreduce": [24.0, 48.0, 72.0],
    "warm": 3, "raised": ("PipelineStageError", True), "lives_on": 10,
    "killed": ("PipelineStageError", True),
    "channels": ["DeviceBufferChannel"],
    "empty_poll": True, "backpressure": True, "read": {"a": 1},
    "none_is_a_value": True, "closed": "ChannelClosed",
}


@pytest.mark.parametrize("part", [_eager, _channels, _collectives,
                                  _stage_errors, _device_channel,
                                  _shm_channel],
                         ids=lambda f: f.__name__.strip("_"))
def test_scenario_gives_the_same_results(pkg, part):
    got = _run(pkg, part)
    want = {k: EXPECTED[k] for k in got if k in EXPECTED}
    assert {k: got[k] for k in want} == want
    if part is _device_channel:
        payload = np.arange(64, dtype=np.float32).reshape(8, 8) / 7
        for name in ("bfloat16", "float32"):
            dtype, shape, host = got[name]
            assert (dtype, shape) == (name, [8, 8])
            x = torch.tensor(payload).to(getattr(torch, name))
            assert np.array_equal(np.asarray(host, np.float32),
                                  (x * 2.0 * 3.0).float().numpy())
    key = part.__name__
    if not pkg.port:
        _RESULTS[key] = got
    elif key in _RESULTS:
        assert got == _RESULTS[key]


def test_rejections_are_the_reference_ones(pkg):
    """Each DAG the JAX package refuses, the port refuses with the same
    exception type and message."""
    got = _rejections(pkg)
    assert all(v is not None for v in got.values()), got
    if not pkg.port:
        _RESULTS["rejections"] = got
    elif "rejections" in _RESULTS:
        assert got == _RESULTS["rejections"]


def _ref_args(p):
    """A stage bound with an ObjectRef among its arguments, run in the
    eager, RPC and channel forms."""
    Stage, _, _ = _classes()
    S = p.rt.remote(Stage)
    with p.graph.InputNode() as inp:
        dag = S.options(num_cpus=0).bind(p.rt.put(7)).step.bind(inp)
    out = {"eager": p.rt.get(dag.execute(1), timeout=TIMEOUT)}
    for form, kw in (("rpc", {}), ("channels", {"channels": True})):
        compiled = dag.experimental_compile(**kw)
        try:
            fut = compiled.execute(1)
            out[form] = (fut.get(timeout_s=TIMEOUT) if kw
                         else p.rt.get(fut, timeout=TIMEOUT))
        except p.compiled.PipelineStageError:
            out[form] = "PipelineStageError"
        finally:
            compiled.teardown()
    return out


def test_object_ref_arguments_resolve(pkg):
    """The stage sees the referenced value in every form of the port
    (``build_llama_pipeline`` hands each stage its shard this way).
    ``ray_tpu``'s channel harness nests the user's arguments, so its stage
    is handed the reference itself and its first item fails typed."""
    got = _run(pkg, _ref_args)
    assert got == {"eager": 8, "rpc": 8,
                   "channels": 8 if pkg.port else "PipelineStageError"}


# ------------------------------------------------------- the Llama pipeline

@pytest.fixture(scope="module")
def jparams():
    """Seeded weights of the JAX init's shapes and dtypes (numpy fills
    them: the JAX init compiles for seconds)."""
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: jllama.init_params(
        jllama.CONFIGS["debug"], jax.random.key(0)))
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.05 * rng.standard_normal(s.shape), s.dtype),
        shapes)


TOKENS = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)


KINDS = ("shm", "device")


def _pipeline_logits(p, jparams):
    """Two microbatches' logits through a two-stage pipeline of each
    channel kind; both pipelines are built before either runs, so their
    four stages start side by side."""
    if p.port:
        from ray_tpu_torch.models import llama as tllama
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.models.pipeline import build_llama_pipeline

        cfg, kw = tllama.CONFIGS["debug"], {"device": "cpu"}
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        tokens = torch.from_numpy(TOKENS)
    else:
        from ray_tpu.models.pipeline import build_llama_pipeline

        cfg, kw, params, tokens = jllama.CONFIGS["debug"], {}, jparams, TOKENS
    dags = {}
    try:
        for kind in KINDS:
            dags[kind] = build_llama_pipeline(cfg, params, 2,
                                              channel_kind=kind, **kw)
        got = {}
        for kind, dag in dags.items():
            outs = [dag.execute(tokens) for _ in range(2)]
            got[kind] = [np.asarray(o.get(timeout_s=120), np.float32)
                         for o in outs]
    finally:
        for dag in dags.values():
            dag.teardown()
    return got


def test_llama_pipeline_logits(pkg, jparams):
    got = _run(pkg, lambda p: _pipeline_logits(p, jparams))
    for kind in KINDS:
        assert all(g.shape == (2, 16, 256) and np.isfinite(g).all()
                   for g in got[kind]), kind
        assert np.array_equal(got[kind][0], got[kind][1]), kind
    if not pkg.port:
        _RESULTS["pipeline"] = got
        return
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.models.convert import params_from_jax

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    own = tllama.forward(params, torch.from_numpy(TOKENS),
                         tllama.CONFIGS["debug"]).detach().numpy()
    for kind in KINDS:
        if "pipeline" in _RESULTS:
            want = _RESULTS["pipeline"][kind][0]
        else:   # ray_tpu's pipelines did not run in this process
            want = np.asarray(jllama.forward(jparams, jnp.asarray(TOKENS),
                                             jllama.CONFIGS["debug"]))
        np.testing.assert_allclose(got[kind][0], want, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        np.testing.assert_allclose(got[kind][0], own, rtol=1e-6, atol=1e-6)


def test_split_params_copies_each_shard():
    """A shard is a copy of its layers, never a view of the stack (a view
    pickles every layer)."""
    from ray_tpu_torch.models import llama as tllama
    from ray_tpu_torch.models.pipeline import split_params

    cfg = tllama.CONFIGS["debug"]
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shards = split_params(params, cfg, 2)
    for s, shard in enumerate(shards):
        for name, w in shard["layers"].items():
            assert w.shape[0] == 1
            assert w.untyped_storage().nbytes() == w.numel() * w.element_size()
            assert torch.equal(w[0], params["layers"][name][s])
    assert "embed" in shards[0] and "lm_head" in shards[1]
    with pytest.raises(ValueError):
        split_params(params, cfg, 3)


# ------------------------------------------------ the exec loop, in process

def _stage_loop(delay_s):
    """The port's stage exec loop on a thread around a compute of
    ``delay_s``, between two fresh shm channels."""
    import threading

    import cloudpickle

    from ray_tpu_torch.graph.channels import ShmChannel
    from ray_tpu_torch.graph.compiled import _PipelineStage

    class Slow:
        def work(self, x):
            time.sleep(delay_s)
            return x

    tag = uuid.uuid4().hex[:8]
    chans = [ShmChannel(f"/rttov_{io}_{tag}", capacity=1 << 16)
             for io in "io"]
    for ch in chans:
        ch._handle()
    stage = _PipelineStage(cloudpickle.dumps(Slow))
    t = threading.Thread(target=stage.run_graph_loop,
                         args=("work", [("ch", chans[0])], chans[1], None),
                         daemon=True)
    t.start()
    return chans, t


@pytest.mark.parametrize("overlap", [True, False])
def test_exec_loop_prefetch_follows_pipeline_overlap(monkeypatch, overlap):
    """With ``pipeline_overlap`` on, the prefetch thread keeps consuming
    the depth-1 input channel while the stage computes, so three writes
    land inside the first compute; off, the third write waits behind the
    unread second (tests/test_channels.py holds the JAX loop the same
    way). The loop ends when its input closes, and closes its output."""
    from ray_tpu_torch.common.config import GLOBAL_CONFIG
    from ray_tpu_torch.graph.channels import ChannelClosed

    monkeypatch.setenv("RT_pipeline_overlap", "1" if overlap else "0")
    GLOBAL_CONFIG.reset_cache()
    try:
        (in_ch, out_ch), loop = _stage_loop(delay_s=0.4)
        in_ch.write(0, timeout_s=5)
        in_ch.write(1, timeout_s=5)
        try:
            in_ch.write(2, timeout_s=0.15)
            parked = False
        except TimeoutError:
            parked = True
        assert parked is not overlap
        got = [out_ch.read(timeout_s=10) for _ in range(3 if overlap else 2)]
        assert got == list(range(len(got)))
        in_ch.close()
        with pytest.raises(ChannelClosed):
            out_ch.read(timeout_s=10)
        loop.join(10)
        assert not loop.is_alive()
        for ch in (in_ch, out_ch):
            ch.unlink()
    finally:
        monkeypatch.delenv("RT_pipeline_overlap")
        GLOBAL_CONFIG.reset_cache()


# ------------------------------------------------ the KV collective group

_KV = MemoryKV


def _collective_program(pkg, rank, world, make):
    """Every op of ``pkg``'s KV group on one rank: what each returns."""
    group_cls = importlib.import_module(f"{pkg}.collective.kv_group").KVGroup
    op_max = importlib.import_module(f"{pkg}.collective.types").ReduceOp.MAX
    g = group_cls(_KV.shared, world, rank, "g", timeout_s=30)
    x = make(rank)
    out = [g.allreduce(x), g.allreduce(x, op_max), g.reduce(x, 1),
           g.broadcast(x, 0), g.allgather(x), g.reducescatter(x)]
    if rank == 0:
        g.send(x, 1)
    else:
        out.append(g.recv(0))
    g.barrier()
    for _ in range(20):   # past a garbage-collection round of the keys
        g.allreduce(x)
    g.destroy()
    return out


def _run_ranks(pkg, make, world=2):
    """Each rank's results, the ranks on threads of this process."""
    import concurrent.futures

    _KV.shared = _KV()
    with concurrent.futures.ThreadPoolExecutor(world) as pool:
        futs = [pool.submit(_collective_program, pkg, r, world, make)
                for r in range(world)]
        return [f.result(timeout=120) for f in futs]


def _flat(results):
    return [x for rank in results for r in rank
            for x in (r if isinstance(r, list) else [r])]


def test_kv_group_equals_jax_and_keeps_tensors():
    """The port's KV group gives ray_tpu's results on numpy operands, op
    for op. On tensors (bf16 and f32) each result is a tensor of the
    operand's dtype, equal to the numpy path's on the same values cast to
    that dtype (bf16 values sum exactly in f32, and a bf16 tensor sum
    rounds once, as the cast does)."""
    def arr(rank):
        return np.arange(8, dtype=np.float32) / 3 + rank

    want = _flat(_run_ranks("ray_tpu", arr))
    got = _flat(_run_ranks("ray_tpu_torch", arr))
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        assert type(g) is np.ndarray and np.array_equal(g, w)
    for dtype in (torch.bfloat16, torch.float32):
        def tensor(rank):
            return torch.from_numpy(arr(rank)).to(dtype)

        ref = _flat(_run_ranks("ray_tpu_torch",
                               lambda r: tensor(r).float().numpy()))
        for g, w in zip(_flat(_run_ranks("ray_tpu_torch", tensor)), ref):
            assert isinstance(g, torch.Tensor) and g.dtype == dtype
            assert torch.equal(g, torch.from_numpy(np.asarray(w)).to(dtype))
