"""One scenario program through both runtimes: ``ray_tpu`` and the port's
``ray_tpu_torch`` each start a single-node cluster (one module-scoped
cluster at a time) and run the same tasks, actors, objects, generators and
placement groups, taken from tests/test_core_api.py and
tests/test_device_objects.py. Each package must give the same results.
Then an actor of each package hosts that package's ``LLMEngine`` on the
``debug`` model, and its greedy tokens for three prompts must equal the
JAX engine's in this process (the port's actor gets the JAX init's weights
converted to torch tensors through the object store)."""

import importlib
import time

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMEngine as JaxEngine

from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
LABELS = {"rt.io/tpu-slice": "slice-a"}
PROMPTS = [([5, 17, 99, 3, 42], 8), (list(range(2, 18)), 6), ([200, 1], 5)]
TIMEOUT = 60


@pytest.fixture(scope="module", params=PACKAGES)
def rt(request):
    pkg = importlib.import_module(request.param)
    if request.param == "ray_tpu":
        pkg.init(num_cpus=4, num_tpus=0, resources={"GPU": 1}, labels=LABELS)
    else:
        pkg.init(num_cpus=4, num_gpus=1, labels=LABELS)
    yield pkg
    pkg.shutdown()


def _status(rt):
    return importlib.import_module(rt.__name__ + ".common.status")


def _run(rt, fn, attempts=5):
    """``fn(rt)``. For ``ray_tpu`` only, run again when a worker of it was
    killed from outside: tests/conftest.py's module guard ends every test
    file with ``pkill -f`` of the JAX package's worker command lines,
    machine-wide, so under xdist another file's teardown can kill this
    file's ray_tpu workers. The port's workers carry other command lines
    and cannot be reached that way, so the port fails on its first
    crash."""
    if rt.__name__ != "ray_tpu":
        return fn(rt)
    status = _status(rt)
    for attempt in range(attempts):
        try:
            return fn(rt)
        except (status.ActorDiedError, status.WorkerCrashedError):
            if attempt == attempts - 1:
                raise


def _tasks(rt):
    out = {}

    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def shape_of(arr, scale=1):
        return tuple(int(s * scale) for s in arr.shape)

    @rt.remote
    def one():
        return 1

    @rt.remote
    def boom():
        raise ValueError("expected failure")

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    @rt.remote
    def big():
        return np.arange(500_000, dtype=np.int64)

    @rt.remote
    def outer(x):
        return rt.get(add.remote(x, 1), timeout=TIMEOUT) + 100

    out["add"] = rt.get(add.remote(2, 3), timeout=TIMEOUT)
    out["kwargs"] = rt.get(shape_of.remote(
        np.zeros((128, 256), np.float32), scale=2), timeout=TIMEOUT)
    a = one.remote()
    out["chain"] = rt.get(add.remote(add.remote(a, 10), a), timeout=TIMEOUT)
    try:
        rt.get(boom.remote(), timeout=TIMEOUT)
        out["error"] = None
    except _status(rt).TaskError as e:
        out["error"] = ("TaskError", "expected failure" in str(e))
    out["num_returns"] = rt.get(three.remote(), timeout=TIMEOUT)
    ref = rt.put({"nested": [1, 2, {"k": "v"}]})
    out["put_get"] = rt.get(ref, timeout=TIMEOUT)
    out["put_arg"] = rt.get(add.remote(rt.put(21), 21), timeout=TIMEOUT)
    fast, slow = sleepy.remote(0.01), sleepy.remote(3.0)
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=10)
    out["wait"] = (ready == [fast], not_ready == [slow])
    v = rt.get(big.remote(), timeout=TIMEOUT)
    out["large_return"] = (v.shape, int(v[-1]))
    out["nested"] = rt.get(outer.remote(1), timeout=TIMEOUT)
    return out


def _actors(rt):
    out = {}

    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.value = start

        def inc(self, by=1):
            self.value += by
            return self.value

    @rt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def push(self, x):
            self.items.append(x)

        def read(self):
            return self.items

        def fail(self):
            raise RuntimeError("actor method failed")

    @rt.remote
    def writer(counter):
        return rt.get(counter.inc.remote(100), timeout=TIMEOUT)

    c = Counter.remote(10)
    out["state"] = [rt.get(c.inc.remote(), timeout=TIMEOUT),
                    rt.get(c.inc.remote(5), timeout=TIMEOUT)]
    out["handle_passing"] = rt.get(writer.remote(c), timeout=TIMEOUT)
    name = f"appender-{time.monotonic_ns()}"  # fresh on a rerun (_run)
    a = Appender.options(name=name).remote()
    for i in range(20):
        a.push.remote(i)
    named = rt.get_actor(name)
    out["call_order"] = rt.get(named.read.remote(), timeout=TIMEOUT)
    try:
        rt.get(a.fail.remote(), timeout=TIMEOUT)
        out["actor_error"] = None
    except _status(rt).TaskError as e:
        out["actor_error"] = ("TaskError", "actor method failed" in str(e))
    rt.kill(a)
    try:
        rt.get(a.read.remote(), timeout=10)
        out["killed"] = None
    except Exception as e:  # noqa: BLE001 — ActorDiedError or a typed wrapper
        out["killed"] = type(e).__name__
    return out


def _async_and_generators(rt):
    out = {}

    @rt.remote(num_cpus=0)
    class AsyncActor:
        """Each call waits until all eight are in flight at once: calls
        that ran one at a time would each time out and return None."""

        def __init__(self):
            self.arrived = 0

        async def slow(self, i):
            import asyncio

            self.arrived += 1
            for _ in range(600):
                if self.arrived >= 8:
                    return i
                await asyncio.sleep(0.05)
            return None

    @rt.remote(num_returns="streaming")
    def squares(n):
        for i in range(n):
            yield i * i

    @rt.remote
    class Streamer:
        def stream(self, n):
            for i in range(n):
                yield i + 1

    aa = AsyncActor.remote()
    out["async_interleave"] = rt.get([aa.slow.remote(i) for i in range(8)],
                                     timeout=TIMEOUT)
    out["generator"] = [rt.get(r, timeout=TIMEOUT) for r in squares.remote(5)]
    s = Streamer.remote()
    g = s.stream.options(num_returns="streaming").remote(4)
    out["actor_generator"] = [rt.get(r, timeout=TIMEOUT) for r in g]
    return out


def _available_gpu(rt, expect, within=10.0):
    """The node's free GPU count once it reads ``expect`` (resource
    reports reach the GCS periodically), or what it reads at the end."""
    deadline = time.monotonic() + within
    while True:
        got = rt.available_resources().get("GPU", 0.0)
        if got == expect or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


def _placement_and_gpus(rt):
    out = {}
    pg_mod = importlib.import_module(
        rt.__name__ + ".core_worker.placement_group")

    @rt.remote(num_cpus=1)
    def where():
        return "ran"

    pack = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    out["pack_ready"] = pack.ready(timeout=10)
    strat = pg_mod.PlacementGroupSchedulingStrategy(pack, 1)
    out["pack_task"] = rt.get(where.options(
        scheduling_strategy=strat).remote(), timeout=TIMEOUT)
    spread = rt.placement_group([{"CPU": 1}, {"CPU": 1}],
                                strategy="STRICT_SPREAD")
    out["strict_spread_ready"] = spread.ready(timeout=1)
    sl = rt.placement_group([{"CPU": 1}], strategy="SLICE_PACK")
    out["slice_pack_ready"] = sl.ready(timeout=10)
    sl2 = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SLICE_PACK")
    out["slice_pack_two_nodes_ready"] = sl2.ready(timeout=1)
    for pg in (pack, spread, sl, sl2):
        rt.remove_placement_group(pg)
    out["pg_table"] = len(rt.placement_group_table()) >= 4

    @rt.remote(num_gpus=1)
    class Holder:
        def ping(self):
            return "held"

    h = Holder.remote()
    out["gpu_actor"] = rt.get(h.ping.remote(), timeout=TIMEOUT)
    out["gpu_while_held"] = _available_gpu(rt, 0.0)
    rt.kill(h)
    out["gpu_after_kill"] = _available_gpu(rt, 1.0)
    total = rt.cluster_resources()
    out["cluster"] = (total["CPU"], total["GPU"], len(rt.nodes()))
    return out


EXPECTED = {
    "add": 5, "kwargs": (256, 512), "chain": 12,
    "error": ("TaskError", True), "num_returns": [1, 2, 3],
    "put_get": {"nested": [1, 2, {"k": "v"}]}, "put_arg": 42,
    "wait": (True, True), "large_return": ((500_000,), 499_999),
    "nested": 102,
    "state": [11, 16], "handle_passing": 116, "call_order": list(range(20)),
    "actor_error": ("TaskError", True), "killed": "ActorDiedError",
    "async_interleave": list(range(8)),
    "generator": [0, 1, 4, 9, 16], "actor_generator": [1, 2, 3, 4],
    "pack_ready": True, "pack_task": "ran", "strict_spread_ready": False,
    "slice_pack_ready": True, "slice_pack_two_nodes_ready": False,
    "pg_table": True,
    "gpu_actor": "held", "gpu_while_held": 0.0, "gpu_after_kill": 1.0,
    "cluster": (4.0, 1.0, 1),
}


@pytest.mark.parametrize("part", [_tasks, _actors, _async_and_generators,
                                  _placement_and_gpus],
                         ids=lambda f: f.__name__.strip("_"))
def test_scenario_gives_the_same_results(rt, part):
    got = _run(rt, part)
    want = {k: EXPECTED[k] for k in got}
    assert got == want


# greedy tokens each package's engine actor served, by package
_SERVED = {}


def _jax_engine_tokens():
    params = jllama.init_params(jllama.CONFIGS["debug"], jax.random.key(0))
    eng = JaxEngine(model="debug", params=params, kv_cache="paged")
    try:
        return [eng.generate(p, max_tokens=n, timeout_s=120)
                for p, n in PROMPTS]
    finally:
        eng.shutdown()


def _serve_debug(rt):
    """Three prompts served by an actor hosting ``rt``'s debug engine."""
    if rt.__name__ == "ray_tpu":
        @rt.remote
        class Server:
            def __init__(self):
                from ray_tpu.models import llama as _llama
                from ray_tpu.serve.llm import LLMEngine as _Engine

                self.eng = _Engine(model="debug", kv_cache="paged",
                                   params=_llama.init_params(
                                       _llama.CONFIGS["debug"],
                                       jax.random.key(0)))

            def generate(self, prompt, n):
                return self.eng.generate(prompt, max_tokens=n, timeout_s=120)

            def weights(self):
                return jax.tree_util.tree_map(np.asarray, self.eng.params)

        server = Server.remote()
        # copied: the values alias this cluster's shared memory, which
        # its shutdown unmaps before the port's cluster starts
        _SERVED["weights"] = jax.tree_util.tree_map(
            np.array, rt.get(server.weights.remote(), timeout=TIMEOUT))
    else:
        from ray_tpu_torch.models.convert import params_from_jax

        weights = params_from_jax(_SERVED.get("weights") or
                                  jax.tree_util.tree_map(
                                      np.asarray, jllama.init_params(
                                          jllama.CONFIGS["debug"],
                                          jax.random.key(0))))

        @rt.remote
        class Server:
            def __init__(self, params):
                from ray_tpu_torch.serve.llm import LLMEngine as _Engine

                self.eng = _Engine(model="debug", kv_cache="paged",
                                   params=params, device="cpu")

            def generate(self, prompt, n):
                return self.eng.generate(prompt, max_tokens=n, timeout_s=120)

        server = Server.remote(rt.put(weights))
    got = rt.get([server.generate.remote(p, n) for p, n in PROMPTS],
                 timeout=180)
    rt.kill(server)
    return got


def test_engine_actor_gives_the_jax_engine_tokens(rt):
    """The JAX actor runs first (the fixture's params are in order); the
    port's actor must give its tokens, or, when it ran alone, the tokens of
    the JAX engine in this process."""
    got = _run(rt, _serve_debug)
    assert [len(t) for t in got] == [n for _, n in PROMPTS]
    _SERVED[rt.__name__] = got
    if rt.__name__ == "ray_tpu_torch":
        want = _SERVED.get("ray_tpu") or _jax_engine_tokens()
        assert got == want
