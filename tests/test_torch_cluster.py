"""The port's ``cluster_utils.Cluster`` and util helpers (``ActorPool``,
``Queue``, ``util.state``) against ``ray_tpu``'s on the CPU: one scenario
program run through both packages, one package at a time, each part's
results held to stated values and, for the port, to what ``ray_tpu``
gave on the same part.

- a Cluster of two raylets (as tests/test_multinode_transfer.py and
  tests/test_gcs_ft.py use it): an object made on the second node is
  read on the driver's node over the transfer service, byte for byte;
  ``kill_gcs`` and ``restart_gcs`` with a ``persist_dir``, across which a
  named actor keeps serving its state (no restart); ``remove_node``, after
  which one node is alive; ``add_node(num_gpus=...)`` counted;
- ``ActorPool`` (``map``, ``map_unordered``, ``submit``/``get_next``,
  ``has_free``/``pop_idle``/``push``), ``Queue`` (FIFO across tasks,
  ``Full``, ``Empty``, batches) and ``util.state``'s lists (nodes,
  actors, jobs, placement groups, task summaries and the chrome trace).

Only ``ray_tpu``'s side runs a part once more when it fails
(tests/conftest.py's module guard ``pkill``s ``ray_tpu``'s workers
machine-wide under xdist: ROADMAP.md C.2); the port fails on its first
error.
"""

import importlib
import time

import numpy as np
import pytest

from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
TIMEOUT = 60
JAX_ATTEMPTS = 2
NBYTES = 2_000_000
# what ray_tpu gave on each part, for the port's run to equal
_RESULTS = {}


def _run(name, part, *args):
    """``part(name, *args)``; for ``ray_tpu`` only, once more when it
    fails (see the module docstring)."""
    if name == "ray_tpu_torch":
        return part(name, *args)
    for attempt in range(JAX_ATTEMPTS):
        try:
            return part(name, *args)
        except Exception:  # noqa: BLE001 — the last attempt re-raises
            if attempt == JAX_ATTEMPTS - 1:
                raise
            rt = importlib.import_module(name)
            if rt.is_initialized():
                rt.shutdown()


def _record(name, part, got):
    if name == "ray_tpu":
        _RESULTS[part] = got
    elif part in _RESULTS:
        assert got == _RESULTS[part], (part, got, _RESULTS[part])


def _poll(fn, want, within=15.0):
    """``fn()`` once it returns ``want``, or what it returns at the end."""
    deadline = time.monotonic() + within
    while True:
        got = fn()
        if got == want or time.monotonic() > deadline:
            return got
        time.sleep(0.1)


def _counter():
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    return Counter


def _cluster(name, persist_dir):
    rt = importlib.import_module(name)
    cu = importlib.import_module(f"{name}.cluster_utils")
    config = importlib.import_module(f"{name}.common.config").GLOBAL_CONFIG
    transfer = importlib.import_module(f"{name}.object_store.transfer")
    gcs_client = importlib.import_module(f"{name}.gcs.client")
    config.set_system_config_value("gcs_restart_reconcile_delay_s", 1.0)
    c = cu.Cluster(initialize_head=True, head_node_args={"num_cpus": 2},
                   persist_dir=persist_dir)
    out = {}
    try:
        if name == "ray_tpu_torch":
            node = c.add_node(num_cpus=2, num_gpus=2,
                              resources={"holder": 1})
        else:   # the JAX package's add_node takes num_tpus
            node = c.add_node(num_cpus=2, resources={"GPU": 2, "holder": 1})
        out["two_nodes"] = c.wait_for_nodes(2)
        rt.init(address=c.address)
        total = rt.cluster_resources()
        out["resources"] = (total["CPU"], total["GPU"], total["holder"])

        @rt.remote(num_cpus=1, resources={"holder": 1})
        def make(seed):
            import numpy as _np

            return _np.random.default_rng(seed).integers(
                0, 255, size=NBYTES, dtype=_np.uint8)

        before = transfer.stats["downloads"]
        got = rt.get(make.remote(7), timeout=TIMEOUT)
        want = np.random.default_rng(7).integers(0, 255, size=NBYTES,
                                                 dtype=np.uint8)
        out["cross_node_object"] = (got.shape, bool((got == want).all()))
        out["over_transfer_service"] = transfer.stats["downloads"] > before

        a = rt.remote(_counter()).options(
            name="survivor", max_restarts=2,
            resources={"CPU": 0}).remote()
        out["before_restart"] = rt.get(a.incr.remote(), timeout=TIMEOUT)
        c.kill_gcs()
        time.sleep(0.3)
        c.restart_gcs()
        gcs = gcs_client.GcsClient(c.gcs.address)
        try:
            view = _poll(lambda: (gcs.get_actor_by_name("survivor") or {})
                         .get("state"), "ALIVE")
            out["after_restart"] = (
                view, gcs.get_actor_by_name("survivor")["num_restarts"],
                rt.get(a.incr.remote(), timeout=TIMEOUT))
        finally:
            gcs.close()

        c.remove_node(node, graceful=True)
        out["alive_after_remove"] = _poll(
            lambda: sum(n["Alive"] for n in rt.nodes()), 1)
    finally:
        if rt.is_initialized():
            rt.shutdown()
        c.shutdown()
        config.set_system_config_value("gcs_restart_reconcile_delay_s", 2.0)
    return out


def _helpers(name):
    rt = importlib.import_module(name)
    util = importlib.import_module(f"{name}.util")
    out = {}
    if name == "ray_tpu_torch":
        rt.init(num_cpus=4, num_gpus=0)
    else:
        rt.init(num_cpus=4, num_tpus=0)
    try:
        class Sq:
            def __init__(self, k):
                self.k = k

            def sq(self, x):
                return x * x + self.k

        actors = [rt.remote(Sq).options(num_cpus=0).remote(0)
                  for _ in range(2)]
        pool = util.ActorPool(actors)
        out["map"] = list(pool.map(lambda a, v: a.sq.remote(v), range(6)))
        out["map_unordered"] = sorted(pool.map_unordered(
            lambda a, v: a.sq.remote(v), range(6)))
        for v in (3, 4, 5):
            pool.submit(lambda a, v: a.sq.remote(v), v)
        out["has_free_while_busy"] = pool.has_free()
        out["get_next"] = [pool.get_next(timeout=TIMEOUT) for _ in range(3)]
        idle = pool.pop_idle()
        out["popped"] = (idle is not None, pool.has_free())
        pool.push(idle)
        try:
            util.ActorPool([])
            out["empty_pool"] = None
        except ValueError:
            out["empty_pool"] = "ValueError"

        q = util.Queue(maxsize=3)

        @rt.remote
        def produce(queue, items):
            for it in items:
                queue.put(it)
            return len(items)

        out["produced"] = rt.get(produce.remote(q, [1, 2, 3]),
                                 timeout=TIMEOUT)
        out["qsize_full"] = (q.qsize(), q.full(), q.empty())
        try:
            q.put(4, timeout=0.2)
            out["full"] = None
        except util.Full:
            out["full"] = "Full"
        out["fifo"] = [q.get(timeout=5) for _ in range(3)]
        try:
            q.get(timeout=0.2)
            out["empty"] = None
        except util.Empty:
            out["empty"] = "Empty"
        out["batch"] = (q.put_nowait_batch([5, 6, 7, 8]),
                        q.get_nowait_batch(10))
        q.shutdown()

        @rt.remote
        def tick(i):
            return i

        rt.get([tick.remote(i) for i in range(5)], timeout=TIMEOUT)
        pg = rt.placement_group([{"CPU": 1}], strategy="PACK")
        pg.ready(timeout=10)
        state = util.state
        nodes = state.list_nodes()
        out["nodes"] = [(n["state"], n["resources_total"]["CPU"])
                        for n in nodes]
        named = rt.remote(Sq).options(name="listed", num_cpus=0).remote(1)
        rt.get(named.sq.remote(1), timeout=TIMEOUT)
        out["actors"] = sorted(
            (a["name"], a["state"]) for a in state.list_actors()
            if a["name"] == "listed")
        out["jobs"] = len(state.list_jobs()) >= 1
        out["pgs"] = [p["strategy"] for p in state.list_placement_groups()]
        count = _poll(lambda: state.summarize_tasks().get(
            "tick", {}).get("count"), 5)
        out["tick_summary"] = count
        trace = state.chrome_tracing_dump()
        out["trace_ticks"] = sum(ev["name"] == "tick" and ev["ph"] == "X"
                                 for ev in trace)
    finally:
        rt.shutdown()
    return out


EXPECTED = {
    "two_nodes": True, "resources": (4.0, 2.0, 1.0),
    "cross_node_object": ((NBYTES,), True), "over_transfer_service": True,
    "before_restart": 1, "after_restart": ("ALIVE", 0, 2),
    "alive_after_remove": 1,
    "map": [0, 1, 4, 9, 16, 25], "map_unordered": [0, 1, 4, 9, 16, 25],
    "has_free_while_busy": False, "get_next": [9, 16, 25],
    "popped": (True, True),
    "empty_pool": "ValueError",
    "produced": 3, "qsize_full": (3, True, False), "full": "Full",
    "fifo": [1, 2, 3], "empty": "Empty", "batch": (3, [5, 6, 7]),
    "nodes": [("ALIVE", 4.0)], "actors": [("listed", "ALIVE")],
    "jobs": True, "pgs": ["PACK"], "tick_summary": 5, "trace_ticks": 5,
}


@pytest.mark.parametrize("name", PACKAGES)
def test_cluster_scenario_gives_the_same_results(name, tmp_path):
    got = _run(name, _cluster, str(tmp_path / name))
    assert got == {k: EXPECTED[k] for k in got}
    _record(name, "cluster", got)


@pytest.mark.parametrize("name", PACKAGES)
def test_util_helpers_give_the_same_results(name):
    got = _run(name, _helpers)
    assert got == {k: EXPECTED[k] for k in got}
    _record(name, "helpers", got)


def test_profiling_writes_a_torch_profiler_trace(tmp_path):
    """util.profiling on torch.profiler: one chrome trace a capture, the
    annotated region in it; no device memory where CUDA is not up."""
    import json

    import torch

    from ray_tpu_torch.util import profiling

    with profiling.profile(str(tmp_path)) as logdir:
        with profiling.annotate("phase-a"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    [trace] = list((tmp_path).iterdir())
    assert logdir == str(tmp_path) and trace.suffix == ".json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(ev.get("name") == "phase-a" for ev in events)
    assert profiling.device_memory_stats() is None
