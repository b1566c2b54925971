"""The port's runtime core (``ray_tpu_torch.init``, tasks, actors, objects,
placement groups) on the CPU.

Pure functions are held to ``ray_tpu``'s on the same seeded inputs: ids,
resource arithmetic and GPU-instance assignment, task specs, the
scheduling policies' node choices, the RPC schema's verdicts and the
native fastspec encodings byte for byte. One port cluster (``num_gpus=1``
declared on a CPU host) then checks device objects holding CPU tensors,
GPU leases exported as ``CUDA_VISIBLE_DEVICES``, the worker processes'
imports, and that the natives built. The scenario program shared with
``ray_tpu`` is in tests/test_torch_runtime_parity.py."""

import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.common import ids as jids
from ray_tpu.common import resources as jres
from ray_tpu.common import task_spec as jspec
from ray_tpu.rpc import native as jnative
from ray_tpu.rpc import schema as jschema
from ray_tpu.scheduling import cluster_state as jcs
from ray_tpu.scheduling import policies as jpol
from ray_tpu_torch.common import gpu_detect
from ray_tpu_torch.common import ids as tids
from ray_tpu_torch.common import resources as tres
from ray_tpu_torch.common import task_spec as tspec
from ray_tpu_torch.rpc import native as tnative
from ray_tpu_torch.rpc import schema as tschema
from ray_tpu_torch.scheduling import cluster_state as tcs
from ray_tpu_torch.scheduling import policies as tpol

from _torch_isolation import _module_isolation_guard  # noqa: F401

TIMEOUT = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# above PID_MAX_LIMIT (2**22): never the pid of a live process
DEAD_PID = 2 ** 22 + 1


# ------------------------------------------------ pure functions vs ray_tpu

def _id_walk(ids, rng):
    job = ids.JobID.from_int(rng.randrange(1, 1 << 31))
    driver = ids.TaskID.for_driver(job)
    out = [job.hex(), job.to_int(), driver.hex()]
    for i in range(4):
        t = ids.TaskID.for_normal_task(job, driver, rng.randrange(1 << 20))
        actor = ids.ActorID.of(job, t, i)
        at = ids.TaskID.for_actor_task(actor, driver, i + 1)
        oid = ids.ObjectID.from_index(at, i + 1)
        put = ids.ObjectID.for_put(t, i + 1)
        out += [t.hex(), actor.hex(), actor.job_id().hex(),
                ids.TaskID.for_actor_creation_task(actor).hex(), at.hex(),
                at.actor_id().hex(), oid.hex(), oid.index(), oid.is_put(),
                put.hex(), put.is_put(), put.task_id().hex(),
                oid.job_id().hex(), ids.ObjectID.nil().is_nil()]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ids_equal_ray_tpu(seed):
    assert (_id_walk(tids, random.Random(seed))
            == _id_walk(jids, random.Random(seed)))


def _resource_walk(res, rng):
    node = res.NodeResources({"CPU": 8, "GPU": 4, "memory": 1e9},
                             {"rt.io/tpu-slice": "s"})
    held, out = [], []
    for _ in range(40):
        if held and rng.random() < 0.4:
            req, asg = held.pop(rng.randrange(len(held)))
            node.free(req, asg)
            out.append(("free", node.snapshot()["available"]))
            continue
        want = {"CPU": rng.choice([0, 0.5, 1, 2]),
                "GPU": rng.choice([0, 0.25, 0.5, 1, 2])}
        req = res.ResourceRequest({k: v for k, v in want.items() if v})
        asg = node.allocate(req)
        out.append(("alloc", want, asg, node.snapshot()["available"]))
        if asg is not None:
            held.append((req, asg))
    a = res.ResourceSet({"CPU": 1.5, "GPU": 0.25})
    b = res.ResourceSet({"CPU": 0.5, "X": 2})
    c = res.ResourceSet({"CPU": 0.5, "GPU": 0.25})
    out.append(((a + b).to_dict(), (a - c).to_dict(), a.is_subset_of(a + b),
                res.to_fixed(0.0001), res.from_fixed(res.to_fixed(0.3))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resources_and_gpu_assignment_equal_ray_tpu(seed):
    assert (_resource_walk(tres, random.Random(seed))
            == _resource_walk(jres, random.Random(seed)))


def _spec(ids, spec, res):
    job = ids.JobID.from_int(7)
    driver = ids.TaskID.for_driver(job)
    return spec.TaskSpec(
        task_id=ids.TaskID.for_normal_task(job, driver, 3), job_id=job,
        task_type=spec.TaskType.NORMAL_TASK,
        function=spec.FunctionDescriptor("mod", "fn"),
        serialized_func=b"f", num_returns=2,
        args=[spec.TaskArg.inline(b"x"),
              spec.TaskArg.by_ref(ids.ObjectID.for_put(driver, 1))],
        required_resources=res.ResourceRequest({"CPU": 1, "GPU": 0.5}),
        scheduling_strategy=spec.SpreadStrategy(), max_retries=2,
        caller_address=("127.0.0.1", 1234), name="fn")


def _spec_view(s):
    return (s.task_id.hex(), s.job_id.hex(), s.task_type.name,
            s.function.key(), [r.hex() for r in s.return_ids()],
            [d.hex() for d in s.dependencies()],
            s.required_resources.to_dict(), type(s.scheduling_strategy).__name__,
            s.max_retries, s.is_actor_task(), s.shape_key()[1:])


def test_task_spec_round_trips_equal_ray_tpu():
    t = pickle.loads(pickle.dumps(_spec(tids, tspec, tres)))
    j = pickle.loads(pickle.dumps(_spec(jids, jspec, jres)))
    assert _spec_view(t) == _spec_view(j)
    assert t.required_resources.shape_key() == j.required_resources.shape_key()


def _view(ids, res, cs, rng):
    view = cs.ClusterView()
    for i in range(6):
        total = {"CPU": rng.choice([2, 4, 8]), "GPU": rng.choice([0, 1, 8])}
        labels = {"rt.io/tpu-slice": f"s{i % 2}"}
        nr = res.NodeResources(total, labels)
        if rng.random() < 0.5:
            nr.allocate(res.ResourceRequest({"CPU": 1}))
        nid = ids.NodeID(bytes([i + 1]) * ids.NodeID.SIZE)
        view.upsert(cs.NodeEntry(nid, ("127.0.0.1", 1000 + i), nr))
    return view


def _policy_walk(ids, res, cs, pol, seed):
    rng = random.Random(seed)
    view = _view(ids, res, cs, rng)
    out = []
    for _ in range(12):
        req = res.ResourceRequest({"CPU": rng.choice([1, 2, 4]),
                                   "GPU": rng.choice([0, 1, 4])})
        e = pol.pick_node(view, req, rng=random.Random(seed))
        out.append(e.node_id.hex() if e else None)
    for strategy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD",
                     "SLICE_PACK"):
        bundles = [res.ResourceRequest({"CPU": 1})] * 2
        try:
            got = pol.place_bundles(view, bundles, strategy,
                                    rng=random.Random(seed))
            out.append([n.hex() for n in got] if got else got)
        except pol.BundlePlacementError as e:
            out.append(("error", str(e)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policies_choose_the_same_nodes_as_ray_tpu(seed):
    assert (_policy_walk(tids, tres, tcs, tpol, seed)
            == _policy_walk(jids, jres, jcs, jpol, seed))


_VALUES = [0, 1.5, "s", b"b", [1], (1, 2), {"k": 1}, None, True]


def _verdicts(schema, seed):
    rng = random.Random(seed)
    out = []
    for method in sorted(tschema.RPC_SCHEMAS):
        if method == "create_actor":
            continue  # the device grant's field differs: see below
        fields = [f.name for f in tschema.RPC_SCHEMAS[method].fields]
        for _ in range(6):
            kw = {f: rng.choice(_VALUES) for f in fields if rng.random() < 0.8}
            if rng.random() < 0.3:
                kw["unknown"] = 1
            try:
                out.append(sorted(schema.validate(method, kw)))
            except schema.SchemaError as e:
                out.append(str(e))
    return out


def _fields(schema, method):
    return [(f.name, f.type, f.required)
            for f in schema.RPC_SCHEMAS[method].fields]


def test_rpc_schema_verdicts_equal_ray_tpu():
    assert _verdicts(tschema, 0) == _verdicts(jschema, 0)
    # the port leaves out what only unported parts send: the coalesced
    # lease grant, the autoscaler's demand feed and the failover fencing
    assert set(jschema.RPC_SCHEMAS) - set(tschema.RPC_SCHEMAS) == {
        "request_worker_leases"}
    assert set(tschema.RPC_SCHEMAS) <= set(jschema.RPC_SCHEMAS)
    for method in tschema.RPC_SCHEMAS:
        if method == "report_resources":
            assert _fields(tschema, method) == [
                f for f in _fields(jschema, method)
                if f[0] not in ("pending", "leader_epoch")]
        elif method != "create_actor":
            assert _fields(tschema, method) == _fields(jschema, method)
    rename = {"tpu_chips": "gpu_ids"}
    assert ([(rename.get(f.name, f.name), f.type, f.required)
             for f in jschema.RPC_SCHEMAS["create_actor"].fields]
            == [(f.name, f.type, f.required)
                for f in tschema.RPC_SCHEMAS["create_actor"].fields])


def test_rpc_server_stop_closes_a_connection_accepted_as_it_stops():
    """A connection the server accepted but whose handler runs only after
    stop() began is closed by that handler, so stop() returns while the
    peer still holds its end; asyncio's wait_closed() otherwise waits on
    it as long as the peer keeps it open (a runtime shutdown that hangs
    on a worker connecting at that moment)."""
    import asyncio
    import socket
    import threading

    from ray_tpu_torch.rpc.rpc import RpcServer

    server = RpcServer()
    handler = server._on_conn

    async def after_stop_began(reader, writer):
        while not server._stopping:
            await asyncio.sleep(0.01)
        await handler(reader, writer)

    server._on_conn = after_stop_began
    server.start()
    peer = socket.create_connection(server.address, timeout=10)
    try:
        time.sleep(0.2)              # accepted; its handler is held
        stopped = threading.Event()
        threading.Thread(target=lambda: (server.stop(), stopped.set()),
                         daemon=True).start()
        assert stopped.wait(10), "stop() waited on the late connection"
        assert peer.recv(1) == b""   # the server closed it
    finally:
        peer.close()


def test_natives_built_and_fastspec_bytes_equal_ray_tpu():
    """The port's natives really load (no silent pure-Python fallback)
    from ray_tpu_torch/_build, and encode byte for byte as ray_tpu's."""
    from ray_tpu_torch.object_store import shm

    tfs, jfs = tnative.load_fastspec(), jnative.load_fastspec()
    assert tfs is not None and jfs is not None
    assert tnative.load_fastloop() is not None
    assert shm._load() is not None
    build = os.path.join(REPO, "ray_tpu_torch", "_build")
    for so in ("_fastspec.so", "_fastloop.so", "libshm_store.so"):
        assert os.path.exists(os.path.join(build, so)), so
    rng = np.random.default_rng(0)
    for _ in range(5):
        b = [rng.bytes(int(n)) for n in rng.integers(0, 64, 7)]
        seq, nret, port = (int(x) for x in rng.integers(0, 1 << 16, 3))
        v1 = tfs.pack(b[0], b[1], b[2], b[3], b[4], b[5], b[6],
                      seq, nret, port)
        assert v1 == jfs.pack(b[0], b[1], b[2], b[3], b[4], b[5], b[6],
                              seq, nret, port)
        assert tnative.unpack_fastspec(v1) == jnative.unpack_fastspec(v1)
        b.append(rng.bytes(9))
        v2 = tfs.pack_task(*b[:8], nret, port)
        assert v2 == jfs.pack_task(*b[:8], nret, port)
        assert tnative.unpack_fasttask(v2) == jnative.unpack_fasttask(v2)


def test_fault_manifest_matches_the_ports_call_sites():
    """The port's FAULT_POINTS and its fault_point("...") call sites agree,
    as tests/test_fault_injection.py holds the JAX package's."""
    import re

    from ray_tpu_torch.common import faults

    pat = re.compile(r"""fault_point\(\s*["']([^"']+)["']\s*\)""")
    sites = set()
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py") and path != os.path.abspath(faults.__file__):
                with open(path, encoding="utf-8") as fh:
                    sites.update(pat.findall(fh.read()))
    assert sites == set(faults.FAULT_POINTS)


# --------------------------------------------- GPU detection, session state

@pytest.mark.parametrize("env,want", [("0,1", 2), ("", 0), ("-1", 0),
                                      ("2,-1,3", 1), ("GPU-a,GPU-b", 2)])
def test_gpu_detect_counts_cuda_visible_devices(monkeypatch, env, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
    assert gpu_detect.detect() == want
    vis = gpu_detect.visible_device_ids()
    assert gpu_detect.device_ids_for(range(want), vis) == vis[:want]
    # a declared count beyond the visible devices names the index
    assert gpu_detect.device_ids_for([want], vis) == [want]


def test_gpu_detect_never_loads_torch_or_cuda():
    code = ("import sys, ray_tpu_torch.common.gpu_detect as g; "
            "n = g.detect(); assert 'torch' not in sys.modules; print(n)")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=60,
                         capture_output=True, text=True, check=True)
    no_gpu = (shutil.which("nvidia-smi") is None
              and not os.path.exists("/proc/driver/nvidia/gpus"))
    assert int(out.stdout) == 0 if no_gpu else int(out.stdout) >= 0


def test_neither_sweep_removes_the_other_packages_state(tmp_path):
    from ray_tpu.object_store import shm as jshm
    from ray_tpu_torch.object_store import shm as tshm

    assert tshm.node_shm_name(tids.NodeID.from_random()).startswith(
        "/rttshm_")
    dirs = {"rt_spill_a": "jax", "rtt_spill_b": "port",
            "rtshm_spill_rtshm_gone": "jax", "rttshm_spill_rttshm_gone": "port"}
    for name in dirs:
        (tmp_path / name).mkdir()
        (tmp_path / name / ".owner").write_text(str(DEAD_PID))
    tshm.gc_spill_dirs(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(
        n for n, who in dirs.items() if who == "jax")
    jshm.gc_spill_dirs(str(tmp_path))
    assert os.listdir(tmp_path) == []


def _refused_cli():
    cli = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "start"],
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=60,
                         capture_output=True, text=True)
    assert cli.returncode != 0
    raise NotImplementedError(cli.stderr)


def _failover_client():
    from ray_tpu_torch.gcs.client import GcsClient

    GcsClient(("127.0.0.1", 1), standby_addresses=[("127.0.0.1", 2)])


def _graph_builds():
    """Compiled graphs are ported: ``.bind`` on a remote function, an
    actor class and its method builds the DAG the JAX package builds (it
    runs in tests/test_torch_graph.py)."""
    from ray_tpu_torch.graph import ClassMethodNode, FunctionNode, InputNode

    class Stage:
        def step(self, x):
            return x

    with InputNode() as inp:
        fn = ray_tpu_torch.remote(lambda x: x).bind(inp)
        dag = ray_tpu_torch.remote(Stage).bind().step.bind(fn)
    assert isinstance(fn, FunctionNode) and isinstance(dag, ClassMethodNode)
    assert [type(n).__name__ for n in dag._topo()] == [
        "ClassNode", "InputNode", "FunctionNode", "ClassMethodNode"]


def _cluster_runs():
    """cluster_utils is ported: a GCS and two raylets come up and
    register (its scenario runs in tests/test_torch_cluster.py)."""
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(head_node_args={"num_cpus": 1})
    try:
        c.add_node(num_cpus=1, num_gpus=1)
        assert c.wait_for_nodes(2)
    finally:
        c.shutdown()


def _nccl_group():
    """The in-program backend is ported: a "nccl" group over two CPU slabs
    (the same reductions as tensor ops; NCCL itself runs on the card, in
    chip_smoke.py) allreduces (its scenario runs in
    tests/test_torch_collective.py)."""
    import torch

    from ray_tpu_torch import collective

    collective.init_collective_group(2, 0, backend="nccl", group_name="x",
                                     devices=[torch.device("cpu")] * 2)
    try:
        group = collective.get_group_handle("x")
        assert group.backend_name == "xla"
        out = collective.allreduce(torch.ones(2, 3), group_name="x")
        assert torch.equal(out, torch.full((3,), 2.0))
    finally:
        collective.destroy_collective_group("x")


def _quantized_group():
    """The KV group's quantized wire is ported: float payloads travel as
    block-int8 codes."""
    from _torch_dist import MemoryKV

    from ray_tpu_torch.collective.kv_group import KVGroup

    g = KVGroup(MemoryKV(), 1, 0, "g", quantized=True)
    x = np.linspace(-1, 1, 8192, dtype=np.float32)
    out = g.allreduce(x)
    assert np.abs(out - x).max() <= 2 / 255 / 2 + 1e-6
    assert g.wire_put_bytes < x.nbytes / 3


def _train_pipeline():
    """Train's pipeline mode is ported: ``pipeline_spec=`` takes the place
    of the train loop (its scenario runs in
    tests/test_torch_train_pipeline.py)."""
    from ray_tpu_torch.train import JaxTrainer, PipelineSpec, StageSpec

    spec = PipelineSpec(stages=[StageSpec(lambda g: {}, lambda p, x: x)],
                        loss=lambda y, t: (y - t).square().mean(),
                        device="cpu")
    assert JaxTrainer(pipeline_spec=spec).pipeline_spec is spec


def _rl_imports():
    """RL's PPO path is ported (tests/test_torch_rl.py)."""
    assert ray_tpu_torch.rl.PPOConfig is not None
    assert ray_tpu_torch.rl.FaultTolerantActorManager is not None


def _rl_later_imports():
    """RL beyond PPO is ported (tests/test_torch_rl_algos.py)."""
    assert ray_tpu_torch.rl.DQN is not None
    assert ray_tpu_torch.rl.DreamerV3Learner is not None


def _rl_anakin_imports():
    """Podracer is ported (tests/test_torch_podracer.py)."""
    assert ray_tpu_torch.rl.SebulbaHandle is not None
    assert ray_tpu_torch.rl.JaxCartPole is ray_tpu_torch.rl.TorchCartPole
    assert ray_tpu_torch.rl.envs.get_jax_env("CartPole-v1") is not None


def _parallel_imports():
    assert ray_tpu_torch.parallel.make_mesh is not None
    assert ray_tpu_torch.parallel.shard_pytree is not None


def _train_imports():
    assert ray_tpu_torch.train.JaxTrainer is not None
    assert ray_tpu_torch.train.TorchTrainer is not None


def _cluster_control_plane():
    from ray_tpu_torch.cluster_utils import Cluster

    Cluster(control_plane_procs=True)


# part -> (the call a user makes, what its refusal names); a part that a
# later slice ported keeps its case, with None for the refusal: its call
# must then run and show the part works
_WAITING_CASES = {
    "client": (lambda: ray_tpu_torch.init(address="ray://localhost:1"),
               "ROADMAP.md, queue A item 11"),
    "control_plane": (lambda: ray_tpu_torch.init(
        system_config={"control_plane_procs": 1}), "control-plane"),
    "dashboard": (lambda: ray_tpu_torch.init(dashboard=True), "dashboard"),
    "autoscaler": (lambda: ray_tpu_torch.init(
        system_config={"autoscaling_enabled": True}), "the autoscaler"),
    "graph": (_graph_builds, None),
    "cluster_utils": (_cluster_runs, None),
    "collective": (_nccl_group, None),
    "collective_quantized": (_quantized_group, None),
    "train_pipeline": (_train_pipeline, None),
    "rl": (_rl_imports, None),
    "rl_later": (_rl_later_imports, None),
    "rl_anakin": (_rl_anakin_imports, None),
    "parallel": (_parallel_imports, None),
    "train": (_train_imports, None),
    "cluster_control_plane": (_cluster_control_plane, "control-plane"),
    "gcs_failover": (_failover_client, "GCS failover"),
    "cli": (_refused_cli, "item 11, the CLI"),
    **{name: (lambda name=name: getattr(ray_tpu_torch, name), item)
       for name, item in (
           ("job", "item 11, jobs"), ("data", None), ("tune", None),
           ("llm", None))},
}


@pytest.mark.parametrize("part", sorted(_WAITING_CASES))
def test_waiting_parts_refuse_with_their_roadmap_item(part):
    call, item = _WAITING_CASES[part]
    if item is None:
        call()
    else:
        with pytest.raises(NotImplementedError, match=item):
            call()
    assert not ray_tpu_torch.is_initialized()


# ------------------------------------------------------ one port cluster

@pytest.fixture(scope="module")
def rt():
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_owner_waits_for_a_return_a_borrower_asks_for_early(rt):
    """A borrower that asks the owner for a return whose task is still
    running waits for it: the owner re-runs only a freed object's task
    (ray_tpu runs the task a second time; ROADMAP.md, places where the
    port differs on purpose)."""
    @rt.remote
    class Slow:
        def __init__(self):
            self.calls = 0

        def work(self):
            self.calls += 1
            time.sleep(1.0)
            return self.calls

        def count(self):
            return self.calls

    @rt.remote
    def resolve(box):
        import ray_tpu_torch as _rt

        return _rt.get(box[0], timeout=TIMEOUT)

    slow = Slow.remote()
    ref = slow.work.remote()   # nested in a list: the task borrows it
    assert rt.get(resolve.remote([ref]), timeout=TIMEOUT) == 1
    assert rt.get(slow.count.remote(), timeout=TIMEOUT) == 1
    rt.kill(slow)


def test_actor_handle_waits_for_a_slow_creation(rt, monkeypatch, caplog):
    """A call on an actor whose constructor outlasts the handle's GCS
    window waits for the creation, as the reference's calls queue until
    the actor is ALIVE or DEAD, and the handle warns while it waits (the
    JAX package's handle gives up after 60 s; ROADMAP.md, places where the
    port differs on purpose)."""
    import logging

    from ray_tpu_torch.common.config import GLOBAL_CONFIG
    from ray_tpu_torch.core_worker import submitter

    monkeypatch.setenv("RT_gcs_rpc_server_reconnect_timeout_s", "1")
    monkeypatch.setattr(submitter, "PENDING_WARN_S", 0.5)
    GLOBAL_CONFIG.reset_cache()
    try:
        @rt.remote
        class SlowStart:
            def __init__(self):
                time.sleep(2.5)

            def ping(self):
                return "up"

        with caplog.at_level(logging.WARNING,
                             logger="ray_tpu_torch.core_worker.submitter"):
            actor = SlowStart.remote()
            assert rt.get(actor.ping.remote(), timeout=TIMEOUT) == "up"
        waits = [r.getMessage() for r in caplog.records
                 if "still PENDING_CREATION" in r.getMessage()]
        assert waits, caplog.records
        rt.kill(actor)
    finally:
        monkeypatch.delenv("RT_gcs_rpc_server_reconnect_timeout_s")
        GLOBAL_CONFIG.reset_cache()


def test_owner_reconstructs_a_value_whose_spill_file_was_lost(rt):
    """An owned return whose spill file is gone (the store dropped the
    entry on a failed restore) is re-run by its owner when a borrower asks
    for it: only a pending return makes the borrower wait."""
    from ray_tpu_torch import api

    @rt.remote
    def make():
        return b"spilled" * 4096

    ref = make.remote()
    assert rt.get(ref, timeout=TIMEOUT) == b"spilled" * 4096
    store = api._core_worker().memory_store
    with store._cv:
        store._spill_locked(1 << 62)
        path = store._entries[ref.object_id].spilled_path
    assert path is not None
    os.unlink(path)
    assert store.get_if_ready(ref.object_id) is None  # entry dropped
    assert not store.contains(ref.object_id)

    @rt.remote
    class Borrower:  # an actor: the re-run task needs a worker of its own
        def resolve(self, box):
            import ray_tpu_torch as _rt

            return _rt.get(box[0], timeout=TIMEOUT)

    borrower = Borrower.remote()
    start = time.monotonic()
    assert (rt.get(borrower.resolve.remote([ref]), timeout=TIMEOUT)
            == b"spilled" * 4096)
    assert time.monotonic() - start < TIMEOUT / 2  # re-run, not waited out
    rt.kill(borrower)


def test_session_dir_has_the_ports_prefix(rt):
    from ray_tpu_torch import api

    assert api._head["session_dir"].startswith(
        os.path.join(tempfile.gettempdir(), "rtt", "session_"))


def test_worker_holds_no_jax_and_nothing_of_ray_tpu(rt):
    @rt.remote
    def modules():
        return sorted(sys.modules)

    mods = rt.get(modules.remote(), timeout=TIMEOUT)
    assert "ray_tpu_torch.core_worker.worker" in mods
    bad = [m for m in mods if m == "ray_tpu" or m.startswith(("ray_tpu.",
                                                             "jax"))]
    assert bad == []
    assert "torch" not in mods  # loaded only where a tensor is handled


def _running(pid):
    """False once ``pid`` has exited (a zombie not yet reaped counts as
    exited: the raylet reaps the workers it exec-spawned lazily)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_gpu_lease_is_exported_and_its_worker_dies_with_it(rt):
    @rt.remote(num_gpus=1)
    def granted():
        return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

    @rt.remote
    def plain():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    visible, pid = rt.get(granted.remote(), timeout=TIMEOUT)
    assert visible == "0"
    assert rt.get(plain.remote(), timeout=TIMEOUT) == ""
    deadline = time.monotonic() + 20
    while _running(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _running(pid), "the worker that held the GPU outlived its lease"


def test_gpu_lease_never_gets_a_worker_that_ran_code(rt):
    """A CPU task that asks torch for CUDA (on a card, cuInit under
    CUDA_VISIBLE_DEVICES="") goes back to the pool; a GPU task and a GPU
    actor after it must each get a worker that has run nothing."""
    from ray_tpu_torch import api
    from ray_tpu_torch.core_worker.worker import CoreWorker

    raylet = api._head["raylet"]

    @rt.remote
    def probe():
        import torch

        torch.cuda.is_available()
        os.environ["RTT_PROBED"] = "1"
        time.sleep(0.2)  # four at once: four workers
        return os.getpid()

    def fresh():
        return (os.getpid(), os.environ["CUDA_VISIBLE_DEVICES"],
                os.environ.get("RTT_PROBED"),
                len(CoreWorker._current._fn_cache))

    @rt.remote(num_gpus=1)
    class Holder:
        def where(self):
            return fresh()

    probed = set(rt.get([probe.remote() for _ in range(4)], timeout=TIMEOUT))

    def pid(w):
        return w.factory_pid or (w.proc.pid if w.proc else None)

    def pooled():  # probed workers back in the pool (the reaper keeps
        # some of them: idle ones beyond the warm watermark are killed)
        return probed & {pid(w) for w in list(raylet._workers.values())
                         if w.state == "IDLE"}

    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not pooled():
        time.sleep(0.01)
    assert pooled(), "no probed worker came back to the pool"
    task_pid, visible, mark, fns = rt.get(
        rt.remote(num_gpus=1)(fresh).remote(), timeout=TIMEOUT)
    assert (visible, mark, fns) == ("0", None, 1)
    assert task_pid not in probed
    h = Holder.remote()
    actor_pid, visible, mark, fns = rt.get(h.where.remote(), timeout=TIMEOUT)
    assert (visible, mark, fns) == ("0", None, 0)  # methods skip the cache
    assert actor_pid not in probed
    rt.kill(h)


def test_worker_refuses_a_gpu_grant_once_torch_is_loaded(rt):
    """The worker's own guard behind the raylet's: once torch is loaded,
    CUDA may have read CUDA_VISIBLE_DEVICES, so a grant of other GPUs
    raises (the raylet then kills the worker and grants again)."""
    @rt.remote
    def grant_after_torch():
        import asyncio

        import torch  # noqa: F401
        from ray_tpu_torch.core_worker.worker import CoreWorker

        try:
            asyncio.run(CoreWorker._current.h_set_visible_devices(
                gpu_ids=[0]))
        except RuntimeError as e:
            return str(e), os.environ["CUDA_VISIBLE_DEVICES"]
        return None, os.environ["CUDA_VISIBLE_DEVICES"]

    err, visible = rt.get(grant_after_torch.remote(), timeout=TIMEOUT)
    assert err is not None and "cannot take a lease" in err
    assert visible == ""


def test_fractional_gpus_share_one_instance(rt):
    @rt.remote(num_gpus=0.5)
    class Half:
        def visible(self):
            return os.environ["CUDA_VISIBLE_DEVICES"]

    a, b = Half.remote(), Half.remote()
    assert rt.get([a.visible.remote(), b.visible.remote()],
                  timeout=TIMEOUT) == ["0", "0"]
    deadline = time.monotonic() + 10
    while (rt.available_resources().get("GPU", 0.0) != 0
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert rt.available_resources().get("GPU", 0.0) == 0
    rt.kill(a)
    rt.kill(b)


# ------------------------------------------- device objects, CPU tensors

def test_device_object_same_process_identity_and_gc(rt):
    import gc

    from ray_tpu_torch.core_worker.worker import CoreWorker

    store = CoreWorker.current_or_raise().device_store
    before = store.stats()
    val = {"w": torch.ones(8, 8, dtype=torch.bfloat16), "step": 3}
    ref = rt.put(val, _tensor_transport="device")
    out = rt.get(ref, timeout=TIMEOUT)
    assert out["w"] is val["w"] and out["step"] == 3
    assert store.stats()["device_bytes"] == before["device_bytes"] + 128
    del ref, out
    gc.collect()
    deadline = time.monotonic() + 10
    while (store.stats()["num_objects"] != before["num_objects"]
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert store.stats() == before


def test_device_object_crosses_workers_bf16_bytes_intact(rt):
    @rt.remote
    def echo(x):
        return x["w"].dtype, x["w"].view(torch.int16).numpy().tobytes()

    g = torch.Generator().manual_seed(0)
    w = torch.randn(2048, 1024, generator=g).to(torch.bfloat16)  # 4 MiB
    ref = rt.put({"w": w, "tag": "weights"}, _tensor_transport="device")
    dtype, raw = rt.get(echo.remote(ref), timeout=TIMEOUT)
    assert dtype == torch.bfloat16
    assert raw == w.view(torch.int16).numpy().tobytes()
    big = torch.randn(3, 1024, 1024, generator=g)  # 12 MiB: chunked pull
    assert rt.get(echo.remote(rt.put({"w": big}, _tensor_transport="device")),
                  timeout=TIMEOUT)[1] == big.view(torch.int16).numpy().tobytes()


def test_actor_device_return_and_consumer_cache(rt):
    @rt.remote
    class WeightServer:
        def __init__(self):
            self._w = torch.full((4, 4), 2.0, dtype=torch.bfloat16)

        @rt.method(tensor_transport="device")
        def weights(self):
            return self._w

        def use_locally(self, w):
            return w is self._w

    @rt.remote
    class Consumer:
        def probe(self, w):
            prev = getattr(self, "_prev", None)
            self._prev = w
            return prev is w, w.dtype, float(w.float().sum())

    srv = WeightServer.remote()
    ref = srv.weights.remote()
    w = rt.get(ref, timeout=TIMEOUT)
    assert w.dtype == torch.bfloat16 and torch.equal(
        w, torch.full((4, 4), 2.0, dtype=torch.bfloat16))
    assert rt.get(srv.use_locally.remote(ref), timeout=TIMEOUT)
    c = Consumer.remote()
    assert rt.get(c.probe.remote(ref), timeout=TIMEOUT) == (
        False, torch.bfloat16, 32.0)
    assert rt.get(c.probe.remote(ref), timeout=TIMEOUT)[0] is True


def test_plain_tensors_cross_as_values(rt):
    @rt.remote
    def double(t):
        return t * 2

    for t in (torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
              torch.randn(300, 300), torch.tensor(True)):
        out, want = rt.get(double.remote(t), timeout=TIMEOUT), t * 2
        assert out.dtype == want.dtype and torch.equal(out, want)
    with pytest.raises(TypeError, match="torch.Tensor"):
        rt.put([1, 2], _tensor_transport="device")


def test_cuda_marker_without_a_gpu_raises():
    from ray_tpu_torch.object_store import device

    staged = {"w": device.HostTensor(torch.ones(2), "cuda")}
    if torch.cuda.is_available():
        pytest.skip("this process sees a GPU")
    with pytest.raises(RuntimeError, match="sees no GPU"):
        device.restore_on_device(staged)
    back = device.restore_on_device(
        {"w": device.HostTensor(torch.ones(2), "cpu")})
    assert torch.equal(back["w"], torch.ones(2))


def test_gpu_actor_of_a_bundle_after_the_gcs_saw_the_bundle_reserved(rt):
    """A GPU actor of a placement-group bundle comes up when the GCS's
    view already shows the node's one GPU reserved by that bundle (0
    free). The GCS used to pick the actor's node by the node's free
    resources, so such an actor stayed pending for ever: how a Train
    gang's one GPU worker sometimes never came up (ROADMAP C.4 (a))."""
    from ray_tpu_torch.core_worker.placement_group import (
        PlacementGroupSchedulingStrategy)

    @rt.remote(num_gpus=1)
    class Worker:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    pg = rt.placement_group([{"GPU": 1}])
    assert pg.ready(timeout=TIMEOUT)
    deadline = time.monotonic() + 20
    while rt.available_resources().get("GPU", 0.0) != 0.0 \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    try:
        w = Worker.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
        assert rt.get(w.visible.remote(), timeout=20) == "0"
        rt.kill(w)
    finally:
        rt.remove_placement_group(pg)
    deadline = time.monotonic() + 20
    while rt.available_resources().get("GPU", 0.0) != 1.0 \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert rt.available_resources().get("GPU", 0.0) == 1.0
