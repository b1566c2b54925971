"""The port's Serve (``ray_tpu_torch.serve``) against ``ray_tpu.serve`` on
the CPU: one module-scoped cluster per package (one at a time; a node of
``{"GPU": 1}`` on this CPU host), and one scenario program run through
both packages' Serve. Each part's results are held to stated values and,
for the port, to what ``ray_tpu`` gave on the same part:

- a function and a class deployment called through handles;
  ``@serve.batch`` (the batch sizes seen) and ``@serve.multiplexed`` (the
  model ids loaded, LRU at a cap of 2);
- the ``debug`` LLMServer (the JAX init's weights, converted for the
  port) through the HTTP proxy as JSON, as an SSE stream and through a
  handle: greedy tokens equal, token for token, and the SSE bytes
  (events and framing) equal;
- ``deploy_config`` with a valid and an invalid ``args.speculation``;
- ``status()`` keys, ``delete``, and the ``serve.replica.call`` fault
  point: the proxy routes the failed call again and answers 200;
- ``build_pd_app`` at ``debug``: its tokens equal the same package's
  unsplit LLMServer at the same seed; in the port each prefill runs once
  and hands its KV over as a device object;
- two ``num_gpus=0.5`` replicas on the one GPU: both see device 0 in the
  port (``CUDA_VISIBLE_DEVICES``);
- the gRPC ingress (skipped only where ``grpc`` is not installed).

Tokens must be exact; there is no float tolerance anywhere in this file.

Only ``ray_tpu``'s side runs a part once more (the PD part aside, which
runs once at one prompt), on a fresh cluster, when the part fails: tests/conftest.py's module guard ends every JAX-package
test file with a machine-wide ``pkill`` of ``ray_tpu``'s worker command
lines, so under xdist another file's teardown can kill this file's
``ray_tpu`` Serve actors at any moment (ROADMAP.md C.2; at the suite's
busiest that is every few seconds, and then ``ray_tpu``'s side can still
fail). The port's workers carry other command lines and cannot be
reached that way, so the port fails on its first error, and its results
are held to the stated values when ``ray_tpu`` gave none.
"""

import concurrent.futures
import importlib
import inspect
import json
import pickle
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jllama

from _torch_isolation import _module_isolation_guard  # noqa: F401

PACKAGES = ["ray_tpu", "ray_tpu_torch"]
PROMPTS = [([5, 17, 99, 3, 42], 8), (list(range(2, 18)), 6), ([200, 1], 5)]
PD_PROMPTS = PROMPTS[:2]
# ray_tpu's own tests/test_llm_pd.py holds its PD app to its engine; here
# its side is kept to one prompt in the smallest cache (one prefill bucket)
JAX_PD_PROMPTS = PROMPTS[:1]
JAX_PD_MAX_SEQ = 32
TIMEOUT = 120
JAX_TIMEOUT = 30      # short: a killed ray_tpu actor shows as a wait
JAX_ATTEMPTS = 2
# what ray_tpu gave on each part, for the port's run to equal
_RESULTS = {}

class _Pkg:
    """One package's runtime, Serve and proxy address."""

    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.serve = importlib.import_module(f"{name}.serve")
        self.port = name == "ray_tpu_torch"
        # the port's entry points run on the card unless told otherwise
        self.device = {"device": "cpu"} if self.port else {}
        self.timeout = TIMEOUT if self.port else JAX_TIMEOUT
        self.addr = None

    def start(self):
        if self.port:
            self.rt.init(num_cpus=8, num_gpus=1)
        else:
            self.rt.init(num_cpus=8, num_tpus=0, resources={"GPU": 1})
        try:
            import grpc  # noqa: F401

            grpc_port = 0
        except ImportError:   # the gRPC ingress needs grpcio
            grpc_port = None
        self.addr = self.serve.start(http_port=0, grpc_port=grpc_port)

    def stop(self):
        self.serve.shutdown()
        self.rt.shutdown()

    def url(self, path):
        return f"http://{self.addr['http_host']}:{self.addr['http_port']}" \
            + path

    def get(self, refs):
        return self.rt.get(refs, timeout=self.timeout)


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


def _post(url, body, headers=None, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _record(part, p, got):
    """Store ray_tpu's result of ``part``; the port's must equal it (when
    ray_tpu ran first in this process, as the fixture's order makes it)."""
    if not p.port:
        _RESULTS[part] = got
    elif part in _RESULTS:
        assert got == _RESULTS[part], (part, got, _RESULTS[part])


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jllama.CONFIGS["debug"], jax.random.key(0))


def _weights(p, jparams):
    if not p.port:
        return jparams
    from ray_tpu_torch.models.convert import params_from_jax

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


# ------------------------------------------------------------ no cluster

def test_serve_exports_every_name_of_ray_tpu_serve():
    import ray_tpu.serve as jserve
    import ray_tpu_torch.serve as tserve

    # the names its __init__ binds, not submodules other tests imported
    names = {n for n in dir(jserve) if not n.startswith("_")
             and not inspect.ismodule(getattr(jserve, n))}
    assert names <= set(dir(tserve))
    for n in names:   # none refuses as not ported
        getattr(tserve, n)


def test_serve_fault_points_are_the_reference_points():
    from ray_tpu.common import faults as jfaults
    from ray_tpu_torch.common import faults as tfaults

    for name in ("serve.replica.call", "serve.replica.stream",
                 "serve.proxy.write", "serve.controller.probe"):
        assert tfaults.FAULT_POINTS[name] == jfaults.FAULT_POINTS[name]


@pytest.mark.parametrize("headers,body,want_tenant", [
    ({"x-client-id": "edge-7"}, {"prompt": [1, 2], "max_tokens": 3}, "edge-7"),
    ({"x-client-id": "edge-7"}, {"prompt": [1, 2], "tenant": "t1",
                                 "temperature": 0.5, "eos_token": 2,
                                 "speculation": "ngram"}, "t1"),
    ({}, {}, None),
])
def test_llm_server_parses_a_proxy_request(headers, body, want_tenant):
    """``LLMServer._parse`` of a proxy Request: the JSON body's fields,
    and ``tenant`` falling back to the x-client-id header; direct handle
    arguments pass through."""
    from ray_tpu.serve.llm import LLMServer as JServer
    from ray_tpu.serve.proxy import Request as JRequest
    from ray_tpu_torch.serve.llm import LLMServer as TServer
    from ray_tpu_torch.serve.proxy import Request as TRequest

    raw = json.dumps(body).encode()
    got = [server._parse(Req("POST", "/llm", {}, headers, raw), {})
           for server, Req in ((JServer, JRequest), (TServer, TRequest))]
    assert got[0] == got[1]
    prompt, kw = got[1]
    assert prompt == body.get("prompt", [])
    assert kw["tenant"] == want_tenant
    assert kw["max_tokens"] == body.get("max_tokens", 64)
    assert TServer._parse([3, 4], {"max_tokens": 2}) == \
        ([3, 4], {"max_tokens": 2})


# ---------------------------------------------------------- the scenario

def _handles_batch_and_multiplex(p):
    serve = p.serve

    @serve.deployment
    def greet(name):
        return f"hello {name}"

    @serve.deployment(name="calc")
    class Calc:
        def add(self, a, b):
            return a + b

    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def __call__(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        def sizes(self):
            return self.batch_sizes

    mux_pkg = p.name

    @serve.deployment
    class Host:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return model_id.upper()

        def __call__(self, x):
            # an untagged request sees the empty model id
            mid = importlib.import_module(
                f"{mux_pkg}.serve").get_multiplexed_model_id()
            return (self.get_model(mid) if mid else mid), x

        def loaded(self):
            multiplex = importlib.import_module(f"{mux_pkg}.serve.multiplex")
            return sorted(multiplex.loaded_model_ids())

    h = serve.run(greet.bind(), name="greeter")
    hc = serve.run(Calc.bind())
    hb = serve.run(Batched.bind(), name="batched")
    hm = serve.run(Host.bind(), name="mux")
    out = {"greet": p.get(h.remote("gpu")),
           "add": p.get(hc.options(method_name="add").remote(2, 3)),
           "batched": sorted(p.get([hb.remote(i) for i in range(16)]))}
    sizes = p.get(hb.options(method_name="sizes").remote())
    out["batch_sizes_sum"] = sum(sizes)
    out["batched_more_than_one"] = max(sizes) > 1
    out["mux"] = [p.get(hm.options(multiplexed_model_id=m).remote(i))
                  for i, m in enumerate(["m1", "m2", "m1", "m3"])]
    out["loaded"] = p.get(hm.options(method_name="loaded").remote())
    out["untagged"] = p.get(hm.remote(9))
    for name in ("greeter", "calc", "batched", "mux"):
        serve.delete(name)
    assert out == {
        "greet": "hello gpu", "add": 5,
        "batched": [10 * i for i in range(16)], "batch_sizes_sum": 16,
        "batched_more_than_one": True,
        "mux": [("M1", 0), ("M2", 1), ("M1", 2), ("M3", 3)],
        "loaded": ["m1", "m3"], "untagged": ("", 9)}, out
    return out


def test_handles_batch_and_multiplex(pkg):
    _record("handles", pkg, _run(pkg, _handles_batch_and_multiplex))


def _sse_tokens(body: bytes):
    events = body.decode().split("\n\n")
    assert events[-2:] == ["data: [DONE]", ""], body
    return [json.loads(e.removeprefix("data: ")) for e in events[:-2]]


def _llm_through_the_proxy(p, weights):
    api = importlib.import_module(f"{p.name}.serve.api")
    app = api.llm_app("debug", kv_cache="paged", num_slots=2,
                      params=weights, **p.device)
    handle = p.serve.run(app, name="llm")
    url = p.url("/llm")
    bodies = [json.dumps({"prompt": pr, "max_tokens": n}).encode()
              for pr, n in PROMPTS]
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        whole = list(pool.map(
            lambda b: _post(url, b, timeout=p.timeout), bodies))
        sse = list(pool.map(lambda b: _post(
            url, b, {"accept": "text/event-stream"}, p.timeout), bodies))
    assert [s for s, _ in whole + sse] == [200] * 6, whole + sse
    tokens = [json.loads(b) for _, b in whole]
    assert [len(t) for t in tokens] == [n for _, n in PROMPTS]
    assert [_sse_tokens(b) for _, b in sse] == tokens
    via_handle = p.get(handle.remote(PROMPTS[0][0],
                                     max_tokens=PROMPTS[0][1]))
    assert via_handle == tokens[0]
    routes = json.loads(_post(p.url("/-/routes"), b"", timeout=p.timeout)[1])
    p.serve.delete("llm")
    return {"tokens": tokens, "sse": [b for _, b in sse], "routes": routes}


def test_llm_through_the_proxy_sse_and_handle(pkg, jparams):
    got = _run(pkg, lambda p: _llm_through_the_proxy(
        p, _weights(p, jparams)))
    _record("llm", pkg, got)
    if pkg.port and "llm" not in _RESULTS:
        from ray_tpu.serve.llm import LLMEngine as JaxEngine

        eng = JaxEngine(model="debug", params=jparams, kv_cache="paged")
        try:
            assert got["tokens"] == [
                eng.generate(pr, max_tokens=n, timeout_s=120)
                for pr, n in PROMPTS]
        finally:
            eng.shutdown()


def _declarative(p):
    schema = importlib.import_module(f"{p.name}.serve.schema")
    app = {"name": "spec-llm", "import_path": f"{p.name}.serve.api:llm_app",
           "args": {"model": "debug", "num_slots": 2, "kv_cache": "slot",
                    "speculation": "ngram", **p.device}}
    with pytest.raises(schema.ServeConfigError, match=r"args\.speculation"):
        p.serve.deploy_config({"applications": [dict(
            app, args=dict(app["args"], speculation={"method": "nope"}))]})
    with pytest.raises(schema.ServeConfigError, match="not in"):
        p.serve.deploy_config({"applications": [dict(
            app, args=dict(app["args"], speculation={
                "method": "draft", "draft_model": "debugg"}))]})
    echo = {"name": "echo",
            "import_path": f"{p.name}.serve._example_app:build_app",
            "args": {"prefix": "built"}}
    st = p.serve.deploy_config({"applications": [app, echo]},
                               timeout_s=p.timeout)
    spec = p.serve.get_declarative_config()["config"]["applications"][0][
        "args"]["speculation"]
    handle = p.serve.get_deployment_handle("spec-llm")
    out = p.get(handle.remote([5, 17, 99, 3, 42], max_tokens=6))
    stats = p.get(handle.options(method_name="stats").remote())
    echoed = p.get(p.serve.get_deployment_handle("echo").remote("x"))
    p.serve.delete("spec-llm")
    p.serve.delete("echo")
    got = {"states": {n: a["state"] for n, a in st["apps"].items()},
           "spec": spec, "n_tokens": len(out),
           "speculation": stats.get("speculation"), "echo": echoed}
    assert got == {"states": {"spec-llm": "DEPLOYED", "echo": "DEPLOYED"},
                   "spec": {"method": "ngram", "k": 4, "ngram": 2},
                   "n_tokens": 6, "speculation": "ngram",
                   "echo": "built:x"}, got
    return got


def test_deploy_config_checks_args_speculation(pkg):
    _record("declarative", pkg, _run(pkg, _declarative))


def _status_delete_and_fault(p):
    serve, name = p.serve, p.name

    @serve.deployment
    class Flaky:
        """Arms serve.replica.call once in its own replica process: the
        first call it receives fails like a torn transport."""

        def __init__(self):
            importlib.import_module(f"{name}.common.faults").inject(
                "serve.replica.call", "once")

        def __call__(self, request):
            return "served"

        def fired(self):
            return importlib.import_module(
                f"{name}.common.faults").fired("serve.replica.call")

    handle = serve.run(Flaky.bind(), name="flaky")
    status, body = _post(p.url("/flaky"), b"x", timeout=p.timeout)
    fired = p.get(handle.options(method_name="fired").remote())
    st = serve.status()
    keys = sorted(st["flaky"])
    serve.delete("flaky")
    got = {"status": status, "body": body.decode(), "fired": fired,
           "keys": keys, "running": st["flaky"]["running_replicas"],
           "deleted": "flaky" not in serve.status()}
    assert got == {"status": 200, "body": "served", "fired": 1,
                   "keys": ["autoscaling", "rolling", "running_replicas",
                            "target_replicas", "version"],
                   "running": 1, "deleted": True}, got
    return got


def test_status_delete_and_a_replica_call_fault(pkg):
    _record("status", pkg, _run(pkg, _status_delete_and_fault))


def _pd_prompts(p):
    return PD_PROMPTS if p.port else JAX_PD_PROMPTS


def _pd_app(p):
    pd = importlib.import_module(f"{p.name}.serve.llm_pd")
    if p.port:
        kw = dict(num_slots=2, max_seq=64, device="cpu",
                  ray_actor_options={"num_gpus": 0.5})
    else:
        kw = dict(num_slots=1, max_seq=JAX_PD_MAX_SEQ)
    handle = pd.build_pd_app("debug", name="pd", **kw)
    got = [p.get(handle.remote(pr, max_tokens=n)) for pr, n in _pd_prompts(p)]
    if p.port:
        pf = p.serve.get_deployment_handle("pd-prefill")
        dc = p.serve.get_deployment_handle("pd-decode")
        prefills = p.get(pf.options(method_name="stats").remote())["prefills"]
        dc_stats = p.get(dc.options(method_name="stats").remote())
        # one prefill per request (the owner never re-runs a task whose
        # return is still on its way) and one KV handoff each, timed apart
        # from the wait for the prefill's reply
        assert (len(prefills) == len(dc_stats["kv_handoff_ms"])
                == len(dc_stats["prefill_wait_ms"]) == len(PD_PROMPTS))
        assert [r["kv_bytes"] for r in prefills] == [
            2 * 2 * len(pr) * 2 * 16 * 4 for pr, _ in PD_PROMPTS]
        # the orchestrator sums the decode replicas' numeric stats; the
        # engine counts the decode steps' tokens (the first token of each
        # request comes from its prefill's logits)
        stats = p.get(handle.options(method_name="stats").remote())
        assert stats["tokens_generated"] == sum(n - 1 for _, n in PD_PROMPTS)
    for name in ("pd", "pd-prefill", "pd-decode"):
        p.serve.delete(name)
    return got


def test_pd_app_equals_the_unsplit_server(pkg):
    """Each package's PD app against its own unsplit LLMServer at the same
    seed. The port's build_pd_app takes ray_actor_options and gives both
    fleets half a GPU each here (ROADMAP.md, places where the port
    differs on purpose)."""
    p = pkg
    # ray_tpu's side runs once: a second cluster would double its cost
    got = _pd_app(p)
    prompts = _pd_prompts(p)
    if not p.port and "llm" in _RESULTS:
        # ray_tpu's seed 0 is the init the LLMServer test served, so its
        # replica's tokens are the unsplit server's (and save this process
        # a JAX engine's compiles)
        want = _RESULTS["llm"]["tokens"][:len(prompts)]
    else:
        llm = importlib.import_module(f"{p.name}.serve.llm")
        server = llm.LLMServer(
            model="debug", num_slots=2,
            max_seq=64 if p.port else JAX_PD_MAX_SEQ, **p.device)
        try:
            want = [server(pr, max_tokens=n) for pr, n in prompts]
        finally:
            server.engine.shutdown()
    assert got == want


def _half_gpu_replicas(p):
    serve = p.serve

    @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
    def lease():
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

    handle = serve.run(lease.bind(), name="lease")
    deadline = time.monotonic() + p.timeout
    seen = set()
    while len({pid for _, pid in seen}) < 2:
        assert time.monotonic() < deadline, seen
        seen |= set(p.get([handle.remote() for _ in range(8)]))
    while p.rt.available_resources().get("GPU", 0.0) != 0.0:
        # the node reports its leases on its next resource update
        assert time.monotonic() < deadline, p.rt.available_resources()
        time.sleep(0.05)
    serve.delete("lease")
    return {v for v, _ in seen}


def test_half_gpu_replicas_share_device_0(pkg):
    # the port exports each lease as CUDA_VISIBLE_DEVICES; ray_tpu counts
    # GPU as a plain resource and exports nothing
    assert _run(pkg, _half_gpu_replicas) == ({"0"} if pkg.port else {None})


def test_grpc_unary_call(pkg):
    grpc = pytest.importorskip("grpc")

    def part(p):
        @p.serve.deployment
        def shout(word):
            return word.upper()

        p.serve.run(shout.bind(), name="shout")
        with grpc.insecure_channel(
                f"{p.addr['http_host']}:{p.addr['grpc_port']}") as channel:
            call = channel.unary_unary("/shout/__call__")
            got = pickle.loads(call(pickle.dumps((("gpu",), {})),
                                    timeout=p.timeout))
        p.serve.delete("shout")
        return got

    assert _run(pkg, part) == "GPU"
