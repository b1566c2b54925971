"""A pool of gloo ranks for the port's distributed tests on the CPU, and
the port's side of each scenario they run.

:class:`RankPool` starts ``world`` processes with ``torch.multiprocessing``
``spawn`` (fork is unsafe once JAX has started threads in the test
process), joins them into one gloo process group, and runs scenarios: a
call sends the name of a function of this module and its arguments to
every rank, and returns each rank's result. This module imports no JAX
and nothing of ``ray_tpu``, so a rank loads only torch and
``ray_tpu_torch``. A test module starts one pool and closes it at its
end; its ``_module_isolation_guard`` reaps any rank left behind.
"""

import socket
import threading
import traceback

import numpy as np

RESULT_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, conn):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    while True:
        task = conn.recv()
        if task is None:
            return   # the group ends with the processes
        name, args = task
        try:
            conn.send((True, globals()[name](*args)))
        except BaseException:  # noqa: BLE001 — report to the test
            conn.send((False, traceback.format_exc()))


class RankPool:
    """``world`` gloo ranks in spawned processes, running this module's
    scenario functions on demand."""

    def __init__(self, world: int = 4):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        # one pipe a rank (queues' semaphores upset spawn's resource
        # tracker at exit)
        pipes = [ctx.Pipe() for _ in range(world)]
        self._conns = [ours for ours, _ in pipes]
        port = _free_port()
        self._procs = [ctx.Process(
            target=_rank_main, args=(r, world, port, pipes[r][1]),
            daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, name: str, *args, timeout: float = RESULT_TIMEOUT_S):
        """``name(*args)`` on every rank; the list of results by rank. A
        rank's exception is raised here with its traceback."""
        for conn in self._conns:
            conn.send((name, args))
        results, errors = [None] * self.world, []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(timeout):
                raise TimeoutError(
                    f"{name}: rank {rank} did not answer in {timeout} s\n"
                    + "\n".join(errors))
            ok, value = conn.recv()
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            # every rank fails the same way as a rule: the first suffices
            raise RuntimeError(f"{name} failed on {len(errors)} rank(s); "
                               f"{errors[0]}")
        return results

    def close(self):
        for conn in self._conns:
            conn.send(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


class MemoryKV:
    """The GCS internal KV's four calls, in memory, shared by threads: a
    collective group's ranks on threads of one process."""

    def __init__(self):
        self._d, self._lock = {}, threading.Lock()

    @staticmethod
    def _k(ns, key):
        return ns, key.encode() if isinstance(key, str) else key

    def kv_put(self, ns, key, value, overwrite=True):
        with self._lock:
            self._d[self._k(ns, key)] = value
        return True

    def kv_get(self, ns, key):
        with self._lock:
            return self._d.get(self._k(ns, key))

    def kv_del(self, ns, key):
        with self._lock:
            return self._d.pop(self._k(ns, key), None) is not None

    def kv_keys(self, ns, prefix=b""):
        with self._lock:
            return [k for n, k in self._d if n == ns and k.startswith(prefix)]


# ------------------------------------------------------- the port's side
# Each runs on every rank with the same arguments; numpy in, numpy out.

def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().float().numpy()


def _mesh(config_kw):
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**config_kw), device_type="cpu")


def _rules(name):
    from ray_tpu_torch.parallel import sharding

    return getattr(sharding, name)


def mesh_and_shards(config_kw, rules_name, params, axes):
    """This rank's mesh coordinate, the mesh's shape, and the local
    shard shape of each leaf of ``params`` placed by ``axes``."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import shard_pytree

    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = _mesh(config_kw)
    # the same mesh over the ranks named
    named = make_mesh(MeshConfig(**config_kw), devices=range(dist.get_world_size()),
                      device_type="cpu")
    assert named.mesh.tolist() == mesh.mesh.tolist()
    placed = shard_pytree(_tensors(params), axes, mesh, _rules(rules_name))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.to_local().shape)

    return {"rank": dist.get_rank(), "coordinate": mesh.get_coordinate(),
            "shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "local_shapes": shapes(placed)}


def _llama_config(sp_axis=None):
    import dataclasses

    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.CONFIGS["debug"], sp_axis=sp_axis)


def _family(name, sp_axis=None):
    """(model module, its debug config with ``sp_axis``, its logical axes)
    of the family ``name``: "llama" or "moe"."""
    import dataclasses

    from ray_tpu_torch.models import llama, moe

    if name == "moe":
        cfg = moe.CONFIGS["debug"]
        cfg = dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, sp_axis=sp_axis))
        return moe, cfg, moe.param_logical_axes(cfg)
    cfg = _llama_config(sp_axis)
    return llama, cfg, llama.param_logical_axes(cfg)


def sharded_loss(config_kw, rules_name, params, tokens, sp_axis=None,
                 family="llama"):
    """The debug model's loss and accuracy on sharded parameters (with
    the MoE's router metrics)."""
    import torch

    from ray_tpu_torch.parallel import shard_pytree

    model, cfg, axes = _family(family, sp_axis)
    mesh, rules = _mesh(config_kw), _rules(rules_name)
    placed = shard_pytree(_tensors(params), axes, mesh, rules)
    with torch.no_grad():
        loss, aux = model.loss_fn(placed, {"tokens": torch.from_numpy(
            tokens)}, cfg, rules, mesh=mesh)
    return {"loss": loss.item(), **{k: v.item() for k, v in aux.items()}}


def sharded_train(config_kw, rules_name, params, tokens, opt_kw, steps,
                  family="llama"):
    """``steps`` sharded train steps of the debug model: each step's
    metrics, the gathered parameters after them, and the placements of
    the state's leaves."""
    import torch

    from ray_tpu_torch.models import training
    from ray_tpu_torch.parallel.sharding import set_mesh

    model, cfg, axes = _family(family)
    mesh, rules = _mesh(config_kw), _rules(rules_name)
    opt = training.OptimizerConfig(**opt_kw).make()
    with set_mesh(mesh):
        state, shardings = training.init_train_state(
            lambda g: _tensors(params), opt, None, param_axes=axes,
            mesh=mesh, rules=rules)
    step = training.make_train_step(
        lambda p, b: model.loss_fn(p, b, cfg, rules, mesh=mesh), opt,
        mesh, rules)
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    if family != "llama":
        return {"metrics": metrics, "params": _numpy(state.params)}
    mu_wq = state.opt_state.mu["layers"]["wq"]
    wq = state.params["layers"]["wq"]
    return {"metrics": metrics, "params": _numpy(state.params),
            "wq_placements": [str(p) for p in wq.placements],
            "mu_wq_placements": [str(p) for p in mu_wq.placements],
            "sharding_wq": [str(p) for p in
                            shardings.params["layers"]["wq"]],
            "sharding_mu_wq": [str(p) for p in
                               shardings.opt_state.mu["layers"]["wq"]],
            "sharding_step": [str(p) for p in shardings.step]}


def ring(config_kw, q, k, v, causal, mode, block, grads):
    """``ring_attention`` of the global (B, S, H, D) q/k/v as DTensors
    on the mesh; the whole output and, with ``grads``, the gradients of
    sum(out²) with respect to q, k and v."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel.sharding import compute_mesh, spec_placements

    mesh = _mesh(config_kw)
    pl = spec_placements((("dp", "fsdp"), "sp", "tp", None), mesh)
    xs = [distribute_tensor(torch.from_numpy(a), compute_mesh(mesh), pl)
          .requires_grad_(grads) for a in (q, k, v)]
    out = ring_attention(*xs, mesh, causal=causal, mode=mode, block=block)
    res = {"out": _numpy(out)}
    if grads:
        loss = out.square().sum().full_tensor()
        gs = torch.autograd.grad(loss, xs)
        res.update({n: _numpy(g) for n, g in zip(("dq", "dk", "dv"), gs)})
    return res


def checkpoint_roundtrip(config_kw, path, params, axes):
    """Save the tree of ``params`` placed by ``axes`` (FSDP_TP_RULES) with
    ``Checkpoint.from_pytree`` and restore it into a zeroed target on the
    same mesh: this rank's shards of the restored tree equal the saved
    ones bit for bit; the files each rank wrote."""
    import os

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import shard_pytree
    from ray_tpu_torch.train import Checkpoint

    mesh, rules = _mesh(config_kw), _rules("FSDP_TP_RULES")
    tree = {"params": shard_pytree(_tensors(params), axes, mesh, rules),
            "count": torch.tensor([7])}
    Checkpoint.from_pytree(path, tree)
    dist.barrier()
    target = {"params": shard_pytree(
        {k: (torch.zeros_like(torch.from_numpy(np.array(v)))
             if not isinstance(v, dict) else
             {n: torch.zeros_like(torch.from_numpy(np.array(w)))
              for n, w in v.items()}) for k, v in params.items()},
        axes, mesh, rules), "count": torch.tensor([0])}
    back = Checkpoint(path).to_pytree(target)

    def local(tree):
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in local(tree[k])]
        return [tree.to_local()]

    equal = all(torch.equal(a, b) for a, b in zip(local(back["params"]),
                                                  local(tree["params"])))
    return {"equal": equal, "count": int(back["count"][0]),
            "files": sorted(f for f in os.listdir(os.path.join(
                path, "pytree_dcp")) if f.endswith(".distcp"))}
