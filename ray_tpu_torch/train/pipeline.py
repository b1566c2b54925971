"""MPMD pipeline-parallel training over resident stage actors (port of
``ray_tpu/train/pipeline.py``).

The model is split into stages (:class:`StageSpec`); each stage runs as a
resident actor executing a 1F1B microbatch schedule (warmup forwards,
steady-state one-forward-one-backward interleave, drain backwards) over
preallocated :class:`~ray_tpu_torch.graph.channels.ShmChannel` hops — the
same depth-1 mutable-shm transport the compiled actor graphs ride
(``graph/compiled.py``), so per-microbatch cost is one memcpy + condvar
wake per hop with **no per-microbatch RPC or driver involvement**. The
driver only feeds microbatches into the head channel and reads one
metrics record per *step* from the tail.

Topology per data-parallel replica ``r`` (S stages, M microbatches)::

    driver ──x──▶ stage 0 ──act──▶ stage 1 ─ … ─▶ stage S-1 ──res──▶ driver
    driver ──y────────────────────────────────────▶ stage S-1
              stage 0 ◀──grad── stage 1 ◀─ … ─◀ stage S-1

Backward is a full recompute (autograd on a fresh forward of the stage at
the stashed input, as the JAX package's ``jax.vjp``), and the last stage
fuses loss + gradient at its forward slot, so warmup for stage ``i`` is
``min(S-1-i, M)`` and the schedule is deadlock-free on depth-1 channels.
Gradients accumulate across microbatches on the stage's device; at the
step boundary the stage takes its host step, as the JAX package does: a
flat f32 parameter vector and the flat mean gradient in leaf order,
:class:`~ray_tpu_torch.train.collectives.FlatOptimizer` (or the
data-parallel KV allreduce before it, or
:class:`~ray_tpu_torch.train.collectives.ZeroShardedOptimizer`), then the
vector cut back into the leaves. The data-parallel collectives ride the
quantized KV wire when ``RT_quantized_collectives`` is on.

Activations and cotangents cross the channels as CPU tensors in their own
dtype, as the shm pipeline of ``models/pipeline.py`` hands them; each
stage moves what it reads onto its device, which ``PipelineSpec.device``
names (None means CUDA, and raises where the stage has no GPU; the JAX
package's stages run on their default device).

This module is deliberately independent of :class:`JaxTrainer`: anything
that wants resident stage actors streaming microbatches can drive a
:class:`PipelineRunner` directly.
"""

from __future__ import annotations

import collections
import dataclasses
import uuid
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.graph.compiled import PipelineStageError

_LOOP_IO_TIMEOUT_S = 600.0  # stage-loop channel ops; driver watches refs


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage: ``init(generator) -> params`` (a dict, list or
    tuple tree of tensors; ``generator`` is seeded with ``seed + stage
    index`` on the stage's device), ``apply(params, x) -> y`` a torch
    function; the backward is autograd on a fresh forward of ``apply``
    (full recompute)."""

    init: Callable[..., Any]
    apply: Callable[[Any, Any], Any]
    name: str = ""


@dataclasses.dataclass
class PipelineSpec:
    """Declarative pipeline: stages + schedule + optimizer.

    ``loss(y_pred, y) -> scalar`` is fused with the last stage's forward.
    ``data_parallel`` replicates the whole pipeline R times with gradient
    allreduce across replicas folded into each stage's step boundary;
    ``zero_sharded_state`` switches that allreduce to the ZeRO
    reducescatter → shard-update → allgather form (optimizer state sharded
    1/R per replica). ``num_steps``/``data_fn`` are consumed by
    ``JaxTrainer.fit`` only — ``PipelineRunner`` users drive ``step()``
    themselves. ``device`` is the stages' device: None means CUDA (the
    stage's GPU lease), ``"cpu"`` the CPU.
    """

    stages: Sequence[StageSpec]
    loss: Callable[[Any, Any], Any]
    num_microbatches: int = 4
    optimizer: str = "sgd"
    learning_rate: float = 0.01
    data_parallel: int = 1
    zero_sharded_state: bool = False
    channel_capacity: int = 4 * 1024 * 1024
    seed: int = 0
    num_steps: int = 1
    data_fn: Optional[Callable[[int], Any]] = None
    device: Optional[str] = None

    def __post_init__(self):
        if not self.stages:
            raise ValueError("PipelineSpec needs at least one stage")
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if self.data_parallel < 1:
            raise ValueError("data_parallel must be >= 1")
        if self.zero_sharded_state and self.data_parallel < 2:
            raise ValueError(
                "zero_sharded_state shards optimizer state across "
                "data-parallel replicas; it needs data_parallel >= 2")


class _CleanStop(Exception):
    """Input channel closed at a step boundary: normal termination."""


# ------------------------------------------------------------ param trees

def _unflatten(like, leaves):
    """``like``'s tree structure holding ``leaves`` in leaf order, the
    order of ``models.training.tree_leaves`` (dict keys sorted, as
    ``jax.tree_util`` orders them)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _ravel(leaves) -> np.ndarray:
    """The leaves as one flat f32 host vector."""
    import torch

    return torch.cat([x.detach().reshape(-1).float().cpu()
                      for x in leaves]).numpy()


def _unravel(flat: np.ndarray, like_leaves, device) -> list:
    """``flat`` cut back into tensors shaped and typed as ``like_leaves``,
    on ``device``."""
    import torch

    out, lo = [], 0
    flat = torch.from_numpy(np.ascontiguousarray(flat))
    for x in like_leaves:
        n = x.numel()
        out.append(flat[lo:lo + n].reshape(x.shape).to(
            device=device, dtype=x.dtype))
        lo += n
    return out


def _wire(value):
    """What a channel carries: a CPU tensor, or a numpy array."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return np.asarray(value)


def _on(value, device):
    import torch

    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class _PipelineStageActor:
    """Resident stage: builds its programs once, then runs the 1F1B loop
    until its input channel closes (clean stop cascades head to tail
    through channel closure)."""

    def __init__(self, stage_blob: bytes, index: int, n_stages: int,
                 num_microbatches: int, seed: int, optimizer: str,
                 learning_rate: float, dp_spec=None, device=None):
        import cloudpickle

        fns = cloudpickle.loads(stage_blob)
        self._init_fn = fns["init"]
        self._apply_fn = fns["apply"]
        self._loss_fn = fns.get("loss")
        self._index = index
        self._n_stages = n_stages
        self._M = num_microbatches
        self._seed = seed
        self._opt_kind = optimizer
        self._lr = learning_rate
        self._dp_spec = dp_spec  # (tag, rank, world, zero) | None
        self._device_name = device
        self._is_last = index == n_stages - 1

    # ------------------------------------------------------------- programs
    def _build_fns(self, like):
        """The stage's forward, recomputing backward and (last stage) fused
        loss + gradient, over the parameter leaves; ``like`` is the
        parameter tree whose structure ``apply`` takes."""
        import torch

        apply_fn, loss_fn = self._apply_fn, self._loss_fn

        def fwd(leaves, x):
            with torch.no_grad():
                return apply_fn(_unflatten(like, leaves), x)

        def _grads(leaves, x, out_fn):
            ps = [p.detach().requires_grad_() for p in leaves]
            wrt_x = x.is_floating_point()
            xg = x.detach().requires_grad_() if wrt_x else x
            with torch.enable_grad():
                out, seed = out_fn(apply_fn(_unflatten(like, ps), xg))
                gs = torch.autograd.grad(out, ps + ([xg] if wrt_x else []),
                                         grad_outputs=seed,
                                         allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ps + ([xg] if wrt_x else []), gs)]
            gx = gs[len(ps)] if wrt_x else None
            return out.detach(), gs[:len(ps)], gx

        def bwd(leaves, x, g):
            _, gp, gx = _grads(leaves, x, lambda y: (y, g))
            return gp, gx

        def fused(leaves, x, y):
            return _grads(leaves, x, lambda out: (loss_fn(out, y), None))

        return fwd, bwd, (fused if self._is_last else None)

    def _host_step(self, leaves, grads, opt, opt_state, dp_group, zero):
        """The step boundary on the host: flat f32 params and mean grads
        in leaf order, the data-parallel reduction, the optimizer, the
        leaves again on the device. Returns (new leaves, opt_state)."""
        pflat = _ravel(leaves)
        gflat = _ravel(grads)
        if zero is not None:
            new_flat = zero.step(pflat, gflat, average=True)
        else:
            if dp_group is not None:
                gflat = np.asarray(
                    dp_group.allreduce(gflat)) / dp_group.world_size
            if opt_state is None:
                opt_state = opt.init_state(pflat.size, pflat.dtype)
            new_flat = opt.update(pflat, gflat, opt_state)
        return _unravel(new_flat, leaves, self._device), opt_state

    # ------------------------------------------------------------ exec loop
    def run_pipeline(self, in_ch, out_ch, grad_in_ch, grad_out_ch,
                     label_ch, result_ch):
        """Run steps until ``in_ch`` closes; returns the final params as a
        tree of CPU tensors."""
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models.training import tree_leaves
        from ray_tpu_torch.train.collectives import (
            FlatOptimizer,
            ZeroShardedOptimizer,
        )

        self._device = resolve_device(self._device_name)
        gen = torch.Generator(device=self._device).manual_seed(
            self._seed + self._index)
        tree = self._init_fn(gen)
        leaves = [_on(x, self._device) for x in tree_leaves(tree)]
        fns = self._build_fns(tree)
        opt = FlatOptimizer(kind=self._opt_kind, lr=self._lr)
        opt_state = None
        dp_group = zero = None
        if self._dp_spec is not None:
            tag, rank, world, use_zero = self._dp_spec
            from ray_tpu_torch import collective as _coll

            # every replica's stage-i loop starts concurrently → the KV
            # rendezvous for this per-stage group completes
            group_name = f"{tag}:dp:{self._index}"
            _coll.init_collective_group(world, rank, backend="kv",
                                        group_name=group_name)
            dp_group = _coll.get_group_handle(group_name)
            if use_zero:
                zero = ZeroShardedOptimizer(dp_group, opt)

        out_chans = [c for c in (out_ch, grad_out_ch, result_ch)
                     if c is not None]
        step = 0
        try:
            while True:
                try:
                    grads, loss = self._one_step(leaves, fns, in_ch, out_ch,
                                                 grad_in_ch, grad_out_ch,
                                                 label_ch)
                except _CleanStop:
                    break
                leaves, opt_state = self._host_step(
                    leaves, grads, opt, opt_state, dp_group, zero)
                step += 1
                if result_ch is not None:
                    result_ch.write({"step": step, "loss": loss},
                                    timeout_s=_LOOP_IO_TIMEOUT_S)
        except BaseException:
            # error stop: close OUR output ends first so blocked neighbors
            # wake with ChannelClosed (cascade) instead of riding out
            # their timeouts, then let the loop ref carry the real error
            for c in out_chans:
                c.close()
            raise
        for c in out_chans:  # clean stop: cascade closure downstream
            c.close()
        return _unflatten(tree, [x.detach().cpu() for x in leaves])

    def _one_step(self, leaves, fns, in_ch, out_ch, grad_in_ch,
                  grad_out_ch, label_ch):
        """One 1F1B step over M microbatches; returns (mean grads as
        leaves, mean loss or None). ChannelClosed on the FIRST read of the
        step is a clean stop; anywhere else it propagates as an error."""
        from ray_tpu_torch.graph.channels import ChannelClosed

        fwd, bwd, fused = fns
        dev = self._device
        M = self._M
        warmup = min(self._n_stages - 1 - self._index, M)
        stash = collections.deque()
        acc = [None]
        loss_sum = [0.0]
        first = [True]

        def add(g):
            acc[0] = g if acc[0] is None else [a + b
                                               for a, b in zip(acc[0], g)]

        def forward():
            try:
                x = in_ch.read(timeout_s=_LOOP_IO_TIMEOUT_S)
            except ChannelClosed:
                if first[0]:
                    raise _CleanStop from None
                raise
            first[0] = False
            x = _on(x, dev)
            if self._is_last:
                y = _on(label_ch.read(timeout_s=_LOOP_IO_TIMEOUT_S), dev)
                loss, gp, gx = fused(leaves, x, y)
                loss_sum[0] += float(loss)
                add(gp)
                if grad_out_ch is not None:
                    grad_out_ch.write(_wire(gx),
                                      timeout_s=_LOOP_IO_TIMEOUT_S)
            else:
                yv = fwd(leaves, x)
                stash.append(x)
                out_ch.write(_wire(yv), timeout_s=_LOOP_IO_TIMEOUT_S)

        def backward():
            if self._is_last:
                return  # fused into the forward slot
            g = _on(grad_in_ch.read(timeout_s=_LOOP_IO_TIMEOUT_S), dev)
            gp, gx = bwd(leaves, stash.popleft(), g)
            add(gp)
            if grad_out_ch is not None:
                grad_out_ch.write(_wire(gx), timeout_s=_LOOP_IO_TIMEOUT_S)

        for _ in range(warmup):
            forward()
        for _ in range(M - warmup):
            forward()
            backward()
        for _ in range(warmup):
            backward()

        grads = [a / M for a in acc[0]]  # averaged over microbatches
        loss = loss_sum[0] / M if self._is_last else None
        return grads, loss


class PipelineRunner:
    """Driver handle: creates channels + stage actors, starts the exec
    loops, then ``step(xs, ys)`` streams one step's microbatches and
    returns the step metrics. ``finish()`` closes the head channels
    (clean-stop cascade) and returns the final stage params.

    A stage actor killed mid-pipeline surfaces as
    :class:`~ray_tpu_torch.graph.compiled.PipelineStageError` from
    ``step()`` within the caller's deadline — channel waits run in short
    slices with the stage loop refs polled between slices, exactly like
    the compiled DAG's ``execute()``. ``actor_options`` go to every stage
    actor (``{"num_gpus": 0.5}`` puts two stages on one GPU)."""

    def __init__(self, spec: PipelineSpec,
                 actor_options: Optional[dict] = None):
        import cloudpickle

        import ray_tpu_torch
        from ray_tpu_torch.graph.channels import ShmChannel

        self.spec = spec
        S = len(spec.stages)
        R = spec.data_parallel
        tag = uuid.uuid4().hex[:10]
        self._tag = tag
        cap = spec.channel_capacity
        self._channels: List[ShmChannel] = []

        def make(name):
            ch = ShmChannel(f"/rttpp_{tag}_{name}", capacity=cap,
                            num_readers=1)
            ch._handle()  # create the segment before any actor opens it
            self._channels.append(ch)
            return ch

        self._x = [make(f"x{r}") for r in range(R)]
        self._y = [make(f"y{r}") for r in range(R)]
        self._res = [make(f"res{r}") for r in range(R)]
        acts = [[make(f"a{r}_{i}") for i in range(S - 1)] for r in range(R)]
        grads = [[make(f"g{r}_{i}") for i in range(S - 1)] for r in range(R)]

        self._actors = []
        self._loop_refs = []
        remote_cls = ray_tpu_torch.remote(_PipelineStageActor)
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        for r in range(R):
            for i, stage in enumerate(spec.stages):
                blob = cloudpickle.dumps(
                    {"init": stage.init, "apply": stage.apply,
                     "loss": spec.loss if i == S - 1 else None})
                dp_spec = (tag, r, R, spec.zero_sharded_state) \
                    if R > 1 else None
                handle = remote_cls.options(**opts).remote(
                    blob, i, S, spec.num_microbatches, spec.seed,
                    spec.optimizer, spec.learning_rate, dp_spec,
                    spec.device)
                self._actors.append(handle)
                in_ch = self._x[r] if i == 0 else acts[r][i - 1]
                out_ch = acts[r][i] if i < S - 1 else None
                grad_in = grads[r][i] if i < S - 1 else None
                grad_out = grads[r][i - 1] if i > 0 else None
                label = self._y[r] if i == S - 1 else None
                res = self._res[r] if i == S - 1 else None
                self._loop_refs.append(handle.run_pipeline.remote(
                    in_ch, out_ch, grad_in, grad_out, label, res))
        self._step = 0
        self._done = False

    # ----------------------------------------------------- failure watching
    def _check_stage_loops(self):
        if not self._loop_refs:
            return
        import ray_tpu_torch

        done, _ = ray_tpu_torch.wait(self._loop_refs,
                                     num_returns=len(self._loop_refs),
                                     timeout=0)
        for ref in done:
            try:
                ray_tpu_torch.get(ref)
            except Exception as e:  # noqa: BLE001 — actor death/loop error
                raise PipelineStageError(
                    f"pipeline stage exec loop failed: "
                    f"{type(e).__name__}: {e}") from e

    def _watched(self, op, timeout_s: float):
        """Run a channel read/write in short slices, polling the stage
        loop refs between slices; a dead stage raises typed within the
        deadline instead of hanging the channel wait."""
        from ray_tpu_torch.common.retry import Deadline

        deadline = Deadline(timeout_s)
        while True:
            try:
                return op(deadline.remaining(cap=0.2) or 0.0)
            except TimeoutError:
                if deadline.expired():
                    raise
                self._check_stage_loops()

    # ----------------------------------------------------------------- step
    def step(self, xs: Sequence, ys: Sequence,
             timeout_s: float = 120.0) -> dict:
        """Feed one step: ``xs``/``ys`` hold ``num_microbatches *
        data_parallel`` microbatches, numpy arrays or tensors
        (replica-major: replica r gets ``xs[r*M:(r+1)*M]``). Returns
        ``{"step", "loss"}`` with the loss averaged across replicas."""
        if self._done:
            raise RuntimeError("pipeline already finished")
        M = self.spec.num_microbatches
        R = self.spec.data_parallel
        if len(xs) != M * R or len(ys) != M * R:
            raise ValueError(
                f"need {M * R} microbatches (M={M} x R={R}), got "
                f"{len(xs)}/{len(ys)}")
        try:
            for m in range(M):
                for r in range(R):
                    x, y = _wire(xs[r * M + m]), _wire(ys[r * M + m])
                    self._watched(
                        lambda t, c=self._x[r], v=x: c.write(v, timeout_s=t),
                        timeout_s)
                    self._watched(
                        lambda t, c=self._y[r], v=y: c.write(v, timeout_s=t),
                        timeout_s)
            losses = []
            for r in range(R):
                rec = self._watched(
                    lambda t, c=self._res[r]: c.read(timeout_s=t), timeout_s)
                losses.append(rec["loss"])
        except PipelineStageError:
            self.shutdown()
            raise
        self._step += 1
        return {"step": self._step, "loss": float(np.mean(losses))}

    # --------------------------------------------------------------- finish
    def finish(self, timeout_s: float = 120.0) -> List[Any]:
        """Close the head channels (clean-stop cascades tail-ward), join
        the stage loops, and return replica 0's per-stage final params."""
        import ray_tpu_torch

        if self._done:
            raise RuntimeError("pipeline already finished")
        self._done = True
        for ch in self._x + self._y:
            ch.close()
        try:
            all_params = ray_tpu_torch.get(self._loop_refs,
                                           timeout=timeout_s)
        except Exception as e:  # noqa: BLE001 — a stage died during drain
            self.shutdown()
            raise PipelineStageError(
                f"pipeline stage failed during drain: "
                f"{type(e).__name__}: {e}") from e
        S = len(self.spec.stages)
        return list(all_params[:S])  # replica 0 is the first S loop refs

    def shutdown(self):
        """Idempotent teardown: close + unlink channels, kill actors."""
        import ray_tpu_torch

        self._done = True
        for ch in self._channels:
            ch.close()
            ch.unlink()
        self._channels = []
        for handle in self._actors:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._actors = []
        self._loop_refs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
