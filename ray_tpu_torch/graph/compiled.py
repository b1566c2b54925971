"""Compiled DAG execution (reference: ``python/ray/dag/compiled_dag_node.py``
``CompiledDAG:809``).

Compilation freezes the graph: DAG-owned actors are instantiated exactly
once, the schedule is topo-sorted once, and each ``execute()`` replays the
schedule submitting actor tasks with pre-wired argument routing — the
driver does no graph traversal, serialization of the graph, or actor
creation per call.

``experimental_compile(channels=True)`` additionally lowers LINEAR actor
pipelines onto preallocated mutable shm channels (reference
``compiled_dag_node.py:809`` + ``experimental/channel/``): each stage actor
runs a resident exec loop reading its input channel and writing its output
channel — per-item cost is one shm memcpy + condvar wake per hop, with no
per-call RPC, scheduling, or driver involvement. Depth-1 channels give
per-stage buffering, so K in-flight items pipeline across K stages.
"""

from __future__ import annotations

import sys
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.graph.dag import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    _DagInput,
)


def _loop_device():
    """The CUDA device of the calling thread, where this process has
    CUDA up (a stage holding its weights on its GPU), else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device()


def _use_device(device) -> None:
    """Give a helper thread of the exec loop the loop's CUDA device: the
    current device is per thread, and a new thread starts on device 0."""
    if device is not None:
        sys.modules["torch"].cuda.set_device(device)


def _as_collective_operand(value):
    """A stage output as the KV group takes it: a tensor as it is (the
    group stages a CUDA tensor to the host and back to its device), any
    other value as a numpy array."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return value
    import numpy as _np

    return _np.asarray(value)


class _PipelineStage:
    """Resident stage harness: holds the user instance, runs the channel
    exec loop (reference ``do_exec_tasks:191`` worker loop)."""

    def __init__(self, cls_blob: bytes, /, *init_args, **init_kwargs):
        # the user's arguments ride at the top level of the creation
        # call, so an ObjectRef among them resolves as it would for the
        # user's class created on its own
        import cloudpickle

        cls = cloudpickle.loads(cls_blob)
        self._inner = cls(*init_args, **init_kwargs)

    def run_loop(self, method: str, in_ch, out_ch) -> bool:
        """Linear-pipeline loop (single input channel)."""
        return self.run_graph_loop(method, [("ch", in_ch)], out_ch, None)

    def run_graph_loop(self, method: str, in_specs, out_ch,
                       collective_spec) -> bool:
        """General exec loop: reads one value per iteration from each
        distinct input channel (fan-in), calls the method, optionally
        allreduces the result across the DAG's collective group
        (reference ``collective_node.py`` lowering), writes the output.

        Transfer/compute overlap (reference ``ExecutableTask.prepare:579``
        overlapped comm; gated by config ``pipeline_overlap``): input reads
        run on a PREFETCH thread one item ahead of compute, and outputs are
        WRITTEN BEHIND on a writer thread — while the method runs on item
        i, item i+1's channel reads (deserialize + memcpy) and item i-1's
        write (serialize + memcpy + downstream wait) proceed concurrently,
        so per-item cost approaches max(compute, read, write) instead of
        their sum. Both threads run on the loop's CUDA device, where the
        stage has one: a device channel places what it reads there, and
        the writer stages from there.

        ``in_specs``: ordered arg slots — ("ch", channel) | ("const", v)
        | ("ch-field", channel, key): read the channel's value once per
        iteration, then pick a field (multi-arg DAG input — the channel
        carries a ``_DagInput``; int keys index args, str keys kwargs).
        ``collective_spec``: None | (group_name, rank, world, op).
        """
        import queue as _q
        import threading as _threading

        from ray_tpu_torch.common.config import GLOBAL_CONFIG
        from ray_tpu_torch.graph.channels import ChannelClosed

        overlap = GLOBAL_CONFIG.get("pipeline_overlap")
        device = _loop_device()

        fn = getattr(self._inner, method)
        if collective_spec is not None:
            group_name, rank, world, coll_op = collective_spec
            from ray_tpu_torch import collective as _coll

            # all stage loops start concurrently → rendezvous completes
            _coll.init_collective_group(world, rank, backend="kv",
                                        group_name=group_name)
        # distinct channels: a channel feeding two arg slots is read ONCE
        # per iteration (one version = one logical value)
        distinct = []
        for spec_item in in_specs:
            if spec_item[0] in ("ch", "ch-field"):
                v = spec_item[1]
                if all(v is not c for c in distinct):
                    distinct.append(v)

        def materialize(by_ch):
            out = []
            for spec_item in in_specs:
                kind, v = spec_item[0], spec_item[1]
                if kind == "const":
                    out.append(v)
                    continue
                val = by_ch[id(v)]
                if kind == "ch-field" and not isinstance(val, _StageError):
                    key = spec_item[2]
                    try:
                        if isinstance(val, _DagInput):
                            val = val.pick(key)
                        elif isinstance(key, int):
                            val = val[key]
                        else:
                            val = getattr(val, key)
                    except Exception as e:  # noqa: BLE001 — bad arity /
                        # missing kwarg: propagate as the item's error
                        # instead of killing the loop (which would strand
                        # the writer and wedge the driver's get())
                        import traceback as _tb

                        val = _StageError(repr(e), _tb.format_exc())
                out.append(val)
            return out

        _END = object()

        def read_inputs():
            return {id(ch): ch.read(timeout_s=3600.0) for ch in distinct}

        reader_exc: List[BaseException] = []
        if overlap:
            prefetch_q: "_q.Queue" = _q.Queue(maxsize=1)  # one item ahead

            def prefetch():
                _use_device(device)
                while True:
                    try:
                        item = read_inputs()
                    except (ChannelClosed, TimeoutError):
                        prefetch_q.put(_END)
                        return
                    except BaseException as e:  # noqa: BLE001 — e.g. an
                        # injected transport fault: end the loop AND carry
                        # the error out (a silently dead prefetch thread
                        # would wedge the compute loop on get() forever)
                        reader_exc.append(e)
                        prefetch_q.put(_END)
                        return
                    prefetch_q.put(item)

            _threading.Thread(target=prefetch, daemon=True,
                              name="stage-prefetch").start()

            def next_inputs():
                return prefetch_q.get()
        else:
            def next_inputs():
                try:
                    return read_inputs()
                except (ChannelClosed, TimeoutError):
                    return _END

        # Write-behind: one item of output buffering so the downstream wait
        # overlaps the next compute. On ANY write failure the writer keeps
        # draining the queue until _END so the compute loop can never wedge
        # against a dead reader mid-put; a non-close failure is re-raised
        # from the loop so the loop ref still fails loudly (same surface
        # as the sequential path).
        downstream_closed = _threading.Event()
        writer = None
        writer_exc: List[BaseException] = []
        if overlap and out_ch is not None:
            write_q: "_q.Queue" = _q.Queue(maxsize=1)

            def write_behind():
                _use_device(device)
                while True:
                    item = write_q.get()
                    if item is _END:
                        return
                    try:
                        # long timeout to match the 3600s read side — a
                        # slow (not dead) downstream must not kill the pipe
                        out_ch.write(item, timeout_s=3600.0)
                    except BaseException as e:  # noqa: BLE001
                        if not isinstance(e, ChannelClosed):
                            writer_exc.append(e)
                        downstream_closed.set()
                        while write_q.get() is not _END:
                            pass
                        return

            writer = _threading.Thread(target=write_behind, daemon=True,
                                       name="stage-writer")
            writer.start()

            def emit(value) -> bool:
                if downstream_closed.is_set():
                    return False
                write_q.put(value)
                return True
        else:
            def emit(value) -> bool:
                try:
                    out_ch.write(value)
                except ChannelClosed:
                    return False
                return True

        loop_exc: List[BaseException] = []
        try:
            while True:
                by_ch = next_inputs()
                if by_ch is _END:
                    break
                args = materialize(by_ch)
                err = next((a for a in args if isinstance(a, _StageError)),
                           None)
                if err is not None:
                    # propagate an upstream failure to the driver
                    if out_ch is not None and not emit(err):
                        break
                    continue
                try:
                    result = fn(*args)
                    if collective_spec is not None:
                        reduced = _coll.allreduce(
                            _as_collective_operand(result),
                            group_name=group_name)
                        if coll_op == "mean":
                            reduced = reduced / world
                        result = reduced
                except Exception as e:  # noqa: BLE001 — user stage error
                    import traceback as _tb

                    result = _StageError(repr(e), _tb.format_exc())
                # out_ch is None for a collective rank whose reduced output
                # has no consumer: it still computes + allreduces every item
                # (the group needs all ranks), then discards the result.
                if out_ch is None:
                    continue
                if not emit(result):
                    break
        except BaseException as e:  # noqa: BLE001 — transport failure
            # (e.g. an injected channel fault escaping next_inputs/emit):
            # the loop must still CLOSE its output so downstream stages see
            # ChannelClosed and cascade-exit instead of blocking a full
            # read timeout against a writer that will never come back
            loop_exc.append(e)
        if loop_exc and out_ch is not None:
            # close FIRST on the failure path: a writer thread stuck in a
            # long write against live-but-slow downstream must be woken
            # (close raises ChannelClosed in it) before we join it
            try:
                out_ch.close()
            except Exception:  # noqa: BLE001
                pass
        if writer is not None:
            write_q.put(_END)
            # unbounded join: the writer is itself bounded by its 3600s
            # write timeout, and closing out_ch under an in-flight write
            # would drop the final item / swallow a late writer exception
            writer.join()
        try:
            if out_ch is not None:
                out_ch.close()
        except Exception:  # noqa: BLE001
            pass
        if loop_exc:
            raise loop_exc[0]
        if reader_exc:
            raise reader_exc[0]
        if writer_exc:
            raise writer_exc[0]
        return True

    def call(self, method: str, *args, **kwargs):
        return getattr(self._inner, method)(*args, **kwargs)


class _StageError:
    """Marker shuttled through the channels when a stage raises: the error
    reaches the driver as the item's result instead of wedging the pipe."""

    def __init__(self, err: str, tb: str):
        self.err = err
        self.tb = tb


class PipelineStageError(RuntimeError):
    pass


class _ChannelResult:
    """FIFO result handle for a channel-compiled execute()."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout_s: float = 120.0):
        value = self._dag._read_result(self._seq, timeout_s)
        if isinstance(value, _StageError):
            raise PipelineStageError(
                f"pipeline stage raised {value.err}\n--- remote ---\n"
                f"{value.tb}")
        return value


class CompiledDAG:
    def __init__(self, root: DAGNode, max_inflight: int = 64,
                 channels: bool = False, channel_capacity: int = 4 << 20,
                 channel_kind: str = "shm"):
        self._root = root
        self._schedule = root._topo()
        self._max_inflight = max_inflight
        self._inflight: List[Any] = []
        self._owned_actors = []
        self._actors: Dict[int, Any] = {}
        self._channels = None
        self._loop_refs: List[Any] = []
        self._write_seq = 0
        self._read_seq = 0
        self._result_buf: Dict[int, Any] = {}
        if channel_kind not in ("shm", "device"):
            raise ValueError(f"unknown channel_kind {channel_kind!r}")
        self._channel_kind = channel_kind
        if channels:
            self._compile_channel_pipeline(channel_capacity)
        else:
            self._validate()
            self._instantiate_actors()

    # --------------------------------------------------- channel pipeline
    def _compile_channel_pipeline(self, capacity: int):
        """Lower the DAG onto preallocated shm channels.

        General (non-linear) lowering: one channel per producer node
        (InputNode / stage output) with ``num_readers`` = number of distinct
        consumer processes — the native channel's broadcast semantics give
        fan-out for free; fan-in stages read one value per input channel
        per iteration. ``CollectiveOutputNode`` groups lower to an
        allreduce INSIDE each participating stage (reference
        ``collective_node.py:23``), so reduced tensors flow downstream
        without driver involvement.
        """
        import cloudpickle

        import ray_tpu_torch
        from ray_tpu_torch.graph.channels import DeviceBufferChannel, ShmChannel
        from ray_tpu_torch.graph.collective_node import CollectiveOutputNode

        ch_cls = (DeviceBufferChannel if self._channel_kind == "device"
                  else ShmChannel)

        input_node: Optional[InputNode] = None
        stage_nodes: List[ClassMethodNode] = []
        attr_nodes: List[InputAttributeNode] = []
        for node in self._schedule:
            if isinstance(node, InputNode):
                if input_node is not None:
                    raise ValueError("a DAG must have exactly one InputNode")
                input_node = node
            elif isinstance(node, ClassMethodNode):
                if not node._parent_is_node:
                    raise ValueError(
                        "channels=True requires DAG-owned actors "
                        "(ClassNode.bind), not live handles")
                if node._bound_kwargs:
                    raise ValueError(
                        "channel stages take positional args only")
                stage_nodes.append(node)
            elif isinstance(node, InputAttributeNode):
                # multi-arg DAG: the input channel carries the whole
                # _DagInput; stages bound to inp[i]/inp.x pick the field
                # at read time ("ch-field" arg slots)
                attr_nodes.append(node)
            elif not isinstance(node, (ClassNode, MultiOutputNode,
                                       CollectiveOutputNode)):
                raise TypeError(
                    f"cannot channel-compile {type(node).__name__}")
        if input_node is None or not stage_nodes:
            raise ValueError(
                "channels=True requires an InputNode feeding actor stages")
        self._multi_arg_input = bool(attr_nodes)
        if self._multi_arg_input and any(
                arg is input_node
                for stage in stage_nodes for arg in stage._data_args()):
            # the input channel carries the _DagInput wrapper in multi-arg
            # mode; a stage bound to the BARE InputNode would receive the
            # wrapper (diverging from eager execution) — reject loudly
            raise ValueError(
                "cannot mix bare InputNode args with inp[i]/inp.key "
                "fields in a channel DAG: bind a field for every "
                "input-consuming stage")

        # collective groups: every branch input must be a distinct stage
        coll_specs: Dict[int, tuple] = {}  # id(stage node) -> spec
        coll_ops = {}
        for node in self._schedule:
            if not isinstance(node, CollectiveOutputNode):
                continue
            op = node._op
            if id(op) in coll_ops:
                continue
            coll_ops[id(op)] = op
            # register EVERY branch of the op: a rank whose reduced output
            # is unconsumed is unreachable from the root, but the group
            # still needs it participating in every allreduce
            for rank, src in enumerate(op.inputs):
                if not isinstance(src, ClassMethodNode):
                    raise ValueError(
                        "collective inputs must be actor-method nodes")
                coll_specs[id(src)] = (op.group_name, rank,
                                       op.world_size, op.op)

        def producer_of(node):
            """The node whose output channel carries ``node``'s value."""
            if isinstance(node, CollectiveOutputNode):
                return node._op.inputs[node._index]
            if isinstance(node, InputAttributeNode):
                return input_node  # field of the shared input channel
            return node

        # outputs (driver-read channels), in declared order
        root = self._root
        out_nodes = (list(root._bound_args)
                     if isinstance(root, MultiOutputNode) else [root])
        self._multi_output = isinstance(root, MultiOutputNode)
        if any(isinstance(n, (InputNode, InputAttributeNode))
               for n in out_nodes):
            raise ValueError(
                "a channel DAG output must be a stage output, not the "
                "input (or one of its fields)")
        out_producers = [producer_of(n) for n in out_nodes]

        # consumer census per producer: distinct stages + the driver
        consumers: Dict[int, set] = {}
        for stage in stage_nodes:
            for arg in stage._data_args():
                if isinstance(arg, DAGNode):
                    p = producer_of(arg)
                    consumers.setdefault(id(p), set()).add(id(stage))
        for p in out_producers:
            consumers.setdefault(id(p), set()).add("driver")

        # a collective stage's pre-reduce value must not ALSO be consumed
        # directly (its channel carries only the reduced value)
        for node in self._schedule:
            if isinstance(node, ClassMethodNode) and id(node) in coll_specs:
                direct = [
                    s for s in stage_nodes
                    if any(a is node for a in s._data_args()
                           if isinstance(a, DAGNode))
                ]
                if direct or any(o is node for o in out_nodes):
                    raise ValueError(
                        "a stage feeding a collective cannot also be "
                        "consumed directly (the reduced value replaces "
                        "its output)")

        tag = uuid.uuid4().hex[:12]
        chan_by_producer: Dict[int, ShmChannel] = {}
        all_channels: List[ShmChannel] = []
        for i, node in enumerate([input_node] + stage_nodes):
            n_readers = len(consumers.get(id(node), set()))
            if n_readers == 0:
                if node is input_node:
                    raise ValueError("no stage consumes the DAG input")
                continue  # dead stage output: skip the channel
            ch = ch_cls(f"/rttch_{tag}_{i}", capacity=capacity,
                        num_readers=n_readers)
            ch._handle()  # create segments before actors open them
            chan_by_producer[id(node)] = ch
            all_channels.append(ch)
        self._in_channel = chan_by_producer[id(input_node)]
        self._out_channels = []
        for p in out_producers:
            if id(p) not in chan_by_producer:
                raise ValueError(
                    "DAG output must be a stage output or collective result")
            self._out_channels.append(chan_by_producer[id(p)])
        self._channels = all_channels

        remote_stage = ray_tpu_torch.remote(_PipelineStage)
        for stage in stage_nodes:
            class_node = stage._parent
            opts = dict(class_node._options or {})
            opts.setdefault("num_cpus", 0)
            handle = remote_stage.options(**opts).remote(
                cloudpickle.dumps(class_node._actor_class._cls),
                *class_node._bound_args, **class_node._bound_kwargs)
            self._owned_actors.append(handle)
            in_specs = []
            for arg in stage._data_args():
                if isinstance(arg, InputAttributeNode):
                    in_specs.append(
                        ("ch-field", chan_by_producer[id(input_node)],
                         arg._key))
                elif isinstance(arg, DAGNode):
                    in_specs.append(
                        ("ch", chan_by_producer[id(producer_of(arg))]))
                else:
                    in_specs.append(("const", arg))
            out_ch = chan_by_producer.get(id(stage))
            if out_ch is None and id(stage) not in coll_specs:
                continue  # output never consumed: don't run the loop
            # (a collective rank ALWAYS runs — the group needs every rank
            # even when its reduced output has no consumer)
            self._loop_refs.append(handle.run_graph_loop.remote(
                stage._method, in_specs, out_ch,
                coll_specs.get(id(stage))))

    def _read_result(self, seq: int, timeout_s: float):
        if seq in self._result_buf:
            return self._result_buf.pop(seq)
        while self._read_seq <= seq:
            value = self._read_one_output(timeout_s)
            got = self._read_seq
            self._read_seq += 1
            if got == seq:
                return value
            self._result_buf[got] = value
        raise RuntimeError(f"result {seq} already consumed")

    def _check_stage_loops(self):
        """Surface a failed stage exec loop as a typed error.

        A SIGKILLed stage actor can never close its channels, so a blocked
        driver read would otherwise ride out its full timeout; the loop
        refs DO fail promptly (worker-death plumbing), so the sliced reads
        poll them between slices and convert the failure into
        :class:`PipelineStageError` within the caller's deadline."""
        if not self._loop_refs:
            return
        import ray_tpu_torch

        done, _ = ray_tpu_torch.wait(self._loop_refs,
                               num_returns=len(self._loop_refs), timeout=0)
        for ref in done:
            try:
                ray_tpu_torch.get(ref)
            except Exception as e:  # noqa: BLE001 — actor death/loop error
                raise PipelineStageError(
                    f"pipeline stage exec loop failed: "
                    f"{type(e).__name__}: {e}") from e

    def _watched_read(self, ch, timeout_s: float):
        """Channel read in short slices, checking the stage loops between
        slices — a dead stage surfaces typed instead of hanging the read."""
        from ray_tpu_torch.common.retry import Deadline

        deadline = Deadline(timeout_s)
        while True:
            try:
                return ch.read(timeout_s=deadline.remaining(cap=0.2) or 0.0)
            except TimeoutError:
                if deadline.expired():
                    raise
                self._check_stage_loops()

    def _read_one_output(self, timeout_s: float):
        """One aligned read across every output channel; a single-output
        DAG returns the bare value, MultiOutputNode returns the list.

        Only the FIRST channel is read at ``timeout_s``: once it has item k,
        every sibling channel will produce item k too (aligned FIFO), so
        the remaining reads use a generous timeout — a 0-timeout probe on
        the first channel can then never strand a partial read."""
        values = [self._watched_read(self._out_channels[0], timeout_s)]
        values += [self._watched_read(ch, max(timeout_s, 60.0))
                   for ch in self._out_channels[1:]]
        err = next((v for v in values if isinstance(v, _StageError)), None)
        if err is not None:
            return err
        if not self._multi_output:
            return values[0]
        return values

    def _validate(self):
        from ray_tpu_torch.graph.collective_node import CollectiveOutputNode

        n_inputs = sum(isinstance(n, InputNode) for n in self._schedule)
        if n_inputs > 1:
            raise ValueError("a DAG must have exactly one InputNode")
        for node in self._schedule:
            if isinstance(node, (InputNode, InputAttributeNode, ClassNode,
                                 ClassMethodNode, FunctionNode,
                                 MultiOutputNode, CollectiveOutputNode)):
                continue
            raise TypeError(f"cannot compile node type {type(node).__name__}")

    def _instantiate_actors(self):
        resolved: Dict[int, Any] = {}
        for node in self._schedule:
            if isinstance(node, ClassNode):
                handle = node._instantiate(resolved)
                resolved[id(node)] = handle
                self._actors[id(node)] = handle
                self._owned_actors.append(handle)

    def execute(self, *args, **kwargs):
        """Submit one invocation; returns ObjectRef (or list for
        MultiOutputNode), or a _ChannelResult on a channel pipeline.
        Backpressure: caps driver-side inflight refs (RPC mode) / the
        depth-1 stage channels themselves (channel mode)."""
        if self._channels is not None:
            if getattr(self, "_multi_arg_input", False):
                payload = _DagInput(args, kwargs)
            elif kwargs or len(args) != 1:
                raise TypeError(
                    "channel pipelines take exactly one positional input "
                    "(bind inp[i]/inp.key for multi-arg DAGs)")
            else:
                payload = args[0]
            # Depth-1 stage channels bound the in-flight items to ~#stages.
            # When full, drain completed outputs into the result buffer so
            # a burst of execute() calls never deadlocks against its own
            # unread results (reference: max_buffered_results).
            deadline = time.monotonic() + 120.0
            while True:
                # drain ready outputs first: keeps the cascade moving and
                # the subsequent write wait on the fast (condvar) path
                try:
                    while True:
                        value = self._read_one_output(timeout_s=0.0)
                        self._result_buf[self._read_seq] = value
                        self._read_seq += 1
                except TimeoutError:
                    pass
                try:
                    self._in_channel.write(payload, timeout_s=0.02)
                    break
                except TimeoutError:
                    # a dead stage can never drain the pipe: surface it
                    # typed instead of spinning out the full deadline
                    self._check_stage_loops()
                    if time.monotonic() > deadline:
                        raise
            seq = self._write_seq
            self._write_seq += 1
            return _ChannelResult(self, seq)
        if len(self._inflight) >= self._max_inflight:
            import ray_tpu_torch

            head = self._inflight.pop(0)
            ray_tpu_torch.wait(head if isinstance(head, list) else [head],
                         num_returns=1, timeout=None)
        resolved: Dict[int, Any] = dict(self._actors)
        for node in self._schedule:
            if isinstance(node, ClassNode):
                continue  # already resolved to its live handle
            resolved[id(node)] = node._apply(resolved, args, kwargs)
        out = resolved[id(self._root)]
        self._inflight.append(out)
        return out

    def teardown(self):
        import ray_tpu_torch

        if self._channels is not None:
            for ch in self._channels:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001
                    pass
        for handle in self._owned_actors:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass
        if self._channels is not None:
            for ch in self._channels:
                ch.unlink()
            self._channels = None
        self._owned_actors = []
        self._actors = {}
