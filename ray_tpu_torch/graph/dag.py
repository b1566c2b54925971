"""DAG node types (reference: ``python/ray/dag/dag_node.py``, ``class_node.py``,
``function_node.py``, ``input_node.py``, ``output_node.py``).

Nodes are immutable descriptions; ``execute()`` walks the graph submitting
real tasks/actor calls with ObjectRefs wired between them. Compilation
(``experimental_compile``) lives in :mod:`ray_tpu_torch.graph.compiled`.
"""

from __future__ import annotations


from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: a node producing one logical output."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # ---------------------------------------------------------- traversal
    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def _resolve_args(self, resolved: Dict[int, Any]):
        args = tuple(resolved[id(a)] if isinstance(a, DAGNode) else a
                     for a in self._bound_args)
        kwargs = {k: resolved[id(v)] if isinstance(v, DAGNode) else v
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _topo(self) -> List["DAGNode"]:
        order: List[DAGNode] = []
        seen = set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in n._children():
                visit(c)
            order.append(n)

        visit(self)
        return order

    # ---------------------------------------------------------- execution
    def execute(self, *input_args, **input_kwargs):
        """Eager execution: one driver-side walk, returns ObjectRef(s)."""
        resolved: Dict[int, Any] = {}
        for node in self._topo():
            resolved[id(node)] = node._apply(resolved, input_args,
                                             input_kwargs)
        return resolved[id(self)]

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.graph.compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def _apply(self, resolved, input_args, input_kwargs):
        raise NotImplementedError


class InputNode(DAGNode):
    """The DAG's input placeholder (reference ``input_node.py``); supports
    ``with InputNode() as inp`` and attribute/index access for multi-arg
    DAGs (``inp.x``, ``inp[0]``)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def __getitem__(self, key):
        return InputAttributeNode(self, key)

    def _apply(self, resolved, input_args, input_kwargs):
        if input_kwargs or len(input_args) != 1:
            # multi-arg DAG: downstream InputAttributeNodes pick fields
            return _DagInput(input_args, input_kwargs)
        return input_args[0]


class _DagInput:
    def __init__(self, args, kwargs):
        self.args = args
        self.kwargs = kwargs

    def pick(self, key):
        if isinstance(key, int):
            return self.args[key]
        return self.kwargs[key]


class InputAttributeNode(DAGNode):
    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _apply(self, resolved, input_args, input_kwargs):
        src = resolved[id(self._bound_args[0])]
        if isinstance(src, _DagInput):
            return src.pick(self._key)
        if isinstance(self._key, int):
            return src[self._key]
        return getattr(src, self._key)


class FunctionNode(DAGNode):
    """A bound remote-function invocation."""

    def __init__(self, remote_fn, args, kwargs, options):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = dict(options or {})

    def _apply(self, resolved, input_args, input_kwargs):
        args, kwargs = self._resolve_args(resolved)
        return self._remote_fn._invoke(args, kwargs, self._options)


class ClassNode(DAGNode):
    """A bound actor construction; instantiated per execute() in eager
    mode, once in compiled mode."""

    def __init__(self, actor_class, args, kwargs, options):
        super().__init__(args, kwargs)
        self._actor_class = actor_class
        self._options = dict(options or {})

    def _instantiate(self, resolved):
        args, kwargs = self._resolve_args(resolved)
        return self._actor_class._create(args, kwargs, self._options)

    def _apply(self, resolved, input_args, input_kwargs):
        return self._instantiate(resolved)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodStub(self, name)


class _ClassMethodStub:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor-method invocation (the workhorse of actor pipelines)."""

    def __init__(self, parent, method: str, args, kwargs):
        # parent: ClassNode (DAG-owned actor) or a live ActorHandle.
        from ray_tpu_torch.core_worker.actor import ActorHandle

        self._parent = parent
        self._method = method
        if isinstance(parent, ClassNode):
            super().__init__((parent,) + tuple(args), kwargs)
            self._parent_is_node = True
        else:
            assert isinstance(parent, ActorHandle), parent
            super().__init__(tuple(args), kwargs)
            self._parent_is_node = False

    def _actor_handle(self, resolved):
        if self._parent_is_node:
            return resolved[id(self._parent)]
        return self._parent

    def _data_args(self):
        """Bound args excluding the parent ClassNode sentinel."""
        if self._parent_is_node:
            return self._bound_args[1:]
        return self._bound_args

    def _apply(self, resolved, input_args, input_kwargs):
        handle = self._actor_handle(resolved)
        args = tuple(resolved[id(a)] if isinstance(a, DAGNode) else a
                     for a in self._data_args())
        kwargs = {k: resolved[id(v)] if isinstance(v, DAGNode) else v
                  for k, v in self._bound_kwargs.items()}
        return getattr(handle, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal node returning a list of outputs
    (reference ``output_node.py``)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _apply(self, resolved, input_args, input_kwargs):
        return [resolved[id(a)] if isinstance(a, DAGNode) else a
                for a in self._bound_args]
