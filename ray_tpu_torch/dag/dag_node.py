"""DAG authoring — the ``.bind()`` API.

The port's copy of ``ray_tpu/dag/dag_node.py``: ``InputNode`` is the
placeholder for per-call input; ``actor.method.bind(*upstreams)`` builds a
``ClassMethodNode``. Graphs are general DAGs: a method may take several
upstream nodes (fan-in) plus baked constants, one node's output may feed
several consumers (fan-out), and ``MultiOutputNode([a, b])`` gathers
multiple leaves into one per-tick result tuple — the serve
preprocess→shard→merge and pipeline shapes all compile.
"""

from __future__ import annotations

from typing import Any, List


class DAGNode:
    def __init__(self, upstreams: List["DAGNode"]):
        self.upstreams: List[DAGNode] = list(upstreams)

    def collect(self) -> List["DAGNode"]:
        """All reachable nodes, dependencies first (stable topo order)."""
        order: List[DAGNode] = []
        seen = set()

        def rec(node: "DAGNode"):
            if id(node) in seen:
                return
            seen.add(id(node))
            for up in node.upstreams:
                rec(up)
            order.append(node)

        rec(self)
        return order

    def chain(self) -> List["DAGNode"]:
        """Nodes from InputNode to self for LINEAR graphs (legacy helper;
        general graphs use :meth:`collect`)."""
        nodes: List[DAGNode] = []
        node = self
        while node is not None:
            nodes.append(node)
            if len(node.upstreams) > 1:
                raise ValueError("chain() only walks linear DAGs")
            node = node.upstreams[0] if node.upstreams else None
        return list(reversed(nodes))

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """Per-execute input placeholder (``with InputNode() as inp:`` or plain
    construction)."""

    def __init__(self):
        super().__init__([])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DAGNode):
    """``actor.method.bind(*args)``: each arg is an upstream DAGNode (one
    channel-fed value per tick) or a constant baked into every call."""

    def __init__(self, actor_handle, method_name: str, *bind_args: Any):
        self.bind_args = list(bind_args)
        super().__init__([a for a in bind_args if isinstance(a, DAGNode)])
        if not self.upstreams:
            raise TypeError(
                "bind() needs at least one InputNode or DAG node argument")
        self.actor = actor_handle
        self.method_name = method_name

    def __repr__(self):
        return f"ClassMethodNode({self.method_name})"


class MultiOutputNode(DAGNode):
    """Terminal gather node: ``execute`` results arrive as a tuple with one
    element per listed leaf."""

    def __init__(self, outputs: List[DAGNode]):
        outputs = list(outputs)
        if not outputs:
            raise ValueError("MultiOutputNode needs at least one output")
        if len({id(o) for o in outputs}) != len(outputs):
            raise ValueError("MultiOutputNode outputs must be distinct nodes")
        for o in outputs:
            if not isinstance(o, ClassMethodNode):
                raise TypeError(
                    "MultiOutputNode outputs must be bound actor methods")
        super().__init__(outputs)

    def __repr__(self):
        return f"MultiOutputNode({len(self.upstreams)})"
