"""Diagnostic trace: the reference's block→pass→candidate JSON tree.

Mirrors the ASTCENC_DIAGNOSTICS trace (reference:
astcenc_diagnostic_trace.h:17-115, astcenc_diagnostic_trace.cpp) so the
parity-debugging workflow — diff our trace against a diagnostics build of
the reference encoder — works node-for-node (tools/trace_diff.py).

The emitted file uses the reference's exact on-disk shape: nested
``["node", <name>, [children...]]`` arrays whose leaves are
``[key, value]`` attribute pairs. The batched encoder captures whole
record tensors per pass and the collector fans them out per block.

The port's own copy of ``astcenc_tpu/codec/trace.py``. The port's driver
compacts the unfinished blocks of each stage, so its hooks
(``codec/compress.py``) hand the collector each row's block index.
"""

from __future__ import annotations

import json


class TraceNode:
    __slots__ = ("name", "items")

    def __init__(self, name: str):
        self.name = name
        self.items = []

    def add(self, key, value):
        if isinstance(value, float):
            # The reference prints floats with %g via vsnprintf
            value = float(f"{value:g}")
        self.items.append([key, value])

    def child(self, name: str) -> "TraceNode":
        c = TraceNode(name)
        self.items.append(c)
        return c

    def to_json(self):
        return ["node", self.name,
                [i.to_json() if isinstance(i, TraceNode) else i
                 for i in self.items]]


class Tracer:
    """Collects one block-node per compressed block.

    The compress driver calls the per-stage hooks with numpy-ified record
    tensors; this class slices them per block into the tree.
    """

    def __init__(self):
        self.root = TraceNode("root")
        self.blocks = {}
        self.positions = {}     # block idx -> (x, y, z) texel coords

    def block(self, idx: int, pos=(0, 0, 0)) -> TraceNode:
        b = self.blocks.get(idx)
        if b is None:
            b = self.root.child("block")
            b.add("pos_x", int(pos[0]))
            b.add("pos_y", int(pos[1]))
            b.add("pos_z", int(pos[2]))
            self.blocks[idx] = b
        return b

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.root.to_json(), f, indent=1)


def parse_trace(path: str):
    """Load a trace file (ours or the reference's) into (name, attrs,
    children) tuples. The reference's writer emits the same nested-array
    shape but is not strictly valid JSON in corner cases (unescaped
    strings); json.load handles every file the encoders actually emit."""
    with open(path) as f:
        data = json.load(f)

    def conv(node):
        assert node[0] == "node", node[:2]
        name = node[1]
        attrs = {}
        children = []
        for item in node[2]:
            if isinstance(item, list) and len(item) == 3 \
                    and item[0] == "node":
                children.append(conv(item))
            else:
                k, v = item[0], item[1]
                if k in attrs:
                    # repeated keys (per-round errors): keep a list
                    prev = attrs[k]
                    attrs[k] = (prev if isinstance(prev, list)
                                else [prev]) + [v]
                else:
                    attrs[k] = v
        return (name, attrs, children)

    return conv(data)
