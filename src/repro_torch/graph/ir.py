"""LayerGraph IR: the typed, model-agnostic network description the planner,
executor and serving engine consume (counterpart of `repro.graph.ir`).

A `LayerGraph` is a linear sequence of typed nodes (`ConvSpec`, `ReLU`,
`PoolSpec`, `Flatten`, `DenseSpec`) plus an input shape. Which impl runs each
conv, and whether a conv+ReLU+pool triple fuses into PECR, is decided by the
op registry and the planner, never by the graph.

Shape inference is static Python, and `units()` groups the nodes into
plannable conv units: one conv, its trailing ReLU if adjacent, and its
trailing pool if adjacent — the structural precondition of the PECR fusion
rule (`repro_torch.graph.registry.fusion_eligible`).

Only `init_graph` differs from the reference: it draws from a
`torch.Generator`, so it cannot reproduce `jax.random` bits. Tests that
compare the two packages make the weights on one side and carry them across
(`repro_torch.convert.params_from_jax`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Node types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvSpec:
    """2-D convolution node: `c_out` filters of k x k at `stride`, with
    `pad` pixels of explicit zero padding on each spatial edge."""

    c_out: int
    k: int = 3
    stride: int = 1
    pad: int = 1


@dataclass(frozen=True)
class ReLU:
    """Element-wise max(x, 0)."""


@dataclass(frozen=True)
class PoolSpec:
    """p x p max-pool at `stride` (0 = p, the non-overlapping default).

    `mode` governs what happens when the windows do not tile the map exactly:
      - "valid" (default): require exact coverage; shape inference raises.
      - "floor": drop the tail explicitly.
      - "ceil": keep a partial tail window (padded with -inf).
    """

    p: int = 2
    stride: int = 0  # 0 == p
    mode: str = "valid"  # valid | floor | ceil

    @property
    def s(self) -> int:
        return self.stride or self.p


@dataclass(frozen=True)
class Flatten:
    """(C, H, W) -> (C*H*W,) — the conv-stack / classifier seam."""


@dataclass(frozen=True)
class DenseSpec:
    """Fully-connected layer to `d_out` features, optional fused ReLU."""

    d_out: int
    relu: bool = False


# ---------------------------------------------------------------------------
# Shape inference
# ---------------------------------------------------------------------------


def conv_out_hw(h: int, w: int, conv: ConvSpec) -> tuple:
    oh = (h + 2 * conv.pad - conv.k) // conv.stride + 1
    ow = (w + 2 * conv.pad - conv.k) // conv.stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"conv {conv} produces empty output from ({h}, {w})")
    return oh, ow


def pool_out_len(n: int, pool: PoolSpec) -> int:
    """Pooled length of one spatial dim; raises on an unintended tail."""
    if n < pool.p:
        raise ValueError(f"pool window p={pool.p} larger than input dim {n}")
    tail = (n - pool.p) % pool.s
    if pool.mode == "valid":
        if tail:
            raise ValueError(
                f"pool p={pool.p} stride={pool.s} would silently drop a "
                f"{tail}-wide tail of a {n}-wide map; use mode='floor' to "
                f"truncate or mode='ceil' to keep a partial window")
        return (n - pool.p) // pool.s + 1
    if pool.mode == "floor":
        return (n - pool.p) // pool.s + 1
    if pool.mode == "ceil":
        out = -(-(n - pool.p) // pool.s) + 1
        # the last window must START inside the input (the cuDNN/PyTorch
        # ceil_mode rule): a window lying wholly in the padding would pool
        # nothing but -inf
        if (out - 1) * pool.s >= n:
            out -= 1
        return out
    raise ValueError(f"unknown pool mode {pool.mode!r}")


def pool_out_hw(h: int, w: int, pool: PoolSpec) -> tuple:
    return pool_out_len(h, pool), pool_out_len(w, pool)


# ---------------------------------------------------------------------------
# Conv units (the planner's granularity)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvUnit:
    """One plannable unit: a conv, its adjacent ReLU, its adjacent pool.
    `stage` counts the pools crossed so far, `slot` the conv within the
    stage (the classic VGG indexing)."""

    index: int
    stage: int
    slot: int
    conv: ConvSpec
    relu: bool
    pool: PoolSpec | None
    in_shape: tuple  # (C, H, W) entering the conv (pre-padding)
    out_shape: tuple  # (C, H, W) leaving the unit (post-pool if any)

    @property
    def conv_out_shape(self) -> tuple:
        """(C, H, W) after the conv itself (pre-pool)."""
        oh, ow = conv_out_hw(self.in_shape[1], self.in_shape[2], self.conv)
        return (self.conv.c_out, oh, ow)


@dataclass(frozen=True)
class LayerGraph:
    """A linear CNN: conv/ReLU/pool body, then Flatten, then dense head."""

    name: str
    in_shape: tuple  # (C, H, W)
    nodes: tuple  # tuple of ConvSpec | ReLU | PoolSpec | Flatten | DenseSpec

    def units(self) -> tuple:
        """Group body nodes into `ConvUnit`s (validates the topology)."""
        return self._parse()[0]

    def head(self) -> tuple:
        """The dense head: tuple[DenseSpec, ...] after the Flatten."""
        return self._parse()[1]

    def feature_shape(self) -> tuple:
        """(C, H, W) leaving the conv body (what Flatten sees)."""
        units = self.units()
        return units[-1].out_shape if units else self.in_shape

    def flat_dim(self) -> int:
        c, h, w = self.feature_shape()
        return c * h * w

    def n_classes(self) -> int:
        return self.head()[-1].d_out

    def signature(self) -> tuple:
        """Hashable structural identity (plan-cache key material)."""
        return (tuple(self.in_shape), tuple(
            (type(n).__name__,) + tuple(vars(n).values()) for n in self.nodes))

    def _parse(self):
        units, head = [], []
        c, h, w = self.in_shape
        cur: dict | None = None  # open conv unit being grouped
        in_head = False
        stage = slot = 0

        def close():
            nonlocal cur
            if cur is not None:
                units.append(ConvUnit(**cur))
                cur = None

        for node in self.nodes:
            if in_head:
                if not isinstance(node, DenseSpec):
                    raise ValueError(
                        f"{self.name}: only DenseSpec may follow Flatten, got {node}")
                head.append(node)
                continue
            if isinstance(node, ConvSpec):
                close()
                oh, ow = conv_out_hw(h, w, node)
                cur = dict(index=len(units), stage=stage, slot=slot, conv=node,
                           relu=False, pool=None, in_shape=(c, h, w),
                           out_shape=(node.c_out, oh, ow))
                c, h, w = node.c_out, oh, ow
                slot += 1
            elif isinstance(node, ReLU):
                if cur is None or cur["pool"] is not None:
                    raise ValueError(f"{self.name}: ReLU must follow a conv")
                cur["relu"] = True
            elif isinstance(node, PoolSpec):
                if cur is None:
                    raise ValueError(f"{self.name}: pool must follow a conv unit")
                h, w = pool_out_hw(h, w, node)
                cur["pool"] = node
                cur["out_shape"] = (c, h, w)
                close()
                stage, slot = stage + 1, 0
            elif isinstance(node, Flatten):
                close()
                in_head = True
            else:
                raise ValueError(f"{self.name}: unknown node {node!r}")
        close()
        if not in_head or not head:
            raise ValueError(f"{self.name}: graph needs Flatten + a dense head")
        return tuple(units), tuple(head)


# ---------------------------------------------------------------------------
# Weight plumbing
# ---------------------------------------------------------------------------


def graph_weights(params) -> tuple:
    """A params dict as (conv_weights, dense_weights) lists: the
    graph-native {"conv": [...], "dense": [...]} layout, or the legacy VGG
    {"stages": [[w, ...], ...], "fc1": w, "fc2": w} that
    `models.cnn.init_cnn` makes."""
    if "stages" in params:
        return ([w for convs in params["stages"] for w in convs],
                [params["fc1"], params["fc2"]])
    return list(params["conv"]), list(params["dense"])


def weight_shapes(graph: LayerGraph) -> tuple:
    """((conv weight shapes (O,C,kh,kw)), (dense weight shapes (d_in,d_out)))."""
    conv_shapes = []
    for u in graph.units():
        conv_shapes.append((u.conv.c_out, u.in_shape[0], u.conv.k, u.conv.k))
    d_in = graph.flat_dim()
    dense_shapes = []
    for spec in graph.head():
        dense_shapes.append((d_in, spec.d_out))
        d_in = spec.d_out
    return tuple(conv_shapes), tuple(dense_shapes)


def init_graph(generator: torch.Generator, graph: LayerGraph, *, device=None,
               dtype=torch.float32) -> dict:
    """Fan-in-scaled random params for a graph, in the graph-native layout.

    Drawn on the host from `generator` (so the same seed gives the same
    weights on every device), then moved to `device` (None = the card)."""
    dev = resolve_device(device)
    conv_shapes, dense_shapes = weight_shapes(graph)
    conv = [(torch.randn(s, generator=generator, dtype=dtype)
             * (s[1] * s[2] * s[3]) ** -0.5).to(dev) for s in conv_shapes]
    dense = [(torch.randn(s, generator=generator, dtype=dtype)
              * s[0] ** -0.5).to(dev) for s in dense_shapes]
    return {"conv": conv, "dense": dense}
