"""AlexNet on the LayerGraph IR (counterpart of `repro.configs.alexnet`).

11x11/4 then 5x5 then three 3x3 convs, ReLU after each, with the overlapping
3x3/2 max-pools of the original. Pooling stride != pool size makes those
pools ineligible for PECR fusion, so a sparse plan runs ECR + an unfused
pool, and the 11x11/stride-4 first conv exercises the kernel's large-k and
strided paths. `ALEXNET_REDUCED` pools in "ceil" mode (partial tails kept).
"""
from __future__ import annotations

from repro_torch.graph.ir import ConvSpec, DenseSpec, Flatten, LayerGraph, PoolSpec, ReLU


def alexnet_graph(*, img_size: int = 224, in_channels: int = 3,
                  n_classes: int = 1000, name: str = "alexnet") -> LayerGraph:
    pool = PoolSpec(3, stride=2)  # overlapping; 55/27/13 all tile exactly
    nodes = (
        ConvSpec(64, k=11, stride=4, pad=2), ReLU(), pool,
        ConvSpec(192, k=5, stride=1, pad=2), ReLU(), pool,
        ConvSpec(384, k=3, stride=1, pad=1), ReLU(),
        ConvSpec(256, k=3, stride=1, pad=1), ReLU(),
        ConvSpec(256, k=3, stride=1, pad=1), ReLU(), pool,
        Flatten(),
        DenseSpec(4096, relu=True), DenseSpec(4096, relu=True),
        DenseSpec(n_classes),
    )
    return LayerGraph(name=name, in_shape=(in_channels, img_size, img_size),
                      nodes=nodes)


def alexnet_reduced_graph(*, img_size: int = 32, in_channels: int = 3,
                          n_classes: int = 10,
                          name: str = "alexnet-tiny") -> LayerGraph:
    pool = PoolSpec(3, stride=2, mode="ceil")  # partial tails kept, not dropped
    nodes = (
        ConvSpec(16, k=5, stride=2, pad=2), ReLU(), pool,
        ConvSpec(24, k=5, stride=1, pad=2), ReLU(), pool,
        ConvSpec(32, k=3, stride=1, pad=1), ReLU(),
        ConvSpec(32, k=3, stride=1, pad=1), ReLU(),
        ConvSpec(24, k=3, stride=1, pad=1), ReLU(), pool,
        Flatten(),
        DenseSpec(64, relu=True),
        DenseSpec(n_classes),
    )
    return LayerGraph(name=name, in_shape=(in_channels, img_size, img_size),
                      nodes=nodes)


ALEXNET = alexnet_graph()
ALEXNET_REDUCED = alexnet_reduced_graph()
