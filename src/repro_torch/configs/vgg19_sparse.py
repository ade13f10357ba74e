"""VGG-19, the paper's own evaluation network, on the LayerGraph IR
(counterpart of `repro.configs.vgg19_sparse`; graph builder only)."""
from dataclasses import dataclass

from repro_torch.graph.ir import ConvSpec, DenseSpec, Flatten, LayerGraph, PoolSpec, ReLU

# VGG-19 conv plan: (out_channels, n_convs) per stage; 2x2 maxpool after each.
VGG19_PLAN = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


@dataclass(frozen=True)
class CNNConfig:
    name: str = "vgg19"
    in_channels: int = 3
    img_size: int = 224
    plan: tuple = VGG19_PLAN
    kernel_size: int = 3
    pool_size: int = 2
    n_classes: int = 1000


def vgg19_graph(ccfg: CNNConfig = CNNConfig()) -> LayerGraph:
    """Per stage, `n_convs` SAME convs (k x k, stride 1, pad k//2) each
    followed by ReLU, a stage-final non-overlapping "valid" pool, then the
    2-layer dense head."""
    nodes = []
    k = ccfg.kernel_size
    for c_out, n_convs in ccfg.plan:
        for _ in range(n_convs):
            nodes += [ConvSpec(c_out, k=k, stride=1, pad=k // 2), ReLU()]
        nodes.append(PoolSpec(ccfg.pool_size))
    nodes += [Flatten(), DenseSpec(512, relu=True), DenseSpec(ccfg.n_classes)]
    return LayerGraph(name=ccfg.name,
                      in_shape=(ccfg.in_channels, ccfg.img_size, ccfg.img_size),
                      nodes=tuple(nodes))
