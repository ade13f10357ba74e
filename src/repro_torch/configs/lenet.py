"""LeNet-5 on the LayerGraph IR (counterpart of `repro.configs.lenet`).

Two 5x5 VALID convs (6 then 16 filters), each followed by ReLU and a 2x2/2
max-pool, then the 120/84/10 head. Both pools are fusion-eligible, so a
sparse plan runs the whole body as PECR with 5x5 kernels and no padding.
`LENET_REDUCED` is the test-scale variant.
"""
from __future__ import annotations

from repro_torch.graph.ir import ConvSpec, DenseSpec, Flatten, LayerGraph, PoolSpec, ReLU


def lenet_graph(*, img_size: int = 32, in_channels: int = 1,
                filters: tuple = (6, 16), k: int = 5,
                head: tuple = (120, 84), n_classes: int = 10,
                name: str = "lenet5") -> LayerGraph:
    nodes = []
    for c_out in filters:
        nodes += [ConvSpec(c_out, k=k, stride=1, pad=0), ReLU(), PoolSpec(2)]
    nodes.append(Flatten())
    for d in head:
        nodes.append(DenseSpec(d, relu=True))
    nodes.append(DenseSpec(n_classes))
    return LayerGraph(name=name, in_shape=(in_channels, img_size, img_size),
                      nodes=tuple(nodes))


LENET = lenet_graph()
LENET_REDUCED = lenet_graph(img_size=16, filters=(4, 8), head=(32,),
                            n_classes=8, name="lenet-tiny")
