"""LayerGraph IR, op registry and executor: the model-agnostic spine
(counterpart of `repro.graph`)."""
from repro_torch.graph.executor import (
    maxpool2d,
    pad2d,
    run_graph,
    run_head,
    run_unit,
    run_units,
    uniform_impls,
)
from repro_torch.graph.ir import (
    ConvSpec,
    ConvUnit,
    DenseSpec,
    Flatten,
    LayerGraph,
    PoolSpec,
    ReLU,
    graph_weights,
    init_graph,
    weight_shapes,
)
from repro_torch.graph.registry import (
    OpImpl,
    conv_impl,
    fused_impl,
    fusion_eligible,
    get_op,
    list_ops,
    register_op,
    unit_impl,
)


def as_graph(graph_or_cfg) -> LayerGraph:
    """Normalize a `LayerGraph` | `CNNConfig` | None (full VGG-19) to a
    `LayerGraph`."""
    if isinstance(graph_or_cfg, LayerGraph):
        return graph_or_cfg
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph

    if graph_or_cfg is None:
        graph_or_cfg = CNNConfig()
    if isinstance(graph_or_cfg, CNNConfig):
        return vgg19_graph(graph_or_cfg)
    raise TypeError(
        f"expected a LayerGraph or CNNConfig, got {type(graph_or_cfg).__name__}")


__all__ = [
    "ConvSpec",
    "ConvUnit",
    "DenseSpec",
    "Flatten",
    "LayerGraph",
    "OpImpl",
    "PoolSpec",
    "ReLU",
    "as_graph",
    "conv_impl",
    "fused_impl",
    "fusion_eligible",
    "get_op",
    "graph_weights",
    "init_graph",
    "list_ops",
    "maxpool2d",
    "pad2d",
    "register_op",
    "run_graph",
    "run_head",
    "run_unit",
    "run_units",
    "uniform_impls",
    "unit_impl",
    "weight_shapes",
]
