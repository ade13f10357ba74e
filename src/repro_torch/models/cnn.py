"""CNNs for the paper's own evaluation (counterpart of `repro.models.cnn`):
VGG-19 and reduced variants, with the conv stack runnable through every
implementation the paper compares:

  impl = "dense"        F.conv2d + separate ReLU + separate max-pool (cuDNN)
  impl = "im2col"       window matrix + GEMM (paper §VII baseline)
  impl = "ecr"          ECR sparse conv oracle (paper §IV), unfused pooling
  impl = "pecr"         ECR conv for in-stage layers + the PECR fused
                        conv+ReLU+pool oracle for stage-final layers (§V)
  impl = "ecr_pallas" / "pecr_pallas"  the same, through the CUDA kernels

This module holds no dispatch of its own: a `CNNConfig` lowers onto the IR
through `configs.vgg19_sparse.vgg19_graph` and runs through
`graph.executor`, whose registry resolves every (kind, impl) pair,
including which stage-final layers fuse into PECR. It also holds
`shift_dead_channels`, which gives random weights a trained net's dead
filters, and whisper's conv frontend (`init_whisper_frontend`,
`whisper_frontend`): two dense 1-D convolutions, as the reference computes
them with `conv_general_dilated` outside any Pallas kernel; the whisper
model itself takes the frame embeddings as its input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
from repro_torch.device import resolve_device
from repro_torch.graph.executor import run_head, run_unit, run_units, uniform_impls
from repro_torch.graph.ir import graph_weights


def init_cnn(generator: torch.Generator, ccfg: CNNConfig, *, device=None,
             dtype=torch.float32) -> dict:
    """Fan-in-scaled random VGG-style params in the legacy {"stages",
    "fc1", "fc2"} layout (graph-native callers use `graph.init_graph`).
    Drawn on the host from `generator` (bits differ from the reference's
    `jax.random`; parity tests carry the reference's weights across with
    `convert.params_from_jax`), then moved to `device` (None = the card)."""
    dev = resolve_device(device)
    graph = vgg19_graph(ccfg)

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=dtype)
                * fan_in ** -0.5).to(dev)

    stages = []
    c_in, k = ccfg.in_channels, ccfg.kernel_size
    for c_out, n_convs in ccfg.plan:
        convs = []
        for _ in range(n_convs):
            convs.append(draw((c_out, c_in, k, k), c_in * k * k))
            c_in = c_out
        stages.append(convs)
    flat = graph.flat_dim()
    return {"stages": stages, "fc1": draw((flat, 512), flat),
            "fc2": draw((512, ccfg.n_classes), 512)}


def cnn_forward(params, img: torch.Tensor, impl: str = "dense",
                ccfg: CNNConfig = CNNConfig()) -> torch.Tensor:
    """(C,H,W) -> class logits, or a batch (N,C,H,W) -> (N, n_classes): each
    conv layer is one whole-batch call at `impl`, then the dense head."""
    graph = vgg19_graph(ccfg)
    conv_ws, dense_ws = graph_weights(params)
    x = run_units(img, conv_ws, graph.units(), uniform_impls(graph, impl))
    return run_head(x, dense_ws, graph.head())


def cnn_forward_batch(params, imgs: torch.Tensor, impl: str = "dense",
                      ccfg: CNNConfig = CNNConfig()) -> torch.Tensor:
    """Batched inference entry point: (N,C,H,W) -> (N, n_classes) logits.
    The dense path batches natively, the ECR / PECR oracles carry the batch
    dim through their compressed formats, and the kernels run per-sample
    channel-block schedules over one launch."""
    if imgs.ndim != 4:
        raise ValueError(f"expected (N,C,H,W), got {tuple(imgs.shape)}")
    return cnn_forward(params, imgs, impl=impl, ccfg=ccfg)


def cnn_feature_maps(params, img: torch.Tensor,
                     ccfg: CNNConfig = CNNConfig()) -> list:
    """The paper's data set (§VI-A): every feature map entering a conv
    layer (before its padding), along the dense path."""
    graph = vgg19_graph(ccfg)
    conv_ws, _ = graph_weights(params)
    maps = []
    x = img
    for unit, w in zip(graph.units(), conv_ws):
        maps.append(x)
        x = run_unit(x, w, unit, "conv", "dense")
    return maps


def shift_dead_channels(params, rate: float = 0.04, shift: float = 0.12):
    """Shift a depth-growing fraction (`rate * depth`) of each conv's output
    filters negative so ReLU kills those channels, as trained VGG nets lose
    whole filters with depth (paper Fig. 2). Keeps the params' layout
    (graph-native or legacy).

    The filters are chosen by a `torch.Generator` seeded with the layer's
    depth, so they differ from the reference's `jax.random.PRNGKey(depth)`
    choice at the same rates; parity tests shift on the JAX side and carry
    the weights across."""
    conv_ws, _ = graph_weights(params)
    shifted_ws = []
    for depth, w in enumerate(conv_ws):
        gen = torch.Generator().manual_seed(depth)
        u = torch.rand((w.shape[0], 1, 1, 1), generator=gen)
        bias_mask = (u < rate * depth).to(device=w.device, dtype=w.dtype)
        shifted_ws.append(w * (1.0 - bias_mask) - shift * bias_mask * w.abs())
    if "stages" in params:
        it = iter(shifted_ws)
        return {"stages": [[next(it) for _ in convs] for convs in params["stages"]],
                "fc1": params["fc1"], "fc2": params["fc2"]}
    return {"conv": shifted_ws, "dense": list(params["dense"])}


# ---------------------------------------------------------------------------
# whisper conv frontend (off the served path, as in the reference)
# ---------------------------------------------------------------------------


def init_whisper_frontend(generator: torch.Generator, n_mels: int, d_model: int, *,
                          device=None, dtype=torch.float32) -> dict:
    """conv1 (d_model, n_mels, 3) and conv2 (d_model, d_model, 3), normal at
    fan-in (channels * 3) ** -0.5, drawn on the host from `generator` and
    moved to `device` (None = the card)."""
    dev = resolve_device(device)

    def draw(shape):
        fan_in = shape[1] * shape[2]
        return (torch.randn(shape, generator=generator, dtype=dtype)
                * fan_in ** -0.5).to(dev)

    return {"conv1": draw((d_model, n_mels, 3)), "conv2": draw((d_model, d_model, 3))}


def whisper_frontend(params, mel: torch.Tensor, stride2: bool = True) -> torch.Tensor:
    """mel (n_mels, T) -> (T // 2, d_model) frame embeddings (T with
    `stride2=False`): conv1 (padding 1), gelu, conv2 (stride 2, padding 1),
    gelu, with jax.nn.gelu's tanh approximation."""
    x = F.conv1d(mel[None], params["conv1"], padding=1)
    x = F.gelu(x, approximate="tanh")
    x = F.conv1d(x, params["conv2"], stride=2 if stride2 else 1, padding=1)
    x = F.gelu(x, approximate="tanh")
    return x[0].T
