"""Dense oracle of the fused conv+ReLU+maxpool op."""
import torch
import torch.nn.functional as F


def conv_pool_ref(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                  stride: int = 1, pool: int = 2) -> torch.Tensor:
    """(C,H,W) -> (O, oh//p, ow//p) or batched (N,C,H,W) -> (N, O, oh//p, ow//p)."""
    batched = x_chw.ndim == 4
    conv = F.conv2d((x_chw if batched else x_chw[None]).float(),
                    kernels_oihw.float(), stride=stride)
    out = F.max_pool2d(torch.relu(conv), pool, pool)
    return out if batched else out[0]
