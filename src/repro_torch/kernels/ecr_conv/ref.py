"""Dense oracle of the ECR conv op: VALID conv, NCHW semantics."""
import torch
import torch.nn.functional as F


def ecr_conv_ref(x_chw: torch.Tensor, kernels_oihw: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """(C,H,W) -> (O,oh,ow) or batched (N,C,H,W) -> (N,O,oh,ow), fp32 truth."""
    batched = x_chw.ndim == 4
    out = F.conv2d((x_chw if batched else x_chw[None]).float(),
                   kernels_oihw.float(), stride=stride)
    return out if batched else out[0]
