"""Flash attention (GQA, fp32 or int8 K/V): the CUDA kernels' wrappers
(forward, int8 forward, and the two backward passes), their plain PyTorch
versions, the fp32 oracle and the model-layout entry with its autograd
Function (counterpart of `repro.kernels.flash_attention`)."""
