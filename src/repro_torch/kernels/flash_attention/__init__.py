"""Flash attention forward (GQA, fp32 or int8 K/V): the CUDA kernels'
wrappers, their plain PyTorch versions, the fp32 oracle and the model-layout
entry (counterpart of `repro.kernels.flash_attention`)."""
