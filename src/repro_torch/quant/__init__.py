"""int8 quantized kernel family: absmax quantization, the int8 ECR and BSR
kernels, cost hooks and the planner's accuracy report (counterpart of
`repro.quant`)."""
