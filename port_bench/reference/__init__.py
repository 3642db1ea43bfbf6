"""The plain reference: HunyuanVideo-Foley's denoiser, sampler and DAC decoder in fp32
PyTorch, from checkpoint-layout weights. It imports nothing of the program."""
