"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see :mod:`repro_torch.kernels.fused_conv`)."""
