"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas TPU kernel
of ``repro.kernels`` on the port's path, each beside its plain PyTorch
version; ``_build`` compiles them at first use."""
