"""Hand-written CUDA kernels, the nvcc build helper and their plain versions."""
