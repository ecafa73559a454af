"""Tensor-level operations of the PyTorch port: gate matrices, the complex
einsum engine, the planar engine and its CUDA kernels."""
