"""kernels of the PyTorch port (counterpart: sparsefusion_tpu/kernels)."""
