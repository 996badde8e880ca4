"""core of the PyTorch port (counterpart: sparsefusion_tpu/core)."""
