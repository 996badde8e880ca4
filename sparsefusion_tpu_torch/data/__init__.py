"""data of the PyTorch port (counterpart: sparsefusion_tpu/data)."""
