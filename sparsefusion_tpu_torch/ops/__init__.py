"""ops of the PyTorch port (counterpart: sparsefusion_tpu/ops)."""
