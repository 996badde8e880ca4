"""distill of the PyTorch port (counterpart: sparsefusion_tpu/distill)."""
