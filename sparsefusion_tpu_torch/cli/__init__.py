"""cli of the PyTorch port (counterpart: sparsefusion_tpu/cli)."""
