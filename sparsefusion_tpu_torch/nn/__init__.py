"""nn of the PyTorch port (counterpart: sparsefusion_tpu/nn)."""
