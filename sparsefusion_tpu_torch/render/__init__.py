"""render of the PyTorch port (counterpart: sparsefusion_tpu/render)."""
