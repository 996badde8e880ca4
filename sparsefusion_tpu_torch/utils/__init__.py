"""utils of the PyTorch port (counterpart: sparsefusion_tpu/utils)."""
