"""Processes and data parallelism (torch.distributed)."""
