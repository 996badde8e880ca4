"""Diffusion schedule, DDPM sampling side and the PLMS sampler."""
