"""SparseFusion in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of ``sparsefusion_tpu`` (the JAX package, which stays the
reference the port is held against).  The subpackage layout and public
names follow the JAX package so each function has an obvious
counterpart; inside, the port uses PyTorch idiom: ``nn.Module``s, an
explicit ``device`` argument, an explicit ``torch.Generator`` for every
random draw, and ``torch.autograd.Function`` where a hand-written kernel
needs a gradient.

Layout:
    core/     cameras (PyTorch3D-convention NDC math), rays, camera paths
    ops/      image resizes and sampling, the multi-resolution grid encode
    kernels/  hand-written CUDA kernels (sources in ``csrc/``) + build
    nn/       the instant-NGP field
    render/   the NGP volume renderer
    data/     scene contract, procedural and co3d_toy scenes
    distill/  per-scene NGP distillation loop
    cli/      demo front-end (argparse-compatible with the JAX package)
"""
import torch

# The JAX reference computes float32 matmuls in full float32.  On the
# card, cuDNN convolutions default to TF32 (about three decimal digits),
# and a TF32 matmul would do the same; both are turned off so the port
# is numerically comparable with the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
