"""SparseFusion in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of ``sparsefusion_tpu`` (the JAX package, which stays the
reference the port is held against).  The subpackage layout and public
names follow the JAX package so each function has an obvious
counterpart; inside, the port uses PyTorch idiom: ``nn.Module``s, an
explicit ``device`` argument, an explicit ``torch.Generator`` for every
random draw, and ``torch.autograd.Function`` where a hand-written kernel
needs a gradient.

Layout:
    core/      cameras (PyTorch3D-convention NDC math), rays, camera
               paths, harmonic embeddings
    ops/       image resizes and sampling, the multi-resolution grid
               encode, shared-kv attention, the row gather (plain
               versions of the kernels)
    kernels/   hand-written CUDA kernels (sources in ``csrc/``): the grid
               encode, the attention and the row gather, one for each
               Pallas kernel of the JAX package; and their build
    nn/        the instant-NGP field, the view-conditioned UNet, the SD
               VAE, the EFT and its ResNet18 trunk
    diffusion/ log-SNR schedule, DDPM loss and ancestral sampling, the
               PLMS sampler
    render/    the NGP volume renderer (two-phase or single-pass), the
               occupancy grid, the EFT light-field renderer
    data/      scene contract, procedural, co3d_toy and CO3Dv2 scenes
    distill/   per-scene distillation loop (EFT cache, bootstrap, fusion;
               the reference recipe and the TPU preset)
    train/     the train step, checkpoints, visualization, import of
               reference checkpoints
    parallel/  torch.distributed start-up and scene sharding
    utils/     images, metrics, and ``set_tf32`` (the entry points keep
               f32 matmuls and convolutions out of TF32; importing the
               package changes no torch setting)
    tools/     the train step's operation count, the row-gather
               micro-benchmark
    models.py  the EFT / VAE / UNet bundle
    cli/       demo and train front-ends (argparse-compatible with the
               JAX package)
"""
__version__ = "0.1.0"
