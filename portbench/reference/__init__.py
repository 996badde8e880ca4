"""The benchmark's plain reference: a frozen copy of the math of the port's
``nn/``, ``render/volume.py``, ``render/lightfield.py``, ``core/``,
``diffusion/`` and ``ops/``, in plain PyTorch, with the plain versions of
the hand-written kernels written in (K1: ``grid_encode.py``'s
``grid_encode_plain``; K2: ``attention.py``'s ``imagen_attention_plain``).

It imports nothing of the program under test and takes nothing the
program made: the weights come from :mod:`portbench.weights` and the
scenes from :mod:`portbench.scenes`, both drawn from the run's seed, and
whatever the program derives in its set-up (Phase A's EFT features and
images, the NGP field's first values) is worked out again here.
:mod:`portbench.reference.sparsefusion` holds the steps that the
correctness check replays.  Run in f32 with TF32 off.
"""
