"""One train step over a batch of two scenes (the JAX step vmaps them and
takes the mean; the port loops, one backward per scene), the port against
the JAX package's ``make_train_step``; tolerances and draws as in
``test_torch_train_step.py``."""
import torch

from tests.test_torch_train_step import check_train_step_against_jax

torch.set_num_threads(2)


def test_train_step_two_scenes_matches_jax():
    check_train_step_against_jax(train_eft=True, n_scenes=2)
