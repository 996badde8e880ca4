"""One train step with the EFT frozen (``train_eft=False``: its render is
detached, no EFT optimizer, no colour loss), the port against the JAX
package's ``make_train_step``; tolerances and draws as in
``test_torch_train_step.py``."""
import torch

from tests.test_torch_train_step import check_train_step_against_jax

torch.set_num_threads(2)


def test_train_step_frozen_eft_matches_jax():
    check_train_step_against_jax(train_eft=False, n_scenes=1)
