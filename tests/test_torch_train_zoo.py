"""The train steps of moe_vit_tiny, mixer_tiny and longseq_tiny against
storm_tpu's on the CPU: ``tests/test_torch_train.py``'s comparison (three
steps, each from storm_tpu's state, AdamW at eps = 1.0 in both packages;
the loss within 1e-5 relative, parameters, moments, state and
``moe_aux_loss`` within 1e-4), in a file of its own to keep each file
under 25 s."""

import pytest

from tests.test_torch_train import check_train_steps


@pytest.mark.parametrize("name", ["longseq_tiny", "mixer_tiny", "moe_vit_tiny"])
def test_train_step_matches_storm_tpu(name):
    check_train_steps(name)
