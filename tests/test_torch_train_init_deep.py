"""storm_tpu's initial parameters of resnet20 and moe_vit_tiny exported
for the card (``checkpoints_torch/<model>_init.npz``), held bit for bit to
storm_tpu's eager ``init_params`` as ``tests/test_torch_train_init.py``
holds lenet5's and vit_tiny's, in a file of its own: each takes storm_tpu
seconds of op-by-op compiles to build."""

import pytest

from tests.test_torch_train_init import check_exported_init

INIT_TAGS = {"resnet20_init": ("resnet20", (32, 32, 3)),
             "moe_vit_tiny_init": ("moe_vit_tiny", (32, 32, 3))}


@pytest.mark.parametrize("tag", sorted(INIT_TAGS))
def test_exported_init_parameters_are_storm_tpus(tag):
    check_exported_init(tag, *INIT_TAGS[tag])
