"""mobilenetv2's train step (16x16x3, 4 rows) against storm_tpu's on the
CPU: ``tests/test_torch_train.py``'s comparison, its moments within 3e-2
of the model's largest (its gradient at initialization is determined to
~1 % in f32, as that file explains), in a file of its own because
storm_tpu takes ~10 s to compile its step."""

from tests.test_torch_train import check_train_steps


def test_train_step_matches_storm_tpu():
    check_train_steps("mobilenetv2")
