"""DenseNet121 (dense blocks concatenating every earlier map) against
``paddle_tpu.models``: the checks and tolerances of
``test_torch_vision_zoo.py`` (its JAX oracle with the differentiable
average pool), in a file of its own: its JAX compiles take ~1 min."""

from test_torch_vision_zoo import DENSENET, check_family


def test_densenet121_forward_and_trainer_step_match_jax():
    check_family(*DENSENET)
