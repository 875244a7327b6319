"""ShuffleNetV2 (channel split and shuffle) and GoogLeNet with its aux
heads (branch concatenation) against ``paddle_tpu.models``: the checks
and tolerances of ``test_torch_vision_zoo.py``, in a file of their own so
that the zoo's JAX compiles spread over the test workers."""

import pytest

from test_torch_vision_zoo import CONCAT_FAMILIES, check_family


@pytest.mark.parametrize("family", list(CONCAT_FAMILIES))
def test_family_forward_and_trainer_step_match_jax(family):
    check_family(*CONCAT_FAMILIES[family])
