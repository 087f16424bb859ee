"""The port's LM train step against the JAX package's without the PQ
uplink (SplitFed), for every architecture of the zoo at its smoke config:
three chained ``make_train_step`` steps under Adam, on the CPU (the
FedLite steps and the shared check are in ``test_torch_lm_steps.py``).
"""

import pytest

from test_torch_lm_steps import three_adam_steps
from test_torch_lm_train import ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adam_splitfed_steps_match_reference(arch):
    three_adam_steps(arch, quantize=False)
