"""The port's train step against the JAX package's at the default
precision policy (bf16 compute, f32 parameters and moments), every
architecture at its ``SMOKE_CONFIG``: ``test_torch_train.py``'s check
with the reference jitted, and for zamba2 with the reference run op by
op (bounds and the reason in ``test_torch_train.py``).  A file of its
own so that it runs beside that one."""

import pytest

from repro.configs import ARCH_IDS
from test_torch_train import check_train_step

OP_BY_OP = ("zamba2_1p2b",)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference_at_default_policy(arch):
    check_train_step(arch, "default_op_by_op" if arch in OP_BY_OP
                     else "default")
