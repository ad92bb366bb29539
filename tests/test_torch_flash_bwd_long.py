"""The bf16 backward kernels' tile model at 1000 x 1000, checked on the
CPU: ``test_torch_flash_bwd.py``'s cases at their longest shape, in a
file of their own so that ``--dist loadfile`` runs them on another
worker.  The model, the inputs and the tolerance are that file's."""
import pytest

from test_torch_flash_bwd import check_kernel_model


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("sq,skv", [(1000, 1000)])
def test_bf16_kernel_model_within_bf16_tolerance(sq, skv, g, d, causal):
    check_kernel_model(sq, skv, g, d, causal)
