"""CPU parity of ``lm.loss_fn`` (training) with the JAX reference for all
ten configs at ``reduce_config`` in float32 under ``DISABLED``: the loss
and every gradient leaf allclose 1e-4 (``_torch_train_parity``).  Port of
the reference's ``test_arch_train_step_smoke`` with the reference's
numbers as the oracle."""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_parity import check_loss_and_grads  # noqa: E402
from repro_torch.configs import ARCH_NAMES  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_train_step_matches_jax(name):
    check_loss_and_grads(name, ste=False)
