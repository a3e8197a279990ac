"""CPU parity of ``lm.loss_fn`` with the JAX reference under
``AAQConfig(ste=True)``, the MoE, SSM, hybrid and enc-dec configs: the
loss and every gradient leaf allclose 1e-4 against the reference run op by
op (``_torch_train_parity``)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_train_parity import check_loss_and_grads  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if get_config(n).kind not in ("dense", "vlm")])
def test_arch_train_step_under_ste_matches_jax(name):
    check_loss_and_grads(name, ste=True)
