"""CPU tests of the two repairs this training slice needed and of the
gradient guard:
  * ``AAQConfig.act`` routes through ``dispatch.fake_quant`` (the
    ``aaq_fake_quant`` kernel on the card), counted, the same bits on every
    backend, and its straight-through form under ``ste``;
  * the quantize kernel takes rows up to 8,192 wide (``_launch_shape``);
  * no kernel wrapper accepts an input that requires grad under grad mode
    (checked on ``meta`` tensors, which reach the guard before any device
    work), and ``dispatch`` in ``auto`` mode sends such operands to the
    plain version under ``<op>.ref_grad``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.policy import AAQConfig as JaxAAQConfig  # noqa: E402
from repro_torch.core.policy import DISABLED, AAQConfig  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel  # noqa: E402
from repro_torch.kernels.aaq_matmul.ops import aaq_linear  # noqa: E402
from repro_torch.kernels.aaq_quant.aaq_quant import (MAX_H, _launch_shape,  # noqa: E402
                                                     aaq_fake_quant_kernel,
                                                     aaq_quantize_kernel)
from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel  # noqa: E402

#: the residual-stream widths of the LM zoo (``lm.pre_ln`` rows)
ZOO_WIDTHS = (512, 1024, 1536, 2048, 3072, 4096, 5120, 6144)


@pytest.mark.parametrize("site", ["lm.pre_ln", "lm.kv_cache", "ssm.state", "lm.none"])
def test_aaq_config_act_routes_through_dispatch(site):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    cfg = AAQConfig(overrides={"lm.none": DISABLED.policy_for("x")})
    jcfg = JaxAAQConfig(overrides={"lm.none": DISABLED.policy_for("x")})
    enabled = cfg.policy_for(site).enabled
    want = np.asarray(jcfg.act(jnp.asarray(x), site))
    dispatch.reset_counters()
    for backend in ("auto", "ref", "kernel"):
        with dispatch.use_backend(backend):
            got = cfg.act(torch.from_numpy(x), site)
        np.testing.assert_array_equal(got.numpy(), want)
    assert dispatch.counters["fakequant.ref"] == 2 * enabled
    assert dispatch.counters["fakequant.kernel"] == enabled
    assert dispatch.plain_counts()["aaq_fake_quant"] == enabled
    # the straight-through form: the same forward, routed too
    dispatch.reset_counters()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = AAQConfig(ste=True, overrides=cfg.overrides).act(xt, site)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert dispatch.counters["fakequant.ref"] == enabled
    assert dispatch.counters["fakequant.ref_grad"] == 0
    assert AAQConfig().ste is False and AAQConfig().collect_stats is False
    dispatch.reset_counters()


@pytest.mark.parametrize("h", ZOO_WIDTHS + (8192,))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_launch_takes_every_zoo_width(h, dtype):
    x = torch.empty((65536 * 1024 // h, h), dtype=dtype, device="meta")
    for bits in (4, 8):
        for k in (0, 4):
            assert _launch_shape(x, bits, k, "aaq_fake_quant") == x.shape


@pytest.mark.parametrize("h,dtype,why", [(8200, torch.bfloat16, "8192"),
                                         (16384, torch.float32, "8192"),
                                         (6148, torch.bfloat16, "16-byte"),
                                         (1026, torch.float32, "16-byte"),
                                         (6145, torch.float32, "even")])
def test_quantize_launch_refuses_what_the_kernel_does_not_take(h, dtype, why):
    assert MAX_H == 8192
    with pytest.raises(ValueError, match=why):
        _launch_shape(torch.empty((4, h), dtype=dtype, device="meta"), 4, 4, "aaq_quantize")


def _meta(*shape, grad=True, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    q, k, v = _meta(1, 64, 2, 64), _meta(1, 64, 2, 64), _meta(1, 64, 2, 64)
    w = _meta(64, 32)
    calls = {
        "flash_mha_kernel": lambda: flash_mha_kernel(q, k, v),
        "aaq_linear": lambda: aaq_linear(_meta(8, 64), w, bits=4, k_outliers=4),
        "aaq_quantize_kernel": lambda: aaq_quantize_kernel(_meta(8, 64), bits=4, k_outliers=4),
        "aaq_fake_quant_kernel": lambda: aaq_fake_quant_kernel(_meta(8, 64), 4, 4),
        "aaq_matmul_kernel": lambda: aaq_matmul_kernel(
            torch.empty((8, 32), dtype=torch.int8, device="meta"),
            torch.empty((8, 1), device="meta"), _meta(8, 4, grad=False),
            torch.empty((8, 4), dtype=torch.int32, device="meta"), w, bits=4),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
            call()
    # grad mode off (the straight-through forward, inference): the guard
    # passes them on to the device check
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported device"):
            flash_mha_kernel(q, k, v)
        with pytest.raises(ValueError, match="unsupported device"):
            aaq_fake_quant_kernel(_meta(8, 64), 4, 4)
    build.refuse_grad("none", None, _meta(2, grad=False))


def test_dispatch_auto_routes_grad_operands_to_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, 2, 16, generator=g) for _ in range(3))
    x, w = torch.randn(3, 32, generator=g), torch.randn(32, 8, generator=g)
    dispatch.reset_counters()
    want = dispatch.attention(q, k, v, causal=True)
    qg = q.clone().requires_grad_(True)
    got = dispatch.attention(qg, k, v, causal=True)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)
    got.sum().backward()
    assert qg.grad is not None and float(qg.grad.abs().sum()) > 0
    dispatch.fake_quant(x.requires_grad_(True), bits=4, k_outliers=4)
    dispatch.quantized_linear(x, w, bits=4, k_outliers=4)
    with torch.no_grad():                                    # no graph: the usual rule
        dispatch.attention(qg, k, v)
    assert dispatch.counters == {
        "attention.kernel": 0, "attention.ref": 2, "attention.ref_grad": 1,
        "qmatmul.kernel": 0, "qmatmul.ref": 0, "qmatmul.ref_grad": 1,
        "fakequant.kernel": 0, "fakequant.ref": 0, "fakequant.ref_grad": 1,
        "quantize.kernel": 0, "quantize.ref": 0, "quantize.ref_grad": 0}
    # an explicit kernel request reaches the wrapper, which refuses such
    # operands on any device but the CPU (where it computes the plain version)
    dispatch.reset_counters()
    with dispatch.use_backend("kernel"):
        dispatch.attention(qg, k, v)
    assert dispatch.counters["attention.kernel"] == 1
    with pytest.raises(RuntimeError, match="requires grad"):
        dispatch.attention(_meta(1, 64, 2, 64), _meta(1, 64, 2, 64), _meta(1, 64, 2, 64),
                           backend="kernel")
    dispatch.reset_counters()
