"""repro_torch.core — token-wise Adaptive Activation Quantization (AAQ) in
PyTorch (port of ``repro.core``)."""
from repro_torch.core.policy import (AAQConfig, DISABLED, GROUP_A, GROUP_B,
                                     GROUP_C, NO_QUANT, QuantPolicy)
from repro_torch.core.qmatmul import qmatmul, qmatmul_fused_ref
from repro_torch.core.qtensor import QTensor, pack_int4, qmax, unpack_int4
from repro_torch.core.quantize import (dequantize, fake_quant, fake_quant_ste,
                                       quant_rmse, quantize)
from repro_torch.core.schemes import SCHEMES, QuantScheme, make_scheme

__all__ = [
    "AAQConfig", "DISABLED", "GROUP_A", "GROUP_B", "GROUP_C", "NO_QUANT",
    "QuantPolicy", "QTensor", "pack_int4", "unpack_int4", "qmax",
    "quantize", "dequantize", "fake_quant", "fake_quant_ste", "quant_rmse",
    "qmatmul", "qmatmul_fused_ref", "SCHEMES", "QuantScheme", "make_scheme",
]
