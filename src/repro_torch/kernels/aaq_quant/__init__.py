from repro_torch.kernels.aaq_quant.ops import aaq_quantize
