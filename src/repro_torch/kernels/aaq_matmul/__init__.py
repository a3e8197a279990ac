from repro_torch.kernels.aaq_matmul.ops import aaq_linear
