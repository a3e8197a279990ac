"""CUDA kernels for the hot spots (each: a CUDA source under ``csrc/``,
a ctypes wrapper with a launch counter, and a plain PyTorch version):

  aaq_quant       fused token-wise AAQ runtime quantization
  aaq_matmul      dequantization-free INT4/INT8 matmul, deferred per-token
                  scale + rank-k outlier correction
  flash_attention token-wise MHA with pair bias / causal / SWA / GQA /
                  kv_valid_len

``dispatch`` is the routing layer every model call site goes through.
"""
from repro_torch.kernels import dispatch
from repro_torch.kernels.aaq_matmul import aaq_linear
from repro_torch.kernels.aaq_quant import aaq_quantize
