"""Public attention op (port of ``repro/kernels/flash_attention/ops.py``).

``use_kernel`` selects the CUDA flash kernel's wrapper (which computes its
plain version on CPU tensors) over the materializing ``mha_ref``.  Models
route through ``dispatch.attention``; this is the direct call.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
from repro_torch.kernels.flash_attention.ref import mha_ref


def mha(q, k, v, *, bias=None, causal=False, window=None, kv_valid_len=None,
        softmax_scale=None, use_kernel=False):
    if use_kernel:
        return flash_mha_kernel(q, k, v, bias, kv_valid_len, causal=causal,
                                window=window, softmax_scale=softmax_scale)
    return mha_ref(q, k, v, bias=bias, causal=causal, window=window,
                   kv_valid_len=kv_valid_len, softmax_scale=softmax_scale)
