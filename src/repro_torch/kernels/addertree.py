"""K7: the adder tree, ``out[M, N] = sum_s partials[s, M, N]``, launched on
the card.

``addertree_cuda`` wraps ``k7_addertree`` in ``csrc/addertree.cu``; its
plain version is ``ref.addertree_ref``, which ``kernels.ops.addertree``
takes for tensors on the CPU.  Both fold s in ascending order at 32 bits
(fp32 for fp32 and bf16 partials, int32 for int8) and cast once, so the
kernel's output is bitwise its plain version's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _cuda

_IN = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2, torch.int8: 3}


def addertree_cuda(partials: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K7: ``partials [S, M, N]`` contiguous (fp32 or bf16 into an fp32 or
    bf16 output; int8 into an int32 or int8 output) -> ``[M, N]`` in
    ``out_dtype`` (default: the partials' dtype), bitwise
    ``ref.addertree_ref``."""
    if partials.dim() != 3:
        raise ValueError(f"partials must be [S, M, N], got "
                         f"{tuple(partials.shape)}")
    out_dtype = out_dtype or partials.dtype
    if partials.dtype not in _IN or out_dtype not in _OUT \
            or partials.dtype.is_floating_point != out_dtype.is_floating_point:
        raise TypeError(f"the adder tree takes fp32/bf16 -> fp32/bf16 and "
                        f"int8 -> int32/int8, got {partials.dtype} -> "
                        f"{out_dtype}")
    s = partials.shape[0]
    if s < 1:
        raise ValueError("the adder tree needs at least one partial")
    # any base: the kernel vectorizes 16-byte-aligned partials and takes
    # the rest element by element
    _cuda.check(partials, "partials", partials.dtype,
                align=partials.element_size())
    out = torch.empty(partials.shape[1:], dtype=out_dtype,
                      device=partials.device)
    if out.numel():
        _cuda.count("addertree")
        _cuda.launch("addertree", "k7_addertree", partials.data_ptr(),
                     out.data_ptr(), s, out.numel(), _IN[partials.dtype],
                     _OUT[out_dtype])
    return out
