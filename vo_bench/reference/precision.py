"""The control's arithmetic: TF32 for the reference's matrix products.

Under `TF32()` every float32 operand of a matrix product (`@`, `matmul`,
`mm`, `bmm`, `einsum`) is rounded to TF32 (10 explicit mantissa bits,
round to nearest even) before the product, which accumulates in float32:
what a TF32 tensor-core product computes, whatever kernel the library
would choose for the shape. The global TF32 flags are turned on too.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
             torch.Tensor.bmm, torch.einsum}


def to_tf32(x):
    """A float32 tensor rounded to TF32's precision; anything else as is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32).reshape(x.shape)


class TF32(TorchFunctionMode):
    def __enter__(self):
        self._flags = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return super().__enter__()

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._flags
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(
                [to_tf32(a) for a in x] if isinstance(x, (list, tuple))
                else to_tf32(x) for x in args)
        return func(*args, **kwargs)
