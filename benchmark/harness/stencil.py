"""The bytes and operations model of the port's 15-tap stencil kernels (K1,
K2: ``stencil_march_kernel`` of ``csrc/stencil.cu``), shared by their files
in ``kernels/``.

A frozen copy of the model behind ``chip_smoke.py``'s bounds (``k1_bytes``,
``k2_bytes``, ``stencil_flops``): each input byte read once, each output
byte written once, whatever the kernel reads again.  The kernels differ
only in how many coefficient fields they stream: K1 reads 15, one a tap;
K2 none, its 15 taps are kernel parameters.
"""

from __future__ import annotations

import math

from .trace import template_matcher

MODULE = "fenicssolver_tpu_torch.ops.cuda_kernels"


class StencilKernel:
    """One instance of the stencil kernel: the program's wrapper that
    launches it, the coefficient fields it streams, and its name in the
    trace (``stencil_march_kernel<T, masked, variable>``)."""

    module = MODULE

    def __init__(self, wrapper, coef_fields):
        self.wrapper = wrapper
        self.coef_fields = int(coef_fields)
        variable = "true" if self.coef_fields else "false"
        self.match = template_matcher(
            "stencil_march_kernel", ["(?:float|double)", "(?:true|false)", variable])

    def bytes(self, shape, itemsize, masked=True):
        """The coefficient fields, x and the mask f read, y written."""
        return (self.coef_fields + (3 if masked else 2)) * math.prod(shape) * itemsize

    @staticmethod
    def flops(shape, masked=True):
        """Per vertex: 15 products and 14 sums, and with a mask f * x once
        and the final f * sum."""
        return (31 if masked else 29) * math.prod(shape)

    def launch_cost(self, x3, coef, free3=None):
        """The modelled bytes and operations of one launch on the wrapper's
        operands (``x3``, the coefficients, the mask); None off the card."""
        if x3.device.type != "cuda":
            return None
        shape, masked = tuple(x3.shape), free3 is not None
        return {"bytes": self.bytes(shape, x3.element_size(), masked),
                "flops": self.flops(shape, masked),
                "dtype": str(x3.dtype).replace("torch.", "")}
