"""K2: the constant-coefficient 15-tap stencil, the GMG level operator
(``fenicssolver_tpu_torch.ops.cuda_kernels.stencil_apply_const``): its taps
are kernel parameters, no coefficient field is streamed."""

from harness.stencil import StencilKernel

MODEL = StencilKernel("stencil_apply_const", coef_fields=0)
