"""K1: the variable-coefficient 15-tap stencil, the lattice PCG operator
(``fenicssolver_tpu_torch.ops.cuda_kernels.stencil_apply_var``): 15
coefficient fields streamed."""

from harness.stencil import StencilKernel

MODEL = StencilKernel("stencil_apply_var", coef_fields=15)
