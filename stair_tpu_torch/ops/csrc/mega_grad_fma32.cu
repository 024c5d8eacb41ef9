// The float32 "fma32" route of the executor backward (mega_grad.cu:
// mega_bwd_kernel<float, true>, the weight gradients' row index and
// mega_wgrad_fma32_kernel, and gemm32's card check), compiled as its own
// translation unit so that it builds in parallel with the general route's
// two; entry points stair_mega_exec_bwd_fma32 / _wgrad_fma32,
// stair_mega_exec_bwd_smem and stair_mega_f32_product_check.
#define STAIR_GRAD_FMA32
#include "mega_grad.cu"
