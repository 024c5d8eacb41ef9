// The bf16 instantiation of the executor backward (mega_grad.cu), compiled
// as its own translation unit so that the two compute dtypes build in
// parallel; entry points stair_mega_exec_bwd_bf16 / _wgrad_bf16.
#define STAIR_GRAD_BF16
#include "mega_grad.cu"
