// Size limits of the executor kernels (mega_exec.cu, mega_grad.cu): the
// largest hidden size H, frame count F and question length L their
// per-block arrays hold. This header is the one home of these values;
// stair_tpu_torch/ops/mega_exec.py reads them from here.
#pragma once

namespace stair {
constexpr int MAX_H = 1024;
constexpr int MAX_F = 256;
constexpr int MAX_L = 1024;
// The tensor-core routes (mega_exec_tc_kernel, mega_bwd_tc_kernel): H a
// multiple of 64 up to TC_MAX_H, any F in [TC_MIN_F, TC_ROUTE_MAX_F]. A CTA
// holds at most TC_MAX_F frame rows of a bf16 [rows, H + 8] tile in shared
// memory: at F a multiple of 16 up to TC_MAX_F the forward keeps both of its
// [F, H + 8] tiles there (one CTA an example); above, or at a ragged F, each
// product runs over row slices of at most TC_MAX_F rows (the row-slice mode,
// an example on a thread-block cluster). The step kernel's tensor-core route
// (executor_step_tc_kernel, #10) takes the same widths and modes.
constexpr int TC_MAX_H = 512;
constexpr int TC_MAX_F = 64;
constexpr int TC_MIN_F = 16;
constexpr int TC_ROUTE_MAX_F = 256;
// The float32 "fma32" routes (mega_exec_kernel<float, true>,
// mega_bwd_kernel<float, true>): H a multiple of gemm32's column tile
// G32_BN (mega_common.cuh) up to FMA32_MAX_H, any F in [FMA32_MIN_F,
// FMA32_MAX_F] (gemm32 walks the frames in row tiles of G32_BM, the last
// one ragged). The float32 step kernel's route (executor_step_fma32_kernel,
// #10) takes the same widths.
constexpr int FMA32_MAX_H = 512;
constexpr int FMA32_MIN_F = 16;
constexpr int FMA32_MAX_F = 256;
}  // namespace stair
