// Size limits of the executor kernels (mega_exec.cu, mega_grad.cu): the
// largest hidden size H, frame count F and question length L their
// per-block arrays hold. This header is the one home of these values;
// stair_tpu_torch/ops/mega_exec.py reads them from here.
#pragma once

namespace stair {
constexpr int MAX_H = 1024;
constexpr int MAX_F = 256;
constexpr int MAX_L = 1024;
}  // namespace stair
