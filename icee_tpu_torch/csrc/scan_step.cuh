// The helpers every training scan and the SentiCap searches share: the
// sigmoid of the gate policies (cell_gates.cuh) and ICEE_TRY, which returns
// a CUDA error from a C entry point.  The scans' recurrence itself is one
// cooperative launch a direction (scan_grid.cuh): K3 (lstm_scan.cu), K4
// (nic_scan.cu) and K8 (senticap_scan.cu) all run it, so no scan launches
// a kernel a step any more.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Return the CUDA error of `expr` from the enclosing C entry point.
#define ICEE_TRY(expr)                     \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

namespace icee {

__device__ __forceinline__ float sigm(float z) { return 1.f / (1.f + expf(-z)); }

}  // namespace icee
