// Fused CTGAN output activation for Hopper (sm_90a): Gumbel-softmax
// (tau = 0.2) within every softmax segment of a row, tanh on tanh segments.
//
// Replaces the TPU kernel fed_tgan_tpu/ops/activate_pallas.py::_fwd_kernel
// (reached through fused_apply_activate, activate_pallas.py:182).  The TPU
// version padded the row to 128 lanes, fed a per-segment max computed
// outside the kernel, and did the segmented sums as matmuls against a 0/1
// membership matrix so they landed on the MXU.  None of that carries over:
// here one warp owns one row, stages it in shared memory with coalesced
// loads, and each lane walks whole segments through an offset table, so
// segments of any width (1 to ~70 in the tables this serves) cost no
// padding and no mask tile.  The Gumbel transform of the uniforms and the
// per-segment max both happen in registers inside the kernel.
//
// Bound on an H100 SXM: memory.  Per element it reads x and u and writes
// out, 12 bytes, and does ~10 float operations (2 logf, 1 expf, a divide).
// One 128-step serving chunk (64,000 x 282) moves 217 MB: ~65 us at
// 3.35 TB/s.  One 500-row step moves 1.7 MB (~0.5 us), so it is bound by
// the launch itself.
//
// Plain C interface, loaded with ctypes (fed_tgan_torch/ops/activate_cuda.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kTau = 0.2f;

__device__ __forceinline__ float gumbel(float u) {
  return -logf(-logf(u + 1e-20f) + 1e-20f);
}

__global__ void activate_fwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ u,
                                    const int* __restrict__ seg_start,
                                    const uint8_t* __restrict__ seg_is_tanh,
                                    float* __restrict__ out, int n_rows,
                                    int dim, int n_seg) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n_rows) return;  // whole warp leaves together: one row per warp

  float* xs = smem + (size_t)warp * 2 * dim;  // the row's logits
  float* ws = xs + dim;                       // uniforms, then results
  const float* xr = x + row * dim;
  const float* ur = u + row * dim;
  for (int i = lane; i < dim; i += kWarp) {
    xs[i] = xr[i];
    ws[i] = ur[i];
  }
  __syncwarp();

  // each lane owns whole segments; every element belongs to one segment,
  // so lanes never touch the same shared-memory word
  for (int s = lane; s < n_seg; s += kWarp) {
    const int a = seg_start[s];
    const int b = seg_start[s + 1];
    if (seg_is_tanh[s]) {
      for (int i = a; i < b; ++i) ws[i] = tanhf(xs[i]);
      continue;
    }
    float m = -INFINITY;
    for (int i = a; i < b; ++i) {
      const float v = (xs[i] + gumbel(ws[i])) / kTau;
      ws[i] = v;
      m = fmaxf(m, v);
    }
    float sum = 0.f;
    for (int i = a; i < b; ++i) {
      const float e = expf(ws[i] - m);
      ws[i] = e;
      sum += e;
    }
    const float denom = sum + (sum == 0.f ? 1.f : 0.f);
    for (int i = a; i < b; ++i) ws[i] = ws[i] / denom;
  }
  __syncwarp();

  float* orow = out + row * dim;
  for (int i = lane; i < dim; i += kWarp) orow[i] = ws[i];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over an (n_rows, dim) float32 row-major
// x and u; seg_start holds n_seg + 1 offsets, seg_is_tanh n_seg flags.
// Returns the cudaError_t of the launch (0 = launched).
int fed_tgan_activate_fwd(const float* x, const float* u, const int* seg_start,
                          const uint8_t* seg_is_tanh, float* out, int n_rows,
                          int dim, int n_seg, void* stream) {
  const size_t row_bytes = 2 * sizeof(float) * (size_t)dim;
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * row_bytes > kDefaultSmem) warps /= 2;
  const size_t smem = warps * row_bytes;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        activate_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + warps - 1) / warps;
  activate_fwd_kernel<<<blocks, warps * kWarp, smem, (cudaStream_t)stream>>>(
      x, u, seg_start, seg_is_tanh, out, n_rows, dim, n_seg);
  return (int)cudaGetLastError();
}

const char* fed_tgan_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
