// Fused CTGAN output activation for Hopper (sm_90a): Gumbel-softmax
// (tau = 0.2) within every softmax segment of a row, tanh on tanh segments
// (K1, activate_fwd_kernel), and its analytic backward (K2,
// activate_bwd_kernel).
//
// K1
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
// K2
//
// Replaces the TPU kernel fed_tgan_tpu/ops/activate_pallas.py::_bwd_kernel
// (the custom_vjp backward, _activate_padded_bwd, activate_pallas.py:170).
// Its only residual is the forward output: on softmax dims
// dx = out * (dy - sum_seg(dy * out)) / tau, on tanh dims
// dx = (1 - out^2) * dy.  Same layout as K1: one warp per row, dy and out
// staged in shared memory with coalesced loads, each lane walking whole
// segments through seg_start; per softmax segment one pass accumulates
// sum(dy * out) in a register and a second writes dx.  No membership
// matrix and no 128-lane padding.  The TPU wrapper also returned a
// gradient for the Gumbel noise (dg = dx on softmax dims) because a JAX
// key was an input of the custom_vjp; the port's uniforms never require a
// gradient, so K2 computes dx alone.
//
// Bound on an H100 SXM: memory.  Per element it reads dy and out and
// writes dx, 12 bytes, and does ~5 float operations.  At the training
// shape (500 x 282) that is 1.7 MB, ~0.5 us at 3.35 TB/s, so one call is
// bound by its launch; at 64,000 rows it is ~65 us.
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

__global__ void activate_bwd_kernel(const float* __restrict__ dy,
                                    const float* __restrict__ out,
                                    const int* __restrict__ seg_start,
                                    const uint8_t* __restrict__ seg_is_tanh,
                                    float* __restrict__ dx, int n_rows,
                                    int dim, int n_seg) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * warps + warp;
  if (row >= n_rows) return;

  float* gs = smem + (size_t)warp * 2 * dim;  // the row's upstream gradient
  float* ws = gs + dim;                       // forward output, then dx
  const float* gr = dy + row * dim;
  const float* orow = out + row * dim;
  for (int i = lane; i < dim; i += kWarp) {
    gs[i] = gr[i];
    ws[i] = orow[i];
  }
  __syncwarp();

  for (int s = lane; s < n_seg; s += kWarp) {
    const int a = seg_start[s];
    const int b = seg_start[s + 1];
    if (seg_is_tanh[s]) {
      for (int i = a; i < b; ++i) ws[i] = (1.f - ws[i] * ws[i]) * gs[i];
      continue;
    }
    float inner = 0.f;
    for (int i = a; i < b; ++i) inner += gs[i] * ws[i];
    for (int i = a; i < b; ++i) ws[i] = ws[i] * (gs[i] - inner) / kTau;
  }
  __syncwarp();

  float* xrow = dx + row * dim;
  for (int i = lane; i < dim; i += kWarp) xrow[i] = ws[i];
}

// Both kernels stage two float rows per warp: as many warps per block (up
// to 8) as fit in the default 48 KB, and above it one warp with the
// dynamic shared-memory limit raised.
template <typename Kernel>
int launch_rows(Kernel kernel, const float* a, const float* b,
                const int* seg_start, const uint8_t* seg_is_tanh, float* out,
                int n_rows, int dim, int n_seg, cudaStream_t stream) {
  const size_t row_bytes = 2 * sizeof(float) * (size_t)dim;
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && warps * row_bytes > kDefaultSmem) warps /= 2;
  const size_t smem = warps * row_bytes;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + warps - 1) / warps;
  kernel<<<blocks, warps * kWarp, smem, stream>>>(a, b, seg_start, seg_is_tanh,
                                                  out, n_rows, dim, n_seg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 on `stream` over an (n_rows, dim) float32 row-major x and u; seg_start holds n_seg + 1 offsets, seg_is_tanh n_seg flags.
// Returns the cudaError_t of the launch (0 = launched).
int fed_tgan_activate_fwd(const float* x, const float* u, const int* seg_start,
                          const uint8_t* seg_is_tanh, float* out, int n_rows,
                          int dim, int n_seg, void* stream) {
  return launch_rows(activate_fwd_kernel, x, u, seg_start, seg_is_tanh, out,
                     n_rows, dim, n_seg, (cudaStream_t)stream);
}

// K2 on `stream`: dx of the activation from the upstream gradient dy and
// the forward output out, both (n_rows, dim) float32 row-major.  Returns
// the cudaError_t of the launch (0 = launched).
int fed_tgan_activate_bwd(const float* dy, const float* out,
                          const int* seg_start, const uint8_t* seg_is_tanh,
                          float* dx, int n_rows, int dim, int n_seg,
                          void* stream) {
  return launch_rows(activate_bwd_kernel, dy, out, seg_start, seg_is_tanh, dx,
                     n_rows, dim, n_seg, (cudaStream_t)stream);
}

const char* fed_tgan_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
