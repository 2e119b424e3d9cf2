// Fused CTGAN output activation for Hopper (sm_90a): Gumbel-softmax
// (tau = 0.2) within every softmax segment of a row, tanh on tanh segments
// (K1, activate_fwd_kernel), and its analytic backward (K2,
// activate_bwd_kernel).
//
// What they replace
//
// K1 replaces the TPU kernel fed_tgan_tpu/ops/activate_pallas.py::_fwd_kernel
// (reached through fused_apply_activate, activate_pallas.py:182).  K2
// replaces fed_tgan_tpu/ops/activate_pallas.py::_bwd_kernel (the
// custom_vjp backward, _activate_padded_bwd, activate_pallas.py:170): from
// the forward output alone, dx = out * (dy - sum_seg(dy * out)) / tau on
// softmax dims and dx = (1 - out^2) * dy on tanh dims.  The TPU versions
// padded the row to 128 lanes and did the segmented max and sums as
// matmuls against a 0/1 membership matrix on the MXU; the TPU backward also
// returned a gradient for the Gumbel noise, which the port's uniforms never
// need.  None of that carries over.  Both scale by 1 / tau as the TPU
// kernels do; the softmax denominator is a correctly rounded division.
//
// What bounds them on an H100 SXM
//
// Memory.  Per element each float32 kernel reads two floats and writes
// one: 12 bytes (the bf16 variants: 8, or 12 for K1 with its residual).
// K1 does ~10 float operations per element (2 logf, 1 expf, a divide), K2
// ~5, so at 3.35 TB/s and 67 TFLOP/s the bytes bound both.  A
// 128-step serving chunk (64,000 x 282) moves 217 MB, ~65 us; a 500-row
// training call moves 1.7 MB, ~0.5 us, so there the launch and the latency
// of the kernel's dependent steps set the time.  Past its load and store,
// K1 is bound by the instructions it issues per element, not by its two
// logf: the passes that look up or walk segments cost more than the logs.
//
// The design
//
// A block owns a tile of R consecutive rows, which in a row-major (N, D)
// tensor is one contiguous run of R * D floats.  It copies the tile's two
// operands into shared memory with cp.async (16-byte copies on the
// 16-byte-aligned interior of the flat tile, 4-byte copies on the ragged
// ends), the per-dim codes and segment offsets in the same group.  Each
// operand's buffer is shifted by the tile's misalignment in floats, so a
// global address and its shared-memory copy agree modulo 16 bytes whatever
// the row width (1,128 and 1,140 bytes here) or the tensor's base.  The
// plan (activate_cuda.py::launch_plan) gives one tile to each block, with
// 5 to 8 blocks resident on an SM: while one block computes, others copy.
// A persistent grid that walks the tiles measured slower at 64,000 rows:
// the tiles are dealt out in advance, so the last blocks to finish hold up
// the whole launch.
//
// A row too wide to stage beside the tables (D above ~23,000) runs
// unstaged, the kStaged = false instantiation: one row per block, operands
// and tables read from global memory, K1's logits kept in `out` until the
// store pass rewrites them, and only the (row, segment) results in shared
// memory.  So the kernels take rows up to D = 29,056, the width at which
// one row of both operands fills a block's 227 KB.
//
// Inside a tile the work is split by element where it is the same for
// every element: thread t takes flat elements t, t + T, ..., so every
// thread makes the same number of logf calls whatever the segment widths
// (a lane that walked whole segments would take a 70-wide one three times
// while its 31 neighbours idled).  The per-segment work runs
// as one pass over (row, segment) pairs spread across all threads: a
// pair's elements are maxed, exponentiated and summed in one fixed order,
// so a row's result does not depend on where it falls in a tile or in the
// tensor.  That keeps chunked sampling byte-identical to one-shot sampling
// and a stacked launch bit-identical to separate ones, which atomics or a
// warp reduction over tile positions would not.
//
// K1: element pass (noisy logits (x + g) / tau, every element alike) ->
// pair pass (tanh(x) on tanh pairs; max, exp(v - max) and their sum on
// softmax pairs) -> store pass (divide by the pair's sum).
// K2: pair pass (sum of dy * out) -> store pass (dx).
// The store pass writes o[e] from thread e % T: a warp writes 128
// contiguous bytes and reads shared memory without bank conflicts.
//
// The bf16 variants (mixed precision, fed_tgan_torch/runtime/precision.py)
//
// Under bf16 compute JAX casts K1's operand to float32 before its float32
// kernel and rounds the result back to bf16 (activate_pallas.py:142-144,
// 197); its backward reads the float32 forward output as the residual and
// a bf16 cotangent, and rounds dx to bf16.  The kernels here are templates
// over the element type T of the first operand and of the result: x or dy
// is read as T (staged as T), every step runs in float32, and the result
// is rounded to nearest even once, in the store pass.  The Gumbel uniforms
// and K2's residual stay float32.  Three bf16 instantiations: K1 for
// sampling (reads 2 + 4 bytes, writes 2: 8 bytes an element), K1 for
// training (also writes the float32 result, K2's residual: 12 bytes) and
// K2 (reads 2 + 4, writes 2: 8 bytes).  The float32 instantiations are
// the kernels as they were.  A bf16 tile can start on a 2-byte boundary,
// which no cp.async size copies: its ragged ends are copied with ordinary
// loads and stores, its aligned interior with 16-byte cp.async (8
// elements).  Unstaged, the bf16 K1 keeps its float32 logits in the
// residual buffer (a scratch the wrapper allocates when it samples).
//
// Accurate logf, expf and tanhf (no fast-math intrinsics: -log(-log(u))
// near u -> 1 is where they lose digits).  No allocation and no
// synchronisation: the wrapper (fed_tgan_torch/ops/activate_cuda.py)
// allocates the output, computes the launch plan and passes PyTorch's
// current stream.  Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block may use
constexpr uint16_t kTanhBit = 0x8000;
constexpr uint16_t kSegMask = 0x7fff;
constexpr float kInvTau = 5.0f;  // 1 / tau, as the TPU kernels scale

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gumbel(float u) {
  return -logf(-logf(u + 1e-20f) + 1e-20f);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The result in T: itself, or rounded to the nearest bf16 (ties to even).
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Elements of T in one 16-byte copy (kN), and its log2.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / (int)sizeof(T);
  static constexpr int kLog = sizeof(T) == 4 ? 2 : 3;
};

// What a tile's passes read: the staged operand buffers (null when
// unstaged), the (row, segment) results, and the tables, in shared memory
// when staged and in global memory when not.
template <typename T>
struct Layout {
  T* a;                   // first operand (x, dy), shifted by its misalignment
  float* b;               // second operand (u, out)
  float2* seg;            // [R * S]: K1 (sum, 1 / sum), K2 (inner, unused)
  const int* start;       // [S + 1]
  const uint16_t* code;   // [D]
};

// Misalignment of a global pointer in elements (0 .. kVec - 1): the
// element at flat index e sits on a 16-byte boundary iff
// (shift + e) % kVec == 0.
template <typename T>
__device__ __forceinline__ int shift_of(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> (4 - Vec<T>::kLog)) &
               (Vec<T>::kN - 1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// One element of a ragged end: a 4-byte cp.async, or for a 2-byte element
// (no cp.async size copies it) an ordinary load and store.
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src);
  } else {
    *dst = *src;
  }
}

// Issue the copy of n elements from src into dst + shift_of(src).
template <typename T>
__device__ __forceinline__ void issue_copy(T* dst, const T* src, int n) {
  const int shift = shift_of(src);
  dst += shift;
  const int head = min((Vec<T>::kN - shift) & (Vec<T>::kN - 1), n);
  const int n_vec = (n - head) >> Vec<T>::kLog;
  const int t = threadIdx.x;
  if (t < head) copy_elem(dst + t, src + t);
  for (int v = t; v < n_vec; v += kThreads) {
    const int e = head + Vec<T>::kN * v;
    cp_async16(dst + e, src + e);
  }
  const int tail = head + Vec<T>::kN * n_vec;
  if (tail + t < n) copy_elem(dst + tail + t, src + tail + t);
}

// Bytes of the staged first operand's buffer: R * D elements of T plus
// room for its misalignment, in whole 16-byte pieces.
template <typename T>
__host__ __device__ __forceinline__ int operand_bytes(int n) {
  constexpr int v = Vec<T>::kN;
  return (int)sizeof(T) * ((n + v - 1 + v - 1) & ~(v - 1));
}

// The staged shared-memory layout, mirrored by smem_bytes() in
// activate_cuda.py: the first operand's buffer (operand_bytes<T>(R * D)),
// the second's of round4(R * D + 3) floats, the (row, segment) results
// (round4(2 * R * S) floats), the segment offsets (round4(S + 1) ints),
// the per-dim codes (D uint16, copied in 16-byte pieces).  Issues the
// copies of the tables (padded to 16 bytes on the host) into it.
template <typename T>
__device__ __forceinline__ Layout<T> stage_tables(float* smem,
                                                  const uint16_t* dim_code,
                                                  const int* seg_start,
                                                  int rows_per_tile, int dim,
                                                  int n_seg) {
  const int n = rows_per_tile * dim;
  float* b = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                      operand_bytes<T>(n));
  float* seg = b + round4(n + 3);
  int* start = reinterpret_cast<int*>(seg + round4(2 * rows_per_tile * n_seg));
  uint16_t* code = reinterpret_cast<uint16_t*>(start + round4(n_seg + 1));
  for (int i = threadIdx.x; i < round4(n_seg + 1) / 4; i += kThreads)
    cp_async16(start + 4 * i, seg_start + 4 * i);
  for (int i = threadIdx.x; i < (dim + 7) / 8; i += kThreads)
    cp_async16(code + 8 * i, dim_code + 8 * i);
  return {reinterpret_cast<T*>(smem), b, reinterpret_cast<float2*>(seg), start,
          code};
}

// Walks flat indices e = first, first + step, ... of a tile as (row, col)
// pairs over rows of width `width`, with no division in the loop.
struct Walker {
  int row, col, drow, dcol, width;
  __device__ __forceinline__ Walker(int first, int step, int w)
      : row(first / w), col(first % w), drow(step / w), dcol(step % w),
        width(w) {}
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// e / d, correctly rounded, from r = 1 / d correctly rounded (one per
// segment): q = e * r is within an ulp, and one residual step (Markstein)
// rounds it correctly outside the subnormal range, without the slow path a
// general float division carries per element.
__device__ __forceinline__ float divide(float e, float2 dr) {
  const float q = e * dr.y;
  return fmaf(fmaf(-dr.x, q, e), dr.y, q);
}

// The guarded denominator of a softmax segment (the TPU kernel's guard
// against a zero sum) and its reciprocal.
__device__ __forceinline__ float2 denominator(float sum) {
  const float d = sum + (sum == 0.f ? 1.f : 0.f);
  return make_float2(d, __frcp_rn(d));
}

// K1's pass over (row, segment) pairs: tanh(x) in place of v on a tanh
// pair; on a softmax pair the max m of its noisy logits v, then exp(v - m)
// in place of v, summed in order, and the guarded sum with its reciprocal.
template <typename T>
__device__ __forceinline__ void pair_softmax(const Layout<T>& l, const T* x,
                                             float* v, int rows, int dim,
                                             int n_seg) {
  Walker w(threadIdx.x, kThreads, n_seg);
  for (int p = threadIdx.x; p < rows * n_seg; p += kThreads, w.next()) {
    const int a = w.row * dim + l.start[w.col];
    const int b = a + l.start[w.col + 1] - l.start[w.col];
    if (a == b) continue;
    if (l.code[l.start[w.col]] & kTanhBit) {
      for (int i = a; i < b; ++i) v[i] = tanhf(to_f32(x[i]));
      continue;
    }
    float m = -INFINITY;
#pragma unroll 4
    for (int i = a; i < b; ++i) m = fmaxf(m, v[i]);
    float sum = 0.f;
    for (int i = a; i < b; ++i) {
      const float e = expf(v[i] - m);
      v[i] = e;
      sum += e;
    }
    l.seg[p] = denominator(sum);
  }
}

// K2's pass over pairs: the sum of dy * out over each softmax pair.
template <typename T>
__device__ __forceinline__ void pair_inner(const Layout<T>& l, const T* dy,
                                           const float* out, int rows,
                                           int dim, int n_seg) {
  Walker w(threadIdx.x, kThreads, n_seg);
  for (int p = threadIdx.x; p < rows * n_seg; p += kThreads, w.next()) {
    const int a = w.row * dim + l.start[w.col];
    const int b = a + l.start[w.col + 1] - l.start[w.col];
    if (a == b || (l.code[l.start[w.col]] & kTanhBit)) continue;
    float inner = 0.f;
#pragma unroll 4
    for (int i = a; i < b; ++i) inner += to_f32(dy[i]) * out[i];
    l.seg[p].x = inner;
  }
}

// Store pass: store(e, row, col) for every flat element e < n of the tile,
// called by thread e % kThreads: a warp writes contiguous bytes and reads
// shared memory without bank conflicts.  (Groups of 4 written as one
// float4 read shared memory at a stride of 4 floats, 4-way conflicted, and
// measured slower.)
template <typename F>
__device__ __forceinline__ void store_tile(int n, int dim, F store) {
  Walker w(threadIdx.x, kThreads, dim);
  for (int e = threadIdx.x; e < n; e += kThreads, w.next())
    store(e, w.row, w.col);
}

// The tile of block blockIdx.x, shared by both kernels.  Staged: copy the
// tables and the tile's two operands in, wait, run `compute` on the copies.
// Unstaged: run `compute` on the operands in global memory.
template <typename T, bool kStaged, typename Compute>
__device__ __forceinline__ void run_tile(
    const T* __restrict__ a, const float* __restrict__ b,
    const uint16_t* __restrict__ dim_code, const int* __restrict__ seg_start,
    int n_rows, int dim, int n_seg, int rows_per_tile, Compute compute) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = (long long)blockIdx.x * rows_per_tile;
  const int rows = (int)min((long long)rows_per_tile, n_rows - row0);
  const size_t off = (size_t)row0 * dim;
  if constexpr (kStaged) {
    const Layout<T> l =
        stage_tables<T>(smem, dim_code, seg_start, rows_per_tile, dim, n_seg);
    issue_copy(l.a, a + off, rows * dim);
    issue_copy(l.b, b + off, rows * dim);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    compute(l, l.a + shift_of(a + off), l.b + shift_of(b + off), rows, off);
  } else {
    const Layout<T> l{nullptr, nullptr, reinterpret_cast<float2*>(smem),
                      seg_start, dim_code};
    compute(l, a + off, b + off, rows, off);
  }
}

// K1.  `out` is T; `res` receives the float32 result when kResidual (the
// bf16 training variant: K2's residual).  Unstaged, the noisy logits are
// kept in global memory until the store pass rewrites them: in `out` for
// float32, in `res` (a scratch when not kResidual) for bf16.  Registers
// are capped at 32 a thread (8 blocks of 256 threads on one SM), so that
// register use never keeps a block off an SM.
template <typename T, bool kStaged, bool kResidual>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    activate_fwd_kernel(const T* __restrict__ x, const float* __restrict__ u,
                        const uint16_t* __restrict__ dim_code,
                        const int* __restrict__ seg_start,
                        T* __restrict__ out, float* __restrict__ res,
                        int n_rows, int dim, int n_seg, int rows_per_tile) {
  run_tile<T, kStaged>(
      x, u, dim_code, seg_start, n_rows, dim, n_seg, rows_per_tile,
      [&](const Layout<T>& l, const T* xs, const float* us, int rows,
          size_t off) {
        const int n = rows * dim;
        // the noisy logit (x + g) / tau, on every element alike (the pair
        // pass overwrites the tanh dims): in place of u's staged copy, or
        // unstaged in global memory, which the store pass rewrites
        float* ws;
        if constexpr (kStaged) {
          ws = const_cast<float*>(us);
        } else if constexpr (std::is_same<T, float>::value) {
          ws = out + off;
        } else {
          ws = res + off;
        }
        for (int e = threadIdx.x; e < n; e += kThreads)
          ws[e] = (to_f32(xs[e]) + gumbel(us[e])) * kInvTau;
        __syncthreads();
        pair_softmax(l, xs, ws, rows, dim, n_seg);
        __syncthreads();
        store_tile(n, dim, [&](int e, int row, int col) {
          const uint16_t c = l.code[col];
          const float v =
              (c & kTanhBit)
                  ? ws[e]
                  : divide(ws[e], l.seg[row * n_seg + (c & kSegMask)]);
          out[off + e] = from_f32<T>(v);
          if constexpr (kResidual) res[off + e] = v;
        });
      });
}

// K2: dy is T, the residual `out` float32, dx T.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    activate_bwd_kernel(const T* __restrict__ dy,
                        const float* __restrict__ out,
                        const uint16_t* __restrict__ dim_code,
                        const int* __restrict__ seg_start,
                        T* __restrict__ dx, int n_rows, int dim,
                        int n_seg, int rows_per_tile) {
  run_tile<T, kStaged>(
      dy, out, dim_code, seg_start, n_rows, dim, n_seg, rows_per_tile,
      [&](const Layout<T>& l, const T* gs, const float* ws, int rows,
          size_t off) {
        pair_inner(l, gs, ws, rows, dim, n_seg);
        __syncthreads();
        store_tile(rows * dim, dim, [&](int e, int row, int col) {
          const uint16_t c = l.code[col];
          const float g = to_f32(gs[e]);
          float v;
          if (c & kTanhBit) {
            v = (1.f - ws[e] * ws[e]) * g;
          } else {
            const float inner = l.seg[row * n_seg + (c & kSegMask)].x;
            v = ws[e] * (g - inner) * kInvTau;
          }
          dx[off + e] = from_f32<T>(v);
        });
      });
}

int grid_of(int n_rows, int rows_per_tile) {
  return (n_rows + rows_per_tile - 1) / rows_per_tile;
}

// One block per tile of rows_per_tile rows; staged or unstaged.
template <typename T, bool kResidual>
int launch_fwd(const void* x, const float* u, const uint16_t* dim_code,
               const int* seg_start, void* out, float* res, int n_rows,
               int dim, int n_seg, int rows_per_tile, int staged,
               int smem_bytes, cudaStream_t stream) {
  const int tiles = grid_of(n_rows, rows_per_tile);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (staged)
    activate_fwd_kernel<T, true, kResidual>
        <<<tiles, kThreads, smem_bytes, stream>>>(
            xt, u, dim_code, seg_start, ot, res, n_rows, dim, n_seg,
            rows_per_tile);
  else
    activate_fwd_kernel<T, false, kResidual>
        <<<tiles, kThreads, smem_bytes, stream>>>(
            xt, u, dim_code, seg_start, ot, res, n_rows, dim, n_seg,
            rows_per_tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dy, const float* out, const uint16_t* dim_code,
               const int* seg_start, void* dx, int n_rows, int dim, int n_seg,
               int rows_per_tile, int staged, int smem_bytes,
               cudaStream_t stream) {
  const int tiles = grid_of(n_rows, rows_per_tile);
  const T* gt = static_cast<const T*>(dy);
  T* dt = static_cast<T*>(dx);
  if (staged)
    activate_bwd_kernel<T, true><<<tiles, kThreads, smem_bytes, stream>>>(
        gt, out, dim_code, seg_start, dt, n_rows, dim, n_seg, rows_per_tile);
  else
    activate_bwd_kernel<T, false><<<tiles, kThreads, smem_bytes, stream>>>(
        gt, out, dim_code, seg_start, dt, n_rows, dim, n_seg, rows_per_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before the first launch: lets every kernel take up to
// 227 KB of dynamic shared memory and prefer shared memory over L1.
// Returns the first cudaError_t that is not 0, else 0.
int fed_tgan_activate_prepare() {
  const void* kernels[] = {
      (const void*)activate_fwd_kernel<float, false, false>,
      (const void*)activate_fwd_kernel<float, true, false>,
      (const void*)activate_fwd_kernel<bf16, false, false>,
      (const void*)activate_fwd_kernel<bf16, true, false>,
      (const void*)activate_fwd_kernel<bf16, false, true>,
      (const void*)activate_fwd_kernel<bf16, true, true>,
      (const void*)activate_bwd_kernel<float, false>,
      (const void*)activate_bwd_kernel<float, true>,
      (const void*)activate_bwd_kernel<bf16, false>,
      (const void*)activate_bwd_kernel<bf16, true>};
  for (const void* k : kernels) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The threads of every block; activate_cuda.py checks its plan against it.
int fed_tgan_activate_threads() { return kThreads; }

// K1 on `stream` over an (n_rows, dim) float32 row-major x and u; dim_code
// holds the per-dim codes (segment index, bit 15 = tanh) and seg_start the
// n_seg + 1 segment offsets, each padded to whole 16 bytes.  The launch
// plan (rows_per_tile, staged, smem_bytes) comes from
// activate_cuda.py::launch_plan.  Returns the cudaError_t of the launch
// (0 = launched).
int fed_tgan_activate_fwd(const float* x, const float* u,
                          const uint16_t* dim_code, const int* seg_start,
                          float* out, int n_rows, int dim, int n_seg,
                          int rows_per_tile, int staged, int smem_bytes,
                          void* stream) {
  return launch_fwd<float, false>(x, u, dim_code, seg_start, out, nullptr,
                                  n_rows, dim, n_seg, rows_per_tile, staged,
                                  smem_bytes, (cudaStream_t)stream);
}

// K1 for sampling under bf16: x and out bf16, u float32.  `scratch` is an
// (n_rows, dim) float32 buffer for the unstaged plan's logits (may be null
// when staged).
int fed_tgan_activate_fwd_bf16(const void* x, const float* u,
                               const uint16_t* dim_code, const int* seg_start,
                               void* out, float* scratch, int n_rows, int dim,
                               int n_seg, int rows_per_tile, int staged,
                               int smem_bytes, void* stream) {
  return launch_fwd<bf16, false>(x, u, dim_code, seg_start, out, scratch,
                                 n_rows, dim, n_seg, rows_per_tile, staged,
                                 smem_bytes, (cudaStream_t)stream);
}

// K1 for training under bf16: as fed_tgan_activate_fwd_bf16, and `res`
// (n_rows, dim) float32 receives the result before its rounding.
int fed_tgan_activate_fwd_train_bf16(const void* x, const float* u,
                                     const uint16_t* dim_code,
                                     const int* seg_start, void* out,
                                     float* res, int n_rows, int dim,
                                     int n_seg, int rows_per_tile, int staged,
                                     int smem_bytes, void* stream) {
  return launch_fwd<bf16, true>(x, u, dim_code, seg_start, out, res, n_rows,
                                dim, n_seg, rows_per_tile, staged, smem_bytes,
                                (cudaStream_t)stream);
}

// K2 on `stream`: dx of the activation from the upstream gradient dy and
// the forward output out, both (n_rows, dim) float32 row-major; the other
// arguments as for K1.  Returns the cudaError_t of the launch.
int fed_tgan_activate_bwd(const float* dy, const float* out,
                          const uint16_t* dim_code, const int* seg_start,
                          float* dx, int n_rows, int dim, int n_seg,
                          int rows_per_tile, int staged, int smem_bytes,
                          void* stream) {
  return launch_bwd<float>(dy, out, dim_code, seg_start, dx, n_rows, dim,
                           n_seg, rows_per_tile, staged, smem_bytes,
                           (cudaStream_t)stream);
}

// K2 under bf16: dy and dx bf16, the residual out float32.
int fed_tgan_activate_bwd_bf16(const void* dy, const float* out,
                               const uint16_t* dim_code, const int* seg_start,
                               void* dx, int n_rows, int dim, int n_seg,
                               int rows_per_tile, int staged, int smem_bytes,
                               void* stream) {
  return launch_bwd<bf16>(dy, out, dim_code, seg_start, dx, n_rows, dim, n_seg,
                          rows_per_tile, staged, smem_bytes,
                          (cudaStream_t)stream);
}

const char* fed_tgan_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
