// Fused masked-SGD epilogue over the flat parameter buffer of one client.
//
// Replaces heterofl_tpu/ops/fused_update.py::_pallas_flat
// (_fused_sgd_kernel).  The TPU kernel walks a sequential grid (2, rows/bm)
// over the lane-packed [rows, 128] buffers and carries the global-norm sum
// of squares from phase 0 to phase 1 in a VMEM scalar.  CUDA blocks run in
// parallel, so the reduction is two launches here: launch A writes one
// partial sum of gm^2 per block (a fixed grid of kParts blocks), launch B
// reduces the kParts partials in a fixed order in every block -- no
// atomics, the same bits run to run -- and applies the update.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads g, p, buf and mask
// and writes p and buf, 6 * 4 * n bytes = 268 MB at ResNet-18
// (n = 11,172,170), about 80 us; this design also reads g and mask in
// launch A, 357 MB.  Memory-bound by far (about 10 flops per element), so
// both launches stream 16-byte vectors with neighbouring threads on
// neighbouring addresses, and the update runs in place on p and buf
// (no new buffers, one write each).
//
// Semantics (fused_update.py:153-186), in the reference's expression
// order, built without --use_fast_math and with -fmad=false so no product
// is contracted into an FMA:
//   gm    = (g / denom) * mask
//   scale = min(1, max_norm / (sqrt(sum gm^2) + 1e-6))
//   buf'  = (momentum * buf + gm * scale) + wd * p
//   p'    = p - lr * buf'
// and with has <= 0 nothing is written (p and buf keep their values).
// denom, lr and has are read from the device vector scal[3], so the step
// loop never reads a value back to the host.  With scale == 1 (no clip)
// the elementwise tail is the plain PyTorch chain bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParts = 1024;       // blocks of launch A == partial sums
constexpr int kApplyBlocks = 2048; // blocks of launch B (grid-stride)

__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float sq_masked(float g, float m, float denom) {
  const float gm = (g / denom) * m;
  return gm * gm;
}

__global__ void sgd_norm_partial(const float* __restrict__ g, const float* __restrict__ mask,
                                 const float* __restrict__ scal, long long n,
                                 float* __restrict__ part) {
  const float denom = scal[0];
  const long long n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* m4 = reinterpret_cast<const float4*>(mask);
  float acc = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const float4 gv = g4[i], mv = m4[i];
    acc += sq_masked(gv.x, mv.x, denom);
    acc += sq_masked(gv.y, mv.y, denom);
    acc += sq_masked(gv.z, mv.z, denom);
    acc += sq_masked(gv.w, mv.w, denom);
  }
  if (blockIdx.x == 0) {
    const long long i = 4 * n4 + threadIdx.x;  // the n % 4 tail
    if (i < n) acc += sq_masked(g[i], mask[i], denom);
  }
  __shared__ float sh[kThreads];
  const float tot = block_sum(acc, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = tot;
}

__device__ __forceinline__ void update_one(float gv, float mv, float& pv, float& bv,
                                           float denom, float lr, float scale,
                                           float momentum, float wd) {
  const float gm = (gv / denom) * mv;
  const float nb = momentum * bv + gm * scale + wd * pv;
  pv = pv - lr * nb;
  bv = nb;
}

__global__ void sgd_apply(const float* __restrict__ g, float* __restrict__ p,
                          float* __restrict__ buf, const float* __restrict__ mask,
                          const float* __restrict__ scal, long long n, float momentum,
                          float wd, float max_norm, const float* __restrict__ part) {
  // every block reduces the kParts partials in the same fixed order
  float acc = 0.f;
  for (int i = threadIdx.x; i < kParts; i += kThreads) acc += part[i];
  __shared__ float sh[kThreads];
  const float total = sqrtf(block_sum(acc, sh));
  const float scale = fminf(1.f, max_norm / (total + 1e-6f));
  const float denom = scal[0], lr = scal[1], has = scal[2];
  if (!(has > 0.f)) return;  // all-padding batch: p and buf stay as they are
  const long long n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* m4 = reinterpret_cast<const float4*>(mask);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* b4 = reinterpret_cast<float4*>(buf);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const float4 gv = g4[i], mv = m4[i];
    float4 pv = p4[i], bv = b4[i];
    update_one(gv.x, mv.x, pv.x, bv.x, denom, lr, scale, momentum, wd);
    update_one(gv.y, mv.y, pv.y, bv.y, denom, lr, scale, momentum, wd);
    update_one(gv.z, mv.z, pv.z, bv.z, denom, lr, scale, momentum, wd);
    update_one(gv.w, mv.w, pv.w, bv.w, denom, lr, scale, momentum, wd);
    p4[i] = pv;
    b4[i] = bv;
  }
  if (blockIdx.x == 0) {
    const long long i = 4 * n4 + threadIdx.x;
    if (i < n) {
      float pv = p[i], bv = buf[i];
      update_one(g[i], mask[i], pv, bv, denom, lr, scale, momentum, wd);
      p[i] = pv;
      buf[i] = bv;
    }
  }
}

}  // namespace

extern "C" {

// Floats of scratch (partial sums) one call needs.
long long hfl_sgd_scratch_floats() { return kParts; }

// In place on p and buf.  All four buffers must be 16-byte aligned.
int hfl_fused_sgd(const float* g, float* p, float* buf, const float* mask, const float* scal,
                  float* part, long long n, float momentum, float wd, float max_norm,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sgd_norm_partial<<<kParts, kThreads, 0, s>>>(g, mask, scal, n, part);
  sgd_apply<<<kApplyBlocks, kThreads, 0, s>>>(g, p, buf, mask, scal, n, momentum, wd,
                                              max_norm, part);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
