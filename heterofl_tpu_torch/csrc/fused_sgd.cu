// Fused masked-SGD epilogue over the flat parameter buffer of one client.
//
// Replaces heterofl_tpu/ops/fused_update.py::_pallas_flat
// (_fused_sgd_kernel).  The TPU kernel walks a sequential grid (2, rows/bm)
// over the lane-packed [rows, 128] buffers and carries the global-norm sum
// of squares from phase 0 to phase 1 in a VMEM scalar.  CUDA blocks run in
// parallel, so the reduction is two launches here: launch A writes one
// partial sum of gm^2 per block (parts(n) blocks, a function of n alone, at
// most kParts), launch B reduces the parts(n) partials in a fixed order in
// every block -- no atomics, the same bits run to run -- and applies the
// update.
//
// The batched pair (the kernel under jax.vmap over a level's G clients, the
// grouped engine) runs the same two launches over g, p, buf [G, n]
// client-major with a shared mask [n] and scal [G, 3]: grid (parts(n), G)
// for launch A, each block one part of one client's row, and (blocks, G)
// for launch B, each block reducing its own client's partials.  A row is
// cut into the same parts as the one-client kernel's buffer of n entries,
// each thread walking the same 4-element chunks in the same order, so row
// g equals the one-client kernel on client g bit for bit.  Rows start at
// g*n floats, so with n % 4 != 0 they are not 16-byte aligned: the chunks
// are then read as four scalars (the same values in the same order).
// parts(n) keeps about 4 chunks a thread, so a level-e row (n about 44k at
// ResNet-18) takes 11 blocks, not 1,024 mostly idle ones.
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

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kParts = 1024;       // blocks of launch A (partial sums), at most
constexpr int kApplyBlocks = 2048; // blocks of launch B (grid-stride), at most

// Blocks of launch A and of launch B for a row of n entries.
inline int parts_for(long long n) {
  const long long chunks = n / 4, per = 4LL * kThreads;
  const long long p = (chunks + per - 1) / per;
  return static_cast<int>(p < 1 ? 1 : (p > kParts ? kParts : p));
}
inline int apply_blocks_for(long long n) {
  const long long p = (n / 4 + kThreads - 1) / kThreads;
  return static_cast<int>(p < 1 ? 1 : (p > kApplyBlocks ? kApplyBlocks : p));
}

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

// Chunk i (entries 4i..4i+3) of p: one 16-byte load, or four scalar ones.
template <bool kVec4>
__device__ __forceinline__ float4 chunk(const float* __restrict__ p, long long i) {
  if (kVec4) return reinterpret_cast<const float4*>(p)[i];
  return make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
}
template <bool kVec4>
__device__ __forceinline__ void put_chunk(float* __restrict__ p, long long i, const float4& v) {
  if (kVec4) {
    reinterpret_cast<float4*>(p)[i] = v;
  } else {
    p[4 * i] = v.x;
    p[4 * i + 1] = v.y;
    p[4 * i + 2] = v.z;
    p[4 * i + 3] = v.w;
  }
}

// Row blockIdx.y: g and scal at that client's row, part at its kParts slots.
template <bool kVec4>
__global__ void sgd_norm_partial(const float* __restrict__ g, const float* __restrict__ mask,
                                 const float* __restrict__ scal, long long n,
                                 float* __restrict__ part) {
  const long long row = blockIdx.y;
  g += row * n;
  const float denom = scal[3 * row];
  const long long n4 = n / 4;
  float acc = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const float4 gv = chunk<kVec4>(g, i), mv = chunk<kVec4>(mask, i);
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
  if (threadIdx.x == 0) part[row * kParts + blockIdx.x] = tot;
}

__device__ __forceinline__ void update_one(float gv, float mv, float& pv, float& bv,
                                           float denom, float lr, float scale,
                                           float momentum, float wd) {
  const float gm = (gv / denom) * mv;
  const float nb = momentum * bv + gm * scale + wd * pv;
  pv = pv - lr * nb;
  bv = nb;
}

template <bool kVec4>
__global__ void sgd_apply(const float* __restrict__ g, float* __restrict__ p,
                          float* __restrict__ buf, const float* __restrict__ mask,
                          const float* __restrict__ scal, long long n, float momentum,
                          float wd, float max_norm, const float* __restrict__ part, int parts) {
  const long long row = blockIdx.y;
  g += row * n;
  p += row * n;
  buf += row * n;
  scal += 3 * row;
  part += row * kParts;
  // every block of the row reduces its parts partials in the same fixed order
  float acc = 0.f;
  for (int i = threadIdx.x; i < parts; i += kThreads) acc += part[i];
  __shared__ float sh[kThreads];
  const float total = sqrtf(block_sum(acc, sh));
  const float scale = fminf(1.f, max_norm / (total + 1e-6f));
  const float denom = scal[0], lr = scal[1], has = scal[2];
  if (!(has > 0.f)) return;  // all-padding batch: p and buf stay as they are
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const float4 gv = chunk<kVec4>(g, i), mv = chunk<kVec4>(mask, i);
    float4 pv = chunk<kVec4>(p, i), bv = chunk<kVec4>(buf, i);
    update_one(gv.x, mv.x, pv.x, bv.x, denom, lr, scale, momentum, wd);
    update_one(gv.y, mv.y, pv.y, bv.y, denom, lr, scale, momentum, wd);
    update_one(gv.z, mv.z, pv.z, bv.z, denom, lr, scale, momentum, wd);
    update_one(gv.w, mv.w, pv.w, bv.w, denom, lr, scale, momentum, wd);
    put_chunk<kVec4>(p, i, pv);
    put_chunk<kVec4>(buf, i, bv);
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

inline bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

// rows of n entries each: the two launches
int run(const float* g, float* p, float* buf, const float* mask, const float* scal,
        float* part, long long n, int rows, float momentum, float wd, float max_norm,
        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = parts_for(n);
  const dim3 grid_a(parts, rows), grid_b(apply_blocks_for(n), rows);
  const bool vec4 = (rows == 1 || n % 4 == 0) && aligned16(g) && aligned16(p) &&
                    aligned16(buf) && aligned16(mask);
  if (vec4) {
    sgd_norm_partial<true><<<grid_a, kThreads, 0, s>>>(g, mask, scal, n, part);
    sgd_apply<true><<<grid_b, kThreads, 0, s>>>(g, p, buf, mask, scal, n, momentum, wd,
                                                max_norm, part, parts);
  } else {
    sgd_norm_partial<false><<<grid_a, kThreads, 0, s>>>(g, mask, scal, n, part);
    sgd_apply<false><<<grid_b, kThreads, 0, s>>>(g, p, buf, mask, scal, n, momentum, wd,
                                                 max_norm, part, parts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch (partial sums) one row of a call needs.
long long hfl_sgd_scratch_floats() { return kParts; }

// In place on p and buf [n].  All four buffers must be 16-byte aligned.
int hfl_fused_sgd(const float* g, float* p, float* buf, const float* mask, const float* scal,
                  float* part, long long n, float momentum, float wd, float max_norm,
                  void* stream) {
  return run(g, p, buf, mask, scal, part, n, 1, momentum, wd, max_norm, stream);
}

// Batched: in place on p and buf [G, n] client-major; mask [n] shared, scal
// [G, 3], part G * kParts floats.
int hfl_fused_sgd_batched(const float* g, float* p, float* buf, const float* mask,
                          const float* scal, float* part, long long n, int G, float momentum,
                          float wd, float max_norm, void* stream) {
  if (G < 1 || G > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run(g, p, buf, mask, scal, part, n, G, momentum, wd, max_norm, stream);
}

}  // extern "C"
