// Train-time batch norm over a channels-last activation viewed as [M, C].
//
// Replaces heterofl_tpu/ops/pallas_norm.py::_call_fwd (_bn_fwd_kernel) and
// ::_call_bwd (_bn_bwd_kernel).  The TPU kernels walk a sequential grid
// (2, M/bm) and carry the per-channel sums from phase 0 to phase 1 in VMEM
// scratch.  CUDA blocks run in parallel and in no order, so each direction
// is two launches here: launch A writes per-(row tile, channel) partial
// sums, launch B reduces them in a fixed order and applies.  No atomics:
// the result is the same bits run to run.
//
// Bound on an H100 SXM (3.35 TB/s): the forward reads x once and writes y
// once, 2*M*C*4 bytes, 5.2 MB at ResNet-18's largest site (M=10240, C=64,
// batch 10) -- about 1.6 us; this design reads x twice (7.9 MB).  At batch
// 10 every site is far below the time of the two launches themselves, so
// the kernels are launch-latency-bound; the design keeps each launch a
// single pass with coalesced 128-byte row segments (32 channels per warp).
//
// Semantics (pallas_norm.py:45-109): one-pass variance
// var = max(s2/n - mean^2, 0); rows with weight <= 0 are excluded from the
// sums by a select, so a non-finite value in a zero-weight row cannot
// poison the statistics; inv = 1/sqrtf(var + eps) (IEEE sqrt and divide:
// the build uses neither --use_fast_math nor FMA contraction).
// stats is [3, C]: mean, inv, n.
//
// The weight is per sample: row r has weight w[r / P], P = pixels per
// sample, so the [M] expansion is never materialised.

#include <cuda_runtime.h>

namespace {

constexpr int kTileC = 32;  // channels per block (one warp row)
constexpr int kLanesR = 8;  // row lanes per block
constexpr int kTileR = 128; // rows per block

__global__ void bn_fwd_partial(const float* __restrict__ x, const float* __restrict__ w,
                               int P, int M, int C, float* __restrict__ part) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kTileC + tx;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int r0 = tile * kTileR;
  const int r1 = min(r0 + kTileR, M);
  float s1 = 0.f, s2 = 0.f, cnt = 0.f;
  for (int r = r0 + ty; r < r1; r += kLanesR) {
    const float wv = w[r / P];
    float xv = (c < C) ? x[(size_t)r * C + c] : 0.f;
    xv = wv > 0.f ? xv : 0.f;
    s1 += xv * wv;
    s2 += xv * xv * wv;
    cnt += wv;
  }
  __shared__ float sh1[kLanesR][kTileC], sh2[kLanesR][kTileC], shn[kLanesR][kTileC];
  sh1[ty][tx] = s1;
  sh2[ty][tx] = s2;
  shn[ty][tx] = cnt;
  __syncthreads();
  if (ty == 0) {
    float a1 = 0.f, a2 = 0.f, an = 0.f;
    for (int k = 0; k < kLanesR; ++k) {
      a1 += sh1[k][tx];
      a2 += sh2[k][tx];
      an += shn[k][tx];
    }
    if (c < C) {
      part[(size_t)tile * C + c] = a1;
      part[(size_t)(ntiles + tile) * C + c] = a2;
    }
    if (blockIdx.y == 0 && tx == 0) part[(size_t)2 * ntiles * C + tile] = an;
  }
}

// Reduce two [ntiles, C] partial planes (and optionally the [ntiles] count)
// for this block's channel tile, in a fixed order, into shared memory.
__device__ void reduce_partials(const float* __restrict__ pa, const float* __restrict__ pb,
                                const float* __restrict__ pn, int ntiles, int C, int c,
                                float* out_a, float* out_b, float* out_n) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  float a = 0.f, b = 0.f, n = 0.f;
  for (int t = ty; t < ntiles; t += kLanesR) {
    if (c < C) {
      a += pa[(size_t)t * C + c];
      b += pb[(size_t)t * C + c];
    }
    if (pn != nullptr) n += pn[t];
  }
  __shared__ float sha[kLanesR][kTileC], shb[kLanesR][kTileC], shn[kLanesR][kTileC];
  sha[ty][tx] = a;
  shb[ty][tx] = b;
  shn[ty][tx] = n;
  __syncthreads();
  if (ty == 0) {
    float ta = 0.f, tb = 0.f, tn = 0.f;
    for (int k = 0; k < kLanesR; ++k) {
      ta += sha[k][tx];
      tb += shb[k][tx];
      tn += shn[k][tx];
    }
    out_a[tx] = ta;
    out_b[tx] = tb;
    out_n[tx] = tn;
  }
  __syncthreads();
}

__global__ void bn_fwd_apply(const float* __restrict__ x, const float* __restrict__ g,
                             const float* __restrict__ b, int M, int C, float eps,
                             const float* __restrict__ part, float* __restrict__ y,
                             float* __restrict__ stats) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kTileC + tx;
  const int ntiles = gridDim.x;
  __shared__ float s1[kTileC], s2[kTileC], sn[kTileC];
  reduce_partials(part, part + (size_t)ntiles * C, part + (size_t)2 * ntiles * C,
                  ntiles, C, c, s1, s2, sn);
  const float n = fmaxf(sn[tx], 1e-6f);
  const float mean = s1[tx] / n;
  const float var = fmaxf(s2[tx] / n - mean * mean, 0.f);
  const float inv = 1.0f / sqrtf(var + eps);
  if (c >= C) return;
  if (blockIdx.x == 0 && ty == 0) {
    stats[c] = mean;
    stats[C + c] = inv;
    stats[2 * C + c] = n;
  }
  const float gc = g[c], bc = b[c];
  const int r0 = blockIdx.x * kTileR;
  const int r1 = min(r0 + kTileR, M);
  for (int r = r0 + ty; r < r1; r += kLanesR) {
    const size_t i = (size_t)r * C + c;
    y[i] = (x[i] - mean) * inv * gc + bc;
  }
}

__global__ void bn_bwd_partial(const float* __restrict__ x, const float* __restrict__ dy,
                               const float* __restrict__ stats, int M, int C,
                               float* __restrict__ part) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kTileC + tx;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int r0 = tile * kTileR;
  const int r1 = min(r0 + kTileR, M);
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    const float mean = stats[c], inv = stats[C + c];
    for (int r = r0 + ty; r < r1; r += kLanesR) {
      const size_t i = (size_t)r * C + c;
      const float d = dy[i];
      const float xhat = (x[i] - mean) * inv;
      a1 += d;
      a2 += d * xhat;
    }
  }
  __shared__ float sh1[kLanesR][kTileC], sh2[kLanesR][kTileC];
  sh1[ty][tx] = a1;
  sh2[ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < kLanesR; ++k) {
      t1 += sh1[k][tx];
      t2 += sh2[k][tx];
    }
    part[(size_t)tile * C + c] = t1;
    part[(size_t)(ntiles + tile) * C + c] = t2;
  }
}

__global__ void bn_bwd_apply(const float* __restrict__ x, const float* __restrict__ w, int P,
                             const float* __restrict__ g, const float* __restrict__ dy,
                             const float* __restrict__ stats, int M, int C,
                             const float* __restrict__ part, float* __restrict__ dx,
                             float* __restrict__ dg, float* __restrict__ db) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kTileC + tx;
  const int ntiles = gridDim.x;
  __shared__ float t1[kTileC], t2[kTileC], unused[kTileC];
  reduce_partials(part, part + (size_t)ntiles * C, nullptr, ntiles, C, c, t1, t2, unused);
  if (c >= C) return;
  const float a1 = t1[tx], a2 = t2[tx];  // db, dg
  if (blockIdx.x == 0 && ty == 0) {
    dg[c] = a2;
    db[c] = a1;
  }
  const float mean = stats[c], inv = stats[C + c];
  const float n = fmaxf(stats[2 * C + c], 1e-6f);
  const float gc = g[c];
  const int r0 = blockIdx.x * kTileR;
  const int r1 = min(r0 + kTileR, M);
  for (int r = r0 + ty; r < r1; r += kLanesR) {
    const size_t i = (size_t)r * C + c;
    const float wv = w[r / P];
    const float xhat = (x[i] - mean) * inv;
    // dx_k = inv*g*dy_k - w_k*inv/n*(g*db) - w_k*xhat_k*inv/n*(g*dg)
    dx[i] = inv * gc * dy[i] - wv * (inv / n) * (gc * a1) - wv * xhat * (inv / n) * (gc * a2);
  }
}

inline dim3 grid_of(int M, int C) {
  return dim3((M + kTileR - 1) / kTileR, (C + kTileC - 1) / kTileC);
}

}  // namespace

extern "C" {

// Floats of scratch the forward (2*ntiles*C + ntiles) or backward
// (2*ntiles*C) needs at this shape.
long long hfl_bn_scratch_floats(int M, int C) {
  const long long nt = (M + kTileR - 1) / kTileR;
  return 2 * nt * C + nt;
}

int hfl_bn_fwd(const float* x, const float* w, int P, const float* g, const float* b,
               float* y, float* stats, float* part, int M, int C, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(M, C), block(kTileC, kLanesR);
  bn_fwd_partial<<<grid, block, 0, s>>>(x, w, P, M, C, part);
  bn_fwd_apply<<<grid, block, 0, s>>>(x, g, b, M, C, eps, part, y, stats);
  return static_cast<int>(cudaGetLastError());
}

int hfl_bn_bwd(const float* x, const float* w, int P, const float* g, const float* dy,
               const float* stats, float* dx, float* dg, float* db, float* part, int M, int C,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(M, C), block(kTileC, kLanesR);
  bn_bwd_partial<<<grid, block, 0, s>>>(x, dy, stats, M, C, part);
  bn_bwd_apply<<<grid, block, 0, s>>>(x, w, P, g, dy, stats, M, C, part, dx, dg, db);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
