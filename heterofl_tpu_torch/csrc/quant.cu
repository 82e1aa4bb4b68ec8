// Stochastic-round quantisation and 4 x 8-bit lane packing: the int8 wire
// codec's encode pass.
//
// Replaces heterofl_tpu/ops/quant.py::_quant_pack_pallas
// (_quant_pack_kernel).  The TPU kernel pads x, s and u into a lane-dense
// [rows, 128] copy (x = 0, s = 1, u = 0 in the padding) and walks row blocks
// of it.  Here there is no padded copy and no tail launch: each thread of a
// grid-stride loop owns one output word, i.e. four consecutive elements,
// and lanes past n are left zero -- as the plain version (and the
// reference's XLA path, pack_lanes) pads, where the Pallas path's padding
// lanes carry `bias`.
//
// Per element, in the reference's order (built without --use_fast_math and
// with -fmad=false, so the division is IEEE-rounded and nothing contracts):
//   q = clamp(floorf(x / s + u), -qmax, qmax)      (int32)
// and per word
//   word = (q0+bias) | (q1+bias) << 8 | (q2+bias) << 16 | (q3+bias) << 24
// with the shifts done in uint32 (a shift into bit 31 of a signed int is
// undefined behaviour in C++).
//
// Bound on an H100 SXM (3.35 TB/s): the function reads x, s and u (12 n
// bytes) and writes q (4 n) and the words (n): 17 n bytes, 189.9 MB at
// ResNet-18's n = 11,172,170, about 57 us.  About ten operations per
// element, so it is memory-bound by far.  A full word reads its twelve
// inputs as three 16-byte vectors and writes its four q as one; neighbouring
// threads own neighbouring words, so every access is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

__device__ __forceinline__ int quantize(float x, float s, float u, float qmax) {
  const float t = floorf(x / s + u);
  return static_cast<int>(fminf(fmaxf(t, -qmax), qmax));
}

__device__ __forceinline__ uint32_t lane(int q, int bias, int k) {
  return static_cast<uint32_t>(q + bias) << (8 * k);
}

__global__ void quant_pack(const float* __restrict__ x, const float* __restrict__ s,
                           const float* __restrict__ u, long long n, int qmax, int bias,
                           int* __restrict__ q, int* __restrict__ words) {
  const float fq = static_cast<float>(qmax);
  const long long full = n / 4;           // words whose four lanes are all real
  const long long nw = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nw; i += stride) {
    uint32_t w = 0;
    if (i < full) {
      const float4 xv = reinterpret_cast<const float4*>(x)[i];
      const float4 sv = reinterpret_cast<const float4*>(s)[i];
      const float4 uv = reinterpret_cast<const float4*>(u)[i];
      int4 qv;
      qv.x = quantize(xv.x, sv.x, uv.x, fq);
      qv.y = quantize(xv.y, sv.y, uv.y, fq);
      qv.z = quantize(xv.z, sv.z, uv.z, fq);
      qv.w = quantize(xv.w, sv.w, uv.w, fq);
      reinterpret_cast<int4*>(q)[i] = qv;
      w = lane(qv.x, bias, 0) | lane(qv.y, bias, 1) | lane(qv.z, bias, 2) | lane(qv.w, bias, 3);
    } else {  // the last word when n % 4 != 0: lanes past n stay zero
      for (int k = 0; k < 4; ++k) {
        const long long e = 4 * i + k;
        if (e < n) {
          const int qk = quantize(x[e], s[e], u[e], fq);
          q[e] = qk;
          w |= lane(qk, bias, k);
        }
      }
    }
    words[i] = static_cast<int>(w);
  }
}

}  // namespace

extern "C" {

// q [n] and words [ceil(n/4)] are written; x, s, u, q and words must be
// 16-byte aligned.  0 <= q + bias <= 255 is the caller's contract
// (qmax < bias <= 255 - qmax).
int hfl_quant_pack(const float* x, const float* s, const float* u, long long n, int qmax,
                   int bias, int* q, int* words, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long nw = (n + 3) / 4;
  long long blocks = (nw + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quant_pack<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, s, u, n, qmax, bias, q, words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
