// Train-time batch norm over a channels-last activation viewed as [M, C]:
// one launch per direction, a thread-block cluster per channel tile.
//
// Replaces heterofl_tpu/ops/pallas_norm.py::_call_fwd (_bn_fwd_kernel) and
// ::_call_bwd (_bn_bwd_kernel).  The TPU kernels walk a sequential grid
// (2, M/bm) and carry the per-channel sums from phase 0 to phase 1 in VMEM
// scratch.  CUDA blocks run in parallel and in no order, so the sums need a
// reduction across blocks.  Here one cluster of up to 16 blocks owns one
// channel tile and spans all rows: each block sums its rows, pushes its sums
// into every peer's shared memory (st.async, counted by the peer's
// transaction barrier: a remote write with no round trip and no
// cluster-wide release fence), and sums the cluster's rows in rank order
// from its own shared memory.  Why not the alternatives: a second launch (a
// partial pass, then a reduce-and-apply pass, as this port first did) costs
// a launch's latency, more than the whole work at batch 10, and re-reads
// the inputs; atomics would make the sum's order, so its bits, change from
// run to run.  Here the order -- each thread's rows in order, a butterfly
// over the warp, the warps in order, the cluster ranks in order -- is fixed
// by the launch plan, a pure function of (M, C) (ops/fused_norm.py::
// bn_plan): the same bits every run.
//
// Bound on an H100 SXM (3.35 TB/s): the forward reads x and writes y,
// 8*M*C bytes; the backward reads x and dy and writes dx, 12*M*C bytes.  At
// ResNet-18's sites at batch 10 that is 0.2-1.6 us forward and 0.3-2.3 us
// backward per site (M*C = 655,360 at the largest): below the latency of
// the launch and of the one cross-block exchange, which bound these
// kernels.  So each thread issues the loads of kBatch row iterations
// together (16 bytes each), keeps those rows in registers (further ones in
// shared memory) across the exchange, and writes the output from that
// copy: each input is read from device memory once.  When a block's rows
// do not fit in shared memory (the plan says so: `resident` 0), the same
// launch reads the rows past the first kBatch iterations again (from L2 at
// these sizes).
//
// Semantics (pallas_norm.py:45-109): one-pass variance
// var = max(s2/n - mean^2, 0); rows with weight <= 0 are excluded from the
// sums by a select, so a non-finite value in a zero-weight row cannot
// poison the statistics; inv = 1/sqrtf(var + eps) (IEEE sqrt and divide:
// the build uses neither --use_fast_math nor FMA contraction).
// stats is [3, C]: mean, inv, n.  The backward's dx is the reference's
// formula in its order; the sample weight gets no gradient.
//
// The weight is per sample: row r has weight w[r / P], P = pixels per
// sample, so the [M] expansion is never materialised.
//
// The batched kernels (1b, 2b: the Pallas kernels under jax.vmap over a
// level's G clients, the grouped engine) take x [M, G*Cg], a grouped
// convolution's clients-in-channels output: column c belongs to client
// c / Cg and takes that client's weight of its sample, w[(c / Cg) * B + r /
// P] with w [G, B].  Each column then has its own count, so the forward's
// sums are three per channel (s1, s2, n), and stats' n row is per channel.
// A channel tile may straddle clients (at level e ResNet-18's stages are 4 to
// 32 channels wide, the tiles at least 8), so each thread resolves the
// weight of each of its four columns.  The rows, the exchange and the order
// of every sum are the one-client kernels'; the plan is
// fused_norm.bn_plan_batched.  What differs is where the weights come from:
// each block first copies the few it needs -- for each client its tile
// touches, the samples its rows span -- into its shared memory (Stage),
// with its loads in flight beside the first rows', so no row loop reads a
// weight from device memory and the backward reads none after its exchange.
// They go out as programmatic dependent launches (fused_norm.BN_BATCHED_PDL):
// a launch may start while the kernel before it on the stream ends, and
// reads no input before griddep_wait.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileC = 128;             // channels per cluster: 32 lanes of 4
constexpr int kSlots = 2 * kMaxTileC + 1;  // two sums per channel, then the count
constexpr int kSlotsCol = 3 * kMaxTileC;   // batched: three sums per channel
constexpr int kBatch = 8;                  // row iterations with their loads in flight together
// the batched kernels' row iterations in flight: fewer, for a shorter kernel
// (its unrolled batches are most of its instructions), the same bytes in
// flight a thread each way -- 4 rows of x forward, 2 of x and dy backward
// (scripts/bn_plan_sweep.py --roots timed 2, 4 and 8 against each other)
constexpr int kBatchFwdB = 4;
constexpr int kBatchBwdB = 2;
constexpr int kSmemLimit = 232448;         // shared memory one block may use on Hopper
constexpr int kMaxCluster = 16;            // blocks per cluster (above 8: non-portable)

struct F4 {
  float v[4];
};

// Four consecutive channels c..c+3 of one row at p + i (i = r*C + c); zero
// past C.  With kVec4 (C % 4 == 0, 16-byte aligned) one 16-byte access.
template <bool kVec4>
__device__ __forceinline__ F4 load4(const float* __restrict__ p, size_t i, int c, int C) {
  F4 o;
  if (kVec4) {
    const float4 t = c < C ? *reinterpret_cast<const float4*>(p + i)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    o.v[0] = t.x;
    o.v[1] = t.y;
    o.v[2] = t.z;
    o.v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) o.v[j] = c + j < C ? p[i + j] : 0.f;
  }
  return o;
}

template <bool kVec4>
__device__ __forceinline__ void store4(float* __restrict__ p, size_t i, int c, int C,
                                       const F4& o) {
  if (kVec4) {
    if (c < C) *reinterpret_cast<float4*>(p + i) = make_float4(o.v[0], o.v[1], o.v[2], o.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < C) p[i + j] = o.v[j];
  }
}

__device__ __forceinline__ float4 pack(const F4& o) {
  return make_float4(o.v[0], o.v[1], o.v[2], o.v[3]);
}

__device__ __forceinline__ F4 unpack(const float4& t) { return F4{{t.x, t.y, t.z, t.w}}; }

// Per-channel values of this thread's four channels; zero past C.
__device__ __forceinline__ void channel4(float (&v)[4], const float* __restrict__ p, int c, int C) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < C ? p[c + j] : 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cluster barrier, split and relaxed: it orders no memory, it only says
// that every block of the cluster runs, so its shared memory may be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Wait until the grids this one depends on have ended and their writes are
// visible: a programmatic dependent launch's first read of what they may have
// written comes after it.  Without that launch attribute it returns at once.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A transaction barrier in this block's shared memory: one arrival (thread
// 0's, with the bytes to expect), then complete when that many bytes have
// landed from the peers' st.async pushes.  Used once, so phase 0.
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t a = smem_addr(bar), one = 1;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(one) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const uint32_t a = smem_addr(bar), phase = 0;
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(a), "r"(phase) : "memory");
}
// Store v at p's place in block `rank`'s shared memory, counted by that
// block's barrier at bar's place: a remote write with no round trip.
__device__ __forceinline__ void push(const float* p, uint64_t* bar, unsigned rank, float v) {
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rp) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(rp), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

// Which rows and channels a thread owns.  The block is `groups` = tile_c/4
// lanes of four channels by `lanes` = 256/groups rows; thread t holds
// channels c..c+3 and rows r0 + rl + k*lanes, k < iters, below r1.  The
// cluster's blocks split the rows: block rank q has rows [q*rows, q*rows +
// rows) of M.
struct Layout {
  int t, grp, rl, lanes, c, r0, r1, iters;
  __device__ Layout(unsigned rank, int tile_c, int rows, int M, int iters_)
      : iters(iters_) {
    t = threadIdx.x;
    const int log2g = __ffs(tile_c) - 3;  // groups = tile_c / 4, a power of two
    grp = t & ((1 << log2g) - 1);
    rl = t >> log2g;
    lanes = kThreads >> log2g;
    c = blockIdx.y * tile_c + 4 * grp;
    r0 = static_cast<int>(rank) * rows;
    r1 = min(r0 + rows, M);
  }
  __device__ __forceinline__ int row(int k) const { return r0 + rl + k * lanes; }
  __device__ __forceinline__ bool has(int k) const { return k < iters && row(k) < r1; }
};

// The sample of a thread's rows in order, row(k) = s*P + rem, stepped by
// `lanes` rows without a division per row.
struct SampleWalk {
  int s, rem, dq, dr, P;
  __device__ SampleWalk(const Layout& L, int P_) : P(P_) {
    const int r = L.row(0);
    s = r / P;
    rem = r - s * P;
    dq = L.lanes / P;
    dr = L.lanes - dq * P;
  }
  __device__ __forceinline__ void next() {
    s += dq;
    rem += dr;
    if (rem >= P) {
      rem -= P;
      ++s;
    }
  }
};

// The cluster's per-channel sums.  On construction thread 0 sets up the
// block's barrier for nb rows of nslots floats and the block arrives at the
// cluster barrier.  sum() adds each thread's kN values over the threads of
// its channel lane in a fixed order -- a butterfly over the warp's row lanes,
// then the warps in order -- (slots [0, tile_c) take v[0..3], [tile_c,
// 2*tile_c) v[4..7], slot 2*tile_c v[8], the count, the same in every lane)
// (batched: slots [2*tile_c, 3*tile_c) take v[8..11], a count per channel)
// and, once every peer runs, pushes the block's row into gather[rank] of
// every block of the cluster; the readers (t < tile_c) return when all nb
// rows have landed.  After the block has its rows it arrives again (done),
// and it waits for that barrier just before it leaves (finish): every push
// has landed before any block exits.
struct Exchange {
  uint64_t* bar;
  unsigned nb, rank;
  int nslots;
  __device__ Exchange(cg::cluster_group& cluster, uint64_t* bar_, int nslots_, int t)
      : bar(bar_), nb(cluster.num_blocks()), rank(cluster.block_rank()), nslots(nslots_) {
    if (nb > 1) {
      if (t == 0) mbar_init_expect(bar, nb * nslots * sizeof(float));
      cluster_arrive_relaxed();
    }
  }
  template <int kN, int kS>
  __device__ __forceinline__ void sum(float (&v)[kN], int tile_c, const Layout& L,
                                      float (*wsum)[kS], float (*gather)[kS]) {
    const int groups = tile_c >> 2;
    for (int off = groups; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
    const int lane = L.t & 31, warp = L.t >> 5;
    if (lane < groups) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (kN != 9 || j < 8) wsum[warp][(j >> 2) * tile_c + 4 * L.grp + (j & 3)] = v[j];
        else if (L.grp == 0) wsum[warp][2 * tile_c] = v[j];
      }
    }
    if (nb > 1) cluster_wait();  // every peer runs and has set up its barrier
    __syncthreads();
    for (int s = L.t; s < nslots; s += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) a += wsum[k][s];
      if (nb > 1) {
        for (unsigned q = 0; q < nb; ++q) push(&gather[rank][s], bar, q, a);
      } else {
        gather[0][s] = a;
      }
    }
    if (nb == 1) __syncthreads();
    else if (L.t < tile_c) mbar_wait(bar);
  }
  __device__ __forceinline__ void done() const {
    if (nb > 1) cluster_arrive_relaxed();
  }
  __device__ __forceinline__ void finish() const {
    if (nb > 1) cluster_wait();
  }
};

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
bn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w, int P,
              const float* __restrict__ g, const float* __restrict__ b,
              float* __restrict__ y, float* __restrict__ stats, int M, int C, float eps,
              int tile_c, int rows, int iters, int resident) {
  extern __shared__ float4 stash[];  // [iters - kBatch][kThreads] of x when resident
  __shared__ float wsum[kWarps][kSlots];
  __shared__ float gather[kMaxCluster][kSlots];  // every cluster block's sums, by rank
  __shared__ float coef[2][kMaxTileC];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  Exchange ex(cluster, &bar, 2 * tile_c + 1, threadIdx.x);
  const Layout L(cluster.block_rank(), tile_c, rows, M, iters);
  float gg[4], bb[4];
  channel4(gg, g, L.c, C);
  channel4(bb, b, L.c, C);
  SampleWalk sw(L, P);
  float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // s1[4], s2[4], n

  // kBatch row iterations from k0: loads all in flight, then the sums in order
  auto load = [&](int k0, F4 (&xv)[kBatch], float (&wv)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = L.has(k0 + u);
      wv[u] = in ? w[sw.s] : 0.f;
      sw.next();
      xv[u] = in ? load4<kVec4>(x, (size_t)L.row(k0 + u) * C + L.c, L.c, C) : F4{};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!L.has(k0 + u)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xs = wv[u] > 0.f ? xv[u].v[j] : 0.f;
        v[j] += xs * wv[u];
        v[4 + j] += xs * xs * wv[u];
      }
      v[8] += wv[u];
    }
  };
  auto normalise = [&](int k0, const F4 (&xv)[kBatch], const float (&mu)[4],
                       const float (&iv)[4]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!L.has(k0 + u)) continue;
      F4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j) o.v[j] = (xv[u].v[j] - mu[j]) * iv[j] * gg[j] + bb[j];
      store4<kVec4>(y, (size_t)L.row(k0 + u) * C + L.c, L.c, C, o);
    }
  };

  // 1. this block's rows: weighted sums; the first kBatch iterations stay in
  // registers, the rest in shared memory when resident
  F4 xr[kBatch];
  {
    float wv[kBatch];
    load(0, xr, wv);
  }
  for (int k0 = kBatch; k0 < iters; k0 += kBatch) {
    F4 xv[kBatch];
    float wv[kBatch];
    load(k0, xv, wv);
    if (resident) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (L.has(k0 + u)) stash[(k0 + u - kBatch) * kThreads + L.t] = pack(xv[u]);
    }
  }

  // 2. the cluster's sums, ranks in order, then the channel statistics
  ex.sum<9, kSlots>(v, tile_c, L, wsum, gather);
  if (L.t < tile_c) {
    float s1 = 0.f, s2 = 0.f, n = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {  // unrolled: every load issued before the sums
      if (q < static_cast<int>(ex.nb)) {
        s1 += gather[q][L.t];
        s2 += gather[q][tile_c + L.t];
        n += gather[q][2 * tile_c];
      }
    }
    n = fmaxf(n, 1e-6f);
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float inv = 1.0f / sqrtf(var + eps);
    coef[0][L.t] = mean;
    coef[1][L.t] = inv;
    const int ch = blockIdx.y * tile_c + L.t;
    if (ex.rank == 0 && ch < C) {
      stats[ch] = mean;
      stats[C + ch] = inv;
      stats[2 * C + ch] = n;
    }
  }
  __syncthreads();
  ex.done();

  // 3. normalise the rows this block holds
  float mu[4], iv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mu[j] = coef[0][4 * L.grp + j];
    iv[j] = coef[1][4 * L.grp + j];
  }
  normalise(0, xr, mu, iv);
  for (int k0 = kBatch; k0 < iters; k0 += kBatch) {
    F4 xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!L.has(k0 + u)) continue;
      xv[u] = resident ? unpack(stash[(k0 + u - kBatch) * kThreads + L.t])
                       : load4<kVec4>(x, (size_t)L.row(k0 + u) * C + L.c, L.c, C);
    }
    normalise(k0, xv, mu, iv);
  }
  ex.finish();
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w, int P,
              const float* __restrict__ g, const float* __restrict__ dy,
              const float* __restrict__ stats, float* __restrict__ dx,
              float* __restrict__ dg, float* __restrict__ db, int M, int C, int tile_c,
              int rows, int iters, int resident) {
  // [2][iters - kBatch][kThreads]: x, then dy, when resident
  extern __shared__ float4 stash[];
  __shared__ float wsum[kWarps][kSlots];
  __shared__ float gather[kMaxCluster][kSlots];
  __shared__ float coef[2][kMaxTileC];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  Exchange ex(cluster, &bar, 2 * tile_c, threadIdx.x);
  const Layout L(cluster.block_rank(), tile_c, rows, M, iters);
  float4* const stash_dy = stash + (size_t)max(iters - kBatch, 0) * kThreads;
  float mu[4], iv[4], nn[4], gg[4];
  channel4(mu, stats, L.c, C);
  channel4(iv, stats + C, L.c, C);
  channel4(nn, stats + 2 * C, L.c, C);
  channel4(gg, g, L.c, C);
#pragma unroll
  for (int j = 0; j < 4; ++j) nn[j] = fmaxf(nn[j], 1e-6f);
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // db[4], dg[4]

  // kBatch row iterations from k0: loads all in flight, then the sums in order
  auto load = [&](int k0, F4 (&xv)[kBatch], F4 (&dv)[kBatch]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = L.has(k0 + u);
      const size_t i = (size_t)L.row(k0 + u) * C + L.c;
      xv[u] = in ? load4<kVec4>(x, i, L.c, C) : F4{};
      dv[u] = in ? load4<kVec4>(dy, i, L.c, C) : F4{};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!L.has(k0 + u)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xhat = (xv[u].v[j] - mu[j]) * iv[j];
        v[j] += dv[u].v[j];
        v[4 + j] += dv[u].v[j] * xhat;
      }
    }
  };
  SampleWalk sw(L, P);
  auto grad = [&](int k0, const F4 (&xv)[kBatch], const F4 (&dv)[kBatch], const float (&a1)[4],
                  const float (&a2)[4]) {
    float wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      wv[u] = L.has(k0 + u) ? w[sw.s] : 0.f;
      sw.next();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!L.has(k0 + u)) continue;
      F4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xhat = (xv[u].v[j] - mu[j]) * iv[j];
        // dx_k = inv*g*dy_k - w_k*inv/n*(g*db) - w_k*xhat_k*inv/n*(g*dg)
        o.v[j] = iv[j] * gg[j] * dv[u].v[j] - wv[u] * (iv[j] / nn[j]) * (gg[j] * a1[j])
                 - wv[u] * xhat * (iv[j] / nn[j]) * (gg[j] * a2[j]);
      }
      store4<kVec4>(dx, (size_t)L.row(k0 + u) * C + L.c, L.c, C, o);
    }
  };

  // 1. this block's rows: db = sum dy, dg = sum dy * xhat; the first kBatch
  // iterations stay in registers, the rest in shared memory when resident
  F4 xr[kBatch], dr[kBatch];
  load(0, xr, dr);
  for (int k0 = kBatch; k0 < iters; k0 += kBatch) {
    F4 xv[kBatch], dv[kBatch];
    load(k0, xv, dv);
    if (resident) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!L.has(k0 + u)) continue;
        stash[(k0 + u - kBatch) * kThreads + L.t] = pack(xv[u]);
        stash_dy[(k0 + u - kBatch) * kThreads + L.t] = pack(dv[u]);
      }
    }
  }

  // 2. the cluster's sums, ranks in order
  ex.sum<8, kSlots>(v, tile_c, L, wsum, gather);
  if (L.t < tile_c) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < static_cast<int>(ex.nb)) {
        a1 += gather[q][L.t];
        a2 += gather[q][tile_c + L.t];
      }
    }
    coef[0][L.t] = a1;
    coef[1][L.t] = a2;
    const int ch = blockIdx.y * tile_c + L.t;
    if (ex.rank == 0 && ch < C) {
      db[ch] = a1;
      dg[ch] = a2;
    }
  }
  __syncthreads();
  ex.done();

  // 3. dx for the rows this block holds
  float a1[4], a2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a1[j] = coef[0][4 * L.grp + j];
    a2[j] = coef[1][4 * L.grp + j];
  }
  grad(0, xr, dr, a1, a2);
  for (int k0 = kBatch; k0 < iters; k0 += kBatch) {
    F4 xv[kBatch], dv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!L.has(k0 + u)) continue;
      const size_t i = (size_t)L.row(k0 + u) * C + L.c;
      xv[u] = resident ? unpack(stash[(k0 + u - kBatch) * kThreads + L.t])
                       : load4<kVec4>(x, i, L.c, C);
      dv[u] = resident ? unpack(stash_dy[(k0 + u - kBatch) * kThreads + L.t])
                       : load4<kVec4>(dy, i, L.c, C);
    }
    grad(k0, xv, dv, a1, a2);
  }
  ex.finish();
}

// -- the batched kernels (1b, 2b) ----------------------------------------------

// The weights a block of a batched kernel reads, staged in its shared memory
// once: for each client its channel tile touches (c_lo..c_lo + nc - 1), the
// samples its rows span (s_lo..s_lo + ns - 1), stage[(client - c_lo) * ns +
// sample - s_lo] = w[client * B + sample].
// Its integer divisions come before the kernel's first load: a warp issues
// in order, and a division's chain would hold the loads behind it.
struct Stage {
  int c_lo, s_lo, ns, n, i0;  // i0: where thread t's first element lies in w
  __device__ Stage(const Layout& L, int tile_c, int C, int Cg, int P, int B) {
    const int c0 = blockIdx.y * tile_c;
    c_lo = c0 / Cg;
    s_lo = L.r0 / P;
    ns = L.r0 < L.r1 ? (L.r1 - 1) / P - s_lo + 1 : 0;
    n = ((min(C, c0 + tile_c) - 1) / Cg - c_lo + 1) * ns;
    i0 = L.t < n ? (c_lo + L.t / ns) * B + s_lo + L.t % ns : 0;
  }
  __device__ __forceinline__ float fetch(const float* __restrict__ w, int i, int B) const {
    return w[(c_lo + i / ns) * B + s_lo + i % ns];
  }
  // where a thread's four columns find sample s: stage[wb[j] + s] (a column
  // past C reads a weight of the block's, and is never written)
  __device__ __forceinline__ void bases(int (&wb)[4], int c, int C, int Cg) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) wb[j] = (c + j < C ? ((c + j) / Cg - c_lo) * ns : 0) - s_lo;
  }
  // thread t's first element, loaded with the first rows; the rest, if any, after
  __device__ __forceinline__ float first(const float* __restrict__ w, int t) const {
    return t < n ? w[i0] : 0.f;
  }
  __device__ __forceinline__ void store(float* stage, const float* __restrict__ w, int t, int B,
                                        float w0) const {
    if (t < n) stage[t] = w0;
    for (int i = t + kThreads; i < n; i += kThreads) stage[i] = fetch(w, i, B);
  }
};

__device__ __forceinline__ void stage_weights4(float (&wv)[4], const float* stage,
                                               const int (&wb)[4], int s, bool in) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wv[j] = in ? stage[wb[j] + s] : 0.f;
}

// The batched forward: the one-client forward's rows, exchange and order, with
// a count per channel (three sums a channel) and each column's weight read
// from the block's stage.  Every read of an input follows griddep_wait; the
// first batch of x loads is in flight while the stage is written.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
bn_fwd_batched_kernel(const float* __restrict__ x, const float* __restrict__ w, int P, int B,
                      int Cg, const float* __restrict__ g, const float* __restrict__ b,
                      float* __restrict__ y, float* __restrict__ stats, int M, int C, float eps,
                      int tile_c, int rows, int iters, int resident) {
  constexpr int kB = kBatchFwdB;
  // [iters - kB][kThreads] of x when resident, then the stage
  extern __shared__ float4 stash[];
  __shared__ float wsum[kWarps][kSlotsCol];
  __shared__ float gather[kMaxCluster][kSlotsCol];
  __shared__ float coef[2][kMaxTileC];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  Exchange ex(cluster, &bar, 3 * tile_c, threadIdx.x);
  const Layout L(cluster.block_rank(), tile_c, rows, M, iters);
  const Stage st(L, tile_c, C, Cg, P, B);
  float* const stage =
      reinterpret_cast<float*>(stash + (resident ? (size_t)max(iters - kB, 0) * kThreads : 0));
  int wb[4];
  st.bases(wb, L.c, C, Cg);
  SampleWalk sw(L, P);
  float gg[4], bb[4];
  float v[12];  // s1[4], s2[4], n[4]
#pragma unroll
  for (int j = 0; j < 12; ++j) v[j] = 0.f;

  auto load_rows = [&](int k0, F4 (&xv)[kB]) {
#pragma unroll
    for (int u = 0; u < kB; ++u)
      xv[u] = L.has(k0 + u) ? load4<kVec4>(x, (size_t)L.row(k0 + u) * C + L.c, L.c, C) : F4{};
  };
  // the sums of kB row iterations from k0, in order
  auto accumulate = [&](int k0, const F4 (&xv)[kB]) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const bool in = L.has(k0 + u);
      float wv[4];
      stage_weights4(wv, stage, wb, sw.s, in);
      sw.next();
      if (!in) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xs = wv[j] > 0.f ? xv[u].v[j] : 0.f;
        v[j] += xs * wv[j];
        v[4 + j] += xs * xs * wv[j];
        v[8 + j] += wv[j];
      }
    }
  };
  auto normalise = [&](int k0, const F4 (&xv)[kB], const float (&mu)[4],
                       const float (&iv)[4]) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (!L.has(k0 + u)) continue;
      F4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j) o.v[j] = (xv[u].v[j] - mu[j]) * iv[j] * gg[j] + bb[j];
      store4<kVec4>(y, (size_t)L.row(k0 + u) * C + L.c, L.c, C, o);
    }
  };

  // 1. this block's rows: the first kB iterations' loads go out, the
  // stage is written, then the weighted sums; the first kB iterations
  // stay in registers, the rest in shared memory when resident
  griddep_wait();
  F4 xr[kB];
  load_rows(0, xr);
  const float w0 = st.first(w, L.t);
  channel4(gg, g, L.c, C);
  channel4(bb, b, L.c, C);
  st.store(stage, w, L.t, B, w0);
  __syncthreads();
  accumulate(0, xr);
  for (int k0 = kB; k0 < iters; k0 += kB) {
    F4 xv[kB];
    load_rows(k0, xv);
    accumulate(k0, xv);
    if (resident) {
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (L.has(k0 + u)) stash[(k0 + u - kB) * kThreads + L.t] = pack(xv[u]);
    }
  }

  // 2. the cluster's sums, ranks in order, then the channel statistics
  ex.sum<12, kSlotsCol>(v, tile_c, L, wsum, gather);
  if (L.t < tile_c) {
    float s1 = 0.f, s2 = 0.f, n = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < static_cast<int>(ex.nb)) {
        s1 += gather[q][L.t];
        s2 += gather[q][tile_c + L.t];
        n += gather[q][2 * tile_c + L.t];
      }
    }
    n = fmaxf(n, 1e-6f);
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float inv = 1.0f / sqrtf(var + eps);
    coef[0][L.t] = mean;
    coef[1][L.t] = inv;
    const int ch = blockIdx.y * tile_c + L.t;
    if (ex.rank == 0 && ch < C) {
      stats[ch] = mean;
      stats[C + ch] = inv;
      stats[2 * C + ch] = n;
    }
  }
  __syncthreads();
  ex.done();

  // 3. normalise the rows this block holds
  float mu[4], iv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mu[j] = coef[0][4 * L.grp + j];
    iv[j] = coef[1][4 * L.grp + j];
  }
  normalise(0, xr, mu, iv);
  for (int k0 = kB; k0 < iters; k0 += kB) {
    F4 xv[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (!L.has(k0 + u)) continue;
      xv[u] = resident ? unpack(stash[(k0 + u - kB) * kThreads + L.t])
                       : load4<kVec4>(x, (size_t)L.row(k0 + u) * C + L.c, L.c, C);
    }
    normalise(k0, xv, mu, iv);
  }
  ex.finish();
}

// The batched backward: the one-client backward with each column's weight
// read from the block's stage, which is written before the exchange (its
// loads in flight with the first rows'), so no weight is read from device
// memory after it.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
bn_bwd_batched_kernel(const float* __restrict__ x, const float* __restrict__ w, int P, int B,
                      int Cg, const float* __restrict__ g, const float* __restrict__ dy,
                      const float* __restrict__ stats, float* __restrict__ dx,
                      float* __restrict__ dg, float* __restrict__ db, int M, int C, int tile_c,
                      int rows, int iters, int resident) {
  constexpr int kB = kBatchBwdB;
  // [2][iters - kB][kThreads]: x, then dy, when resident; then the stage
  extern __shared__ float4 stash[];
  __shared__ float wsum[kWarps][kSlots];
  __shared__ float gather[kMaxCluster][kSlots];
  __shared__ float coef[2][kMaxTileC];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  Exchange ex(cluster, &bar, 2 * tile_c, threadIdx.x);
  const Layout L(cluster.block_rank(), tile_c, rows, M, iters);
  const Stage st(L, tile_c, C, Cg, P, B);
  const size_t held = resident ? (size_t)max(iters - kB, 0) * kThreads : 0;
  float4* const stash_dy = stash + held;
  float* const stage = reinterpret_cast<float*>(stash + 2 * held);
  int wb[4];
  st.bases(wb, L.c, C, Cg);
  SampleWalk sw(L, P);
  griddep_wait();
  const float w0 = st.first(w, L.t);
  float mu[4], iv[4], nn[4], gg[4];
  channel4(mu, stats, L.c, C);
  channel4(iv, stats + C, L.c, C);
  channel4(nn, stats + 2 * C, L.c, C);
  channel4(gg, g, L.c, C);
#pragma unroll
  for (int j = 0; j < 4; ++j) nn[j] = fmaxf(nn[j], 1e-6f);
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // db[4], dg[4]

  // kB row iterations from k0: loads all in flight, then the sums in order
  auto load = [&](int k0, F4 (&xv)[kB], F4 (&dv)[kB]) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const bool in = L.has(k0 + u);
      const size_t i = (size_t)L.row(k0 + u) * C + L.c;
      xv[u] = in ? load4<kVec4>(x, i, L.c, C) : F4{};
      dv[u] = in ? load4<kVec4>(dy, i, L.c, C) : F4{};
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (!L.has(k0 + u)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xhat = (xv[u].v[j] - mu[j]) * iv[j];
        v[j] += dv[u].v[j];
        v[4 + j] += dv[u].v[j] * xhat;
      }
    }
  };
  auto grad = [&](int k0, const F4 (&xv)[kB], const F4 (&dv)[kB], const float (&a1)[4],
                  const float (&a2)[4]) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const bool in = L.has(k0 + u);
      float wv[4];
      stage_weights4(wv, stage, wb, sw.s, in);
      sw.next();
      if (!in) continue;
      F4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xhat = (xv[u].v[j] - mu[j]) * iv[j];
        // dx_k = inv*g*dy_k - w_k*inv/n*(g*db) - w_k*xhat_k*inv/n*(g*dg)
        o.v[j] = iv[j] * gg[j] * dv[u].v[j] - wv[j] * (iv[j] / nn[j]) * (gg[j] * a1[j])
                 - wv[j] * xhat * (iv[j] / nn[j]) * (gg[j] * a2[j]);
      }
      store4<kVec4>(dx, (size_t)L.row(k0 + u) * C + L.c, L.c, C, o);
    }
  };

  // 1. this block's rows: db = sum dy, dg = sum dy * xhat; the first kB
  // iterations stay in registers, the rest in shared memory when resident;
  // the stage is written after the first loads (the exchange's barrier
  // publishes it)
  F4 xr[kB], dr[kB];
  load(0, xr, dr);
  st.store(stage, w, L.t, B, w0);
  for (int k0 = kB; k0 < iters; k0 += kB) {
    F4 xv[kB], dv[kB];
    load(k0, xv, dv);
    if (resident) {
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (!L.has(k0 + u)) continue;
        stash[(k0 + u - kB) * kThreads + L.t] = pack(xv[u]);
        stash_dy[(k0 + u - kB) * kThreads + L.t] = pack(dv[u]);
      }
    }
  }

  // 2. the cluster's sums, ranks in order
  ex.sum<8, kSlots>(v, tile_c, L, wsum, gather);
  if (L.t < tile_c) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < static_cast<int>(ex.nb)) {
        a1 += gather[q][L.t];
        a2 += gather[q][tile_c + L.t];
      }
    }
    coef[0][L.t] = a1;
    coef[1][L.t] = a2;
    const int ch = blockIdx.y * tile_c + L.t;
    if (ex.rank == 0 && ch < C) {
      db[ch] = a1;
      dg[ch] = a2;
    }
  }
  __syncthreads();
  ex.done();

  // 3. dx for the rows this block holds
  float a1[4], a2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a1[j] = coef[0][4 * L.grp + j];
    a2[j] = coef[1][4 * L.grp + j];
  }
  grad(0, xr, dr, a1, a2);
  for (int k0 = kB; k0 < iters; k0 += kB) {
    F4 xv[kB], dv[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (!L.has(k0 + u)) continue;
      const size_t i = (size_t)L.row(k0 + u) * C + L.c;
      xv[u] = resident ? unpack(stash[(k0 + u - kB) * kThreads + L.t])
                       : load4<kVec4>(x, i, L.c, C);
      dv[u] = resident ? unpack(stash_dy[(k0 + u - kB) * kThreads + L.t])
                       : load4<kVec4>(dy, i, L.c, C);
    }
    grad(k0, xv, dv, a1, a2);
  }
  ex.finish();
}

// A measuring aid, on no path (chip_smoke.py and scripts/bn_plan_sweep.py call
// it): an empty kernel launched as a plan's kernel is -- the same grid,
// cluster and shared memory, and the same dependent-launch wait -- so its time
// is that plan's launch floor.
__global__ void __launch_bounds__(kThreads) bn_floor_kernel() { griddep_wait(); }

// Bytes of one tensor's rows past the first `batch` iterations, per block.
inline size_t stash_bytes(int iters, int batch = kBatch) {
  return (size_t)(iters > batch ? iters - batch : 0) * kThreads * sizeof(float4);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A plan the kernels can run: lanes of four channels that divide a warp, at
// most 16 blocks a cluster, and rows for every block.
inline bool plan_ok(int M, int C, int tile_c, int cluster, int rows, int iters) {
  const int groups = tile_c / 4;
  return M > 0 && C > 0 && tile_c % 4 == 0 && tile_c <= kMaxTileC && 32 % groups == 0 &&
         cluster >= 1 && cluster <= kMaxCluster && rows >= 1 && (long long)rows * cluster >= M &&
         (long long)iters * (kThreads / groups) >= rows;
}

// Once per kernel (one device per process): allow clusters of 16, above the
// portable 8, and dynamic shared memory up to what is left of the limit.
template <typename Kernel>
cudaError_t prepare(Kernel* kernel, bool& ready) {
  if (ready) return cudaSuccess;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit - static_cast<int>(a.sharedSizeBytes));
  ready = e == cudaSuccess;
  return e;
}

// One cluster launch: grid (cluster, channel tiles), clusters of (cluster, 1, 1);
// with pdl, a programmatic dependent launch (the kernel may start before the
// one before it on the stream ends, and waits for it in griddep_wait).
template <typename Kernel, typename... Args>
int launch(Kernel* kernel, bool& ready, int cluster, int C, int tile_c, size_t smem, bool pdl,
           void* stream, Args... args) {
  cudaError_t e = prepare(kernel, ready);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, (C + tile_c - 1) / tile_c, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 2 : 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

bool g_ready[9];  // fwd vec4, fwd scalar, bwd vec4, bwd scalar; the batched four; floor

inline int fwd(const float* x, const float* w, int P, const float* g, const float* b, float* y,
               float* stats, int M, int C, float eps, int tile_c, int cluster, int rows,
               int iters, int resident, void* stream) {
  if (!plan_ok(M, C, tile_c, cluster, rows, iters) || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = resident ? stash_bytes(iters) : 0;
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(y);
  auto go = [&](auto kernel, bool& ready) {
    return launch(kernel, ready, cluster, C, tile_c, smem, false, stream, x, w, P, g, b, y,
                  stats, M, C, eps, tile_c, rows, iters, resident);
  };
  return v4 ? go(bn_fwd_kernel<true>, g_ready[0]) : go(bn_fwd_kernel<false>, g_ready[1]);
}

inline int bwd(const float* x, const float* w, int P, const float* g, const float* dy,
               const float* stats, float* dx, float* dg, float* db, int M, int C, int tile_c,
               int cluster, int rows, int iters, int resident, void* stream) {
  if (!plan_ok(M, C, tile_c, cluster, rows, iters) || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = resident ? 2 * stash_bytes(iters) : 0;
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  auto go = [&](auto kernel, bool& ready) {
    return launch(kernel, ready, cluster, C, tile_c, smem, false, stream, x, w, P, g, dy,
                  stats, dx, dg, db, M, C, tile_c, rows, iters, resident);
  };
  return v4 ? go(bn_bwd_kernel<true>, g_ready[2]) : go(bn_bwd_kernel<false>, g_ready[3]);
}

// The batched kernels' client layout: C = G * Cg columns, M = B * P rows.
inline bool clients_ok(int M, int C, int P, int B, int Cg) {
  return P >= 1 && B >= 1 && Cg >= 1 && C % Cg == 0 && (long long)B * P == M;
}

// Bytes of a batched block's weight stage (Stage), the largest over the
// plan's blocks, in whole 16-byte units: the clients of the widest channel
// tile times the samples of the widest row range.
inline size_t stage_bytes(int M, int C, int P, int Cg, int tile_c, int cluster, int rows) {
  long long nc = 0, ns = 0;
  for (int c0 = 0; c0 < C; c0 += tile_c)
    nc = std::max<long long>(nc, (std::min(C, c0 + tile_c) - 1) / Cg - c0 / Cg + 1);
  for (int q = 0; q < cluster && (long long)q * rows < M; ++q) {
    const int r0 = q * rows;
    ns = std::max<long long>(ns, (std::min(M, r0 + rows) - 1) / P - r0 / P + 1);
  }
  return (size_t)((nc * ns + 3) / 4) * 16;
}

inline int fwd_batched(const float* x, const float* w, int P, int B, int Cg, const float* g,
                       const float* b, float* y, float* stats, int M, int C, float eps,
                       int tile_c, int cluster, int rows, int iters, int resident, bool pdl,
                       void* stream) {
  if (!plan_ok(M, C, tile_c, cluster, rows, iters) || !clients_ok(M, C, P, B, Cg))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (resident ? stash_bytes(iters, kBatchFwdB) : 0) +
                      stage_bytes(M, C, P, Cg, tile_c, cluster, rows);
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(y);
  auto go = [&](auto kernel, bool& ready) {
    return launch(kernel, ready, cluster, C, tile_c, smem, pdl, stream, x, w, P, B, Cg, g, b, y,
                  stats, M, C, eps, tile_c, rows, iters, resident);
  };
  return v4 ? go(bn_fwd_batched_kernel<true>, g_ready[4])
            : go(bn_fwd_batched_kernel<false>, g_ready[5]);
}

inline int bwd_batched(const float* x, const float* w, int P, int B, int Cg, const float* g,
                       const float* dy, const float* stats, float* dx, float* dg, float* db,
                       int M, int C, int tile_c, int cluster, int rows, int iters, int resident,
                       bool pdl, void* stream) {
  if (!plan_ok(M, C, tile_c, cluster, rows, iters) || !clients_ok(M, C, P, B, Cg))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (resident ? 2 * stash_bytes(iters, kBatchBwdB) : 0) +
                      stage_bytes(M, C, P, Cg, tile_c, cluster, rows);
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
  auto go = [&](auto kernel, bool& ready) {
    return launch(kernel, ready, cluster, C, tile_c, smem, pdl, stream, x, w, P, B, Cg, g, dy,
                  stats, dx, dg, db, M, C, tile_c, rows, iters, resident);
  };
  return v4 ? go(bn_bwd_batched_kernel<true>, g_ready[6])
            : go(bn_bwd_batched_kernel<false>, g_ready[7]);
}

}  // namespace

extern "C" {

// Forward: y [M, C], stats [3, C] from x [M, C], w [M / P], g, b [C], on the
// plan (tile_c, cluster, rows, iters, resident) of fused_norm.bn_plan(M, C).
int hfl_bn_fwd(const float* x, const float* w, int P, const float* g, const float* b,
               float* y, float* stats, int M, int C, float eps, int tile_c, int cluster,
               int rows, int iters, int resident, void* stream) {
  return fwd(x, w, P, g, b, y, stats, M, C, eps, tile_c, cluster, rows, iters, resident, stream);
}

// Backward: dx [M, C], dg, db [C] from x, dy [M, C], w, g and the forward's
// stats [3, C], on the same plan.
int hfl_bn_bwd(const float* x, const float* w, int P, const float* g, const float* dy,
               const float* stats, float* dx, float* dg, float* db, int M, int C, int tile_c,
               int cluster, int rows, int iters, int resident, void* stream) {
  return bwd(x, w, P, g, dy, stats, dx, dg, db, M, C, tile_c, cluster, rows, iters, resident,
             stream);
}

// Batched forward: x [M, G * Cg] of G clients, w [G, B] (B = M / P), g, b
// [G * Cg] -> y, stats [3, G * Cg], on fused_norm.bn_plan_batched(M, C, Cg,
// P); a programmatic dependent launch when pdl.
int hfl_bn_fwd_batched(const float* x, const float* w, int P, int B, int Cg, const float* g,
                       const float* b, float* y, float* stats, int M, int C, float eps,
                       int tile_c, int cluster, int rows, int iters, int resident, int pdl,
                       void* stream) {
  return fwd_batched(x, w, P, B, Cg, g, b, y, stats, M, C, eps, tile_c, cluster, rows, iters,
                     resident, pdl != 0, stream);
}

// Batched backward: dx, dg, db from x, dy, w [G, B], g and the batched
// forward's stats, on the same plan.
int hfl_bn_bwd_batched(const float* x, const float* w, int P, int B, int Cg, const float* g,
                       const float* dy, const float* stats, float* dx, float* dg, float* db,
                       int M, int C, int tile_c, int cluster, int rows, int iters, int resident,
                       int pdl, void* stream) {
  return bwd_batched(x, w, P, B, Cg, g, dy, stats, dx, dg, db, M, C, tile_c, cluster, rows,
                     iters, resident, pdl != 0, stream);
}

// The launch floor of a plan: the empty kernel on grid (cluster, tiles),
// clusters of `cluster`, with smem bytes of dynamic shared memory (the
// plan's static and dynamic together), a dependent launch when pdl.
int hfl_bn_floor(int tiles, int cluster, int smem, int pdl, void* stream) {
  if (tiles < 1 || cluster < 1 || cluster > kMaxCluster || smem < 0 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(bn_floor_kernel, g_ready[8], cluster, tiles, 1, smem, pdl != 0, stream);
}

}  // extern "C"
