// Fused masked-SGD epilogue over flat parameter buffers: one client's (two
// launches), and a level's G clients' (kernel 3b, one launch).
//
// Replaces heterofl_tpu/ops/fused_update.py::_pallas_flat
// (_fused_sgd_kernel).  The TPU kernel walks a sequential grid (2, rows/bm)
// over the lane-packed [rows, 128] buffers and carries the global-norm sum
// of squares from phase 0 to phase 1 in a VMEM scalar.  CUDA blocks run in
// parallel, so the one-client kernel is two launches: launch A writes one
// partial sum of gm^2 per block (parts(n) blocks, a function of n alone, at
// most kParts), launch B reduces the parts(n) partials in a fixed order in
// every block -- no atomics, the same bits run to run -- and applies the
// update.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads g, p, buf and mask
// and writes p and buf, 6 * 4 * n bytes = 268 MB at ResNet-18
// (n = 11,172,170), about 80 us; this design also reads g and mask in
// launch A, 357 MB.  Memory-bound by far (about 10 flops per element), so
// both launches stream 16-byte vectors with neighbouring threads on
// neighbouring addresses, and the update runs in place on p and buf
// (no new buffers, one write each).
//
// The batched kernel (3b: the kernel under jax.vmap over a level's G
// clients, the grouped engine) updates g, p, buf [G, n] -- rows ld >= n
// floats apart -- with a shared mask [n] and scal [G, 3], in ONE launch
// whose every row equals the one-client kernel on that client bit for bit.
// What fixes a row's bits is the order of its norm's sum, so 3b keeps the
// one-client kernel's VIRTUAL PARTS: part b of a row is what launch A's
// block b sums -- thread t takes chunks b*256 + t + k*parts*256, k = 0, 1,
// ..., in order, part 0 adds the n % 4 tail last, then block_sum's tree --
// and the total is the partials summed as launch B sums them (thread t
// takes part[t + 256 j] in order, then the tree).  Whichever block computes
// part b uses the stride parts(n)*256, never its own grid size, so the
// bits hold on any grid; the apply is elementwise.  Two routes, chosen by
// the plan (ops/fused_update.py::sgd_plan_batched, a pure function of the
// shape):
//
// * persistent (a row of more than 16 parts: ResNet-18 levels a-d, the
//   LM's a-d).  A grid no larger than the blocks the card holds at once
//   (occupancy x SMs).  Norm pass: the blocks walk work items (row group,
//   part); a block sums part b of up to 8 rows together, so it reads each
//   mask chunk once for the group, not once a row (the plan groups the rows
//   where a row has 512 parts or more, else takes them one at a time, so a
//   row of few parts spreads over more blocks).  Then a grid-wide barrier:
//   the launch is cooperative, so CUDA starts it only with every block
//   resident (or refuses it) and gives each launch its own barrier state,
//   and the blocks meet in cooperative_groups' grid sync.  Apply pass: each
//   block reduces its rows' partials in the fixed order and updates its
//   units -- an item's chunks, cut into as many units as fill the grid --
//   walking them in reverse, so its first reads of g and mask after the
//   barrier hit the 50 MB L2.  Bytes: g and mask twice, (6G + 2) * 4n
//   against the function's (5G + 1) * 4n, less what L2 keeps.
// * cluster (at most 16 parts: ResNet-18 level e, 11 parts; the LM's, 7):
//   one thread-block cluster a row, block rank b being part b.  Each thread
//   has at most 4 chunks, so it loads its g, mask, p and buf chunks into
//   registers at once, keeps (g / denom) * mask there, sums; warp 0 pushes
//   the block's partial into every block's shared memory (st.async, counted
//   by each block's transaction barrier), and each warp sums the partials
//   itself and applies the update from its registers: one round trip to
//   memory, one exchange, the stores.
//
// Both are programmatic dependent launches (the cooperative one too, also
// under stream capture): a launch may begin while the kernel before it on
// the stream ends, and reads nothing before griddep_wait.  Rows ld apart
// with ld % 4 == 0 (the grouped engine pads them) take 16-byte chunks,
// others four scalars -- the same values in the same order.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

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

inline bool aligned(const void* q, int bytes) {
  return (reinterpret_cast<uintptr_t>(q) & (bytes - 1)) == 0;
}

// One client's buffers of n entries: the two launches.
int run(const float* g, float* p, float* buf, const float* mask, const float* scal,
        float* part, long long n, float momentum, float wd, float max_norm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = parts_for(n);
  const dim3 grid_a(parts, 1), grid_b(apply_blocks_for(n), 1);
  const bool vec4 = aligned(g, 16) && aligned(p, 16) && aligned(buf, 16) && aligned(mask, 16);
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

// -- kernel 3b: G rows in one launch ------------------------------------------

constexpr int kMaxRows = 8;        // rows a pass of the persistent route, at most
constexpr int kClusterParts = 16;  // the cluster route: rows of at most this many parts

// A call's arguments; rows r of g, p, buf start at r * ld floats.
struct Batch {
  const float* g;
  float* p;
  float* buf;
  const float* mask;
  const float* scal;
  float* part;  // [G, parts] partial sums (persistent route)
  long long n, ld;
  int G, parts, rows, groups;  // rows a pass, groups = ceil(G / rows)
  int slices;                  // apply units an item is cut into (persistent route)
  float momentum, wd, max_norm;
};

// Chunk i of q: one 16-byte load (kVec 4) or four scalars (1); the same
// four values in the same order.
template <int kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ q, long long i) {
  return chunk<kVec == 4>(q, i);
}
template <int kVec>
__device__ __forceinline__ void store4(float* __restrict__ q, long long i, const float4& v) {
  put_chunk<kVec == 4>(q, i, v);
}

__device__ __forceinline__ void update4(const float4& gv, const float4& mv, float4& pv,
                                        float4& bv, float denom, float lr, float scale,
                                        float momentum, float wd) {
  update_one(gv.x, mv.x, pv.x, bv.x, denom, lr, scale, momentum, wd);
  update_one(gv.y, mv.y, pv.y, bv.y, denom, lr, scale, momentum, wd);
  update_one(gv.z, mv.z, pv.z, bv.z, denom, lr, scale, momentum, wd);
  update_one(gv.w, mv.w, pv.w, bv.w, denom, lr, scale, momentum, wd);
}

// update_one past its first line: gm is (g / denom) * mask.
__device__ __forceinline__ void update_gm(float gm, float& pv, float& bv, float lr, float scale,
                                          float momentum, float wd) {
  const float nb = momentum * bv + gm * scale + wd * pv;
  pv = pv - lr * nb;
  bv = nb;
}

__device__ __forceinline__ float add_sq4(float acc, const float4& gv, const float4& mv,
                                         float denom) {
  acc += sq_masked(gv.x, mv.x, denom);
  acc += sq_masked(gv.y, mv.y, denom);
  acc += sq_masked(gv.z, mv.z, denom);
  acc += sq_masked(gv.w, mv.w, denom);
  return acc;
}

// Thread t < 32's sum in block_sum's order down to step s = 32, from the
// 256 values of v in shared memory: the pairs (t, t + 128), then (t, t + 64),
// then (t, t + 32), in one read of eight values.
__device__ __forceinline__ float tree_to_warp(const float* v, int t) {
  return ((v[t] + v[t + 128]) + (v[t + 64] + v[t + 192])) +
         ((v[t + 32] + v[t + 160]) + (v[t + 96] + v[t + 224]));
}

// block_sum's last five steps, (t, t + s) for s = 16 ... 1, by shuffles
// inside a warp -> lane 0 (a lane whose source is past the warp adds its
// own value, which no lane below it reads).
__device__ __forceinline__ float warp_tree(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, s);
  return x;
}

// v[r] for each of kRows rows summed over the block in block_sum's order
// (every addition the same pair of values), with two barriers in place of
// nine; every thread gets the sums.
template <int kRows>
__device__ __forceinline__ void rows_sum(float (&v)[kRows], float (*sh)[kThreads],
                                         float* out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) sh[r][t] = v[r];
  __syncthreads();
  if (t < 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float x = warp_tree(tree_to_warp(sh[r], t));
      if (t == 0) out[r] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = out[r];
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The persistent route.  Norm pass: work item w is (group w / parts, part
// w % parts), block x takes w = x, x + grid, ...; it sums part b of the
// group's rows together, the mask chunk read once for them.  Apply pass:
// item w is cut into `slices` units, unit s taking the item's chunks k = s,
// s + slices, ... (more units than items where the items alone would leave
// blocks idle); block x takes units x, x + grid, ... in reverse, so its
// first reads after the barrier are of what it read last before it.
template <int kVec, int kRows>
__global__ void __launch_bounds__(kThreads) sgd_batched_persistent(const Batch a) {
  __shared__ float sh[kRows][kThreads];
  __shared__ float tot[kRows];
  const int t = threadIdx.x;
  const long long n4 = a.n / 4, stride = (long long)a.parts * kThreads;
  const int items = a.parts * a.groups;
  griddep_wait();
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int grp = w / a.parts, b = w - grp * a.parts;
    const int r0 = grp * a.rows, nr = min(a.rows, a.G - r0);
    const float* g[kRows];
    float den[kRows], acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = r0 + (r < nr ? r : 0);
      g[r] = a.g + row * a.ld;
      den[r] = a.scal[3 * row];
      acc[r] = 0.f;
    }
    for (long long i = (long long)b * kThreads + t; i < n4; i += stride) {
      const float4 mv = load4<kVec>(a.mask, i);  // every row's loads, then the sums
      float4 gv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) gv[r] = load4<kVec>(g[r], i);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) acc[r] = add_sq4(acc[r], gv[r], mv, den[r]);
    }
    if (b == 0) {
      const long long i = 4 * n4 + t;  // the n % 4 tail, last in part 0
      if (i < a.n) {
        const float m = a.mask[i];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nr) acc[r] += sq_masked(g[r][i], m, den[r]);
      }
    }
    rows_sum<kRows>(acc, sh, tot);
    if (t < nr) a.part[(long long)(r0 + t) * a.parts + b] = tot[t];
  }
  cg::this_grid().sync();  // a cooperative launch: every block is resident
  const int units = items * a.slices;
  if ((int)blockIdx.x >= units) return;
  int cur = -1;
  float scale[kRows], den[kRows], lr[kRows];
  bool on[kRows];
  const int last = blockIdx.x + (units - 1 - blockIdx.x) / gridDim.x * gridDim.x;
  for (int u = last; u >= (int)blockIdx.x; u -= gridDim.x) {
    const int w = u / a.slices, s = u - w * a.slices;
    const int grp = w / a.parts, b = w - grp * a.parts;
    const int r0 = grp * a.rows, nr = min(a.rows, a.G - r0);
    if (grp != cur) {  // this group's clip scales: its partials in the fixed order
      cur = grp;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r] = 0.f;
        if (r < nr) {
          const float* part = a.part + (long long)(r0 + r) * a.parts;
          for (int j = t; j < a.parts; j += kThreads) acc[r] += __ldcg(part + j);
        }
      }
      rows_sum<kRows>(acc, sh, tot);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long row = r0 + (r < nr ? r : 0);
        scale[r] = fminf(1.f, a.max_norm / (sqrtf(acc[r]) + 1e-6f));
        den[r] = a.scal[3 * row];
        lr[r] = a.scal[3 * row + 1];
        on[r] = r < nr && a.scal[3 * row + 2] > 0.f;  // has <= 0: left as it is
      }
    }
    const long long i0 = (long long)b * kThreads + t;
    const long long kmax = i0 < n4 ? (n4 - 1 - i0) / stride : -1;
    // this unit's chunks of the thread, the last (k <= kmax, k = s mod slices) first
    for (long long k = kmax < s ? -1 : s + (kmax - s) / a.slices * a.slices; k >= 0;
         k -= a.slices) {
      const long long i = i0 + k * stride;
      // every row's loads issued before any store (a store may alias a load)
      const float4 mv = load4<kVec>(a.mask, i);
      float4 gv[kRows], pv[kRows], bv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!on[r]) continue;
        const long long off = (long long)(r0 + r) * a.ld;
        gv[r] = load4<kVec>(a.g + off, i);
        pv[r] = load4<kVec>(a.p + off, i);
        bv[r] = load4<kVec>(a.buf + off, i);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!on[r]) continue;
        const long long off = (long long)(r0 + r) * a.ld;
        update4(gv[r], mv, pv[r], bv[r], den[r], lr[r], scale[r], a.momentum, a.wd);
        store4<kVec>(a.p + off, i, pv[r]);
        store4<kVec>(a.buf + off, i, bv[r]);
      }
    }
    if (b == 0 && s == 0) {
      const long long i = 4 * n4 + t;
      if (i < a.n) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!on[r]) continue;
          const long long off = (long long)(r0 + r) * a.ld + i;
          float pv = a.p[off], bv = a.buf[off];
          update_one(a.g[off], a.mask[i], pv, bv, den[r], lr[r], scale[r], a.momentum, a.wd);
          a.p[off] = pv;
          a.buf[off] = bv;
        }
      }
    }
  }
}

// The barrier of a cluster launch, split: arrive (relaxed: it only says the
// block runs, so its shared memory may be written) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* q) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(q));
}

// A transaction barrier in this block's shared memory: one arrival (thread
// 0's, with the bytes to expect), then complete when that many bytes have
// landed from the peers' st.async pushes.  Used once a launch, so phase 0.
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t q = smem_addr(bar), one = 1;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(q), "r"(one) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(q), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const uint32_t q = smem_addr(bar), phase = 0;
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(q), "r"(phase) : "memory");
}
// Store v at q's place in block `rank`'s shared memory, counted by that
// block's barrier at bar's place: a remote write with no round trip.
__device__ __forceinline__ void push(const float* q, uint64_t* bar, unsigned rank, float v) {
  uint32_t rq, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rq) : "r"(smem_addr(q)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(rq), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

// The cluster route: grid (parts, G), clusters of (parts, 1, 1); block rank
// b is part b of row blockIdx.y.  A thread has at most 4 chunks (parts(n) *
// 1024 >= n / 4 when parts(n) <= 16), loaded at once and kept in registers
// across the exchange: warp 0 sums the block's part and pushes it into
// slot b of every block's shared memory (st.async, counted by that block's
// transaction barrier), so each block waits only for its own slots.
template <int kVec>
__global__ void __launch_bounds__(kThreads) sgd_batched_cluster(const Batch a) {
  __shared__ float sh[kThreads];
  __shared__ float slots[kClusterParts];
  __shared__ uint64_t bar;
  const int t = threadIdx.x, b = static_cast<int>(cg::this_cluster().block_rank());
  const long long row = blockIdx.y, n4 = a.n / 4, stride = (long long)a.parts * kThreads;
  const long long i0 = (long long)b * kThreads + t, it = 4 * n4 + t;
  const float* g = a.g + row * a.ld;
  float* p = a.p + row * a.ld;
  float* buf = a.buf + row * a.ld;
  const bool tail = b == 0 && it < a.n;
  if (t == 0) mbar_init_expect(&bar, a.parts * sizeof(float));
  cluster_arrive_relaxed();
  griddep_wait();
  const float denom = a.scal[3 * row], lr = a.scal[3 * row + 1], has = a.scal[3 * row + 2];
  float4 gm[4], pv[4], bv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = i0 + k * stride;
    if (i < n4) {
      gm[k] = load4<kVec>(g, i);
      const float4 mv = load4<kVec>(a.mask, i);
      pv[k] = load4<kVec>(p, i);
      bv[k] = load4<kVec>(buf, i);
      gm[k] = make_float4((gm[k].x / denom) * mv.x, (gm[k].y / denom) * mv.y,
                          (gm[k].z / denom) * mv.z, (gm[k].w / denom) * mv.w);
    }
  }
  float gmt = 0.f, pt = 0.f, bt = 0.f;
  if (tail) {
    gmt = (g[it] / denom) * a.mask[it];
    pt = p[it];
    bt = buf[it];
  }
  // the masked gradient kept in registers: the sum of its squares and the
  // update take the same values sq_masked and update_one compute
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k * stride < n4) {
      acc += gm[k].x * gm[k].x;
      acc += gm[k].y * gm[k].y;
      acc += gm[k].z * gm[k].z;
      acc += gm[k].w * gm[k].w;
    }
  }
  if (tail) acc += gmt * gmt;
  sh[t] = acc;
  cluster_wait();  // every peer runs and has set up its barrier
  __syncthreads();
  if (t < 32) {  // the block's part in block_sum's order, to every peer
    const float part = __shfl_sync(0xffffffffu, warp_tree(tree_to_warp(sh, t)), 0);
    if (t < a.parts) push(&slots[b], &bar, t, part);
  }
  mbar_wait(&bar);
  // each warp sums the parts partials as launch B does: lanes past parts
  // hold 0, which the tree's earlier steps would have added
  const int lane = t & 31;
  const float x = __shfl_sync(0xffffffffu, warp_tree(lane < a.parts ? 0.f + slots[lane] : 0.f),
                              0);
  const float scale = fminf(1.f, a.max_norm / (sqrtf(x) + 1e-6f));
  if (has > 0.f) {  // has <= 0: p and buf stay as they are
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = i0 + k * stride;
      if (i < n4) {
        update_gm(gm[k].x, pv[k].x, bv[k].x, lr, scale, a.momentum, a.wd);
        update_gm(gm[k].y, pv[k].y, bv[k].y, lr, scale, a.momentum, a.wd);
        update_gm(gm[k].z, pv[k].z, bv[k].z, lr, scale, a.momentum, a.wd);
        update_gm(gm[k].w, pv[k].w, bv[k].w, lr, scale, a.momentum, a.wd);
        store4<kVec>(p, i, pv[k]);
        store4<kVec>(buf, i, bv[k]);
      }
    }
    if (tail) {
      update_gm(gmt, pt, bt, lr, scale, a.momentum, a.wd);
      p[it] = pt;
      buf[it] = bt;
    }
  }
  cluster_arrive_relaxed();  // no block leaves while a push into it may be in flight
  cluster_wait();
}

// The launch floor of a plan: nothing but the dependent wait and, with
// sync 1, the cooperative grid's sync, with 2 the cluster barrier.  A
// measuring aid.
__global__ void __launch_bounds__(kThreads) sgd_floor_kernel(int sync) {
  griddep_wait();
  if (sync == 1) cg::this_grid().sync();
  if (sync == 2) cg::this_cluster().sync();
}

using BatchKernel = void (*)(Batch);

inline int vec_index(int vec) { return vec == 4 ? 0 : 1; }
inline int rows_index(int rows) { return rows <= 1 ? 0 : (rows <= 2 ? 1 : (rows <= 4 ? 2 : 3)); }

BatchKernel persistent_kernel(int vec, int rows) {
  static const BatchKernel table[2][4] = {
      {sgd_batched_persistent<4, 1>, sgd_batched_persistent<4, 2>,
       sgd_batched_persistent<4, 4>, sgd_batched_persistent<4, 8>},
      {sgd_batched_persistent<1, 1>, sgd_batched_persistent<1, 2>,
       sgd_batched_persistent<1, 4>, sgd_batched_persistent<1, 8>}};
  return table[vec_index(vec)][rows_index(rows)];
}
BatchKernel cluster_kernel(int vec) {
  static const BatchKernel table[2] = {sgd_batched_cluster<4>, sgd_batched_cluster<1>};
  return table[vec_index(vec)];
}

// Blocks of a persistent kernel the card holds at once (once per kernel;
// one device per process), or a negative CUDA error.
int resident(int vec, int rows) {
  static int cache[2][4];
  int& c = cache[vec_index(vec)][rows_index(rows)];
  if (c > 0) return c;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel(vec, rows),
                                                      kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  c = per_sm * sms;
  return c;
}

// The persistent route's launch: `slices` apply units an item (as many as
// fill the resident blocks, at most a thread's chunk iterations), then the
// fewest waves of at most the resident blocks that take the units, the
// units spread evenly over the blocks.  0, or a CUDA error.
int persistent_launch(int vec, int rows, long long n, int parts, int groups, int& grid,
                      int& slices) {
  const int most = resident(vec, rows);
  if (most <= 0) return most < 0 ? -most : static_cast<int>(cudaErrorInvalidValue);
  const long long stride = (long long)parts * kThreads, iters = (n / 4 + stride - 1) / stride;
  const int items = parts * groups;
  const long long want = (most + items - 1) / items;
  slices = static_cast<int>(want < iters ? want : (iters < 1 ? 1 : iters));
  const long long units = (long long)items * slices, waves = (units + most - 1) / most;
  grid = static_cast<int>((units + waves - 1) / waves);
  return 0;
}

// Once per kernel: allow clusters of 16, above the portable 8.
template <typename Kernel>
cudaError_t allow_big_clusters(Kernel* kernel, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  ready = e == cudaSuccess;
  return e;
}

// Launch attributes: a programmatic dependent launch, a cooperative one.
constexpr int kPdl = 1, kCoop = 2;

// One launch of kernel on grid, clusters of `cluster` blocks along x (0:
// none), with the attributes in attrs.
template <typename... Args>
int launch(void (*kernel)(Args...), dim3 grid, int cluster, int attrs, void* stream,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[3];
  int na = 0;
  if (cluster > 0) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = cluster;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (attrs & kPdl) {
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  if (attrs & kCoop) {
    attr[na].id = cudaLaunchAttributeCooperative;
    attr[na].val.cooperative = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// A plan the kernels can run (route 0 persistent, 1 cluster): the one-client
// parts, rows a pass within kMaxRows, rows of a vector width they align to.
inline bool plan_ok(long long n, long long ld, int G, int parts, int route, int rows, int vec) {
  return n >= 1 && ld >= n && G >= 1 && parts == parts_for(n) && rows >= 1 &&
         rows <= kMaxRows && (vec == 1 || vec == 4) && (G == 1 || ld % vec == 0) &&
         (route == 0 || (route == 1 && parts <= kClusterParts && G <= 65535));
}

bool g_cluster_ready[3];  // the cluster kernel at vec 4, 1; the floor kernel

}  // namespace

extern "C" {

// Floats of scratch (partial sums) one row of a call needs.
long long hfl_sgd_scratch_floats() { return kParts; }

// In place on p and buf [n].  All four buffers must be 16-byte aligned.
int hfl_fused_sgd(const float* g, float* p, float* buf, const float* mask, const float* scal,
                  float* part, long long n, float momentum, float wd, float max_norm,
                  void* stream) {
  return run(g, p, buf, mask, scal, part, n, momentum, wd, max_norm, stream);
}

// Batched (3b): in place on p and buf [G, n], rows ld floats apart; mask
// [n] shared, scal [G, 3]; on the plan (parts, route, rows, vec) of
// fused_update.sgd_plan_batched(n, G, ld).  The persistent route needs part
// [G * parts].
int hfl_fused_sgd_batched(const float* g, float* p, float* buf, const float* mask,
                          const float* scal, float* part, long long n, long long ld, int G,
                          float momentum, float wd, float max_norm, int parts, int route,
                          int rows, int vec, void* stream) {
  if (!plan_ok(n, ld, G, parts, route, rows, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const int abytes = 4 * vec;
  if (!aligned(g, abytes) || !aligned(p, abytes) || !aligned(buf, abytes) ||
      !aligned(mask, abytes))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int groups = (G + rows - 1) / rows;
  Batch a{g, p, buf, mask, scal, part, n, ld, G, parts, rows, groups, 1, momentum, wd, max_norm};
  if (route == 1) {
    const BatchKernel k = cluster_kernel(vec);
    const cudaError_t e = allow_big_clusters(k, g_cluster_ready[vec_index(vec)]);
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch(k, dim3(parts, G, 1), parts, kPdl, stream, a);
  }
  if (part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int e = persistent_launch(vec, rows, n, parts, groups, grid, a.slices);
  if (e != 0) return e;
  return launch(persistent_kernel(vec, rows), dim3(grid, 1, 1), 0, kPdl | kCoop, stream, a);
}

// The launch floor of a plan for G rows of n entries: the empty kernel on
// the plan's grid, with the plan's attributes (route 0: the persistent
// launch of rows a pass at vec, cooperative; 1: (parts, G) in clusters of
// parts); sync 1 adds the route's barrier.  The grid into *grid.
int hfl_sgd_floor(int route, int vec, int rows, long long n, int G, int sync, int* grid,
                  void* stream) {
  const int parts = n >= 1 ? parts_for(n) : 0;
  if (n < 1 || G < 1 || rows < 1 || rows > kMaxRows || sync < 0 || sync > 1 ||
      (route == 1 && parts > kClusterParts))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    const cudaError_t e = allow_big_clusters(sgd_floor_kernel, g_cluster_ready[2]);
    if (e != cudaSuccess) return static_cast<int>(e);
    *grid = parts * G;
    return launch(sgd_floor_kernel, dim3(parts, G, 1), parts, kPdl, stream, 2 * sync);
  }
  int slices = 0;
  const int e = persistent_launch(vec, rows, n, parts, (G + rows - 1) / rows, *grid, slices);
  if (e != 0) return e;
  return launch(sgd_floor_kernel, dim3(*grid, 1, 1), 0, kPdl | kCoop, stream, sync);
}

}  // extern "C"
