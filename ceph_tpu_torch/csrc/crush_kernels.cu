// CRUSH placement kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ceph_tpu_torch/_build.py), beside the EC
// kernels in one library.
//
// The bulk mapper (ceph_tpu_torch/ops/crush/device.py) runs every PG of
// a pool as one lane.  Four kernels carry it:
//   K4 crush_descend     the multi-level straw2 descent of each lane;
//   K5 crush_post        the up-filter, stable compaction and primary;
//   K6 crush_hitscan     the lanes a changed OSD set touches (remap);
//   K7 crush_rowcompact  the indices of flagged lanes per row group.
// Each launches on the caller's stream, allocates nothing and does not
// synchronise; each C entry returns cudaGetLastError() so a refused
// launch reaches the Python wrapper, which raises.  Every loop over
// lanes or groups is grid-stride, so any lane count launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kHashSeed = 1315423911u;
constexpr int kItemNone = 0x7FFFFFFF;
constexpr int kRhLhEntries = 258;            // 129 (reciprocal, log) pairs
constexpr int kLnEntries = kRhLhEntries + 256;
constexpr long long kLnOne = 1LL << 48;
constexpr long long kS64Min = -9223372036854775807LL - 1;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  // grid-stride loops cover the rest; 132 SMs x 16 blocks keeps the
  // card full without a grid of millions of blocks
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// rjenkins1 mix (src/crush/hash.c crush_hashmix), wrapping u32.
__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// 2^44 * log2(u + 1) in fixed point (mapper.c:226-268), from the
// reciprocal/log tables in shared memory.  x * rh may pass 2^64; the
// unsigned product wraps as in the reference and bits 48..55 stay exact.
__device__ __forceinline__ long long crush_ln(uint32_t u,
                                              const unsigned long long* rhlh,
                                              const unsigned long long* ll) {
  uint32_t x = u + 1;
  long long iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = __clz(x) - 16;          // 16 - bit_length(x)
    x <<= bits;
    iexpon = 15 - bits;
  }
  const uint32_t index1 = (x >> 8) << 1;
  const unsigned long long rh = rhlh[index1 - 256];
  unsigned long long lh = rhlh[index1 + 1 - 256];
  const unsigned long long xl64 = ((unsigned long long)x * rh) >> 48;
  lh = (lh + ll[xl64 & 0xff]) >> 4;
  return (iexpon << 44) + (long long)lh;
}

// ---------------------------------------------------------------------------
// K4: straw2 descent
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ops/crush/pallas_draw.py:make_descend_kernel
// (pallas_call at :418).  Per lane (x, r, start bucket, choose_args
// position): at each level draw every item of the current bucket,
//   draw_i = trunc((crush_ln(hash32_3(x, id_i, r) & 0xffff) - 2^48) / w_i)
// (S64_MIN for w_i == 0), take the first item with the strictly greatest
// draw, and either stop on an item of the wanted type (ok), stop for good
// on a device of the wrong type, an out-of-range device or a missing
// bucket (perm), stop on an empty child bucket (retryable: neither bit),
// or walk into the child bucket.  Level d draws over at most levels[d]
// items, the widest bucket the rule can reach there.
// Bound: operations.  Each draw is one rjenkins hash (~100 32-bit integer
// operations), two table reads and a signed 64-bit division, which the
// card emulates in software; the lane inputs and outputs are 20 bytes.
// The TPU kernel had no 64-bit integer unit and approximated the draw in
// f32 with certainty bounds; Hopper computes it exactly, so nothing is
// flagged for a resolve pass.  Design: one thread per lane walking the
// levels; bucket rows are read straight from device memory, where the
// flat tables stay resident in L2 (a few tens of KiB for a 1000-OSD
// map); the crush_ln tables (4 KiB) are copied into shared memory per
// block.
__global__ void __launch_bounds__(kThreads)
descend_kernel(const long long* __restrict__ xs, const int* __restrict__ rs,
               const int* __restrict__ bids, const int* __restrict__ poss,
               const int* __restrict__ items, const int* __restrict__ ids,
               const long long* __restrict__ weights,
               const int* __restrict__ bsize, const int* __restrict__ btype,
               const int* __restrict__ levels, int n_levels, int B, int S,
               int n_pos, int max_devices, int want_type,
               const unsigned long long* __restrict__ ln_tbl, long long L,
               int* __restrict__ item_out, int* __restrict__ status_out) {
  __shared__ unsigned long long s_ln[kLnEntries];
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x) s_ln[i] = ln_tbl[i];
  __syncthreads();
  const unsigned long long* rhlh = s_ln;
  const unsigned long long* ll = s_ln + kRhLhEntries;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x; l < L;
       l += stride) {
    const uint32_t x = (uint32_t)xs[l];
    const uint32_t r = (uint32_t)rs[l];
    int cur = bids[l];
    int p = poss[l];
    p = p < 0 ? 0 : (p > n_pos - 1 ? n_pos - 1 : p);
    int item = kItemNone;
    int status = 0;
    bool done = cur < 0 || cur >= B || bsize[cur] == 0;
    for (int d = 0; d < n_levels && !done; ++d) {
      const int width = levels[d];
      const int size = bsize[cur];
      const int n = size < width ? size : width;
      const int* row_ids = ids + (long long)cur * S;
      const long long* row_w = weights + ((long long)p * B + cur) * S;
      int best = 0;
      long long best_draw = kS64Min;
      for (int i = 0; i < n; ++i) {
        const long long w = row_w[i];
        long long draw = kS64Min;
        if (w != 0) {
          const uint32_t u = hash32_3(x, (uint32_t)row_ids[i], r) & 0xffffu;
          draw = (crush_ln(u, rhlh, ll) - kLnOne) / w;
        }
        if (i == 0 || draw > best_draw) {
          best = i;
          best_draw = draw;
        }
      }
      const int chosen = items[(long long)cur * S + best];
      const bool is_bucket = chosen < 0;
      const int cbid = is_bucket ? -1 - chosen : 0;
      const bool bucket_ok = is_bucket && cbid < B;
      const int ctype = bucket_ok ? btype[cbid] : 0;
      const bool oob = !is_bucket && chosen >= max_devices;
      const bool reach =
          !oob && (is_bucket ? (bucket_ok && ctype == want_type) : want_type == 0);
      if (reach) {
        item = chosen;
        status = 1;
        done = true;
      } else if (!bucket_ok) {
        status = 2;
        done = true;
      } else if (bsize[cbid] == 0) {
        done = true;
      } else {
        cur = cbid;
      }
    }
    item_out[l] = item;
    status_out[l] = status;
  }
}

// Bit d of a device bitmask, from shared memory when it was staged there.
__device__ __forceinline__ bool has_bit(const uint32_t* bits, int v, int D) {
  return v >= 0 && v < D && ((bits[v >> 5] >> (v & 31)) & 1u);
}

// Stage a bitmask of `words` words in shared memory (words == 0: leave
// it in device memory).  Every thread of the block calls this.
__device__ __forceinline__ const uint32_t* stage_bits(const uint32_t* bits,
                                                      uint32_t* s_bits,
                                                      int words) {
  if (words == 0) return bits;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s_bits[i] = bits[i];
  __syncthreads();
  return s_bits;
}

// ---------------------------------------------------------------------------
// K5: post-CRUSH filter (no primary affinity)
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ops/crush/pallas_draw.py:make_post_kernel (pallas_call
// at :503).  Per lane: keep the slots that hold an OSD id in [0, D) with
// its exists&up bit set, others become ITEM_NONE; with can_shift the
// survivors move to the front in order; the primary is the first survivor
// (-1 for none).  Bound: bytes, the raw rows read once and the up rows
// and primaries written once.  Design: one thread per lane; the keep set
// is a bitmask in shared memory (1000 OSDs: 128 bytes), so a lookup is
// one shared read and a shift where the TPU kernel needed a one-hot MXU
// fetch.  Rows are written slot by slot, so S has no upper limit.
__global__ void __launch_bounds__(kThreads)
post_kernel(const int* __restrict__ raw, const uint32_t* __restrict__ keep,
            int D, int S, int can_shift, int smem_words, long long L,
            int* __restrict__ up, int* __restrict__ prim) {
  extern __shared__ uint32_t s_bits[];
  const uint32_t* bits = stage_bits(keep, s_bits, smem_words);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x; l < L;
       l += stride) {
    const int* in = raw + l * S;
    int* out = up + l * S;
    int n = 0;
    int first = -1;
    for (int j = 0; j < S; ++j) {
      const int v = in[j];
      const bool k = has_bit(bits, v, D);
      if (k && first < 0) first = v;
      if (can_shift) {
        if (k) out[n++] = v;
      } else {
        out[j] = k ? v : kItemNone;
      }
    }
    if (can_shift)
      for (int j = n; j < S; ++j) out[j] = kItemNone;
    prim[l] = first;
  }
}

// ---------------------------------------------------------------------------
// K6: remap hit scan
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ops/crush/pallas_draw.py:make_hitscan_kernel
// (pallas_call at :562).  hit[l] = some slot of raw[l] holds an OSD id in
// [0, D) whose changed bit is set.  Bound: bytes, the raw rows read once
// and one byte a lane written.  Design: one thread per lane, the changed
// set a bitmask in shared memory.
__global__ void __launch_bounds__(kThreads)
hitscan_kernel(const int* __restrict__ raw, const uint32_t* __restrict__ changed,
               int D, int S, int smem_words, long long L,
               bool* __restrict__ hit) {
  extern __shared__ uint32_t s_bits[];
  const uint32_t* bits = stage_bits(changed, s_bits, smem_words);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x; l < L;
       l += stride) {
    const int* in = raw + l * S;
    bool h = false;
    for (int j = 0; j < S; ++j) h |= has_bit(bits, in[j], D);
    hit[l] = h;
  }
}

// ---------------------------------------------------------------------------
// K7: row-group compaction
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ops/crush/pallas_draw.py:make_rowcompact_kernel
// (pallas_call at :707).  Lanes form groups of `row`; for group g, slot
// j < min(cnt[g], kt) of idx[g*kt ..] is the j-th hit lane in ascending
// order, pad slots hold the group's base lane g*row, valid = slot <
// cnt[g] (every hit lane is below pg_num: hits at or above it are
// ignored), cnt[g] the group's hit count (> kt shows an overflow; the
// slots then hold the first kt hits).  Bound: bytes, one byte a lane
// read and the kt slots of each group written.  Design: one block per
// group (grid-stride over groups), 256 lanes per step: a warp's hits come
// from __ballot_sync, its prefix from __popc of the lower lanes' bits,
// and the eight warps' counts are scanned in shared memory, so every hit
// gets its slot without atomics and the order is deterministic.  The
// ragged last group is masked; the TPU's alignment rule does not apply.
__global__ void __launch_bounds__(kThreads)
rowcompact_kernel(const bool* __restrict__ hit, long long n, long long pg_num,
                  int row, int kt, long long nr, int* __restrict__ idx,
                  bool* __restrict__ valid, int* __restrict__ cnt) {
  __shared__ int s_warp[kThreads / 32];
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long limit = n < pg_num ? n : pg_num;
  for (long long g = blockIdx.x; g < nr; g += gridDim.x) {
    const long long base = g * row;
    int* gidx = idx + g * kt;
    bool* gvalid = valid + g * kt;
    int running = 0;
    for (int t = 0; t < row; t += blockDim.x) {
      const int off = t + threadIdx.x;
      const long long lane = base + off;
      const bool h = off < row && lane < limit && hit[lane];
      const unsigned m = __ballot_sync(0xffffffffu, h);
      const int pre = __popc(m & ((1u << lane_id) - 1u));
      if (lane_id == 0) s_warp[warp] = __popc(m);
      __syncthreads();
      int woff = 0, total = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int c = s_warp[w];
        woff += w < warp ? c : 0;
        total += c;
      }
      const int slot = running + woff + pre;
      if (h && slot < kt) gidx[slot] = (int)lane;
      running += total;
      __syncthreads();              // s_warp is rewritten next step
    }
    for (int s = threadIdx.x; s < kt; s += blockDim.x) {
      if (s >= running) gidx[s] = (int)base;
      gvalid[s] = s < running;
    }
    if (threadIdx.x == 0) cnt[g] = running;
  }
}

}  // namespace

extern "C" {

int crush_descend(const void* x, const void* r, const void* bid,
                  const void* pos, const void* items, const void* ids,
                  const void* weights, const void* bsize, const void* btype,
                  const void* levels, int n_levels, int B, int S, int n_pos,
                  int max_devices, int want_type, const void* ln_tbl,
                  long long L, void* item, void* status, void* stream) {
  cudaGetLastError();
  if (L < 1 || B < 1 || S < 1 || n_pos < 1 || n_levels < 0)
    return (int)cudaErrorInvalidValue;
  descend_kernel<<<grid_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (const int*)r, (const int*)bid, (const int*)pos,
      (const int*)items, (const int*)ids, (const long long*)weights,
      (const int*)bsize, (const int*)btype, (const int*)levels, n_levels, B,
      S, n_pos, max_devices, want_type, (const unsigned long long*)ln_tbl, L,
      (int*)item, (int*)status);
  return (int)cudaGetLastError();
}

int crush_post(const void* raw, const void* keep_bits, int D, int S,
               int can_shift, int smem_words, long long L, void* up,
               void* prim, void* stream) {
  cudaGetLastError();
  if (L < 1 || S < 1 || D < 0) return (int)cudaErrorInvalidValue;
  post_kernel<<<grid_for(L), kThreads, (size_t)smem_words * 4,
                (cudaStream_t)stream>>>(
      (const int*)raw, (const uint32_t*)keep_bits, D, S, can_shift,
      smem_words, L, (int*)up, (int*)prim);
  return (int)cudaGetLastError();
}

int crush_hitscan(const void* raw, const void* changed_bits, int D, int S,
                  int smem_words, long long L, void* hit, void* stream) {
  cudaGetLastError();
  if (L < 1 || S < 1 || D < 0) return (int)cudaErrorInvalidValue;
  hitscan_kernel<<<grid_for(L), kThreads, (size_t)smem_words * 4,
                   (cudaStream_t)stream>>>(
      (const int*)raw, (const uint32_t*)changed_bits, D, S, smem_words, L,
      (bool*)hit);
  return (int)cudaGetLastError();
}

int crush_rowcompact(const void* hit, long long n, long long pg_num, int row,
                     int kt, void* idx, void* valid, void* cnt, void* stream) {
  cudaGetLastError();
  if (n < 1 || row < 1 || kt < 1) return (int)cudaErrorInvalidValue;
  const long long nr = (n + row - 1) / row;
  const int grid = (int)(nr < 132 * 16 ? nr : 132 * 16);
  rowcompact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bool*)hit, n, pg_num, row, kt, nr, (int*)idx, (bool*)valid,
      (int*)cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
