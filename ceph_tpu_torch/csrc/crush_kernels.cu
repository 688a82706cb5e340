// CRUSH placement kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ceph_tpu_torch/_build.py), beside the EC
// kernels in one library.
//
// The bulk mapper (ceph_tpu_torch/ops/crush/device.py) runs every PG of
// a pool as one lane.  Four kernels carry it:
//   K4 crush_choose      each lane's whole choose step (one thread a lane),
//                        a pool's pps seeds included;
//   K5 crush_post        the up-filter, stable compaction and primary;
//   K6 crush_hitscan     the lanes a changed OSD set touches (remap);
//   K7 crush_rowcompact  the indices of hit lanes per row group.
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
constexpr int kItemUndef = 0x7FFFFFFE;
constexpr int kRhLhEntries = 258;            // 129 (reciprocal, log) pairs
constexpr int kLnEntries = kRhLhEntries + 256;
constexpr int kLnBytes = kLnEntries * 8;     // 4112, a multiple of 16
constexpr long long kLnOne = 1LL << 48;
constexpr long long kQNone = 0x7FFFFFFFFFFFFFFFLL;

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

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
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
// K4: the choose step
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ops/crush/pallas_draw.py:make_descend_kernel
// (pallas_call at :418) together with the loops the reference runs around
// it, the optimistic pass and the full retry loops of
// ceph_tpu/ops/crush/device.py:780-1109.  One thread runs one lane's
// crush_choose_firstn or crush_choose_indep (mapper.c:438-821, local
// tries 0) to its end and writes the lane's raw row:
//   firstn  per replica, descents at r = rep + ftotal until one is placed,
//           fails for good (a wrong-type or out-of-range device, a missing
//           bucket) or `tries` have been taken; a pick that collides with
//           the row, is out (reweight rejection, mapper.c:402-416) or,
//           under chooseleaf, finds no leaf in `recurse` inner descents
//           (r = sub_r + ift, sub_r = r >> (vary_r - 1) plus outpos unless
//           stable; a leaf already in the row or out is retried) is
//           retried; choose_args position outpos;
//   indep   rounds ftotal = 0, 1, ...: every UNDEF slot draws at
//           r = rep + numrep * ftotal (inner descents at r + rep +
//           numrep * ift, position rep); a permanent failure is
//           ITEM_NONE at once, a slot still UNDEF at the end too.
// Each descent walks bucket to bucket from its start, drawing every item:
//   draw_i = trunc((crush_ln(hash32_3(x, id_i, r) & 0xffff) - 2^48) / w_i)
// (S64_MIN for w_i == 0), and takes the first item with the strictly
// greatest draw.  With a = 2^48 - crush_ln(u) in [0, 2^48] the draw is
// -floor(a / w): the kernel takes q = trunc(a * (1/w)) in float64 (the
// reciprocal precomputed per weight; the product is within 2^-4 of a / w)
// and corrects it by one exact integer step, so no integer division is
// emulated and the result is the host engine's for every input.
// A lane's input x is the caller's xs[l] or, for a pool pass (xs null),
// the lane's pps seed, which its thread hashes itself from the pool's
// raw_pg_to_pps arguments (lane_x): one hash32_2 against the ~200
// straw2 draws a lane takes, and no seed pass or seed buffer before the
// launch; xs_out, where given, receives the seeds for the post filter's
// primary affinity.
// Bound: operations.  Every draw costs one rjenkins hash, at least 137
// issue slots (45 mix steps of IADD3, SHF and LOP3, plus the input XORs),
// the crush_ln lookup and the draw; the hash's subtractions, XORs and
// shifts all belong to the integer ALU pipe, which takes 64 lanes per SM
// per clock, half the card's issue slots.  The bytes moved (at most 8 in,
// 4 per slot out) are three orders of magnitude below the card's rate.
// Design: no lane waits on another, so the retry loops run per thread
// with no host round trips and no full-width pass over lanes that are
// done (the TPU kernel, with no per-lane control flow, ran every lane
// through every level and attempt).  The loop is a state machine: each
// trip is one attempt of the lane a thread holds, and a thread takes the
// next unassigned lane as soon as one is done (one wave of resident
// blocks, lanes handed out by a counter, one atomic per warp and trip),
// so no thread idles until the lanes run out, and a warp does not wait
// for the slowest lane of every replica.  A descent draws two items a
// step, two independent hash chains for the scheduler to interleave.
// The map's bucket rows (reciprocals, weights, items, hash ids, row
// offsets, types: ~21 KiB for a 1000-OSD map) and the crush_ln tables are
// staged in shared memory when they fit, so the inner draws of a warp,
// whose lanes sit in different hosts, read shared memory, not device
// memory; a larger map is read from device memory (the kStaged = false
// instance).  A lane's picks and leaves live in its rows of the output
// (and of a scratch buffer under chooseleaf), so any width maps.
constexpr int kMaxLevels = 16;
constexpr int kChooseThreads = 256;
constexpr int kStOk = 1;
constexpr int kStPerm = 2;

struct ChoosePlan {
  int take_bid, numrep, slots, want_type, firstn, leaf, tries, recurse,
      vary_r, stable, n_outer, n_inner;
  int outer[kMaxLevels];                     // level widths of the descents
  int inner[kMaxLevels];
};

// The packed map (kernels.CrushTables.packed): reciprocals float64
// [n_pos][N], weights uint32 [n_pos][N], items [N], hash ids [N], row
// offsets [B + 1], types [B].
struct MapView {
  const double* rcp;
  const uint32_t* w;
  const int* item;
  const int* id;
  const int* off;
  const int* type;
  int N, B, n_pos, max_devices;
};

__device__ __forceinline__ MapView map_view(const unsigned char* base, int N,
                                            int B, int n_pos,
                                            int max_devices) {
  MapView m;
  m.rcp = reinterpret_cast<const double*>(base);
  m.w = reinterpret_cast<const uint32_t*>(base + (size_t)n_pos * N * 8);
  m.item = reinterpret_cast<const int*>(base + (size_t)n_pos * N * 12);
  m.id = m.item + N;
  m.off = m.id + N;
  m.type = m.off + B + 1;
  m.N = N;
  m.B = B;
  m.n_pos = n_pos;
  m.max_devices = max_devices;
  return m;
}

// raw_pg_to_pps's arguments (osd_types.cc:1815-1831), for a launch whose
// lanes hash their own seeds: lane l's ps is lanes[l], or base + l where
// lanes is null.
struct PpsArgs {
  long long base;
  const long long* lanes;
  uint32_t pgp_num, pgp_mask, pool;
  int hashpspool;
};

// Lane l's input: xs[l] where the caller gave inputs, else its pps seed,
// the stable mod of its ps into pgp_num then the pool mix (the plain
// version is ops/crush/kernels.py pps_seed).
__device__ __forceinline__ uint32_t lane_x(const long long* __restrict__ xs,
                                           const PpsArgs& a, long long l) {
  if (xs) return (uint32_t)xs[l];
  const uint32_t ps = (uint32_t)(a.lanes ? a.lanes[l] : a.base + l);
  const uint32_t m = ps & a.pgp_mask;
  const uint32_t masked = m < a.pgp_num ? m : ps & (a.pgp_mask >> 1);
  return a.hashpspool ? hash32_2(masked, a.pool) : masked + a.pool;
}

struct LnTables {
  const unsigned long long* rhlh;
  const unsigned long long* ll;
};

// floor((2^48 - crush_ln(hash32_3(x, id, r) & 0xffff)) / w) for w > 0.
__device__ __forceinline__ long long draw_q(uint32_t x, uint32_t id,
                                            uint32_t r, uint32_t w,
                                            double rcp, const LnTables& ln) {
  const uint32_t u = hash32_3(x, id, r) & 0xffffu;
  const long long a = kLnOne - crush_ln(u, ln.rhlh, ln.ll);
  long long q = __double2ll_rz(__dmul_rn(__ll2double_rn(a), rcp));
  const long long rem = a - q * (long long)w;
  if (rem < 0) {
    --q;
  } else if (rem >= (long long)w) {
    ++q;
  }
  return q;
}

// The straw2 descent from bucket index `cur` (kernels.descend_plain):
// returns the item and sets status to ok, perm or neither (retryable).
__device__ int descend(const MapView& m, int cur, const int* levels,
                       int n_levels, int want, uint32_t x, uint32_t r, int pos,
                       const LnTables& ln, int& status) {
  status = 0;
  if (cur < 0 || cur >= m.B) return kItemNone;
  int row = m.off[cur];
  int size = m.off[cur + 1] - row;
  if (size == 0) return kItemNone;
  const int p = pos < 0 ? 0 : (pos >= m.n_pos ? m.n_pos - 1 : pos);
  const uint32_t* wp = m.w + (size_t)p * m.N;
  const double* rp = m.rcp + (size_t)p * m.N;
  for (int d = 0; d < n_levels; ++d) {
    const int n = size < levels[d] ? size : levels[d];
    // two items a step: their hashes are independent chains, which the
    // scheduler interleaves; a zero weight draws S64_MIN (q = kQNone)
    int best = 0;
    long long best_q = kQNone;
    int i = 0;
    for (; i + 2 <= n; i += 2) {
      const int e = row + i;
      const uint32_t w0 = wp[e], w1 = wp[e + 1];
      long long q0 = draw_q(x, (uint32_t)m.id[e], r, w0, rp[e], ln);
      long long q1 = draw_q(x, (uint32_t)m.id[e + 1], r, w1, rp[e + 1], ln);
      q0 = w0 ? q0 : kQNone;
      q1 = w1 ? q1 : kQNone;
      if (q0 < best_q) {                     // the greatest draw, first wins
        best_q = q0;
        best = i;
      }
      if (q1 < best_q) {
        best_q = q1;
        best = i + 1;
      }
    }
    if (i < n && wp[row + i] != 0 &&
        draw_q(x, (uint32_t)m.id[row + i], r, wp[row + i], rp[row + i], ln) <
            best_q)
      best = i;
    const int chosen = m.item[row + best];
    if (chosen >= 0) {
      status = (chosen < m.max_devices && want == 0) ? kStOk : kStPerm;
      return status == kStOk ? chosen : kItemNone;
    }
    const int cb = -1 - chosen;
    if (cb >= m.B) {
      status = kStPerm;
      return kItemNone;
    }
    if (m.type[cb] == want) {
      status = kStOk;
      return chosen;
    }
    row = m.off[cb];
    size = m.off[cb + 1] - row;
    if (size == 0) return kItemNone;         // an empty child: retry
  }
  return kItemNone;
}

__device__ __forceinline__ bool is_out(const int* __restrict__ dev_w, int D,
                                       int item, uint32_t x) {
  if (item < 0 || item >= D) return true;
  const int w = __ldg(dev_w + item);
  if (w >= 0x10000) return false;
  if (w <= 0) return true;
  return (int)(hash32_2(x, (uint32_t)item) & 0xffffu) >= w;
}

// One attempt of a lane's current replica: the outer descent at r and,
// under chooseleaf, up to P.recurse leaf descents at r0 + step * ift.
// Returns 1 placed (item, leaf set), 2 failed for good, 0 retry.
// firstn: collisions against out[0..outpos) and leaves[0..outpos);
// indep: against out[0..slots) only.
__device__ __forceinline__ int attempt(const ChoosePlan& P, const MapView& m,
                                       const int* __restrict__ dev_w, int D,
                                       uint32_t x, const LnTables& ln, int r,
                                       int pos, int r0, int step, int ipos,
                                       const int* out, const int* leaves,
                                       int ncheck, int& item, int& leaf) {
  int st;
  item = descend(m, P.take_bid, P.outer, P.n_outer, P.want_type, x,
                 (uint32_t)r, pos, ln, st);
  if (st & kStPerm) return 2;
  if (!(st & kStOk)) return 0;
  for (int j = 0; j < ncheck; ++j)
    if (out[j] == item) return 0;
  leaf = item;
  if (P.leaf && item < 0) {
    bool found = false;
    for (int ift = 0; ift < P.recurse && !found; ++ift) {
      int cst;
      const int cand = descend(m, -1 - item, P.inner, P.n_inner, 0, x,
                               (uint32_t)(r0 + step * ift), ipos, ln, cst);
      if (cst & kStPerm) break;
      if (!(cst & kStOk)) continue;
      bool dup = false;
      if (P.firstn)
        for (int j = 0; j < ncheck; ++j) dup |= leaves[j] == cand;
      if (dup || is_out(dev_w, D, cand, x)) continue;
      leaf = cand;
      found = true;
    }
    if (!found) return 0;
  }
  if (P.want_type == 0 && is_out(dev_w, D, item, x)) return 0;
  return 1;
}

template <bool kStaged>
__global__ void __launch_bounds__(kChooseThreads)
choose_kernel(const long long* __restrict__ xs, const PpsArgs pps,
              long long* __restrict__ xs_out, long long L,
              const ChoosePlan plan, const unsigned char* __restrict__ packed,
              int packed_bytes, int N, int B, int n_pos, int max_devices,
              const int* __restrict__ dev_w, int D,
              const unsigned long long* __restrict__ ln_tbl,
              unsigned long long* __restrict__ next, int* picks, int* rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ChoosePlan s_plan;
  unsigned long long* s_ln = reinterpret_cast<unsigned long long*>(smem);
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x) s_ln[i] = ln_tbl[i];
  const unsigned char* base = packed;
  if (kStaged) {
    uint4* dst = reinterpret_cast<uint4*>(smem + kLnBytes);
    const uint4* src = reinterpret_cast<const uint4*>(packed);
    for (int i = threadIdx.x; i < packed_bytes / 16; i += blockDim.x)
      dst[i] = src[i];
    base = smem + kLnBytes;
  }
  if (threadIdx.x == 0) s_plan = plan;
  __syncthreads();
  const ChoosePlan& P = s_plan;
  const MapView m = map_view(base, N, B, n_pos, max_devices);
  const LnTables ln = {s_ln, s_ln + kRhLhEntries};
  const int slots = P.slots;
  const int empty = P.firstn ? kItemNone : kItemUndef;
  // one trip = one attempt of the lane this thread holds; when a lane is
  // done its thread takes the next unassigned one (the first grid's
  // worth statically, the rest from a counter, one atomic per warp), so
  // every thread stays busy until the lanes run out.  The lane's picks
  // and leaves are its rows of `picks` and `rows` (one buffer unless
  // chooseleaf), so a row has no width limit.
  const long long first = (long long)gridDim.x * blockDim.x;
  const unsigned lanemask_lt = (1u << (threadIdx.x & 31)) - 1u;
  long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int rep = 0, ftotal = 0, outpos = 0, left = slots;
  uint32_t x = 0;
  int* out = picks;
  int* leaves = rows;
  if (l < L) {
    x = lane_x(xs, pps, l);
    if (xs_out) xs_out[l] = x;
    out = picks + l * slots;
    leaves = rows + l * slots;
    for (int j = 0; j < slots; ++j) out[j] = leaves[j] = empty;
  }
  while (__any_sync(0xffffffffu, l < L)) {
    bool done = false;
    if (l < L) {
      int item = kItemNone, leaf = kItemNone;
      if (P.firstn) {
        const int r = rep + ftotal;
        const int r0 =
            (P.vary_r ? (r >> (P.vary_r - 1)) : 0) + (P.stable ? 0 : outpos);
        const int res = attempt(P, m, dev_w, D, x, ln, r, outpos, r0, 1,
                                outpos, out, leaves, outpos, item, leaf);
        if (res == 1) {
          out[outpos] = item;
          leaves[outpos] = leaf;
          ++outpos;
        }
        if (res != 0 || ++ftotal >= P.tries) {
          ++rep;
          ftotal = 0;
        }
        done = rep >= P.numrep || outpos >= slots;
      } else {
        const int r = rep + P.numrep * ftotal;
        const int res = attempt(P, m, dev_w, D, x, ln, r, 0, r + rep,
                                P.numrep, rep, out, leaves, slots, item,
                                leaf);
        if (res != 0) {
          out[rep] = res == 1 ? item : kItemNone;
          leaves[rep] = res == 1 ? leaf : kItemNone;
          --left;
        }
        // the next UNDEF slot, round by round (mapper.c:658-663)
        do {
          if (++rep >= slots) {
            rep = 0;
            ++ftotal;
          }
        } while (left > 0 && ftotal < P.tries && out[rep] != kItemUndef);
        done = left == 0 || ftotal >= P.tries;
        if (done)
          for (int j = 0; j < slots; ++j)
            if (leaves[j] == kItemUndef) leaves[j] = kItemNone;
      }
    }
    const unsigned need = __ballot_sync(0xffffffffu, done);
    if (need == 0) continue;
    unsigned long long got = 0;
    if ((threadIdx.x & 31) == __ffs(need) - 1)
      got = atomicAdd(next, (unsigned long long)__popc(need));
    got = __shfl_sync(0xffffffffu, got, __ffs(need) - 1);
    if (done) {
      l = first + (long long)got + __popc(need & lanemask_lt);
      rep = ftotal = outpos = 0;
      left = slots;
      if (l < L) {
        x = lane_x(xs, pps, l);
        if (xs_out) xs_out[l] = x;
        out = picks + l * slots;
        leaves = rows + l * slots;
        for (int j = 0; j < slots; ++j) out[j] = leaves[j] = empty;
      }
    }
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
// read and the kt slots of each group written (5 bytes a slot, 4 a
// group).  Design: a team of 128 threads covers 2048 lanes of a group per
// step, 16 lanes a thread: one 16-byte load where the lanes are aligned
// and whole (the group's start a multiple of 16), masked byte loads at
// the ragged edges, in the same code.  Each thread turns its 16 bytes
// into a 16-bit hit mask, a warp scan of the masks' popcounts
// (__shfl_up_sync) gives each thread its place in its warp, and one
// combine of the four warps' totals through shared memory (a named
// barrier per team) its place in the step; the thread then writes its
// hits' lanes in order, so slots ascend without atomics.  Four teams a
// block, each walking its own groups (grid-stride), so a barrier holds
// only the team it serves.
constexpr int kRcTeam = 128;
constexpr int kRcTeams = 4;
constexpr int kRcSpan = kRcTeam * 16;

// 4 bool bytes (0 or 1) -> 4 bits, byte j to bit j.
__device__ __forceinline__ unsigned bits4(uint32_t v) {
  v = __vcmpne4(v, 0u) & 0x01010101u;
  return (v * 0x01020408u) >> 24;
}

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(kRcTeam) : "memory");
}

__global__ void __launch_bounds__(kRcTeam* kRcTeams)
rowcompact_kernel(const unsigned char* __restrict__ hit, long long n,
                  long long pg_num, int row, int kt, long long nr, int vec,
                  int* __restrict__ idx, bool* __restrict__ valid,
                  int* __restrict__ cnt) {
  __shared__ int s_tot[kRcTeams][kRcTeam / 32];
  const int team = threadIdx.x / kRcTeam;
  const int t = threadIdx.x % kRcTeam;
  const int lane_id = t & 31;
  const int warp = t >> 5;
  const long long limit = n < pg_num ? n : pg_num;
  for (long long g = (long long)blockIdx.x * kRcTeams + team; g < nr;
       g += (long long)gridDim.x * kRcTeams) {
    const long long base = g * row;
    int* gidx = idx + g * kt;
    bool* gvalid = valid + g * kt;
    int running = 0;
    for (int s = 0; s < row; s += kRcSpan) {
      const int off = s + t * 16;
      const long long lane0 = base + off;
      unsigned mask = 0;
      if (vec && off + 16 <= row && lane0 + 16 <= limit) {
        const uint4 v = *reinterpret_cast<const uint4*>(hit + lane0);
        mask = bits4(v.x) | (bits4(v.y) << 4) | (bits4(v.z) << 8) |
               (bits4(v.w) << 12);
      } else {
        for (int j = 0; j < 16; ++j)
          if (off + j < row && lane0 + j < limit && hit[lane0 + j])
            mask |= 1u << j;
      }
      const int c = __popc(mask);
      int inc = c;                           // inclusive scan in the warp
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane_id >= d) inc += y;
      }
      if (lane_id == 31) s_tot[team][warp] = inc;
      team_sync(team);
      int woff = 0, total = 0;
      for (int w = 0; w < kRcTeam / 32; ++w) {
        const int v = s_tot[team][w];
        woff += w < warp ? v : 0;
        total += v;
      }
      int slot = running + woff + inc - c;
      for (; mask; mask &= mask - 1, ++slot)
        if (slot < kt) gidx[slot] = (int)(lane0 + __ffs(mask) - 1);
      running += total;
      team_sync(team);                       // s_tot is rewritten next step
    }
    for (int s = t; s < kt; s += kRcTeam) {
      if (s >= running) gidx[s] = (int)base;
      gvalid[s] = s < running;
    }
    if (t == 0) cnt[g] = running;
  }
}

}  // namespace

extern "C" {

int crush_choose(const void* x, long long base, const void* lanes,
                 unsigned pgp_num, unsigned pgp_mask, unsigned pool,
                 int hashpspool, void* x_out, long long L, const void* packed,
                 int packed_bytes, int N, int B, int n_pos, int max_devices,
                 int staged, const void* plan_ints, const void* dev_w, int D,
                 const void* ln_tbl, void* next, void* picks, void* rows,
                 void* stream) {
  cudaGetLastError();
  const int* pi = (const int*)plan_ints;
  ChoosePlan plan;
  int* head = &plan.take_bid;
  for (int i = 0; i < 12; ++i) head[i] = pi[i];
  for (int i = 0; i < kMaxLevels; ++i) {
    plan.outer[i] = pi[12 + i];
    plan.inner[i] = pi[12 + kMaxLevels + i];
  }
  if (L < 1 || N < 0 || B < 1 || n_pos < 1 || packed_bytes % 16 ||
      plan.slots < 1 || plan.n_outer < 1 ||
      plan.n_outer > kMaxLevels || plan.n_inner < 0 ||
      plan.n_inner > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const int smem = kLnBytes + (staged ? packed_bytes : 0);
  auto kern = staged ? choose_kernel<true> : choose_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kChooseThreads,
                                                smem);
  // one wave of resident blocks: each stages the map once, and its
  // threads take lanes from the counter until none are left
  const long long cap = (long long)(sms > 0 ? sms : 132) * (occ > 0 ? occ : 1);
  long long blocks = (L + kChooseThreads - 1) / kChooseThreads;
  if (blocks > cap) blocks = cap;
  err = cudaMemsetAsync(next, 0, sizeof(unsigned long long),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const PpsArgs pps = {base, (const long long*)lanes, pgp_num, pgp_mask, pool,
                       hashpspool};
  kern<<<(int)blocks, kChooseThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)x, pps, (long long*)x_out, L, plan,
      (const unsigned char*)packed, packed_bytes, N, B, n_pos, max_devices,
      (const int*)dev_w, D,
      (const unsigned long long*)ln_tbl, (unsigned long long*)next,
      (int*)picks, (int*)rows);
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
                     int kt, int vec, void* idx, void* valid, void* cnt,
                     void* stream) {
  cudaGetLastError();
  if (n < 1 || row < 1 || kt < 1) return (int)cudaErrorInvalidValue;
  const long long nr = (n + row - 1) / row;
  const long long blocks = (nr + kRcTeams - 1) / kRcTeams;
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  rowcompact_kernel<<<grid, kRcTeam * kRcTeams, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)hit, n, pg_num, row, kt, nr, vec, (int*)idx,
      (bool*)valid, (int*)cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
