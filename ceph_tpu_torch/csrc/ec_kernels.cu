// Erasure-code region kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (ceph_tpu_torch/_build.py).
//
// All three compute GF(2^w) region products through the (rows x k*w)
// 0/1 bitmatrix of matrices.matrix_to_bitmatrix: output bit y of word i
// is the XOR of the input bits (j, x) that row i*w+y selects.  The
// bitmatrix is a runtime argument (every decode signature has its own):
// K1 and K2 take packed row masks (row r is eight uint32 words, bit c
// of the row = bitmatrix[r][c], so one row covers k*w <= 256 input
// bits), K3 the rows' lists of set bits (kernels.XorSchedule) over at
// most 256 input rows.
//
// Wider products are sums of launches: the wrapper cuts the input
// rows into slices of at most 256 bits (whole chunks; w divides 256),
// and each launch after the first runs with `accumulate` set, so its
// epilogue XORs the slice's result into the output instead of storing
// it.  The XOR of the slices happens in the kernels.  (The mma's K
// loop is not simply lengthened: the epilogue packs popcounts several
// to a word and relies on a count being at most 256.)
//
// Each kernel launches on the caller's stream, allocates nothing and
// does not synchronise; each C entry returns cudaGetLastError() so a
// refused launch reaches the Python wrapper, which raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaskWords = 8;      // 256 input bits per bitmatrix row

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// ---------------------------------------------------------------------------
// K1 and K2: one GF(2) product on the tensor cores
// ---------------------------------------------------------------------------
// K1 replaces ceph_tpu/ec/kernels.py:_fused_xor_pallas (:348, pallas_call
// at :413), the byte layout: (k, P) uint32 lanes of byte chunks.  K2
// replaces _ec_tile_kernel / _encode_pallas (:89 / :103, pallas_call at
// :124), w-bit words (w = 8, 16, 32; the TPU left w=16/32 to XLA).  Both
// are one function: column c of the (k, n) input is the vector of its
// k*w input bits, bit j*w + x = bit x of element (j, c) (at w=8 in K1's
// byte layout the elements are the bytes), and output bit y of element
// (i, c) is popc(row i*w+y & column) & 1.
//
// Bound: bytes, each input byte read once and each output byte
// written once.  The products themselves are far under it: the 1-bit
// m16n8k256 product issues once every ~6.7 clocks per SM sub-partition
// and m16n8k128 every ~4.5 (tools/b1_mma_rate.cu), ~27 us of tensor
// work at k=8, m=3 and 32 MiB a row.  What comes nearest the bound is
// issuing the integer instructions around them (permutes, merges,
// multiply-adds, selects): every 32-bit integer operation issues at 64
// lanes a SM a clock, one warp instruction every two clocks per
// sub-partition, on whichever pipe.  At k=8, m=3 a warp's step over
// 256 bytes of each row takes ~680 SASS instructions, ~0.33 per input
// byte (the earlier K1 took 722 per 32-byte group of a thread, ~0.7 per
// input byte, with a predicated AND/XOR for every (row, bit) pair; the
// earlier K2 issued eight shared-memory mask loads for every output
// bit).
//
// Design: mma.sync m16n8k128 / m16n8k256 .b1 .and.popc computes 128
// popcounts at once.  The 16 rows of A are data columns (a warp's 16
// blocks of 16 bytes of every input row, one column of each block per
// product), the 8 columns of B are bitmatrix rows (the packed rows are
// already B's fragments; staged in shared memory in fragment order
// once per block), K is the k*w input bits (zero-padded; zero bits
// change no parity).  Thread (g, t) loads 16 bytes of each input
// row its K slots cover (a slot is 32 bits: four rows at w=8, two at
// w=16, one at w=32) and turns them into column words with byte or
// half-word permutes.  Sixteen products give a thread 64 popcounts for
// two rows of every output byte of its group's two blocks; multiply-
// adds gather their parity bits four to a word, the words are
// OR-reduced across the four threads of the group, and each thread
// stores one 4-byte word of each block.  The matrices stay runtime
// arguments, so every decode signature runs through the same compiled
// kernel.  Ragged edges and views that are not 16-byte aligned load
// and store element by element, masked.
constexpr int kProductWarps = 4;    // warps per block
constexpr int kMaxProductTiles = 128;   // 8-row tiles: m*w <= 1024

template <int W>
struct Word;
template <> struct Word<8> { typedef uint8_t T; };
template <> struct Word<16> { typedef uint16_t T; };
template <> struct Word<32> { typedef uint32_t T; };

// 4x4 byte transpose: afterwards x[c] byte r == (before) x[r] byte c.
__device__ __forceinline__ void transpose4x4(uint32_t& x0, uint32_t& x1,
                                             uint32_t& x2, uint32_t& x3) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  x0 = __byte_perm(t0, t2, 0x5410);
  x1 = __byte_perm(t0, t2, 0x7632);
  x2 = __byte_perm(t1, t3, 0x5410);
  x3 = __byte_perm(t1, t3, 0x7632);
}

// d[0..3] = popc(A & B) for one m16n8 tile (fragments as in the PTX
// ISA: a0/a2 row g, a1/a3 row g+8, K bits 32t.. (a0, a1, b0) and
// 128+32t.. (a2, a3, b1); d (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1)).
template <bool K256>
__device__ __forceinline__ void popc_mma(int d[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint2 b) {
  if constexpr (K256) {
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y), "r"(0));
  } else {
    asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a0), "r"(a1), "r"(b.x), "r"(0));
  }
}

// in (k, n) and out (m, n) elements of W bits, rows n*W/8 bytes apart;
// masks (m*W, 8) packed rows.  vin: every row start 16-byte aligned
// (else every step loads element by element); vout: every output row
// start 4-byte aligned; acc: XOR the product into out (a later
// slice).  Dynamic shared memory: the B fragments.  A warp's step
// covers 256 bytes of every row: 16 blocks of 16 bytes, block b*8 + g
// holding the columns of A row g (b = 0) or g+8 (b = 1).
template <int W, bool K256>
__global__ void __launch_bounds__(32 * kProductWarps)
gf2_product_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const uint32_t* __restrict__ masks, int k, int m,
                   long long n, int vin, int vout, int acc) {
  typedef typename Word<W>::T T;
  constexpr int kSlots = K256 ? 2 : 1;   // 32-bit K slots a thread holds
  constexpr int kRows = 32 / W;          // input rows in one slot
  constexpr int kCols = 128 / W;         // columns in 16 bytes
  constexpr int kBytes = W / 8;          // bytes of an element
  extern __shared__ uint2 frag[];   // [tile][lane]
  const int tiles = m * W / 8;
  for (int x = threadIdx.x; x < tiles * 32; x += blockDim.x) {
    const int row = (x >> 5) * 8 + ((x & 31) >> 2), t = x & 3;
    frag[x] = make_uint2(masks[row * kMaskWords + t],
                         K256 ? masks[row * kMaskWords + 4 + t] : 0u);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long row_bytes = n * kBytes;
  const long long iters = ceil_div(row_bytes, 256);
  const long long stride = (long long)gridDim.x * kProductWarps;
  const long long first = (long long)blockIdx.x * kProductWarps + warp;
  const uint32_t mul0 = 1u << (2 * t);   // shift of rows 2t, 2t+1 in a byte
  const uint8_t* tsrc = in + (long long)t * kRows * row_bytes + g * 16;
  for (long long it = first; it < iters; it += stride) {
    // v[s][b][r]: the 16-byte block b*8 + g of row (t + 4s)*kRows + r,
    // zero past row k
    uint32_t v[kSlots][2][kRows][4];
    // 16 bytes at a time when all 256 bytes of the step lie in the rows
    // and the rows are 16-byte aligned; else element by element
    if (vin && (it + 1) * 256 <= row_bytes) {
      const uint8_t* src = tsrc + it * 256;
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int j = (t + 4 * s) * kRows + r;
            uint4 q = make_uint4(0u, 0u, 0u, 0u);
            if (j < k)
              q = __ldg(reinterpret_cast<const uint4*>(
                  src + (long long)(4 * s * kRows + r) * row_bytes + b * 128));
            v[s][b][r][0] = q.x; v[s][b][r][1] = q.y;
            v[s][b][r][2] = q.z; v[s][b][r][3] = q.w;
          }
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int j = (t + 4 * s) * kRows + r;
            const long long c0 = (it * 256 + (b * 8 + g) * 16) / kBytes;
            const T* el = reinterpret_cast<const T*>(in + (long long)j * row_bytes);
            v[s][b][r][0] = v[s][b][r][1] = v[s][b][r][2] = v[s][b][r][3] = 0u;
#pragma unroll
            for (int u = 0; u < kCols; ++u)
              if (j < k && c0 + u < n)
                v[s][b][r][u / (4 / kBytes)] |= (uint32_t)el[c0 + u]
                                                << (u % (4 / kBytes) * W);
          }
    }
    // a[s][b][e]: slot s, block b (rows g and g+8 of A), column e
    uint32_t a[kSlots][2][kCols];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (W == 8) {
            uint32_t x0 = v[s][b][0][q], x1 = v[s][b][1][q],
                     x2 = v[s][b][2][q], x3 = v[s][b][3][q];
            transpose4x4(x0, x1, x2, x3);
            a[s][b][4 * q] = x0; a[s][b][4 * q + 1] = x1;
            a[s][b][4 * q + 2] = x2; a[s][b][4 * q + 3] = x3;
          } else if constexpr (W == 16) {
            a[s][b][2 * q] = __byte_perm(v[s][b][0][q], v[s][b][1][q], 0x5410);
            a[s][b][2 * q + 1] = __byte_perm(v[s][b][0][q], v[s][b][1][q], 0x7632);
          } else {
            a[s][b][q] = v[s][b][0][q];
          }
        }
    for (int i = 0; i < m; ++i) {
      uint2 bf[kBytes];
#pragma unroll
      for (int z = 0; z < kBytes; ++z) bf[z] = frag[(i * kBytes + z) * 32 + lane];
      // h[b][o]: parity bits of output block b, bytes 4o..4o+3, bit
      // 8*byte + 2t + row of this thread
      uint32_t h[2][4];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        int d[4][4];   // [byte][fragment]
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int byte = 4 * o + y, e = byte / kBytes, z = byte % kBytes;
          popc_mma<K256>(d[y], a[0][0][e], a[0][1][e],
                         a[kSlots - 1][0][e], a[kSlots - 1][1][e], bf[z]);
        }
        // lo[f] byte y bit 0: the parity of fragment f of product y.
        // A count is at most K; under 256 (K = 128) four share a word
        // a byte apart, else (K = 256, a count of 256 would carry) two
        // a half-word apart are masked first
        uint32_t lo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint32_t d0 = d[0][f], d1 = d[1][f], d2 = d[2][f],
                         d3 = d[3][f];
          if constexpr (K256) {
            const uint32_t x02 = (d2 * 0x10000u + d0) & 0x00010001u;
            const uint32_t x13 = (d3 * 0x10000u + d1) & 0x00010001u;
            lo[f] = x13 * 0x100u + x02;
          } else {
            lo[f] = ((d3 * 0x100u + d2) * 0x10000u + d1 * 0x100u + d0) &
                    0x01010101u;
          }
        }
#pragma unroll
        for (int b = 0; b < 2; ++b)
          h[b][o] = (lo[2 * b + 1] * 2u + lo[2 * b]) * mul0;
      }
      // OR-reduce across the group's four threads; thread t keeps the
      // word for bytes 4t..4t+3 of each block
      uint32_t word[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool hi = t & 2, odd = t & 1;
        uint32_t keep0 = hi ? h[b][2] : h[b][0], send0 = hi ? h[b][0] : h[b][2];
        uint32_t keep1 = hi ? h[b][3] : h[b][1], send1 = hi ? h[b][1] : h[b][3];
        keep0 |= __shfl_xor_sync(0xffffffffu, send0, 2);
        keep1 |= __shfl_xor_sync(0xffffffffu, send1, 2);
        const uint32_t keep = odd ? keep1 : keep0, send = odd ? keep0 : keep1;
        word[b] = keep | __shfl_xor_sync(0xffffffffu, send, 1);
      }
      uint8_t* orow = out + (long long)i * row_bytes;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const long long off = it * 256 + (b * 8 + g) * 16 + 4 * t;
        if (vout && off + 4 <= row_bytes) {
          uint32_t* p = reinterpret_cast<uint32_t*>(orow + off);
          *p = acc ? *p ^ word[b] : word[b];
        } else {
          T* el = reinterpret_cast<T*>(orow);
          const long long c0 = off / kBytes;
#pragma unroll
          for (int u = 0; u < 4 / kBytes; ++u)
            if (c0 + u < n) {
              const T v = (T)(word[b] >> (u * W));
              el[c0 + u] = acc ? (T)(el[c0 + u] ^ v) : v;
            }
        }
      }
    }
  }
}

template <int W, bool K256>
int launch_product(const void* in, void* out, const void* masks, int k,
                   int m, long long n, int vin, int vout, int acc,
                   cudaStream_t s) {
  const int tiles = m * W / 8;
  const size_t smem = (size_t)tiles * 32 * sizeof(uint2);
  auto kern = gf2_product_kernel<W, K256>;
  // one wave of resident blocks at most (the warps stride over the
  // rest), from the SM count and the occupancy at this shared-memory
  // size, both looked up once
  static int sm_count = 0, per_sm[kMaxProductTiles + 1];
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  int& occ = per_sm[tiles];
  if (occ == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                  32 * kProductWarps, smem);
    if (occ < 1) occ = 1;
  }
  const long long iters = ceil_div(n * (W / 8), 256);
  long long blocks = ceil_div(iters, kProductWarps);
  const long long cap = (long long)sm_count * occ;
  if (blocks > cap) blocks = cap;
  kern<<<(int)blocks, 32 * kProductWarps, smem, s>>>(
      (const uint8_t*)in, (uint8_t*)out, (const uint32_t*)masks, k, m, n,
      vin, vout, acc);
  return (int)cudaGetLastError();
}

template <int W>
int product(const void* in, void* out, const void* masks, int k, int m,
            long long n, int acc, cudaStream_t s) {
  const long long row_bytes = n * (W / 8);
  const int vin = ((uintptr_t)in % 16 == 0) && row_bytes % 16 == 0;
  const int vout = ((uintptr_t)out % 4 == 0) && row_bytes % 4 == 0;
  if (k * W <= 128)
    return launch_product<W, false>(in, out, masks, k, m, n, vin, vout, acc,
                                    s);
  return launch_product<W, true>(in, out, masks, k, m, n, vin, vout, acc, s);
}

// ---------------------------------------------------------------------------
// K3: XOR schedule on the planes8 layout
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ec/kernels.py:_xor_schedule_pallas (pallas_call at
// :210).  in (in_rows*8, P) uint8, out (out_rows*8, P) uint8: block b is
// the 8*P contiguous bytes of rows 8b..8b+7, and output block r is the
// XOR of the input blocks its bitmatrix row selects.  A block is any
// number of bytes: the planes8 form has blocks of 8*P bytes, a jerasure
// bitmatrix code rows of nw*packetsize bytes (kernels.xor_rows).
//
// Bound: bytes, each input block read once and each output block
// written once.  The XORs the matrix needs are far under it: one per
// selected (row, input block) pair, 401 at isa k=8, m=3, as the Pallas
// kernel unrolls them at trace time.
//
// Design: the wrapper passes a sparse schedule built once per mask set
// on the host (kernels.XorSchedule): for each output row the input
// blocks it XORs, as (start, count) into a byte list whose rows start
// 4-byte aligned.  Persistent blocks walk column tiles of 128 bytes; a
// block double-buffers the tile's in_rows x 128 bytes in shared memory,
// filled by cp.async copies, so the next tile's loads are in flight
// while this tile's XORs run.  Each warp takes four output rows at a
// time, eight lanes a row and a 16-byte column a lane; a lane walks its
// row's list four indices a load, reads the sources' 16 bytes from
// shared memory, folds them with 3-input XORs and stores 16 bytes.
// Registers do not grow with the output count, and every output row
// comes from one read of the inputs in one launch.  A row with no
// sources stores zeros.  Pointers and blocks off the 16-byte grid copy
// and store in 8-byte units (odd P), or byte by byte (any other view):
// the template argument A.  The small ring (16 KiB at k=8) keeps six
// blocks on an SM.  K3_LOG_TILE and K3_STAGES set the tile width and
// the ring's depth at build time; tools/k3_tiles.py times the other
// settings.  On the H100 the kept 128 bytes and two stages were the
// fastest at the k=8 encode, within the spread of the best at the
// one-shard reconstruct, and a few per cent behind three stages at
// k=32 with 8 chunks (PERF.md section 6).
//
// Shared-memory reads are the popcount x 16 bytes a 16-byte column
// (401 MiB at k=8, m=3 and 1 MiB blocks, ~12.6 us at 128 bytes a clock
// an SM, under the 30 us byte bound); at k=32 with dense rows (~126
// sources a row) they outlast the bytes and set the pace.
#ifndef K3_LOG_TILE
#define K3_LOG_TILE 7
#endif
#ifndef K3_STAGES
#define K3_STAGES 2
#endif
constexpr int kXorThreads = 256;
constexpr int kXorWarps = kXorThreads / 32;
constexpr int kXorLogTile = K3_LOG_TILE;  // log2 bytes of each block a tile
constexpr int kXorTile = 1 << kXorLogTile;
constexpr int kXorStages = K3_STAGES;
constexpr int kXorRowLanes = 8;           // a row's lanes: 128 bytes a pass
constexpr int kXorWarpRows = 32 / kXorRowLanes;
constexpr int kXorSmemOptin = 227 * 1024;  // a block's shared memory, sm_90
static_assert(kXorLogTile >= 7 && kXorStages >= 1, "K3 tiling");

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until all of this thread's copy groups but the N newest have
// landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int A>
struct Unit {
  static constexpr int log = A == 16 ? 4 : A == 8 ? 3 : 0;
};

// one A-byte unit from device memory into shared memory: cp.async for
// A = 16 or 8, else a plain byte load and store
template <int A>
__device__ __forceinline__ void copy_unit(uint8_t* dst, const uint8_t* src) {
  if constexpr (A == 1) {
    *dst = __ldg(src);
  } else {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (A == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                   :: "r"(s), "l"(src), "n"(A) : "memory");
  }
}

// stage columns off .. off+kXorTile-1 of every input block (in_rows
// rows of kXorTile bytes); units past the block's end are left as they
// are (their output bytes are not stored).  block_bytes is a multiple
// of A.
template <int A>
__device__ __forceinline__ void stage_tile(uint8_t* buf, const uint8_t* in,
                                           int in_rows, long long block_bytes,
                                           long long off) {
  constexpr int logU = kXorLogTile - Unit<A>::log;   // units a row
  const int total = in_rows << logU;
  const long long left = block_bytes - off;
  for (int u = threadIdx.x; u < total; u += kXorThreads) {
    const int row = u >> logU;
    const int c = (u & ((1 << logU) - 1)) << Unit<A>::log;
    if (c < left)
      copy_unit<A>(buf + row * kXorTile + c,
                   in + (long long)row * block_bytes + off + c);
  }
}

// 16 bytes to the output, whole A-byte units up to the block's end
// (left > 0 bytes of the block from dst on); acc: XOR them into it
template <int A>
__device__ __forceinline__ void store16(uint8_t* dst, const uint4& v,
                                        long long left, int acc) {
  if constexpr (A == 16) {
    uint4* p = reinterpret_cast<uint4*>(dst);
    if (acc) {
      const uint4 o = *p;
      *p = make_uint4(v.x ^ o.x, v.y ^ o.y, v.z ^ o.z, v.w ^ o.w);
    } else {
      *p = v;
    }
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 16; e += A) {
      if (e < left) {
        if constexpr (A == 8) {
          uint2* p = reinterpret_cast<uint2*>(dst + e);
          uint2 x = make_uint2(w[e / 4], w[e / 4 + 1]);
          if (acc) {
            const uint2 o = *p;
            x.x ^= o.x;
            x.y ^= o.y;
          }
          *p = x;
        } else {
          const uint8_t x = (uint8_t)(w[e / 4] >> (8 * (e % 4)));
          dst[e] = acc ? (uint8_t)(dst[e] ^ x) : x;
        }
      }
    }
  }
}

__device__ __forceinline__ uint4 lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void xor3(uint4& a, const uint4& b, const uint4& c) {
  a.x ^= b.x ^ c.x; a.y ^= b.y ^ c.y; a.z ^= b.z ^ c.z; a.w ^= b.w ^ c.w;
}

// every output row's 16-byte columns of one staged tile, 128 bytes of
// each row a pass
template <int A>
__device__ __forceinline__ void xor_tile(const uint8_t* buf, uint8_t* out,
                                         const int2* __restrict__ spans,
                                         const uint8_t* __restrict__ idx,
                                         int out_rows, long long block_bytes,
                                         long long off, int acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pass = 0; pass < kXorTile; pass += 128) {
    const int colb = pass + (lane % kXorRowLanes) * 16;
    const uint8_t* base = buf + colb;
    const long long left = block_bytes - off - colb;
    for (int r = warp * kXorWarpRows + lane / kXorRowLanes; r < out_rows;
         r += kXorWarps * kXorWarpRows) {
      const int2 sp = __ldg(spans + r);
      const uint8_t* list = idx + sp.x;
      uint4 sum = make_uint4(0u, 0u, 0u, 0u);
      int j = 0;
      for (; j + 4 <= sp.y; j += 4) {
        const uint32_t q =
            __ldg(reinterpret_cast<const uint32_t*>(list + j));
        const uint4 v0 = lds16(base + (q & 0xFFu) * kXorTile);
        const uint4 v1 = lds16(base + ((q >> 8) & 0xFFu) * kXorTile);
        const uint4 v2 = lds16(base + ((q >> 16) & 0xFFu) * kXorTile);
        const uint4 v3 = lds16(base + (q >> 24) * kXorTile);
        xor3(sum, v0, v1);
        xor3(sum, v2, v3);
      }
      for (; j < sp.y; ++j) {
        const uint4 v = lds16(base + (uint32_t)__ldg(list + j) * kXorTile);
        sum.x ^= v.x; sum.y ^= v.y; sum.z ^= v.z; sum.w ^= v.w;
      }
      if (left > 0)
        store16<A>(out + (long long)r * block_bytes + off + colb, sum, left,
                   acc);
    }
  }
}

// in, out and block_bytes aligned to A bytes; acc: XOR into out (a
// later slice of more than 256 input rows).  Dynamic shared memory:
// kXorStages stages of in_rows x kXorTile bytes.
template <int A>
__global__ void __launch_bounds__(kXorThreads)
xor_schedule_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    const int2* __restrict__ spans,
                    const uint8_t* __restrict__ idx, int in_rows,
                    int out_rows, long long block_bytes, int acc) {
  extern __shared__ uint4 xor_ring[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(xor_ring);
  const int stage_bytes = in_rows * kXorTile;
  const long long tiles = ceil_div(block_bytes, kXorTile);
  const long long stride = gridDim.x;
  for (int s = 0; s < kXorStages; ++s) {
    const long long t = blockIdx.x + s * stride;
    if (t < tiles)
      stage_tile<A>(ring + s * stage_bytes, in, in_rows, block_bytes,
                    t * kXorTile);
    cp_async_commit();
  }
  int s = 0;
  for (long long t = blockIdx.x; t < tiles; t += stride) {
    cp_async_wait<kXorStages - 1>();      // this tile's copies have landed
    __syncthreads();
    xor_tile<A>(ring + s * stage_bytes, out, spans, idx, out_rows,
                block_bytes, t * kXorTile, acc);
    __syncthreads();                      // the stage is free again
    const long long next = t + kXorStages * stride;
    if (next < tiles)
      stage_tile<A>(ring + s * stage_bytes, in, in_rows, block_bytes,
                    next * kXorTile);
    cp_async_commit();
    s = s + 1 == kXorStages ? 0 : s + 1;
  }
}

template <int A>
int launch_xor_schedule(const void* in, void* out, const void* spans,
                        const void* idx, int in_rows, int out_rows,
                        long long block_bytes, int acc, cudaStream_t s) {
  const size_t smem = (size_t)kXorStages * in_rows * kXorTile;
  auto kern = xor_schedule_kernel<A>;
  // one wave of resident blocks at most (the blocks stride over the
  // rest of the tiles): the SM count once, the occupancy once for each
  // input row count
  static int sm_count = 0;
  static int per_sm[257];
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    constexpr int most = kXorStages * 256 * kXorTile;   // k = 32
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         most < kXorSmemOptin ? most : kXorSmemOptin);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  int& occ = per_sm[in_rows];
  if (occ == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kXorThreads,
                                                  smem);
    if (occ < 1) occ = 1;
  }
  const long long tiles = ceil_div(block_bytes, kXorTile);
  const long long cap = (long long)sm_count * occ;
  const long long blocks = tiles < cap ? tiles : cap;
  kern<<<(int)blocks, kXorThreads, smem, s>>>(
      (const uint8_t*)in, (uint8_t*)out, (const int2*)spans,
      (const uint8_t*)idx, in_rows, out_rows, block_bytes, acc);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes): pointers and the stream as void*, sizes as int /
// long long; `accumulate` nonzero XORs the result into `out` (the
// slices of a wide product after the first); returns
// cudaGetLastError() after the launch.
// ---------------------------------------------------------------------------

extern "C" {

int ec_fused_xor(const void* in, void* out, const void* masks, int k, int m,
                 long long P, int accumulate, void* stream) {
  cudaGetLastError();   // clear a stale error so the return is this launch's
  if (k < 1 || k > 32 || m < 1 || m > kMaxProductTiles || P < 1)
    return (int)cudaErrorInvalidValue;
  // the P uint32 lanes of a row are its 4P bytes: w = 8 elements
  return product<8>(in, out, masks, k, m, 4 * P, accumulate,
                    (cudaStream_t)stream);
}

int ec_bitplane_matmul(const void* in, void* out, const void* masks, int k,
                       int m, int w, long long n, int accumulate,
                       void* stream) {
  cudaGetLastError();
  if (k < 1 || m < 1 || n < 1 || (long long)k * w > 256 ||
      m * w > 8 * kMaxProductTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 8: return product<8>(in, out, masks, k, m, n, accumulate, s);
    case 16: return product<16>(in, out, masks, k, m, n, accumulate, s);
    case 32: return product<32>(in, out, masks, k, m, n, accumulate, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ec_xor_schedule(const void* in, void* out, const void* spans,
                    const void* idx, int in_rows, int out_rows,
                    long long block_bytes, int accumulate, void* stream) {
  cudaGetLastError();
  if (in_rows < 1 || in_rows > 256 || out_rows < 1 || block_bytes < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the widest unit that the pointers and the block size allow
  const uintptr_t grid = (uintptr_t)in | (uintptr_t)out |
                         (uintptr_t)block_bytes;
  if (grid % 16 == 0)
    return launch_xor_schedule<16>(in, out, spans, idx, in_rows, out_rows,
                                   block_bytes, accumulate, s);
  if (grid % 8 == 0)
    return launch_xor_schedule<8>(in, out, spans, idx, in_rows, out_rows,
                                  block_bytes, accumulate, s);
  return launch_xor_schedule<1>(in, out, spans, idx, in_rows, out_rows,
                                block_bytes, accumulate, s);
}

}  // extern "C"

