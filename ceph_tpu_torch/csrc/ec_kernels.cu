// Erasure-code region kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (ceph_tpu_torch/_build.py).
//
// All three compute GF(2^w) region products through the (rows x k*w)
// 0/1 bitmatrix of matrices.matrix_to_bitmatrix: output bit y of word i
// is the XOR of the input bits (j, x) that row i*w+y selects.  The
// bitmatrix is a runtime argument (every decode signature has its own),
// passed as packed row masks: row r is eight uint32 words, bit c of the
// row = bitmatrix[r][c], so one row covers k*w <= 256 input bits.
//
// Each kernel launches on the caller's stream, allocates nothing and
// does not synchronise; each C entry returns cudaGetLastError() so a
// refused launch reaches the Python wrapper, which raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaskWords = 8;      // 256 input bits per bitmatrix row
constexpr int kThreads = 256;

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

inline int grid_for(long long work) {
  long long blocks = ceil_div(work, kThreads);
  if (blocks < 1) blocks = 1;
  // grid-stride loops cover the rest; 132 SMs x 16 blocks keeps the
  // card full without a grid of millions of blocks
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
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
// start 4-byte aligned.  Dynamic shared memory: the B fragments.  A
// warp's step covers 256 bytes of every row: 16 blocks of 16 bytes,
// block b*8 + g holding the columns of A row g (b = 0) or g+8 (b = 1).
template <int W, bool K256>
__global__ void __launch_bounds__(32 * kProductWarps)
gf2_product_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   const uint32_t* __restrict__ masks, int k, int m,
                   long long n, int vin, int vout) {
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
          *reinterpret_cast<uint32_t*>(orow + off) = word[b];
        } else {
          T* el = reinterpret_cast<T*>(orow);
          const long long c0 = off / kBytes;
#pragma unroll
          for (int u = 0; u < 4 / kBytes; ++u)
            if (c0 + u < n) el[c0 + u] = (T)(word[b] >> (u * W));
        }
      }
    }
  }
}

template <int W, bool K256>
int launch_product(const void* in, void* out, const void* masks, int k,
                   int m, long long n, int vin, int vout, cudaStream_t s) {
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
      vin, vout);
  return (int)cudaGetLastError();
}

template <int W>
int product(const void* in, void* out, const void* masks, int k, int m,
            long long n, cudaStream_t s) {
  const long long row_bytes = n * (W / 8);
  const int vin = ((uintptr_t)in % 16 == 0) && row_bytes % 16 == 0;
  const int vout = ((uintptr_t)out % 4 == 0) && row_bytes % 4 == 0;
  if (k * W <= 128)
    return launch_product<W, false>(in, out, masks, k, m, n, vin, vout, s);
  return launch_product<W, true>(in, out, masks, k, m, n, vin, vout, s);
}

// ---------------------------------------------------------------------------
// K3: XOR schedule on the planes8 layout
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ec/kernels.py:_xor_schedule_pallas (pallas_call at
// :210).  in (in_rows*8, P) uint8, out (M*8 block rows, ...) uint8:
// block b is the 8*P contiguous bytes of rows 8b..8b+7, and output
// block r is the XOR of the input blocks its bitmatrix row selects.
// Bound: bytes, each input block read once and each output block
// written once.  Design: one thread per 16-byte column group of the
// flattened blocks; the input blocks stream through once, each XORed
// into the 8*M accumulators that select it (uniform, from shared
// memory).  The tail below 16 bytes is masked byte by byte.
template <int M>
__global__ void __launch_bounds__(kThreads)
xor_schedule_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    const uint32_t* __restrict__ masks, int in_rows,
                    long long block_bytes, int vec) {
  __shared__ uint8_t sel[256 * M];     // sel[b*M + c]: bits of rows 8c..8c+7
  for (int t = threadIdx.x; t < in_rows * M; t += blockDim.x) {
    int b = t / M, c = t % M;
    uint8_t bitsel = 0;
    for (int y = 0; y < 8; ++y)
      bitsel |= (uint8_t)(((masks[(8 * c + y) * kMaskWords + b / 32] >>
                            (b % 32)) & 1u) << y);
    sel[t] = bitsel;
  }
  __syncthreads();
  const long long groups = ceil_div(block_bytes, 16);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const long long off = g * 16;
    const bool full = vec && off + 16 <= block_bytes;
    uint4 acc[8 * M];
#pragma unroll
    for (int r = 0; r < 8 * M; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);
    for (int b = 0; b < in_rows; ++b) {
      const uint8_t* src = in + (long long)b * block_bytes + off;
      uint4 v;
      if (full) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint8_t tmp[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) tmp[e] = (off + e < block_bytes) ? src[e] : 0;
        v = make_uint4(
            tmp[0] | tmp[1] << 8 | tmp[2] << 16 | (uint32_t)tmp[3] << 24,
            tmp[4] | tmp[5] << 8 | tmp[6] << 16 | (uint32_t)tmp[7] << 24,
            tmp[8] | tmp[9] << 8 | tmp[10] << 16 | (uint32_t)tmp[11] << 24,
            tmp[12] | tmp[13] << 8 | tmp[14] << 16 | (uint32_t)tmp[15] << 24);
      }
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const uint32_t s = sel[b * M + c];
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          if (s & (1u << y)) {
            uint4& a = acc[8 * c + y];
            a.x ^= v.x; a.y ^= v.y; a.z ^= v.z; a.w ^= v.w;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8 * M; ++r) {
      uint8_t* dst = out + (long long)r * block_bytes + off;
      if (full) {
        *reinterpret_cast<uint4*>(dst) = acc[r];
      } else {
        const uint32_t w4[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (off + e < block_bytes) dst[e] = (uint8_t)(w4[e / 4] >> (8 * (e % 4)));
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes): pointers and the stream as void*, sizes as int /
// long long; returns cudaGetLastError() after the launch.
// ---------------------------------------------------------------------------

extern "C" {

int ec_fused_xor(const void* in, void* out, const void* masks, int k, int m,
                 long long P, void* stream) {
  cudaGetLastError();   // clear a stale error so the return is this launch's
  if (k < 1 || k > 32 || m < 1 || m > kMaxProductTiles || P < 1)
    return (int)cudaErrorInvalidValue;
  // the P uint32 lanes of a row are its 4P bytes: w = 8 elements
  return product<8>(in, out, masks, k, m, 4 * P, (cudaStream_t)stream);
}

int ec_bitplane_matmul(const void* in, void* out, const void* masks, int k,
                       int m, int w, long long n, void* stream) {
  cudaGetLastError();
  if (k < 1 || m < 1 || n < 1 || (long long)k * w > 256 ||
      m * w > 8 * kMaxProductTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 8: return product<8>(in, out, masks, k, m, n, s);
    case 16: return product<16>(in, out, masks, k, m, n, s);
    case 32: return product<32>(in, out, masks, k, m, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ec_xor_schedule(const void* in, void* out, const void* masks, int in_rows,
                    int m, long long block_bytes, int vec, void* stream) {
  cudaGetLastError();
  if (in_rows < 1 || in_rows > 256 || m < 1 || m > 4 || block_bytes < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(ceil_div(block_bytes, 16));
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* i = (const uint8_t*)in;
  uint8_t* o = (uint8_t*)out;
  const uint32_t* mk = (const uint32_t*)masks;
  switch (m) {
    case 1: xor_schedule_kernel<1><<<grid, kThreads, 0, s>>>(i, o, mk, in_rows, block_bytes, vec); break;
    case 2: xor_schedule_kernel<2><<<grid, kThreads, 0, s>>>(i, o, mk, in_rows, block_bytes, vec); break;
    case 3: xor_schedule_kernel<3><<<grid, kThreads, 0, s>>>(i, o, mk, in_rows, block_bytes, vec); break;
    default: xor_schedule_kernel<4><<<grid, kThreads, 0, s>>>(i, o, mk, in_rows, block_bytes, vec); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
