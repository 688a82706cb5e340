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

// 8x8 bit transpose across eight uint32 words, per byte slot: afterwards
// t[x] byte-bit s == v[s] byte-bit x.  An involution (three masked swap
// rounds), the same butterfly as ceph_tpu/ec/kernels.py:_bit_transpose8.
__device__ __forceinline__ void transpose8(uint32_t v[8]) {
  const uint32_t m4lo = 0x0F0F0F0Fu, m4hi = 0xF0F0F0F0u;
  const uint32_t m2lo = 0x33333333u, m2hi = 0xCCCCCCCCu;
  const uint32_t m1lo = 0x55555555u, m1hi = 0xAAAAAAAAu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t a = v[i], b = v[i + 4];
    v[i] = (a & m4lo) | ((b & m4lo) << 4);
    v[i + 4] = ((a >> 4) & m4lo) | (b & m4hi);
  }
#pragma unroll
  for (int g = 0; g < 8; g += 4) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t a = v[g + i], b = v[g + i + 2];
      v[g + i] = (a & m2lo) | ((b & m2lo) << 2);
      v[g + i + 2] = ((a >> 2) & m2lo) | (b & m2hi);
    }
  }
#pragma unroll
  for (int g = 0; g < 8; g += 2) {
    uint32_t a = v[g], b = v[g + 1];
    v[g] = (a & m1lo) | ((b & m1lo) << 1);
    v[g + 1] = ((a >> 1) & m1lo) | (b & m1hi);
  }
}

// ---------------------------------------------------------------------------
// K1: byte-layout GF(2^8) region matmul (fused transpose + XOR schedule)
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ec/kernels.py:_fused_xor_pallas (pallas_call at :413).
// in (k, P) uint32 lanes of byte-layout chunks, out (M, P) lanes.
// Bound: bytes, (k+M)/k of the payload read and written once; the XOR
// schedule costs about a dozen integer operations per input byte, under
// the card's integer rate at k=8,M=3.  Design: one thread per 32-byte
// column group of every chunk row (two 16-byte vector loads), so each
// bit-plane fills a whole 32-bit register: eight lanes are transposed
// to planes in registers, the planes a row selects are XORed into 8*M
// accumulators, and the accumulators are transposed back and stored.
// The selection bytes sit in shared memory and are uniform across the
// warp, so the predicated XORs never diverge.  The ragged edge is
// masked (zero lanes in, nothing stored), so no padding is needed and
// zero columns give zero parity.  M <= 4 output chunks per launch keeps
// the accumulators in 32 registers; the wrapper launches once for each
// group of four output chunks.
template <int M>
__global__ void __launch_bounds__(kThreads)
fused_xor_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ masks, int k, long long P,
                 int vec) {
  __shared__ uint8_t sel[32 * 8 * M];   // sel[j*8M + r]: row r, chunk j
  for (int t = threadIdx.x; t < k * 8 * M; t += blockDim.x) {
    int j = t / (8 * M), r = t % (8 * M);
    sel[t] = (uint8_t)(masks[r * kMaskWords + j / 4] >> (8 * (j % 4)));
  }
  __syncthreads();
  const long long groups = ceil_div(P, 8);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const long long c0 = g * 8;
    const bool full = vec && c0 + 8 <= P;
    uint32_t acc[8 * M];
#pragma unroll
    for (int r = 0; r < 8 * M; ++r) acc[r] = 0u;
    for (int j = 0; j < k; ++j) {
      const uint32_t* row = in + (long long)j * P + c0;
      uint32_t v[8];
      if (full) {
        uint4 a = *reinterpret_cast<const uint4*>(row);
        uint4 b = *reinterpret_cast<const uint4*>(row + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s) v[s] = (c0 + s < P) ? row[s] : 0u;
      }
      transpose8(v);
      const uint8_t* sj = sel + j * 8 * M;
#pragma unroll
      for (int r = 0; r < 8 * M; ++r) {
        const uint32_t s = sj[r];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          if (s & (1u << x)) acc[r] ^= v[x];
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      uint32_t q[8];
#pragma unroll
      for (int y = 0; y < 8; ++y) q[y] = acc[8 * i + y];
      transpose8(q);
      uint32_t* orow = out + (long long)i * P + c0;
      if (full) {
        *reinterpret_cast<uint4*>(orow) = make_uint4(q[0], q[1], q[2], q[3]);
        *reinterpret_cast<uint4*>(orow + 4) = make_uint4(q[4], q[5], q[6], q[7]);
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s)
          if (c0 + s < P) orow[s] = q[s];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: bit-plane GF(2) matmul over w-bit words
// ---------------------------------------------------------------------------
// Replaces ceph_tpu/ec/kernels.py:_encode_pallas / _ec_tile_kernel
// (pallas_call at :124), and covers w=16/32 too, which the TPU left to
// the XLA program encode_xla.  in (k, n) words, out (m, n) words.
// Bound: at w=8 the operations (per output bit, one AND and XOR per
// 32-bit word of the k*w input bits and a popcount) outweigh the
// bytes; at w=16/32 the same count is spread over wider words.
// Design: one thread per word column gathers the column's k*w input
// bits into at most eight registers (the words laid end to end are
// exactly the bitmatrix column order j*w + x); each output bit is the
// parity of (row mask & bits), a popcount, with the row masks in
// shared memory, read uniformly across the warp.
template <int W>
struct Word;
template <> struct Word<8> { typedef uint8_t T; };
template <> struct Word<16> { typedef uint16_t T; };
template <> struct Word<32> { typedef uint32_t T; };

template <int W>
__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const typename Word<W>::T* __restrict__ in,
                       typename Word<W>::T* __restrict__ out,
                       const uint32_t* __restrict__ masks, int k, int m,
                       long long n) {
  typedef typename Word<W>::T T;
  extern __shared__ uint32_t smask[];          // (m*W, nw)
  const int nw = (int)ceil_div((long long)k * W, 32);
  for (int t = threadIdx.x; t < m * W * nw; t += blockDim.x)
    smask[t] = masks[(t / nw) * kMaskWords + t % nw];
  __syncthreads();
  constexpr int per = 32 / W;                  // words per register
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < n; c += (long long)gridDim.x * blockDim.x) {
    uint32_t bits[kMaskWords];
#pragma unroll
    for (int q = 0; q < kMaskWords; ++q) bits[q] = 0u;
#pragma unroll
    for (int q = 0; q < kMaskWords; ++q) {
#pragma unroll
      for (int e = 0; e < per; ++e) {
        const int j = q * per + e;
        if (j < k) bits[q] |= (uint32_t)in[(long long)j * n + c] << (e * W % 32);
      }
    }
    for (int i = 0; i < m; ++i) {
      uint32_t word = 0u;
      for (int y = 0; y < W; ++y) {
        const uint32_t* row = smask + (i * W + y) * nw;
        uint32_t p = 0u;
#pragma unroll
        for (int q = 0; q < kMaskWords; ++q)
          if (q < nw) p ^= row[q] & bits[q];
        word |= (uint32_t)(__popc(p) & 1) << y;
      }
      out[(long long)i * n + c] = (T)word;
    }
  }
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
                 long long P, int vec, void* stream) {
  cudaGetLastError();   // clear a stale error so the return is this launch's
  if (k < 1 || k > 32 || m < 1 || m > 4 || P < 1) return (int)cudaErrorInvalidValue;
  const int grid = grid_for(ceil_div(P, 8));
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* mk = (const uint32_t*)masks;
  switch (m) {
    case 1: fused_xor_kernel<1><<<grid, kThreads, 0, s>>>(i, o, mk, k, P, vec); break;
    case 2: fused_xor_kernel<2><<<grid, kThreads, 0, s>>>(i, o, mk, k, P, vec); break;
    case 3: fused_xor_kernel<3><<<grid, kThreads, 0, s>>>(i, o, mk, k, P, vec); break;
    default: fused_xor_kernel<4><<<grid, kThreads, 0, s>>>(i, o, mk, k, P, vec); break;
  }
  return (int)cudaGetLastError();
}

int ec_bitplane_matmul(const void* in, void* out, const void* masks, int k,
                       int m, int w, long long n, void* stream) {
  cudaGetLastError();
  if (k < 1 || m < 1 || n < 1 || (long long)k * w > 256 || m * w > 1024)
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(n);
  const size_t smem = (size_t)m * w * ceil_div((long long)k * w, 32) * sizeof(uint32_t);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* mk = (const uint32_t*)masks;
  switch (w) {
    case 8:
      bitplane_matmul_kernel<8><<<grid, kThreads, smem, s>>>(
          (const uint8_t*)in, (uint8_t*)out, mk, k, m, n);
      break;
    case 16:
      bitplane_matmul_kernel<16><<<grid, kThreads, smem, s>>>(
          (const uint16_t*)in, (uint16_t*)out, mk, k, m, n);
      break;
    case 32:
      bitplane_matmul_kernel<32><<<grid, kThreads, smem, s>>>(
          (const uint32_t*)in, (uint32_t*)out, mk, k, m, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
