// The 1-bit tensor-core product that K1 and K2 (csrc/ec_kernels.cu) run
// on: checks its fragment layout and times its issue rate.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o b1_mma_rate tools/b1_mma_rate.cu && ./b1_mma_rate
//
// The probe runs one mma.sync m16n8k128 and m16n8k256 .b1 .and.popc on
// random fragments and compares each output with popc(row & column)
// under the layout the kernels assume (A rows g / g+8, K words t / 4+t;
// B column g; D (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1)).  The rate loop
// keeps eight independent products in flight per warp at 4 to 32 warps
// per SM and prints the clocks per product per SM sub-partition, from
// CUDA events at the card's maximum clock and from clock64; the int8
// m16n8k32 product, whose rate the data sheet gives, is timed beside.
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma256(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma128(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KIND, int NCH>
__global__ void bench(int* out, long long* cyc, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 7 * i + 1);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 31 + i);
  int acc[NCH][4];
  for (int c = 0; c < NCH; ++c) for (int r = 0; r < 4; ++r) acc[c][r] = 0;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (KIND == 0) mma256(acc[c], a, b);
      else if (KIND == 1) mma128(acc[c], a, b);
      else mma_s8(acc[c], a, b);
    }
  }
  long long t1 = clock64();
  int s = 0;
  for (int c = 0; c < NCH; ++c) for (int r = 0; r < 4; ++r) s += acc[c][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

__global__ void probe(const uint32_t* A, const uint32_t* B, int* D, int k256) {
  int l = threadIdx.x;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = A[l * 4 + i];
  for (int i = 0; i < 2; ++i) b[i] = B[l * 2 + i];
  int d[4] = {0, 0, 0, 0};
  if (k256) mma256(d, a, b); else mma128(d, a, b);
  for (int i = 0; i < 4; ++i) D[l * 4 + i] = d[i];
}

static int popc(uint32_t x) { return __builtin_popcount(x); }

int main() {
  int dev = 0; cudaDeviceProp p; cudaGetDeviceProperties(&p, dev);
  int clk = 0; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, dev);
  printf("device %s sms %d clock_khz %d\n", p.name, p.multiProcessorCount, clk);
  // layout probe
  for (int k256 = 0; k256 < 2; ++k256) {
    uint32_t hA[128], hB[64]; int hD[128];
    srand(1 + k256);
    for (int i = 0; i < 128; ++i) hA[i] = (uint32_t)rand() ^ ((uint32_t)rand() << 16);
    for (int i = 0; i < 64; ++i) hB[i] = (uint32_t)rand() ^ ((uint32_t)rand() << 16);
    uint32_t *dA, *dB; int* dD;
    cudaMalloc(&dA, sizeof hA); cudaMalloc(&dB, sizeof hB); cudaMalloc(&dD, sizeof hD);
    cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
    cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
    probe<<<1, 32>>>(dA, dB, dD, k256);
    cudaError_t e = cudaDeviceSynchronize();
    cudaMemcpy(hD, dD, sizeof hD, cudaMemcpyDeviceToHost);
    // hypothesis: A row g (a0,a2) / g+8 (a1,a3), k word t (a0,a1) / 4+t (a2,a3);
    // B col g, k word t (b0) / 4+t (b1); D (g,2t),(g,2t+1),(g+8,2t),(g+8,2t+1)
    uint32_t Am[16][8] = {}, Bm[8][8] = {};
    for (int l = 0; l < 32; ++l) {
      int g = l >> 2, t = l & 3;
      Am[g][t] = hA[l * 4 + 0]; Am[g + 8][t] = hA[l * 4 + 1];
      Bm[g][t] = hB[l * 2 + 0];
      if (k256) { Am[g][4 + t] = hA[l * 4 + 2]; Am[g + 8][4 + t] = hA[l * 4 + 3]; Bm[g][4 + t] = hB[l * 2 + 1]; }
    }
    int bad = 0;
    for (int l = 0; l < 32; ++l) {
      int g = l >> 2, t = l & 3;
      int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
      for (int i = 0; i < 4; ++i) {
        int want = 0;
        for (int w = 0; w < 8; ++w) want += popc(Am[rows[i]][w] & Bm[cols[i]][w]);
        if (want != hD[l * 4 + i]) ++bad;
      }
    }
    printf("probe k%d err=%s mismatches=%d of 128\n", k256 ? 256 : 128, cudaGetErrorString(e), bad);
  }
  // rate
  int sms = p.multiProcessorCount;
  int* out; long long* cyc;
  cudaMalloc(&out, sizeof(int) * sms * 64 * 1024); cudaMalloc(&cyc, sizeof(long long) * sms * 64);
  const char* names[3] = {"b1 m16n8k256", "b1 m16n8k128", "s8 m16n8k32"};
  for (int kind = 0; kind < 3; ++kind) {
    for (int wpsm : {4, 8, 16, 32}) {
      int threads = 128, blocks = sms * wpsm / 4, iters = 4096;
      cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
      auto launch = [&]() {
        if (kind == 0) bench<0, 8><<<blocks, threads>>>(out, cyc, iters, 12345u);
        else if (kind == 1) bench<1, 8><<<blocks, threads>>>(out, cyc, iters, 12345u);
        else bench<2, 8><<<blocks, threads>>>(out, cyc, iters, 12345u);
      };
      launch(); cudaDeviceSynchronize();
      cudaEventRecord(a); launch(); cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b);
      long long hc[4096]; cudaMemcpy(hc, cyc, sizeof(long long) * blocks, cudaMemcpyDeviceToHost);
      double mc = 0; for (int i = 0; i < blocks; ++i) mc += hc[i]; mc /= blocks;
      double mmas = (double)blocks * 4 * iters * 8;
      double per_sp = mmas / (sms * 4);
      printf("%s warps/SM %d: %.4f ms, %.3f Gmma/s, %.3f clk per mma per SP (events, %d kHz), %.3f clk per mma per SP (clock64, per block)\n",
             names[kind], wpsm, ms, mmas / ms / 1e6, (ms * 1e-3 * clk * 1e3) / per_sp, clk,
             mc / ((double)4 / 4 * iters * 8 * (wpsm / 4.0)));
      cudaError_t e = cudaGetLastError(); if (e) printf("err %s\n", cudaGetErrorString(e));
    }
  }
  return 0;
}
