// Peak-rate probes of the card for the roofline (utils/roofline.py): the
// float32 FMA rate, the 32-bit logic-instruction rate and the device-memory
// copy bandwidth. These are measuring kernels, not the port of any TPU
// kernel: the roofline prices the JAX package's work counts at the rates
// they measure (measure_vpu_f32_flops, measure_vpu_bool_ops,
// measure_hbm_bw), each the two-point slope of CUDA events over two loop
// lengths.
//
// - fma: kAcc independent chains per thread of explicit __fmaf_rn (the build
//   passes -fmad=false, so nothing else is contracted), kUnroll steps per
//   loop iteration, enough blocks to fill every SM. Each thread does
//   2 * kAcc * kUnroll FLOPs per iteration.
// - logic: the same shape with one 3-input logic instruction (lop3.b32) per
//   step, four truth tables in turn (xor3, majority, a ^ (b & c),
//   a ^ (b | c)), each step reading two fresh operands: two steps of a chain
//   depend on five registers, so no two fold into one instruction, and the
//   count is the card's logic-instruction issue rate.
// - copy: a grid-stride float4 copy of two planes far larger than the 50 MB
//   L2 cache: each launch reads n floats once and writes n floats once.
// - shift sum: per cell, passes of shifted reads of a padded plane, one add
//   each (measure_static_shift_cost, measure_shift_floor): what a shifted
//   neighbour read costs a stencil on this card.
//
// Every entry point returns the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAcc = 8;
constexpr int kUnroll = 16;

__global__ void fma_chain_kernel(float* __restrict__ out, int iters, float a, float b) {
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 1e-3f * (float)threadIdx.x + (float)i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = __fmaf_rn(acc[i], a, b);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) s += acc[i];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

__global__ void logic_chain_kernel(uint32_t* __restrict__ out, int iters, uint32_t seed) {
  uint32_t v[8];
  uint32_t acc[kAcc];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = seed * (2654435761u + 40503u * i) ^ (threadIdx.x << i);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = v[i] ^ blockIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; u += 4) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = lop3<0x96>(acc[i], v[(i + u) & 7], v[(i + u + 3) & 7]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = lop3<0xE8>(acc[i], v[(i + u + 1) & 7], v[(i + u + 5) & 7]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = lop3<0x78>(acc[i], v[(i + u + 2) & 7], v[(i + u + 6) & 7]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        acc[i] = lop3<0x1E>(acc[i], v[(i + u + 3) & 7], v[(i + u + 7) & 7]);
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) s ^= acc[i];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// out (H, W): per cell the sum over `reps` passes of n_off shifted reads of
// `padded` ((H + 2 pad) x (W + 2 pad)); offs holds 2 * n_off (di, dj) pairs
// in [-pad, pad] (the table twice), and pass r starts at entry r % n_off, so
// every read's address depends on the pass and none is hoisted out of it.
__global__ void shift_sum_kernel(const float* __restrict__ padded, float* __restrict__ out, int H,
                                 int W, int pad, const int2* __restrict__ offs, int n_off,
                                 int reps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const int wp = W + 2 * pad;
  const float* base = padded + (size_t)(i + pad) * wp + (j + pad);
  float s = 0.0f;
  for (int r = 0; r < reps; ++r) {
    const int2* table = offs + r % n_off;
    for (int o = 0; o < n_off; ++o) {
      const int2 d = table[o];
      s += base[d.x * wp + d.y];
    }
  }
  out[(size_t)i * W + j] = s;
}

__global__ void copy_kernel(const float4* __restrict__ in, float4* __restrict__ out, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride)
    out[i] = in[i];
}

}  // namespace

extern "C" {

const char* te_peaks_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Steps of one chain kernel's thread per loop iteration (FMAs or logic
// instructions): kAcc chains x kUnroll steps.
int te_peaks_steps_per_iter() { return kAcc * kUnroll; }

// out: blocks * threads float32.
int te_peaks_fma(float* out, int blocks, int threads, int iters, float a, float b, void* stream) {
  fma_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters, a, b);
  return (int)cudaGetLastError();
}

// out: blocks * threads uint32.
int te_peaks_logic(uint32_t* out, int blocks, int threads, int iters, uint32_t seed, void* stream) {
  logic_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters, seed);
  return (int)cudaGetLastError();
}

// padded ((H + 2 pad) x (W + 2 pad)) float32, out (H, W) float32, offs
// 2 * n_off int32 pairs; a 32 x 8 block per tile of cells.
int te_peaks_shift_sum(const float* padded, float* out, int H, int W, int pad, const int* offs,
                       int n_off, int reps, void* stream) {
  if (H < 1 || W < 1 || pad < 0 || n_off < 1) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8), grid((W + 31) / 32, (H + 7) / 8);
  shift_sum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(padded, out, H, W, pad,
                                                             (const int2*)offs, n_off, reps);
  return (int)cudaGetLastError();
}

// in, out: n float32 each, 16-byte aligned, n a multiple of 4.
int te_peaks_copy(const float* in, float* out, long long n, int blocks, int threads, void* stream) {
  if (n % 4 != 0 || ((uintptr_t)in | (uintptr_t)out) % 16 != 0) return (int)cudaErrorInvalidValue;
  copy_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const float4*)in, (float4*)out, n / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
