// Scaled dropout keep-mask for Hopper (sm_90a), and uniform floats from the
// same random bits, with a plain C interface.
//
// Replaces the Pallas TPU kernel ctgan_tpu/kernels/dropout.py::_mask_kernel
// (launched by _mask_padded).  Same contract: mask[i] = scale where the
// random bits of element i are < thresh, else 0, with thresh =
// min(int(keep_prob * 2^32), 2^32 - 1) and scale = fp32(1 / keep_prob)
// rounded once to the output type.  The mask only: x * mask is done outside,
// so autodiff of any order sees a constant.
//
// Random bits: Philox4x32-10 keyed on (seed, 0), counter (g_lo, g_hi, 0, 0)
// for the group g of elements 4g..4g+3.  The TPU kernel used the TPU's own
// generator seeded per 256x1024 block; a counter-based generator keyed on the
// element index needs no blocks, no padding and no state shared between
// blocks.  ctgan_tpu_torch/kernels/dropout.py::dropout_mask_reference
// computes the same bits with integer tensor arithmetic, and the two must
// agree bit for bit.
//
// Bound: a pure write of numel * sizeof(T) bytes (a [256,8,8,128] fp32 mask
// is 8 MiB, about 2.5 us at 3.35 TB/s).  Each thread makes one Philox block
// (4 words) per step of a grid-stride loop and writes its 4 elements with
// one vector store (16 bytes in fp32, 8 in bf16); the ragged tail is written
// element by element.
//
// Second entry, ctgan_philox_uniform: out[i] = (bits_i >> 8) * 2^-24 * scale
// in fp32, with bits_i the same Philox word as above.  The top 24 bits as a
// fraction are exact in fp32 and lie in [0, 1); one rounded multiply by
// scale follows.  The trainer draws its dequantisation noise this way
// (U[0, 1/128) over 5 x 64 x 3072 pixels an iteration), so the noise is the
// same on the card and on the CPU, where
// ctgan_tpu_torch/kernels/dropout.py::philox_uniform_reference computes it.
// It replaces no TPU kernel: the JAX package draws that noise with
// jax.random.uniform.  Bound: a write of 4 * n bytes; one float4 store per
// Philox block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libdropout_mask.so dropout_mask.cu

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// kBytes is the element size: 4 writes fp32, 2 writes bf16.  The kept value
// is turned into its bit pattern once, so the stores are plain integer stores.
template <int kBytes>
__global__ void dropout_mask_kernel(void* __restrict__ out, int64_t n, uint32_t seed,
                                    uint32_t thresh, float scale) {
  const uint32_t keep_bits = kBytes == 4
                                 ? __float_as_uint(scale)
                                 : static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(scale)));
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), seed, 0u);
    const uint32_t v0 = r.x < thresh ? keep_bits : 0u;
    const uint32_t v1 = r.y < thresh ? keep_bits : 0u;
    const uint32_t v2 = r.z < thresh ? keep_bits : 0u;
    const uint32_t v3 = r.w < thresh ? keep_bits : 0u;
    const int64_t i = 4 * g;
    if (kBytes == 4) {
      uint32_t* o = static_cast<uint32_t*>(out);
      if (i + 3 < n) {
        *reinterpret_cast<uint4*>(o + i) = make_uint4(v0, v1, v2, v3);
      } else {
        const uint32_t v[4] = {v0, v1, v2, v3};
        for (int j = 0; i + j < n; ++j) o[i + j] = v[j];
      }
    } else {
      uint16_t* o = static_cast<uint16_t*>(out);
      if (i + 3 < n) {
        *reinterpret_cast<uint2*>(o + i) = make_uint2(v0 | (v1 << 16), v2 | (v3 << 16));
      } else {
        const uint32_t v[4] = {v0, v1, v2, v3};
        for (int j = 0; i + j < n; ++j) o[i + j] = static_cast<uint16_t>(v[j]);
      }
    }
  }
}

__global__ void philox_uniform_kernel(float* __restrict__ out, int64_t n, uint32_t seed,
                                      float scale) {
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), seed, 0u);
    const float v[4] = {
        __fmul_rn(__fmul_rn(__uint2float_rn(r.x >> 8), 0x1p-24f), scale),
        __fmul_rn(__fmul_rn(__uint2float_rn(r.y >> 8), 0x1p-24f), scale),
        __fmul_rn(__fmul_rn(__uint2float_rn(r.z >> 8), 0x1p-24f), scale),
        __fmul_rn(__fmul_rn(__uint2float_rn(r.w >> 8), 0x1p-24f), scale),
    };
    const int64_t i = 4 * g;
    if (i + 3 < n) {
      *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; i + j < n; ++j) out[i + j] = v[j];
    }
  }
}

int64_t grid_blocks(int64_t n, int threads) {
  constexpr int64_t kMaxBlocks = 8192;
  const int64_t groups = (n + 3) / 4;
  const int64_t blocks = (groups + threads - 1) / threads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

constexpr int kThreads = 256;

}  // namespace

// out: device buffer of n elements, 16-byte aligned; dtype 0 = fp32, 1 = bf16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ctgan_dropout_mask(void* out, int64_t n, uint32_t seed, uint32_t thresh,
                                  float scale, int dtype, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = grid_blocks(n, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_mask_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(out, n, seed, thresh,
                                                                              scale);
  } else if (dtype == 1) {
    dropout_mask_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(out, n, seed, thresh,
                                                                              scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: device buffer of n fp32 values, 16-byte aligned.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int ctgan_philox_uniform(float* out, int64_t n, uint32_t seed, float scale,
                                    void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = grid_blocks(n, kThreads);
  philox_uniform_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(out, n, seed, scale);
  return static_cast<int>(cudaGetLastError());
}
