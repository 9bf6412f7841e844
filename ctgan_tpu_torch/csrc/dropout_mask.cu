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
// Random bits: Philox4x32-10 keyed on (seed, 0), counter (g, 0, 0, 0) for
// the group g of elements 4g..4g+3.  The TPU kernel used the TPU's own
// generator seeded per 256x1024 block; a counter-based generator keyed on the
// element index needs no blocks, no padding and no state shared between
// blocks.  ctgan_tpu_torch/kernels/dropout.py::dropout_mask_reference
// computes the same bits with integer tensor arithmetic, and the two must
// agree bit for bit.
//
// The seed is read from device memory, seeds[slot], once per thread: a
// CUDA graph that captured the launch replays it with whatever the table
// holds, so a step's draws change with the table and not with the graph.
//
// Second entry, ctgan_philox_uniform: out[i] = (bits_i >> 8) * 2^-24 * scale
// in fp32, with bits_i the same Philox word as above.  The top 24 bits as a
// fraction are exact in fp32 and lie in [0, 1); one rounded multiply by
// scale follows.  The trainer draws its dequantisation noise this way
// (U[0, 1/128) over 5 x 64 x 3072 pixels an iteration), so the noise is the
// same on the card and on the CPU, where
// ctgan_tpu_torch/kernels/dropout.py::philox_uniform_reference computes it.
// It replaces no TPU kernel: the JAX package draws that noise with
// jax.random.uniform.
//
// What bounds them on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W limit):
// a mask is a pure write, numel * sizeof(T) bytes at 3.35 TB/s, and each
// element costs Philox's integer work, one 10-round block per 4 elements.
// The operation bound counts the SASS integer instructions of the main
// loop (ctgan_tpu_torch/kernels/sass.py) at the CUDA C++ Programming
// Guide's 64 per clock per SM for compute capability 9.0, on 132 SMs at the
// card's maximum SM clock.  The first design (one block per thread per
// step, 16.5 integer instructions per bf16 element) ran the bf16
// [2560,128,8,8] mask at 2.1x its 12.52 us byte bound: in bf16 the integer
// work, not the bytes, bounds it (PERF.md has the counts and times).  So
// this design:
//   * computes each 32x32->64 product with one mul.wide.u32 (one
//     IMAD.WIDE.U32; a 64-bit product of zero-extended words made ptxas add
//     zero high words and recompute low words), and each output word's two
//     XORs as one LOP3;
//   * folds what does not depend on the counter into per-thread constants
//     (PhiloxKey): the round keys, and round 1's product M0 * seed, since
//     word 0 after round 0 is the seed whatever the counter, with the key
//     words rounds 1 and 2 XOR into its halves;
//   * runs two independent Philox blocks per thread per loop step (8
//     elements), so one block's multiplies cover the other's latency.  In
//     bf16 they are 8 contiguous elements, one 16-byte store; in fp32 a
//     warp's two stores each cover 512 contiguous bytes (lane l takes the
//     groups l and l + 32 of its warp's 64), as 16-byte stores of 8
//     contiguous fp32 elements per thread would leave every 32-byte sector
//     half written by each store;
//   * sizes the grid to the card, from the blocks it holds resident (SMs x
//     blocks per SM from the occupancy API, queried once per device): half
//     of them for the bf16 mask, which is bound by operations, so that each
//     thread pays its seed read and key set-up over more loop steps; four
//     times as many for the fp32 mask and the uniforms, which are bound by
//     bytes and gain from more stores in flight.  A grid-stride loop runs
//     over 32-bit indices of whole 256-element warp spans; the ragged tail
//     (n % 256 elements, at most 64 groups) is written after the loop by the
//     first 64 threads, one group each, so the loop body is straight-line.
// The fp32 mask writes twice the bytes for the same integer work and stays
// bound by bytes; the uniforms add a conversion and two multiplies per
// element to the same integer work.
//
// Row segments (ctgan_dropout_mask_segments, ctgan_philox_uniform_segments):
// a process of a data-parallel run draws only its rows of the global draw,
// up to four (start, count) element ranges of it, written one after another;
// element j of a segment takes exactly the bits of element start + j of the
// whole draw, so the ranks' draws together are the one-process draw.  A
// segment whose start and local offset are multiples of 8 runs the loop
// above with its counters moved by start / 4; any other segment a plain
// element loop.  The one-segment entries above are unchanged: a whole draw
// launches them.
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
constexpr int kThreads = 256;
// A warp's loop step: 32 threads x two Philox blocks of 4 elements.
constexpr int kSpanGroups = 64;
constexpr int kSpan = 4 * kSpanGroups;
// counters and span indices are 32-bit: n < 2^34 elements
constexpr int64_t kMaxElements = int64_t{1} << 34;

__device__ __forceinline__ void mulhilo(uint32_t m, uint32_t c, uint32_t& hi, uint32_t& lo) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(m), "r"(c));
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// What Philox4x32-10 under the key (seed, 0) computes without the counter.
// Round r's key is (seed + r * W0, r * W1): word 1 is a constant.  Round 0
// maps the counter (x, 0, 0, 0) to (seed, 0, hi(M0 x), lo(M0 x)), so round
// 1's product M0 * seed does not depend on x either, nor does word 3 after
// round 1, which round 2 XORs with its constant key word.
struct PhiloxKey {
  uint32_t k0[10];  // key word 0 of round r
  uint32_t r1_z;    // hi(M0 * seed) ^ W1: word 2 after round 1 is lo(M0 x) ^ r1_z
  uint32_t r2_z;    // lo(M0 * seed) ^ 2 W1: word 2 after round 2 is hi(M0 c0) ^ r2_z
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t seed) {
  PhiloxKey key;
#pragma unroll
  for (int r = 0; r < 10; ++r) key.k0[r] = seed + static_cast<uint32_t>(r) * kPhiloxW0;
  uint32_t hi, lo;
  mulhilo(kPhiloxM0, seed, hi, lo);
  key.r1_z = hi ^ kPhiloxW1;
  key.r2_z = lo ^ (2 * kPhiloxW1);
  return key;
}

// Philox4x32-10 of the counter (x, 0, 0, 0).
__device__ __forceinline__ uint4 philox(uint32_t x, const PhiloxKey& key) {
  uint32_t h0, l0, h1, l1;
  mulhilo(kPhiloxM0, x, h0, l0);   // round 0; M1 * 0 = 0
  mulhilo(kPhiloxM1, h0, h1, l1);  // round 1; M0 * seed is in the key
  const uint32_t c0 = h1 ^ key.k0[1], c1 = l1, c2 = l0 ^ key.r1_z;
  mulhilo(kPhiloxM0, c0, h0, l0);  // round 2
  mulhilo(kPhiloxM1, c2, h1, l1);
  uint4 c = make_uint4(h1 ^ c1 ^ key.k0[2], l1, h0 ^ key.r2_z, l0);
#pragma unroll
  for (int r = 3; r < 10; ++r) {
    mulhilo(kPhiloxM0, c.x, h0, l0);
    mulhilo(kPhiloxM1, c.z, h1, l1);
    c = make_uint4(h1 ^ c.y ^ key.k0[r], l1, h0 ^ c.w ^ (static_cast<uint32_t>(r) * kPhiloxW1), l0);
  }
  return c;
}

__device__ __forceinline__ uint32_t keep(uint32_t bits, uint32_t thresh, uint32_t value) {
  return bits < thresh ? value : 0u;
}

// Two bf16 mask values in one word, the lower element in the low half.
__device__ __forceinline__ uint32_t keep2(uint32_t b0, uint32_t b1, uint32_t thresh, uint32_t lo,
                                          uint32_t hi) {
  return keep(b0, thresh, lo) | keep(b1, thresh, hi);
}

__device__ __forceinline__ float uniform(uint32_t bits, float scale) {
  return __fmul_rn(__fmul_rn(__uint2float_rn(bits >> 8), 0x1p-24f), scale);
}

// The output of group g (elements 4g..4g+3) from its Philox words r, and
// the same for the ragged tail, element by element.
struct Fp32Mask {
  uint32_t thresh, value;
  __device__ __forceinline__ uint4 group(uint4 r) const {
    return make_uint4(keep(r.x, thresh, value), keep(r.y, thresh, value), keep(r.z, thresh, value),
                      keep(r.w, thresh, value));
  }
  __device__ __forceinline__ uint32_t element(uint32_t r) const { return keep(r, thresh, value); }
};

struct Bf16Mask {
  uint32_t thresh, value;  // value: the bf16 bits of the scale
  __device__ __forceinline__ uint2 group(uint4 r) const {
    const uint32_t hi = value << 16;
    return make_uint2(keep2(r.x, r.y, thresh, value, hi), keep2(r.z, r.w, thresh, value, hi));
  }
  __device__ __forceinline__ uint16_t element(uint32_t r) const {
    return static_cast<uint16_t>(keep(r, thresh, value));
  }
};

struct Uniform {
  float scale;
  __device__ __forceinline__ float4 group(uint4 r) const {
    return make_float4(uniform(r.x, scale), uniform(r.y, scale), uniform(r.z, scale), uniform(r.w, scale));
  }
  __device__ __forceinline__ float element(uint32_t r) const { return uniform(r, scale); }
};

// One thread's loop step t (warp span w = t / 32, lane l = t % 32): two
// Philox blocks.  4-byte elements: groups 64 w + l and 64 w + l + 32, each
// a 16-byte store, so a warp's store covers 512 contiguous bytes.  2-byte
// elements: groups 2t and 2t + 1, one 16-byte store.
// Group g of the output takes the Philox block of counter g + base: base is
// 0 for a whole draw, and a segment's first global group for a segment.
template <typename Out, typename Op>
__device__ __forceinline__ void wide_step(Out* out, uint32_t t, uint32_t base, const PhiloxKey& key,
                                          const Op& op) {
  const uint32_t g = 2 * t - (t & 31u);
  Out* o = out + g;
  o[0] = op.group(philox(g + base, key));
  o[32] = op.group(philox(g + 32 + base, key));
}

__device__ __forceinline__ void narrow_step(uint16_t* out, uint32_t t, uint32_t base, const PhiloxKey& key,
                                            const Bf16Mask& op) {
  const uint2 a = op.group(philox(2 * t + base, key)), b = op.group(philox(2 * t + 1 + base, key));
  reinterpret_cast<uint4*>(out)[t] = make_uint4(a.x, a.y, b.x, b.y);
}

// The whole kernel for one output type: whole warp spans in a grid-stride
// loop, then the tail.  Output group g takes the Philox block of counter
// g + base (the one-segment kernels pass the literal 0, which folds away).
template <typename T, typename Op>
__device__ __forceinline__ void draw(T* __restrict__ out, int64_t n, const PhiloxKey& key, const Op& op,
                                     uint32_t base) {
  const uint32_t spans = static_cast<uint32_t>(n / kSpan);
  const uint32_t steps = 32 * spans;
  const uint32_t first = blockIdx.x * kThreads + threadIdx.x;
#pragma unroll 1
  for (uint32_t t = first; t < steps; t += gridDim.x * kThreads) {
    if constexpr (sizeof(T) == 4) {
      wide_step(reinterpret_cast<decltype(op.group(uint4{}))*>(out), t, base, key, op);
    } else {
      narrow_step(out, t, base, key, op);
    }
  }
  const uint32_t g = kSpanGroups * spans + first;  // the tail's groups, one per thread
  if (first < kSpanGroups && int64_t{4} * g < n) {
    const uint4 r = philox(g + base, key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (int64_t{4} * g + j < n) out[int64_t{4} * g + j] = op.element(bits[j]);
    }
  }
}

// Elements are written as their bit patterns (uint32_t fp32, uint16_t
// bf16): the kept value is turned into its bits once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_mask_kernel(T* __restrict__ out, int64_t n, const uint32_t* __restrict__ seeds, int slot,
                        uint32_t thresh, float scale) {
  const PhiloxKey key = philox_key(seeds[slot]);
  if constexpr (sizeof(T) == 4) {
    draw(out, n, key, Fp32Mask{thresh, __float_as_uint(scale)}, 0u);
  } else {
    const uint32_t value = __bfloat16_as_ushort(__float2bfloat16(scale));
    draw(out, n, key, Bf16Mask{thresh, value}, 0u);
  }
}

__global__ void __launch_bounds__(kThreads)
    philox_uniform_kernel(float* __restrict__ out, int64_t n, const uint32_t* __restrict__ seeds, int slot,
                          float scale) {
  draw(out, n, philox_key(seeds[slot]), Uniform{scale}, 0u);
}

// Row segments: a rank's rows of a global draw.  Segment s is the global
// elements [start[s], start[s] + count[s]), written at offset[s] of the
// local output, one segment after another; element j of segment s takes the
// bits that element start[s] + j takes in the whole draw.  Passed by value,
// so a captured graph keeps the layout with the launch.
constexpr int kMaxSegments = 4;

struct Segments {
  int64_t start[kMaxSegments];
  int64_t count[kMaxSegments];
  int64_t offset[kMaxSegments];
  int n;
};

// A segment whose start is not a multiple of 8 elements, or whose local
// offset is not (16-byte stores), element by element: each thread one
// Philox block of the groups the segment touches, its first and last block
// only partly used.
template <typename T, typename Op>
__device__ __forceinline__ void draw_ragged(T* __restrict__ out, int64_t start, int64_t n, const PhiloxKey& key,
                                            const Op& op) {
  const int64_t end = start + n;
  const uint32_t first = static_cast<uint32_t>(start / 4), last = static_cast<uint32_t>((end + 3) / 4);
#pragma unroll 1
  for (uint32_t g = first + blockIdx.x * kThreads + threadIdx.x; g < last; g += gridDim.x * kThreads) {
    const uint4 r = philox(g, key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = int64_t{4} * g + j;
      if (e >= start && e < end) out[e - start] = op.element(bits[j]);
    }
  }
}

// The segment of this block row: its global start, count and local offset,
// read with constant indices (a kernel parameter indexed at run time, or
// taken by address, is copied to the stack).
struct Segment {
  int64_t start, count, offset;
};

template <int S>
__device__ __forceinline__ Segment segment_at(const Segments& seg) {
  return Segment{seg.start[S], seg.count[S], seg.offset[S]};
}

__device__ __forceinline__ Segment segment_of_block(const Segments& seg) {
  static_assert(kMaxSegments == 4, "one branch per segment");
  switch (blockIdx.y) {
    case 0: return segment_at<0>(seg);
    case 1: return segment_at<1>(seg);
    case 2: return segment_at<2>(seg);
    default: return segment_at<3>(seg);
  }
}

// Where the segment's start and offset are multiples of 8 elements (every
// flagship shape: a row is C*H*W elements) it runs the one-segment loop,
// 16-byte stores and two Philox blocks per thread step, with the counters
// moved by start / 4.
template <typename T, typename Op>
__device__ __forceinline__ void draw_segment(T* __restrict__ out, Segment s, const PhiloxKey& key, const Op& op) {
  T* o = out + s.offset;
  if (((s.start | s.offset) & 7) == 0) {
    draw(o, s.count, key, op, static_cast<uint32_t>(s.start / 4));
  } else {
    draw_ragged(o, s.start, s.count, key, op);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_mask_segments_kernel(T* __restrict__ out, const Segments seg, const uint32_t* __restrict__ seeds,
                                 int slot, uint32_t thresh, float scale) {
  const PhiloxKey key = philox_key(seeds[slot]);
  const Segment s = segment_of_block(seg);
  if constexpr (sizeof(T) == 4) {
    draw_segment(out, s, key, Fp32Mask{thresh, __float_as_uint(scale)});
  } else {
    const uint32_t value = __bfloat16_as_ushort(__float2bfloat16(scale));
    draw_segment(out, s, key, Bf16Mask{thresh, value});
  }
}

__global__ void __launch_bounds__(kThreads)
    philox_uniform_segments_kernel(float* __restrict__ out, const Segments seg, const uint32_t* __restrict__ seeds,
                                   int slot, float scale) {
  draw_segment(out, segment_of_block(seg), philox_key(seeds[slot]), Uniform{scale});
}

// Blocks for n elements: enough to cover them, at most `waves` times what
// the card holds resident at once (SMs x blocks per SM), queried once per
// device and kernel (each instantiation keeps its own table).
constexpr int kMaxDevices = 64;
constexpr float kOpBoundWaves = 0.5f;
constexpr float kByteBoundWaves = 4.0f;

template <typename Kernel>
int grid_blocks(Kernel kernel, float waves, int64_t n, unsigned* blocks) {
  static int cap[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int c = static_cast<int>(waves * sms * per_sm);
    cap[dev] = c > 0 ? c : 1;
  }
  const int64_t needed = ((n + 7) / 8 + kThreads - 1) / kThreads;
  *blocks = static_cast<unsigned>(needed < cap[dev] ? needed : cap[dev]);
  return 0;
}

}  // namespace

// out: device buffer of n elements (0 < n < 2^34), 16-byte aligned; seeds:
// device table of uint32 seeds, read at seeds[slot]; dtype 0 = fp32, 1 =
// bf16.  Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ctgan_dropout_mask(void* out, int64_t n, const uint32_t* seeds, int slot, uint32_t thresh,
                                  float scale, int dtype, void* stream) {
  if (n <= 0) return 0;
  if (n >= kMaxElements || slot < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = 0;
  int rc;
  if (dtype == 0) {
    rc = grid_blocks(dropout_mask_kernel<uint32_t>, kByteBoundWaves, n, &blocks);
    if (rc) return rc;
    dropout_mask_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(static_cast<uint32_t*>(out), n, seeds, slot,
                                                             thresh, scale);
  } else {
    rc = grid_blocks(dropout_mask_kernel<uint16_t>, kOpBoundWaves, n, &blocks);
    if (rc) return rc;
    dropout_mask_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(static_cast<uint16_t*>(out), n, seeds, slot,
                                                             thresh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: device buffer of n fp32 values (0 < n < 2^34), 16-byte aligned;
// seeds and slot as above.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int ctgan_philox_uniform(float* out, int64_t n, const uint32_t* seeds, int slot, float scale,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n >= kMaxElements || slot < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const int rc = grid_blocks(philox_uniform_kernel, kByteBoundWaves, n, &blocks);
  if (rc) return rc;
  philox_uniform_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, n, seeds, slot,
                                                                                   scale);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The segments checked and laid out one after another: 0 on success.
int layout(const int64_t* starts, const int64_t* counts, int n_segments, Segments* seg, int64_t* largest) {
  if (n_segments < 1 || n_segments > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  seg->n = n_segments;
  int64_t offset = 0;
  *largest = 0;
  for (int s = 0; s < kMaxSegments; ++s) {
    const bool used = s < n_segments;
    seg->start[s] = used ? starts[s] : 0;
    seg->count[s] = used ? counts[s] : 0;
    seg->offset[s] = used ? offset : 0;
    if (used) {
      if (starts[s] < 0 || counts[s] <= 0 || starts[s] + counts[s] >= kMaxElements) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      offset += counts[s];
      if (counts[s] > *largest) *largest = counts[s];
    }
  }
  return 0;
}

}  // namespace

// The row-segment forms: out holds the segments' elements one after another
// (sum of counts), 16-byte aligned; starts[s] and counts[s] (host arrays of
// n_segments <= 4) are global element ranges of the whole draw.  The rest as
// above.  One launch, a grid row per segment.
extern "C" int ctgan_dropout_mask_segments(void* out, const int64_t* starts, const int64_t* counts, int n_segments,
                                           const uint32_t* seeds, int slot, uint32_t thresh, float scale,
                                           int dtype, void* stream) {
  Segments seg;
  int64_t largest = 0;
  int rc = layout(starts, counts, n_segments, &seg, &largest);
  if (rc) return rc;
  if (slot < 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = 0;
  if (dtype == 0) {
    rc = grid_blocks(dropout_mask_segments_kernel<uint32_t>, kByteBoundWaves, largest, &blocks);
    if (rc) return rc;
    dropout_mask_segments_kernel<uint32_t><<<dim3(blocks, n_segments), kThreads, 0, s>>>(
        static_cast<uint32_t*>(out), seg, seeds, slot, thresh, scale);
  } else {
    rc = grid_blocks(dropout_mask_segments_kernel<uint16_t>, kOpBoundWaves, largest, &blocks);
    if (rc) return rc;
    dropout_mask_segments_kernel<uint16_t><<<dim3(blocks, n_segments), kThreads, 0, s>>>(
        static_cast<uint16_t*>(out), seg, seeds, slot, thresh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctgan_philox_uniform_segments(float* out, const int64_t* starts, const int64_t* counts,
                                             int n_segments, const uint32_t* seeds, int slot, float scale,
                                             void* stream) {
  Segments seg;
  int64_t largest = 0;
  int rc = layout(starts, counts, n_segments, &seg, &largest);
  if (rc) return rc;
  if (slot < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  rc = grid_blocks(philox_uniform_segments_kernel, kByteBoundWaves, largest, &blocks);
  if (rc) return rc;
  philox_uniform_segments_kernel<<<dim3(blocks, n_segments), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, seg, seeds, slot, scale);
  return static_cast<int>(cudaGetLastError());
}
