// Weight and bias gradients of a depthwise 7x7 convolution, stride 1,
// zero-padded by 3 on each side ("SAME"): the latent encoder's
// ConvNeXtBlock.Conv_0 (hypernet/blocks.py).
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA. It
// was added because the library's route ran far off this card's bound. The
// latent encoder of the hypernet runs 21 such layers a training step (7
// levels x 3 blocks, 64 channels, 256x256 down to 4x4 at B = 8); on an H100
// (700 W) cuDNN's wgrad2d_grouped_direct_kernel took 84-90 ms of a 165-171 ms
// step for them, about 250x the time their bytes need.
//
// What it computes, for each channel c and tap (ky, kx), summed over b, y, x:
//   dW[c, ky, kx] = gy[b, c, y, x] * x[b, c, y + ky - 3, x + kx - 3]
//   db[c]         = gy[b, c, y, x]
// with x taken as 0 outside its plane. x and gy are channels-last (NHWC in
// memory): in the latent encoder autograd hands both over so (the layer
// norm's permute), and reading them so spares two transposing copies of
// ~1 GB a step.
//
// What bounds it: x and gy are read once; 49 FMA per pair of 8 bytes. The 21
// layers of a step read ~1.07 GB, ~0.32 ms at 3.35 TB/s, and make ~6.6 G FMA,
// ~0.2 ms on the f32 CUDA cores at 67 TFLOP/s: both about as near, so
// neither the loads nor the FMAs may wait on the other. Design:
//  * A thread owns kVec = 4 adjacent columns of one plane (b, c) and walks
//    down a strip of its rows, keeping in registers the 49 sums, the bias
//    sum and the 7 gy rows (4 values each) that the current x row meets.
//    Each step loads one x row segment with its 3-column halo on each side
//    (10 values) and one new gy row segment (4); the 7 horizontal taps then
//    come from registers: 196 FMA per 14 values loaded.
//  * Eight lanes of a warp hold 8 adjacent channels of the same columns, and
//    the warp's four such groups 4 adjacent column groups: each load of the
//    warp takes four whole 32-byte sectors (8 channels of one column each);
//    the halo comes from the neighbouring lanes' sectors in L1.
//  * A thread block holds 32 items (b, strip, column group) of one group of 8
//    channels, columns fastest. A strip reads 3 halo rows of x above and
//    below it. The wrapper's plan cuts the strips from the shape and the SM
//    count, so that the card holds one wave of threads: long strips at the
//    finest levels, one row at the smallest.
//  * Each block sums its threads' 50 sums per channel (warp shuffles across
//    the column groups, then shared memory across warps) into its own
//    partials; a second small launch sums each channel's partials in a
//    fixed order. No float atomics: the result is the same run to run.
//  * f32 loads, f32 products and sums (no TF32).
// Launches go on the caller's stream; nothing is allocated or synchronised
// here. The entry returns the CUDA error code of the launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 8;  // channels of a block, adjacent lanes
constexpr int kItems = kThreads / kChannels;  // items of a block
constexpr int kK = 7;  // taps per axis
constexpr int kR = kK / 2;  // zero padding on each side
constexpr int kVec = 4;  // columns of a thread
constexpr int kXs = kVec + kK - 1;  // x values of a thread's row segment
constexpr int kSums = kK * kK + 1;  // the taps, then the bias

// The wrapper's plan (ops/dw_wgrad.py::plan).
struct Plan {
  int n_b, n_c, h, w;
  int strip, n_strips, n_seg, n_blk;
};

__device__ __forceinline__ float warp_sum(float v, int from) {
  for (int off = 16; off >= from; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row y of a channels-last plane at `plane` (element (b, c, 0, 0) of its
// tensor): element (y, col) is plane[y * p.w * p.n_c + col * p.n_c].
__device__ __forceinline__ const float* row_of(const float* plane, const Plan& p, int y) {
  return plane + static_cast<long long>(y) * p.w * p.n_c;
}

// gy row `y`, columns j0 .. j0 + kVec; zero unless `valid` (the row lies in
// the thread's strip), and past the plane's width.
__device__ __forceinline__ void load_gy(float (&g)[kVec], const float* plane, const Plan& p,
                                        int y, int j0, bool valid) {
  if (!valid) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) g[u] = 0.f;
    return;
  }
  const float* row = row_of(plane, p, y);
#pragma unroll
  for (int u = 0; u < kVec; ++u) g[u] = j0 + u < p.w ? __ldg(row + (j0 + u) * p.n_c) : 0.f;
}

// x row `y`, columns j0 - kR .. j0 + kVec + kR, zero outside [0, w).
__device__ __forceinline__ void load_x(float (&v)[kXs], const float* plane, const Plan& p, int y,
                                       int j0) {
  const float* row = row_of(plane, p, y);
#pragma unroll
  for (int m = 0; m < kXs; ++m) {
    const int col = j0 - kR + m;
    v[m] = (col >= 0 && col < p.w) ? __ldg(row + col * p.n_c) : 0.f;
  }
}

// Per-block partial sums; grid (blocks per channel group, channel groups).
// Block (blk, g) writes partials[(c * n_blk + blk) * kSums + t], t < kSums,
// for each of its channels c < n_c.
__global__ void __launch_bounds__(kThreads, 2)
dw_wgrad_partials(const float* __restrict__ x, const float* __restrict__ gy, Plan p,
                  float* __restrict__ partials) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kChannels + lane % kChannels;
  const int item = blockIdx.x * kItems + threadIdx.x / kChannels;
  float acc[kK][kK];
  float bias = 0.f;
#pragma unroll
  for (int ky = 0; ky < kK; ++ky) {
#pragma unroll
    for (int kx = 0; kx < kK; ++kx) acc[ky][kx] = 0.f;
  }
  if (c < p.n_c && item < p.n_b * p.n_strips * p.n_seg) {
    const int seg = item % p.n_seg;
    const int rest = item / p.n_seg;
    const int s = rest % p.n_strips;
    const int b = rest / p.n_strips;
    const long long plane = static_cast<long long>(b) * p.h * p.w * p.n_c + c;
    const float* xp = x + plane;
    const float* gp = gy + plane;
    const int j0 = seg * kVec;
    const int y0 = s * p.strip, y1 = min(p.h, y0 + p.strip);
    const int r0 = max(0, y0 - kR), r1 = min(p.h, y1 + kR);
    // g[q]: gy row r - kR + q at the step of x row r (zero outside the strip).
    float g[kK][kVec];
#pragma unroll
    for (int q = 0; q < kK - 1; ++q) {
      const int y = r0 - kR + q;
      load_gy(g[q], gp, p, y, j0, y >= y0 && y < y1);
#pragma unroll
      for (int u = 0; u < kVec; ++u) bias += g[q][u];
    }
    for (int r = r0; r < r1; ++r) {
      const int y = r + kR;
      load_gy(g[kK - 1], gp, p, y, j0, y < y1);
      float v[kXs];
      load_x(v, xp, p, r, j0);
#pragma unroll
      for (int u = 0; u < kVec; ++u) bias += g[kK - 1][u];
      // Tap ky meets gy row r + kR - ky: ring slot kK - 1 - ky.
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
          for (int u = 0; u < kVec; ++u)
            acc[ky][kx] = fmaf(g[kK - 1 - ky][u], v[u + kx], acc[ky][kx]);
        }
      }
#pragma unroll
      for (int q = 0; q < kK - 1; ++q) {
#pragma unroll
        for (int u = 0; u < kVec; ++u) g[q][u] = g[q + 1][u];
      }
    }
  }
  // Lanes l, l + 8, l + 16, l + 24 hold channel l % 8: sum them, then the warps.
  __shared__ float red[kWarps][kChannels][kSums];
#pragma unroll
  for (int t = 0; t < kSums - 1; ++t) {
    const float v = warp_sum(acc[t / kK][t % kK], kChannels);
    if (lane < kChannels) red[warp][lane][t] = v;
  }
  bias = warp_sum(bias, kChannels);
  if (lane < kChannels) red[warp][lane][kSums - 1] = bias;
  __syncthreads();
  for (int i = threadIdx.x; i < kChannels * kSums; i += kThreads) {
    const int ch = i / kSums, t = i % kSums;
    const int cc = blockIdx.y * kChannels + ch;
    if (cc < p.n_c) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[w][ch][t];
      partials[(static_cast<long long>(cc) * gridDim.x + blockIdx.x) * kSums + t] = sum;
    }
  }
}

// out[c * 49 + t] (taps) and out[n_c * 49 + c] (bias): each channel's
// partials summed over its blocks in a fixed order; grid (channels).
__global__ void __launch_bounds__(64)
sum_partials(const float* __restrict__ partials, int n_blk, int n_c, float* __restrict__ out) {
  const int c = blockIdx.x, t = threadIdx.x;
  if (t >= kSums) return;
  const float* q = partials + static_cast<long long>(c) * n_blk * kSums + t;
  float s = 0.f;
  for (int i = 0; i < n_blk; ++i) s += q[static_cast<long long>(i) * kSums];
  if (t < kK * kK) {
    out[c * kK * kK + t] = s;
  } else {
    out[n_c * kK * kK + c] = s;
  }
}

}  // namespace

extern "C" int dw_wgrad_threads() { return kThreads; }
extern "C" int dw_wgrad_channels() { return kChannels; }
extern "C" int dw_wgrad_vec() { return kVec; }
extern "C" int dw_wgrad_taps() { return kK; }

// dW [n_c, 7, 7] into out[0, n_c * 49), db [n_c] after it, then the
// partial sums (n_c * n_blk * 50 floats): n_c * 50 * (1 + n_blk) floats in
// all. x and gy are channels-last [n_b, n_c, h, w] f32 tensors. plan is
// the wrapper's: {n_b, n_c, h, w, strip rows, strips, column groups of kVec,
// blocks per channel group}. Returns the CUDA error code of the launches (0
// on success).
extern "C" int dw_wgrad_launch(const float* x, const float* gy, const int* plan, float* out,
                               void* stream_ptr) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7]};
  const int n_groups = (p.n_c + kChannels - 1) / kChannels;
  if (p.n_b < 1 || p.n_c < 1 || n_groups > 65535 || p.h < 1 || p.w < 1 || p.strip < 1 ||
      p.n_strips < 1 || p.n_seg < 1 || p.n_blk < 1 ||
      static_cast<long long>(p.strip) * p.n_strips < p.h ||
      static_cast<long long>(p.n_seg) * kVec < p.w ||
      static_cast<long long>(p.n_blk) * kItems <
          static_cast<long long>(p.n_b) * p.n_strips * p.n_seg ||
      static_cast<long long>(p.n_blk) * kThreads > 0x7fffffffLL ||
      static_cast<long long>(p.w) * p.n_c > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(p.n_blk, n_groups);
  float* partials = out + static_cast<long long>(p.n_c) * kSums;
  dw_wgrad_partials<<<grid, kThreads, 0, stream>>>(x, gy, p, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<p.n_c, 64, 0, stream>>>(partials, p.n_blk, p.n_c, out);
  return static_cast<int>(cudaGetLastError());
}
