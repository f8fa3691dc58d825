// Weight gradient of the learned upsampling's per-image 1-D filters.
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA. It
// was added because the library's routes ran far off this card's bound. The
// upsampling (models/upsampling.py) filters [C, B, H, W] tensors with one
// k-tap filter per image b (the images are the convolution's groups, the
// latent channels its batch): a stride-2 transposed convolution along H,
// then along W, per x2 step, and a zero-padded convolution along H, then
// along W, per pre-concat filter. On an H100 (700 W) at 512x768, B = 8, the
// library's weight gradients (cuDNN's wgrad2d_grouped_direct_kernel and
// wgrad_alg0_engine for the transposed calls, ATen's
// conv_depthwise2d_grad_weight for the padded ones) took 15.3 ms of a 54.3 ms
// batched step: about 175x the time their bytes need. The reduction over
// half a million pixels per group went to a handful of thread blocks on a
// 132-SM card.
//
// What it computes, for each image b and tap t < k, summed over c, i, j:
//   along rows:    dW[b, t] = A[c, b, i, j] * W[c, b, S*i + off + t, j]
//   along columns: dW[b, t] = A[c, b, i, j] * W[c, b, i, S*j + off + t]
// with the "window" tensor W taken as 0 outside its rows (columns):
//   transposed (stride 2): A = x, W = dy, S = 2, off = 0;
//   zero-padded:           A = dy, W = x, S = 1, off = -(k / 2).
//
// What bounds it: each output gradient and input is read once, ~2 FLOP per
// 8 bytes, so device memory (3.35 TB/s). At 512x768, B = 8, the 24 weight
// gradients of one step read ~290 MB: ~87 us. Design:
//  * Every image's C*H*W domain is split over as many blocks as fill the
//    card (the wrapper's plan, from the shapes and the SM count): a block
//    covers part of one image and writes k partial sums; a second small
//    launch sums each image's partials in a fixed order. No float atomics:
//    the result is the same run to run.
//  * Taps sit right-aligned in KMAX compile-time slots (slot p is tap
//    p - (KMAX - k)), so the window and the k accumulators live in
//    registers whatever the runtime k; slots left of the taps read real
//    rows or zeros and are never stored.
//  * Along rows, a thread owns VEC adjacent columns (16-byte loads where the
//    rows are 16-byte aligned) and walks down a strip of A's rows, keeping
//    the KMAX window rows of W in registers: each step loads one A row and
//    S new W rows.
//  * Along columns, a warp takes 128 columns of a row at a time: each lane
//    loads 4 A values and its share of their W segment plus halo (coalesced
//    loads, all in flight at once), the segment goes through the warp's own
//    shared buffer, and each lane multiplies its A values by their k window
//    values from there. Only the warp synchronises until the block's sum.
//  * f32 loads, f32 products and sums (no TF32), warp-shuffle then
//    shared-memory reduction per block.
// Launches go on the caller's stream; nothing is allocated or synchronised
// here. The entry returns the CUDA error code of the launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;  // A columns of a lane in a column item
constexpr int kChunk = 32 * kColsPerLane;  // A columns of a column item

// A [C, B, H, W] f32 tensor with unit stride along W; strides in floats.
struct Grid4 {
  const float* ptr;
  long long sc, sb, sh;
  int h, w;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums the taps' slots (KMAX - k .. KMAX) over the block of kThreads; thread
// t < k writes tap t's sum to partial[t]. Every thread of the block calls it.
template <int KMAX>
__device__ void block_sum_store(const float (&acc)[KMAX], int k, float* partial) {
  __shared__ float red[kWarps][KMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p >= KMAX - k) {
      const float v = warp_sum(acc[p]);
      if (lane == 0) red[warp][p] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < k) {
    const int p = threadIdx.x + KMAX - k;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][p];
    partial[threadIdx.x] = s;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[u] = __ldg(p + u);
  }
}

// Row `r` of the window plane at `p` (VEC columns), zero outside [0, h).
template <int VEC>
__device__ __forceinline__ void load_window_row(float (&v)[VEC], const float* p, long long sh,
                                                int h, int r) {
  if (r >= 0 && r < h) {
    load_vec<VEC>(v, p + r * sh);
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[u] = 0.f;
  }
}

// Along rows. Thread item = (c, strip, column group), column group fastest;
// grid (blocks per image, B). Image b's partials: partials + b * gridDim.x * k.
template <int KMAX, int S, int VEC>
__global__ void __launch_bounds__(kThreads)
wgrad_rows(Grid4 a, Grid4 win_t, int n_c, int k, int off, int strip, int n_strips, int n_cg,
           float* partials) {
  const int b = blockIdx.y;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_items = static_cast<long long>(n_c) * n_strips * n_cg;
  float acc[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) acc[p] = 0.f;
  if (item < n_items) {
    const int cg = static_cast<int>(item % n_cg);
    const long long rest = item / n_cg;
    const int s = static_cast<int>(rest % n_strips);
    const int c = static_cast<int>(rest / n_strips);
    const int j = cg * VEC;
    const float* ap = a.ptr + c * a.sc + b * a.sb + j;
    const float* wp = win_t.ptr + c * win_t.sc + b * win_t.sb + j;
    const int i0 = s * strip;
    const int i1 = min(a.h, i0 + strip);
    const int base = off - (KMAX - k);  // window row of slot 0 at A row 0
    float win[KMAX][VEC];
#pragma unroll
    for (int p = 0; p < KMAX; ++p)
      load_window_row<VEC>(win[p], wp, win_t.sh, win_t.h, S * i0 + base + p);
    for (int i = i0; i < i1; ++i) {
      float av[VEC];
      load_vec<VEC>(av, ap + i * a.sh);
#pragma unroll
      for (int p = 0; p < KMAX; ++p) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) acc[p] = fmaf(av[u], win[p][u], acc[p]);
      }
      if (i + 1 < i1) {
#pragma unroll
        for (int p = 0; p < KMAX - S; ++p) {
#pragma unroll
          for (int u = 0; u < VEC; ++u) win[p][u] = win[p + S][u];
        }
#pragma unroll
        for (int q = 0; q < S; ++q)
          load_window_row<VEC>(win[KMAX - S + q], wp, win_t.sh, win_t.h,
                               S * (i + 1) + base + KMAX - S + q);
      }
    }
  }
  block_sum_store<KMAX>(acc, k, partials + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * k);
}

// Along columns. A warp item is kChunk columns of one row of image b (rows
// c * H + h); the warps of the grid's row b walk image b's items with a
// grid stride. Each lane loads its kColsPerLane A values and kLoads window
// values (coalesced, all in flight together), the window goes through the
// warp's own shared buffer, and no barrier wider than the warp is taken
// until the block's final sum.
template <int KMAX, int S>
__global__ void __launch_bounds__(kThreads)
wgrad_cols(Grid4 a, Grid4 win_t, int n_c, int k, int off, int n_chunks, float* partials) {
  constexpr int kSeg = S * (kChunk - 1) + KMAX;  // window values of one item
  constexpr int kLoads = (kSeg + 31) / 32;
  __shared__ float seg[kWarps][kLoads * 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_items = static_cast<long long>(n_c) * a.h * n_chunks;
  float acc[KMAX];
#pragma unroll
  for (int p = 0; p < KMAX; ++p) acc[p] = 0.f;
  for (long long item = static_cast<long long>(blockIdx.x) * kWarps + warp; item < n_items;
       item += static_cast<long long>(gridDim.x) * kWarps) {
    const int chunk = static_cast<int>(item % n_chunks);
    const int row = static_cast<int>(item / n_chunks);
    const int c = row / a.h, h = row - c * a.h;
    const float* arow = a.ptr + c * a.sc + b * a.sb + h * a.sh;
    const float* wrow = win_t.ptr + c * win_t.sc + b * win_t.sb + h * win_t.sh;
    const int j0 = chunk * kChunk;
    const int col0 = S * j0 + off - (KMAX - k);  // window column of seg slot 0
    float av[kColsPerLane], wv[kLoads];
#pragma unroll
    for (int v = 0; v < kColsPerLane; ++v) {
      const int j = j0 + lane + 32 * v;
      av[v] = j < a.w ? __ldg(arow + j) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int col = col0 + lane + 32 * m;
      wv[m] = (col >= 0 && col < win_t.w) ? __ldg(wrow + col) : 0.f;
    }
    __syncwarp();  // the previous item's reads of seg are done
#pragma unroll
    for (int m = 0; m < kLoads; ++m) seg[warp][lane + 32 * m] = wv[m];
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kColsPerLane; ++v) {
      const float* sp = &seg[warp][S * (lane + 32 * v)];
#pragma unroll
      for (int p = 0; p < KMAX; ++p) acc[p] = fmaf(av[v], sp[p], acc[p]);
    }
  }
  block_sum_store<KMAX>(acc, k, partials + (static_cast<long long>(b) * gridDim.x + blockIdx.x) * k);
}

// out[b, t] = sum over blk of partials[b, blk, t], in a fixed order; grid (B).
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* partials, int n_blk, int k, float* out) {
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = partials + static_cast<long long>(blockIdx.x) * n_blk * k;
  for (int t = 0; t < k; ++t) {
    float s = 0.f;
    for (int i = threadIdx.x; i < n_blk; i += kThreads) s += p[static_cast<long long>(i) * k + t];
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += red[w];
      out[static_cast<long long>(blockIdx.x) * k + t] = v;
    }
    __syncthreads();
  }
}

template <int KMAX, int S>
cudaError_t launch_rows(dim3 grid, Grid4 a, Grid4 w, int n_c, int k, int off, const int* plan,
                        float* partials, cudaStream_t stream) {
  const int vec = plan[1], strip = plan[2], n_strips = plan[3], n_cg = plan[4];
  if (vec == 4) {
    wgrad_rows<KMAX, S, 4><<<grid, kThreads, 0, stream>>>(a, w, n_c, k, off, strip, n_strips,
                                                           n_cg, partials);
    return cudaGetLastError();
  }
  if (vec != 1) return cudaErrorInvalidValue;
  wgrad_rows<KMAX, S, 1><<<grid, kThreads, 0, stream>>>(a, w, n_c, k, off, strip, n_strips, n_cg,
                                                         partials);
  return cudaGetLastError();
}

template <int KMAX, int S>
cudaError_t launch_cols(dim3 grid, Grid4 a, Grid4 w, int n_c, int k, int off, const int* plan,
                        float* partials, cudaStream_t stream) {
  const int n_chunks = plan[1];
  if (n_chunks < 1) return cudaErrorInvalidValue;
  wgrad_cols<KMAX, S><<<grid, kThreads, 0, stream>>>(a, w, n_c, k, off, n_chunks, partials);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_main(int axis, int stride, dim3 grid, Grid4 a, Grid4 w, int n_c, int k,
                        int off, const int* plan, float* partials, cudaStream_t stream) {
  if (axis == 2)
    return stride == 2 ? launch_rows<KMAX, 2>(grid, a, w, n_c, k, off, plan, partials, stream)
                       : launch_rows<KMAX, 1>(grid, a, w, n_c, k, off, plan, partials, stream);
  return stride == 2 ? launch_cols<KMAX, 2>(grid, a, w, n_c, k, off, plan, partials, stream)
                     : launch_cols<KMAX, 1>(grid, a, w, n_c, k, off, plan, partials, stream);
}

Grid4 grid4(const float* ptr, const long long* geom) {
  return Grid4{ptr, geom[0], geom[1], geom[2], static_cast<int>(geom[3]),
               static_cast<int>(geom[4])};
}

}  // namespace

extern "C" int ups_wgrad_threads() { return kThreads; }
extern "C" int ups_wgrad_chunk() { return kChunk; }

// dW [n_b, k] of one per-image 1-D filter (see the top of this file) into
// out, its partial sums after it (n_b * k * (1 + blocks per image) floats in
// all). `a` and `w` are the A and window tensors; geom holds the geometry of
// each, {stride of c, of b, of h (floats), h, w}, A's first. plan is the
// wrapper's, {axis, stride, k, off, n_c, n_b, KMAX, ...split, blocks per
// image}: axis 2 filters along rows, 3 along columns; off is 0 (transposed,
// stride 2) or -(k / 2) (padded, stride 1); KMAX is 8 or 16, at least k;
// the split is
//   axis 2: {VEC, strip rows, strips, column groups}
//   axis 3: {chunks of kChunk columns per row, 0, 0, 0}.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ups_wgrad_launch(const float* a, const float* w, const long long* geom,
                                const int* plan, float* out, void* stream_ptr) {
  const int axis = plan[0], stride = plan[1], k = plan[2], off = plan[3], n_c = plan[4];
  const int n_b = plan[5], kmax = plan[6], n_blk = plan[11];
  const int* split = plan + 6;  // {KMAX, the four numbers of the split, blocks per image}
  if ((axis != 2 && axis != 3) || (stride != 1 && stride != 2) || k < 1 || k > kmax ||
      n_c < 1 || n_b < 1 || n_b > 65535 || n_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(n_blk, n_b);
  const Grid4 ga = grid4(a, geom), gw = grid4(w, geom + 5);
  float* partials = out + static_cast<long long>(n_b) * k;
  cudaError_t err;
  switch (kmax) {
    case 8: err = launch_main<8>(axis, stride, grid, ga, gw, n_c, k, off, split, partials, stream); break;
    case 16: err = launch_main<16>(axis, stride, grid, ga, gw, n_c, k, off, split, partials, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<n_b, kThreads, 0, stream>>>(partials, n_blk, k, out);
  return static_cast<int>(cudaGetLastError());
}
