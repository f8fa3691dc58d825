// Fused eval-mode ARM rate over a pyramid of latent planes (Hopper, sm_90a).
//
// Replaces coolchic_tpu/ops/pallas_arm.py::_kernel (launched there once per
// plane by arm_rate_pallas / arm_rate_pallas_pyramid). For every latent y of
// every plane: gather the dim_arm causal context values of the plane
// zero-padded by 4, run n_hidden residual layers x <- relu(W x + b + x) and
// the 2-wide head (mu, log_scale), then write the Laplace rate
//   -log2(max(CDF(y + 1/2) - CDF(y - 1/2), 2^-16)),
//   CDF(v) = 1/2 - 1/2 sign(v - mu) expm1(-|v - mu| / scale),
//   scale = exp(clamp(log_scale - 4, -4.6, 5)).
// The plane is read once and the rate written once; the [M, dim_arm] context
// matrix of the plain version never exists.
//
// What bounds it: per latent, n_hidden * C^2 + 2 C multiply-adds against 8
// bytes of traffic (C = dim_arm). At C = 24, n_hidden = 2 that is ~1,200 FMA
// per 8 bytes, far above the card's ~20 FLOP/byte balance point for f32 on
// the CUDA cores, so the kernel is bound by f32 FMA throughput.
// Design: one thread per output latent over a 32 x 8 tile; the tile and its
// causal halo (4 rows above, 4 columns each side) are staged in shared memory
// with zero fill outside the plane, so the stencil reads shared memory only.
// All weights sit in shared memory and are read as float4 broadcasts (every
// thread of a warp reads the same address). The MLP runs in registers, with
// dim_arm a template parameter so the layer loops unroll fully. One launch
// covers every plane of the pyramid: a by-value table maps each block to its
// plane, and the output is the flat rate vector in forward order
// (plane-major, then raster), at the same offsets as the input.
// No fast-math: expf, expm1f and log2f stay IEEE-accurate to hold 1e-4
// against the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 4;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHaloW = kTileW + 2 * kPad;  // context columns reach dx in [-4, 4]
constexpr int kHaloH = kTileH + kPad;      // context rows reach dy in [-4, 0]
constexpr int kMaxPlanes = 64;

// Indices into the flattened 9 x 9 causal window (models/arm.py tables).
__constant__ int c_ctx_index[4][32] = {
    {13, 22, 30, 31, 32, 37, 38, 39},
    {13, 14, 20, 21, 22, 23, 24, 28, 29, 30, 31, 32, 33, 37, 38, 39},
    {4, 11, 12, 13, 14, 15, 19, 20, 21, 22, 23, 24, 25, 28, 29, 30, 31,
     32, 33, 34, 36, 37, 38, 39},
    {2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 16, 19, 20, 21, 22, 23, 24, 25,
     26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39},
};

struct PlaneTable {
  int n_planes;
  int h[kMaxPlanes];
  int w[kMaxPlanes];
  int tiles_x[kMaxPlanes];
  int first_tile[kMaxPlanes];
  long long offset[kMaxPlanes];
};

__device__ __forceinline__ float sign_f(float v) {
  return static_cast<float>((v > 0.f) - (v < 0.f));
}

__device__ __forceinline__ float laplace_cdf(float shifted, float scale) {
  return 0.5f - 0.5f * sign_f(shifted) * expm1f(-fabsf(shifted) / scale);
}

// Weights layout (floats): per hidden layer W[C][C] (out-major) then b[C];
// then the head W[2][C] and b[2]; zero padded to a multiple of 4.
template <int C>
__global__ void __launch_bounds__(kTileW * kTileH)
arm_rate_kernel(const float* __restrict__ latents, float* __restrict__ rate,
                const float* __restrict__ weights, int n_weights, int n_hidden,
                PlaneTable table) {
  extern __shared__ float4 w_smem4[];
  __shared__ float tile[kHaloH][kHaloW];
  const float* w_smem = reinterpret_cast<const float*>(w_smem4);

  // Which plane does this block work on? Static indices only, so the table
  // stays in the parameter bank.
  const int block = blockIdx.x;
  int h = table.h[0], w = table.w[0], tiles_x = table.tiles_x[0];
  int first = 0;
  long long offset = table.offset[0];
#pragma unroll
  for (int i = 1; i < kMaxPlanes; ++i) {
    if (i < table.n_planes && block >= table.first_tile[i]) {
      h = table.h[i];
      w = table.w[i];
      tiles_x = table.tiles_x[i];
      first = table.first_tile[i];
      offset = table.offset[i];
    }
  }
  const int local = block - first;
  const int row0 = (local / tiles_x) * kTileH;
  const int col0 = (local % tiles_x) * kTileW;
  const float* plane = latents + offset;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int n_threads = kTileW * kTileH;
  const float4* w_global4 = reinterpret_cast<const float4*>(weights);
  for (int i = tid; i < n_weights / 4; i += n_threads) w_smem4[i] = w_global4[i];
  for (int i = tid; i < kHaloH * kHaloW; i += n_threads) {
    const int r = i / kHaloW, c = i % kHaloW;
    const int gy = row0 - kPad + r, gx = col0 - kPad + c;
    tile[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                     ? plane[static_cast<long long>(gy) * w + gx]
                     : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x;
  const int gy = row0 + ty, gx = col0 + tx;
  if (gy >= h || gx >= w) return;  // no barrier follows

  float a[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int idx = c_ctx_index[C / 8 - 1][k];
    a[k] = tile[ty + idx / 9][tx + idx % 9];
  }

  const float* layer = w_smem;
  for (int l = 0; l < n_hidden; ++l) {
    float y[C];
#pragma unroll
    for (int o = 0; o < C; ++o) {
      const float4* row = reinterpret_cast<const float4*>(layer + o * C);
      float acc = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < C / 4; ++k4) {
        const float4 wv = row[k4];
        acc = fmaf(a[4 * k4 + 0], wv.x, acc);
        acc = fmaf(a[4 * k4 + 1], wv.y, acc);
        acc = fmaf(a[4 * k4 + 2], wv.z, acc);
        acc = fmaf(a[4 * k4 + 3], wv.w, acc);
      }
      y[o] = fmaxf(acc + layer[C * C + o] + a[o], 0.f);
    }
#pragma unroll
    for (int o = 0; o < C; ++o) a[o] = y[o];
    layer += C * C + C;
  }

  const float4* head_mu = reinterpret_cast<const float4*>(layer);
  const float4* head_ls = reinterpret_cast<const float4*>(layer + C);
  float mu = 0.f, ls = 0.f;
#pragma unroll
  for (int k4 = 0; k4 < C / 4; ++k4) {
    const float4 wm = head_mu[k4];
    const float4 wl = head_ls[k4];
    mu = fmaf(a[4 * k4 + 0], wm.x, mu);
    mu = fmaf(a[4 * k4 + 1], wm.y, mu);
    mu = fmaf(a[4 * k4 + 2], wm.z, mu);
    mu = fmaf(a[4 * k4 + 3], wm.w, mu);
    ls = fmaf(a[4 * k4 + 0], wl.x, ls);
    ls = fmaf(a[4 * k4 + 1], wl.y, ls);
    ls = fmaf(a[4 * k4 + 2], wl.z, ls);
    ls = fmaf(a[4 * k4 + 3], wl.w, ls);
  }
  mu += layer[2 * C];
  ls += layer[2 * C + 1];
  const float scale = expf(fminf(fmaxf(ls - 4.f, -4.6f), 5.f));

  const float y0 = tile[ty + kPad][tx + kPad];
  const float cdf_hi = laplace_cdf(y0 + 0.5f - mu, scale);
  const float cdf_lo = laplace_cdf(y0 - 0.5f - mu, scale);
  const float proba = fmaxf(cdf_hi - cdf_lo, 1.0f / 65536.0f);
  rate[offset + static_cast<long long>(gy) * w + gx] = -log2f(proba);
}

template <int C>
cudaError_t launch(const float* latents, float* rate, const float* weights,
                   int n_weights, int n_hidden, const PlaneTable& table,
                   int n_blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_weights) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        arm_rate_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  arm_rate_kernel<C><<<n_blocks, dim3(kTileW, kTileH), smem, stream>>>(
      latents, rate, weights, n_weights, n_hidden, table);
  return cudaGetLastError();
}

}  // namespace

extern "C" int arm_rate_max_planes() { return kMaxPlanes; }

// Returns the CUDA error code of the launch (0 on success).
extern "C" int arm_rate_launch(const float* latents, float* rate,
                               const float* weights, int n_weights,
                               int dim_arm, int n_hidden, int n_planes,
                               const int* plane_h, const int* plane_w,
                               const long long* plane_offset, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_weights % 4 != 0 || n_hidden < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PlaneTable table = {};
  table.n_planes = n_planes;
  int n_blocks = 0;
  for (int i = 0; i < n_planes; ++i) {
    table.h[i] = plane_h[i];
    table.w[i] = plane_w[i];
    table.tiles_x[i] = (plane_w[i] + kTileW - 1) / kTileW;
    table.first_tile[i] = n_blocks;
    table.offset[i] = plane_offset[i];
    n_blocks += table.tiles_x[i] * ((plane_h[i] + kTileH - 1) / kTileH);
  }
  if (n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dim_arm) {
    case 8: err = launch<8>(latents, rate, weights, n_weights, n_hidden, table, n_blocks, s); break;
    case 16: err = launch<16>(latents, rate, weights, n_weights, n_hidden, table, n_blocks, s); break;
    case 24: err = launch<24>(latents, rate, weights, n_weights, n_hidden, table, n_blocks, s); break;
    case 32: err = launch<32>(latents, rate, weights, n_weights, n_hidden, table, n_blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
