// Fused eval-mode ARM rate over a pyramid of latent planes, on Hopper's
// tensor cores (sm_90a).
//
// Replaces coolchic_tpu/ops/pallas_arm.py::_kernel (launched there once per
// plane by arm_rate_pallas / arm_rate_pallas_pyramid). For every latent y of
// every plane: gather the dim_arm causal context values of the plane
// zero-padded by 4, run n_hidden residual layers x <- relu(W x + b + x) and
// the 2-wide head (mu, log_scale), then write the Laplace rate
//   -log2(max(CDF(y + 1/2) - CDF(y - 1/2), 2^-16)),
//   CDF(v) = 1/2 - 1/2 sign(v - mu) expm1(-|v - mu| / scale),
//   scale = exp(clamp(log_scale - 4, -4.6, 5)).
// Each plane is read where it lies and the rate written once; the
// [M, dim_arm] context matrix of the plain version never exists. One launch
// covers a batch of images, each with its own ARM: image b's planes, weights
// and rates lie at the tables' addresses plus b times a stride.
//
// What bounds it: per latent, n_hidden * C^2 + 2 C multiply-adds against 8
// bytes of traffic (C = dim_arm), far above the card's balance point, so the
// kernel is bound by operations. Design:
//  * The MLP runs on the tensor cores with mma.sync m16n8k8 in float64
//    (sm_90; the older m8n8k4 shape reaches half the f64 rate). The rate is
//    ill-conditioned (~144 bits per unit of mu where the Laplace scale sits
//    at its 0.01 floor), so the MLP must be at least as accurate as f32.
//    TF32 in the 3xTF32 scheme (x = rna_tf32(x) + rna_tf32(rest), three
//    products) keeps ~22 bits of each operand against f32's 24, and misses
//    the f32 tolerance on latents near 3,000; products of f32 inputs are
//    exact in f64, and the sums are f64 too.
//  * A work item is 64 latents of one row, in halves of two m-tiles of 16
//    (the M of the mma) that share every B fragment read from shared memory.
//    Feature 8j + 2t of a layer's input sits at k position t of k-step j
//    and feature 8j + 2t + 1 at position t + 4 (t = lane % 4); the weight
//    columns are permuted to match when they are staged. Then the
//    accumulator of output tile j is the A fragment of the next layer's
//    k-step j: layers chain in registers with no shuffle. The residual is
//    folded into the weights (W + I, exact in f64) and the bias is the
//    addend of the first mma, so only the ReLU is left between layers. The
//    2-wide head is padded to N = 8 with zero columns; mu and log_scale go
//    through a per-warp shared buffer so that every lane runs the epilogue
//    of one latent. The epilogue is f32, as in the plain version, with
//    y - mu taken in f64.
//  * Persistent blocks (two per SM) stage the weights once, in B-fragment
//    order as f64, read from the per-layer weight / bias tensors through a
//    by-value pointer table; layers past what shared memory holds are read
//    where they lie. After that one barrier the warps are independent: each
//    walks the items with a grid stride and copies the next item's causal
//    halo (4 rows above, 4 columns each side, zero-filled outside the plane)
//    into its own shared buffer with 16-byte cp.async while it computes the
//    current one (two buffers), so a slow warp stalls no other.
//  * Context offsets are compile-time constants per dim_arm; an item finds
//    its plane by binary search in a table the block loads once.
//  * A batch is the grid's second dimension: the blocks of row b stage
//    image b's weights and its plane table (the launch's table moved by b
//    strides) and walk image b's items; each image gets an equal share of
//    the blocks the card holds at once. After the staging nothing knows of
//    the batch, so one image runs as it did before there was one.
// No fast-math: expf, expm1f and log2f stay IEEE-accurate.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kPad = 4;
constexpr int kItemW = 64;  // a work item: 64 latents of one row, four m-tiles
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHaloW = kItemW + 2 * kPad;  // context columns reach dx in [-4, 4]
constexpr int kHaloH = 1 + kPad;           // context rows reach dy in [-4, 0]
constexpr int kHalo = kHaloH * kHaloW;
constexpr int kMaxPlanes = 64;
// Hidden layers: up to 1023, past the 806 of dim_arm 8 whose f32 weights
// fill 227 KB, the most that a kernel staging them all in shared memory takes.
constexpr int kMaxHidden = 1023;
constexpr int kMaxSmem = 227 * 1024;  // dynamic + static shared memory of a block

// (dy * kHaloW + dx) of context feature k in the 9 x 9 causal window
// (index // 9, index % 9 of models/arm.py's NON_ZERO_PIXEL_CTX_INDEX).
__host__ __device__ constexpr int ctx_offset(int C, int k) {
  constexpr int tab[4][32] = {
      {13, 22, 30, 31, 32, 37, 38, 39},
      {13, 14, 20, 21, 22, 23, 24, 28, 29, 30, 31, 32, 33, 37, 38, 39},
      {4, 11, 12, 13, 14, 15, 19, 20, 21, 22, 23, 24, 25, 28, 29, 30, 31,
       32, 33, 34, 36, 37, 38, 39},
      {2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 16, 19, 20, 21, 22, 23, 24, 25,
       26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39},
  };
  return tab[C / 8 - 1][k] / 9 * kHaloW + tab[C / 8 - 1][k] % 9;
}

// Plane i of image b is ptr[i] + b * stride[i] and its rates start at
// rate + b * rate_stride + offset[i]: one table serves the whole batch.
struct PlaneTable {
  const float* ptr[kMaxPlanes];
  long long offset[kMaxPlanes];  // into an image's flat rate
  long long stride[kMaxPlanes];  // floats from an image's plane to the next image's
  long long rate_stride;         // floats from an image's rates to the next image's
  int h[kMaxPlanes];
  int w[kMaxPlanes];
  int first_item[kMaxPlanes];
  int n_planes;
  int n_items;   // of one image
  int n_images;
};

// Hidden layer l: w[l] is [C, C] (out-major), b[l] is [C]; the head is
// w[n_hidden] [2, C], b[n_hidden] [2]. In a batch each is the first image's
// and the images follow one another densely ([B, C, C], [B, C], [B, 2, C],
// [B, 2]), so their strides are the shapes'. 16 KB of kernel parameters: sm_90
// takes up to 32 KB (CUDA 12.1 on), and on an H100 a table of 8 entries
// made the kernel no faster.
struct LayerTable {
  const float* w[kMaxHidden + 1];
  const float* b[kMaxHidden + 1];
};

// The planes of the image a block works on: the table's entries moved to
// that image.
struct SmemPlanes {
  const float* ptr[kMaxPlanes];
  long long offset[kMaxPlanes];  // into the whole batch's rates
  int h[kMaxPlanes];
  int w[kMaxPlanes];
  int first_item[kMaxPlanes];
};

// d += a b on the tensor cores in float64 (m16n8k8, sm_90): A is 16 x 8,
// [0] (g, t), [1] (g + 8, t), [2] (g, t + 4), [3] (g + 8, t + 4); B is 8 x 8,
// x (t, g), y (t + 4, g); D is 16 x 8, [0] (g, 2t), [1] (g, 2t + 1), [2]
// (g + 8, 2t), [3] (g + 8, 2t + 1); g = lane / 4, t = lane % 4. Products of
// f32 inputs are exact in f64.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], double2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b.x), "d"(b.y));
}

// d = a b + c, c = (c.x, c.y) in both rows: a bias on columns 2t, 2t + 1.
__device__ __forceinline__ void dmma_bias(double (&d)[4], const double (&a)[4], double2 b,
                                          double2 c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %10, %11};"
      : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b.x), "d"(b.y), "d"(c.x), "d"(c.y));
}

// Copies of 4 or 16 bytes into shared memory; invalid ones write zeros.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// max(v, 0) by the sign bit (an f64 max costs more on this card).
__device__ __forceinline__ double relu(double v) {
  return __double2hiint(v) < 0 ? 0.0 : v;
}

__device__ __forceinline__ float sign_f(float v) {
  return static_cast<float>((v > 0.f) - (v < 0.f));
}

__device__ __forceinline__ float laplace_cdf(float shifted, float scale) {
  return 0.5f - 0.5f * sign_f(shifted) * expm1f(-fabsf(shifted) / scale);
}

struct Item {
  int plane, row, col0;
};

__device__ __forceinline__ Item find_item(const SmemPlanes& p, int n_planes, int item) {
  int lo = 0, hi = n_planes - 1;  // last plane whose first item is <= item
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.first_item[mid] <= item) lo = mid; else hi = mid - 1;
  }
  const int local = item - p.first_item[lo];
  const int items_x = (p.w[lo] + kItemW - 1) / kItemW;
  return {lo, local / items_x, (local % items_x) * kItemW};
}

// One hidden layer on kM m-tiles, x <- relu(b + x W'^T) with W' = W + I:
// fetch_b(j, n) gives the B fragment of k-step j and n-tile n, fetch_bias(n)
// the bias of columns 8n + 2t and 8n + 2t + 1, the addend of k-step 0.
template <int C, int kM, typename FetchB, typename FetchBias>
__device__ __forceinline__ void hidden_layer(double (&x)[kM][C / 8][4], FetchB fetch_b,
                                             FetchBias fetch_bias) {
  constexpr int KS = C / 8;
  double acc[kM][KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const double2 b = fetch_b(j, n);
      if (j == 0) {
        const double2 bn = fetch_bias(n);
#pragma unroll
        for (int m = 0; m < kM; ++m) dmma_bias(acc[m][n], x[m][j], b, bn);
      } else {
#pragma unroll
        for (int m = 0; m < kM; ++m) dmma(acc[m][n], x[m][j], b);
      }
    }
  }
  // Output tile n: [0] (g, 8n + 2t), [1] (g, 8n + 2t + 1), [2] (g + 8,
  // 8n + 2t), [3] (g + 8, 8n + 2t + 1): the next layer's k-step n.
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      x[m][n][0] = relu(acc[m][n][0]);
      x[m][n][2] = relu(acc[m][n][1]);
      x[m][n][1] = relu(acc[m][n][2]);
      x[m][n][3] = relu(acc[m][n][3]);
    }
  }
}

// Dynamic shared memory (doubles): n_smem hidden layers of KS * KS * 32 B
// fragments (2 doubles each) and their biases [n_smem][C]; the head's KS * 32
// fragments and its bias (padded to 2 doubles).
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
arm_rate_kernel(float* __restrict__ rate, PlaneTable table, LayerTable layers, int n_hidden,
                int n_smem) {
  constexpr int KS = C / 8;  // k-steps of a layer, and n-tiles of its output
  // m-tiles computed together, sharing each B fragment read from shared
  // memory; at C = 32 two would not fit the registers of two blocks per SM.
  constexpr int kM = C <= 24 ? 2 : 1;
  extern __shared__ double2 smem[];
  __shared__ __align__(16) float halo[kWarps][2][kHalo];
  __shared__ double head_out[kWarps][2][16][2];  // (mu, log_scale) of an item
  __shared__ SmemPlanes planes;

  double2* frag = smem;
  double* bias = reinterpret_cast<double*>(frag + n_smem * KS * KS * 32);
  double2* head = reinterpret_cast<double2*>(bias + n_smem * C);
  double* head_bias = reinterpret_cast<double*>(head + KS * 32);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Everything a block reads once, in one loop so that the loads overlap:
  // the plane table, moved to this block's image; fragment (l, j, n, lane)
  // of each staged layer, W'[8n + g][8j + 2t] and W'[8n + g][8j + 2t + 1]
  // (k positions t and t + 4 of k-step j) with W' = W + I, the residual x
  // folded into the product (exactly, in f64); the biases; the head's
  // fragments, N padded from 2 to 8 with zeros; the head's bias.
  {
    const long long img = blockIdx.y;
    const int n_frag = n_smem * KS * KS * 32, n_bias = n_smem * C, n_head = KS * 32;
    const int n_stage = table.n_planes + n_frag + n_bias + n_head + 2;
    for (int i = tid; i < n_stage; i += kThreads) {
      int k = i;
      if (k < table.n_planes) {
        planes.ptr[k] = table.ptr[k] + img * table.stride[k];
        planes.offset[k] = table.offset[k] + img * table.rate_stride;
        planes.h[k] = table.h[k];
        planes.w[k] = table.w[k];
        planes.first_item[k] = table.first_item[k];
      } else if ((k -= table.n_planes) < n_frag) {
        const int ln = k & 31, rest = k >> 5;
        const int n = rest % KS, j = (rest / KS) % KS, l = rest / (KS * KS);
        const int row = 8 * n + (ln >> 2), col = 8 * j + 2 * (ln & 3);
        const float* w = layers.w[l] + img * (C * C) + row * C + col;
        frag[k] = make_double2(w[0] + (row == col ? 1.0 : 0.0),
                               w[1] + (row == col + 1 ? 1.0 : 0.0));
      } else if ((k -= n_frag) < n_bias) {
        bias[k] = layers.b[k / C][img * C + k % C];
      } else if ((k -= n_bias) < n_head) {
        const int ln = k & 31, j = k >> 5, n = ln >> 2;
        const float* w = layers.w[n_hidden] + img * (2 * C) + n * C + 8 * j + 2 * (ln & 3);
        head[k] = n < 2 ? make_double2(w[0], w[1]) : make_double2(0.0, 0.0);
      } else {
        head_bias[k - n_head] = layers.b[n_hidden][img * 2 + k - n_head];
      }
    }
  }

  // This lane's context offsets: features 8j + 2t and 8j + 2t + 1.
  int off_e[KS], off_o[KS];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      if (t == tt) {
        off_e[j] = ctx_offset(C, 8 * j + 2 * tt);
        off_o[j] = ctx_offset(C, 8 * j + 2 * tt + 1);
      }
    }
  }
  __syncthreads();  // the last block-wide barrier: warps go their own way

  const int n_planes = table.n_planes;
  float(*hb)[kHalo] = halo[warp];
  double(*ho)[16][2] = head_out[warp];
  // Copy an item's halo, 4 floats at a time: 16-byte copies where the 4
  // lie in the plane and are aligned, zeros where they all lie outside,
  // 4-byte copies with zero fill at the plane's edges.
  auto prefetch = [&](const Item& it, int buf) {
    const float* src = planes.ptr[it.plane];
    const int h = planes.h[it.plane], w = planes.w[it.plane];
#pragma unroll
    for (int i = lane; i < kHalo / 4; i += 32) {
      const int r = i / (kHaloW / 4), q = i % (kHaloW / 4);
      const int gy = it.row - kPad + r, gx = it.col0 - kPad + 4 * q;
      float* dst = &hb[buf][r * kHaloW + 4 * q];
      const bool row_in = gy >= 0 && gy < h;
      const float* p = src + static_cast<long long>(row_in ? gy : 0) * w + gx;
      if (row_in && gx >= 0 && gx + 3 < w && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        cp_async16(dst, p, true);
      } else if (!row_in || gx + 3 < 0 || gx >= w) {  // any 16-byte aligned source
        cp_async16(dst, reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(src) & ~15ull),
                   false);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = gx + e >= 0 && gx + e < w;
          cp_async4(dst + e, valid ? p + e : src, valid);
        }
      }
    }
  };

  const int stride = gridDim.x * kWarps;
  int buf = 0;
  int item = blockIdx.x * kWarps + warp;
  Item next = item < table.n_items ? find_item(planes, n_planes, item) : Item{0, 0, 0};
  if (item < table.n_items) prefetch(next, 0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (; item < table.n_items; item += stride) {
    const Item it = next;
    if (item + stride < table.n_items) {
      next = find_item(planes, n_planes, item + stride);
      prefetch(next, buf ^ 1);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();

    const int w = planes.w[it.plane];
    const float* hs = hb[buf];

    // The item's columns in 32-latent halves, each two m-tiles of 16 (kM at
    // a time): m-tile m of half v is columns 32v + 16m .. 32v + 16m + 15 of
    // the item; row g of the mma its column 32v + 16m + g, row g + 8 its
    // column 32v + 16m + g + 8.
#pragma unroll 1
    for (int v = 0; v < kItemW / 32; ++v) {
#pragma unroll 1
      for (int m0 = 0; m0 < 2; m0 += kM) {
        // A fragments of k-step j: [0] row g, [1] row g + 8 at feature
        // 8j + 2t; [2], [3] the same rows at feature 8j + 2t + 1.
        double x[kM][KS][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const int base = 32 * v + 16 * (m0 + m) + g;
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            x[m][j][0] = hs[base + off_e[j]];
            x[m][j][1] = hs[base + 8 + off_e[j]];
            x[m][j][2] = hs[base + off_o[j]];
            x[m][j][3] = hs[base + 8 + off_o[j]];
          }
        }

#pragma unroll 1
        for (int l = 0; l < n_hidden; ++l) {
          if (l < n_smem) {
            const double2* fl = frag + l * KS * KS * 32 + lane;
            const double* bl = bias + l * C + 2 * t;
            hidden_layer<C, kM>(
                x, [&](int j, int n) { return fl[(j * KS + n) * 32]; },
                [&](int n) { return *reinterpret_cast<const double2*>(bl + 8 * n); });
          } else {  // past shared memory: read the layer where it lies
            const long long img = blockIdx.y;
            const float* wl = layers.w[l] + img * (C * C) + g * C + 2 * t;
            const float* bg = layers.b[l] + img * C + 2 * t;
            hidden_layer<C, kM>(
                x,
                [&](int j, int n) {
                  const int row = 8 * n + g, col = 8 * j + 2 * t;
                  return make_double2(
                      __ldg(wl + 8 * n * C + 8 * j) + (row == col ? 1.0 : 0.0),
                      __ldg(wl + 8 * n * C + 8 * j + 1) + (row == col + 1 ? 1.0 : 0.0));
                },
                [&](int n) { return make_double2(__ldg(bg + 8 * n), __ldg(bg + 8 * n + 1)); });
          }
        }

#pragma unroll
        for (int m = 0; m < kM; ++m) {
          double out[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
          for (int j = 0; j < KS; ++j) dmma(out, x[m][j], head[j * 32 + lane]);
          if (t == 0) {  // columns 0 and 1 of the head's output: mu, log_scale
            ho[m0 + m][g][0] = out[0];
            ho[m0 + m][g][1] = out[1];
            ho[m0 + m][g + 8][0] = out[2];
            ho[m0 + m][g + 8][1] = out[3];
          }
        }
      }
      __syncwarp();

      // Every lane runs the epilogue of one latent: m-tile t / 2, row
      // g + 8 (t % 2).
      const int cl = 32 * v + 16 * (t >> 1) + 8 * (t & 1) + g;  // column in the item
      if (it.col0 + cl < w) {
        const double mu = ho[t >> 1][g + 8 * (t & 1)][0] + head_bias[0];
        const float ls = static_cast<float>(ho[t >> 1][g + 8 * (t & 1)][1] + head_bias[1]);
        const float scale = expf(fminf(fmaxf(ls - 4.f, -4.6f), 5.f));
        const float y0 = hs[kPad * kHaloW + kPad + cl];
        const float cdf_hi = laplace_cdf(static_cast<float>(y0 + 0.5 - mu), scale);
        const float cdf_lo = laplace_cdf(static_cast<float>(y0 - 0.5 - mu), scale);
        const float proba = fmaxf(cdf_hi - cdf_lo, 1.0f / 65536.0f);
        rate[planes.offset[it.plane] + static_cast<long long>(it.row) * w + it.col0 + cl] =
            -log2f(proba);
      }
      __syncwarp();  // head_out is rewritten next
    }
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int C>
constexpr size_t layer_bytes() {
  return sizeof(double) * (C * C + C);  // B fragments and bias
}

template <int C>
constexpr size_t fixed_bytes() {
  return sizeof(double) * (C * 8 + 2);  // the head's fragments and bias
}

constexpr int kMaxDevices = 64;

// What a launch on one device needs to know, found once per device: the
// kernel's static shared memory (after raising its dynamic ceiling there),
// the SM count, and the occupancy of the last dynamic size asked for.
struct DeviceInfo {
  size_t static_smem = 0;
  int n_sm = 0;
  int occ_smem = -1, occ_blocks = 0;
};

template <int C>
cudaError_t launch(float* rate, const PlaneTable& table, const LayerTable& layers,
                   int n_hidden, cudaStream_t stream) {
  static std::mutex mutex;  // callers may launch from several host threads
  static DeviceInfo infos[kMaxDevices];
  cudaError_t err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n_smem, smem, max_blocks;
  {
    std::lock_guard<std::mutex> lock(mutex);
    DeviceInfo& info = infos[dev];
    if (info.n_sm == 0) {
      cudaFuncAttributes attr;
      if ((err = cudaFuncGetAttributes(&attr, arm_rate_kernel<C>)) != cudaSuccess) return err;
      err = cudaFuncSetAttribute(arm_rate_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem - attr.sharedSizeBytes));
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&info.n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      info.static_smem = attr.sharedSizeBytes;
    }
    const size_t fit = (kMaxSmem - info.static_smem - fixed_bytes<C>()) / layer_bytes<C>();
    n_smem = n_hidden < static_cast<int>(fit) ? n_hidden : static_cast<int>(fit);
    smem = static_cast<int>(n_smem * layer_bytes<C>() + fixed_bytes<C>());
    if (smem != info.occ_smem) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.occ_blocks, arm_rate_kernel<C>,
                                                          kThreads, smem);
      if (err != cudaSuccess) return err;
      if (info.occ_blocks < 1) return cudaErrorInvalidConfiguration;
      info.occ_smem = smem;
    }
    max_blocks = info.occ_blocks * info.n_sm;
  }
  // Blocks of one image: as many as its items ask for, within an equal share
  // of the blocks the card holds at once (past that many images, one each:
  // the rows then take their turn on the card).
  const int wanted = (table.n_items + kWarps - 1) / kWarps;
  int per_image = max_blocks / table.n_images;
  per_image = per_image < 1 ? 1 : (per_image > wanted ? wanted : per_image);
  arm_rate_kernel<C><<<dim3(per_image, table.n_images), kThreads, smem, stream>>>(
      rate, table, layers, n_hidden, n_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" void arm_rate_limits(int* max_planes, int* max_hidden) {
  *max_planes = kMaxPlanes;
  *max_hidden = kMaxHidden;
}

// Rates of n_planes planes (at most kMaxPlanes) of each of n_images images
// in one launch. plane_ptr[i] is plane i of the first image ([h, w],
// row-major f32), the same plane of image b lies plane_stride[i] * b floats
// further, and its rate goes to rate + b * rate_stride + plane_offset[i].
// layer_ptr holds weight, bias of each hidden layer, then of the head, each
// the first image's of a dense [n_images, ...] tensor. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int arm_rate_launch(float* rate, const float* const* plane_ptr, const int* plane_h,
                               const int* plane_w, const long long* plane_offset,
                               const long long* plane_stride, int n_planes,
                               const float* const* layer_ptr, int n_hidden, int dim_arm,
                               int n_images, long long rate_stride, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_hidden < 0 || n_hidden > kMaxHidden ||
      n_images < 1 || n_images > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PlaneTable table = {};
  table.n_planes = n_planes;
  table.n_images = n_images;
  table.rate_stride = rate_stride;
  int n_items = 0;
  for (int i = 0; i < n_planes; ++i) {
    table.ptr[i] = plane_ptr[i];
    table.offset[i] = plane_offset[i];
    table.stride[i] = plane_stride[i];
    table.h[i] = plane_h[i];
    table.w[i] = plane_w[i];
    table.first_item[i] = n_items;
    n_items += ((plane_w[i] + kItemW - 1) / kItemW) * plane_h[i];
  }
  table.n_items = n_items;
  if (n_items == 0) return 0;
  LayerTable layers = {};
  for (int l = 0; l <= n_hidden; ++l) {
    layers.w[l] = layer_ptr[2 * l];
    layers.b[l] = layer_ptr[2 * l + 1];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dim_arm) {
    case 8: err = launch<8>(rate, table, layers, n_hidden, s); break;
    case 16: err = launch<16>(rate, table, layers, n_hidden, s); break;
    case 24: err = launch<24>(rate, table, layers, n_hidden, s); break;
    case 32: err = launch<32>(rate, table, layers, n_hidden, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
