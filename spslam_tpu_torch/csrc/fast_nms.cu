// Fused FAST-9/16 corner score + two-threshold bonus + 3x3 NMS, one pass.
//
// Replaces the TPU Pallas kernel spslam_tpu/ops/fast_pallas.py
// (fast_nms_scores_pallas, body _fast_nms_kernel): same score definition
// and the same NMS tie rule as the plain PyTorch version
// spslam_tpu_torch/ops/fast.py (nms3x3(fast_score_map(img))), which this
// kernel matches bit for bit away from the image border.  Pixels outside
// the image read 0, as in the Pallas kernel's zero pad; the plain version
// wraps (torch.roll), so the two differ only within 4 px of the border,
// which the 19-px detection border masks.
//
// Bound: bytes.  The function reads the float32 image once and writes the
// float32 score map once, 8 B per pixel: 950,532 px per frame over the
// 8 levels of a 640x480 pyramid is ~7.6 MB, ~2.3 us at 3.35 TB/s.  The
// arithmetic (~200 sub/min/max per pixel) is far below the card's rate.
//
// Design (simple and right first): one thread per output pixel in 32x8
// blocks.  The block stages its input tile plus a 4-px halo (3 for the
// ring, 1 for the NMS neighbours) in shared memory, computes the score of
// the 34x10 region (tile + 1-px NMS halo) in shared memory with the same
// log-doubling circular min as the plain version, then applies NMS.
// Only sub/min/max/compare/add: built without --use_fast_math, the
// results equal the plain PyTorch version exactly.
//
// Making it fast is later work; one candidate is a single launch for all
// 8 pyramid levels instead of one launch per level.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;              // output tile width  (threads in x)
constexpr int TH = 8;               // output tile height (threads in y)
constexpr int HALO = 4;             // 3 (ring) + 1 (NMS)
constexpr int IW = TW + 2 * HALO;   // staged input width
constexpr int IH = TH + 2 * HALO;   // staged input height
constexpr int SW = TW + 2;          // score region width  (1-px NMS halo)
constexpr int SH = TH + 2;          // score region height
constexpr float SCORE_BONUS = 1e6f;

// Ring order of spslam_tpu/ops/fast.py CIRCLE_OFFSETS, as (dx, dy).
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

// max over the 16 window starts of the min over 9 circularly contiguous
// entries, by the same log-doubling as the plain version:
// w2[k] = min(d[k], d[k+1]); w4[k] = min(w2[k], w2[k+2]);
// w8[k] = min(w4[k], w4[k+4]); w9[k] = min(w8[k], d[k+8]).
__device__ __forceinline__ float arc_min_max(const float d[16]) {
    float w2[16], w4[16], w8[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w2[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) w4[k] = fminf(w2[k], w2[(k + 2) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) w8[k] = fminf(w4[k], w4[(k + 4) & 15]);
    float m = fminf(w8[0], d[8]);
#pragma unroll
    for (int k = 1; k < 16; ++k) m = fmaxf(m, fminf(w8[k], d[(k + 8) & 15]));
    return m;
}

__global__ void __launch_bounds__(TW * TH)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, float th_low, float th_high) {
    __shared__ float s_in[IH][IW];
    __shared__ float s_sc[SH][SW];

    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.y * TW + threadIdx.x;
    constexpr int NT = TW * TH;

    // 1. stage the input tile + halo; outside the image reads 0
    for (int i = tid; i < IH * IW; i += NT) {
        const int r = i / IW, c = i % IW;
        const int gy = y0 - HALO + r, gx = x0 - HALO + c;
        s_in[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[gy * W + gx] : 0.0f;
    }
    __syncthreads();

    // 2. score of every pixel in the tile + 1-px halo; score region (r, c)
    //    is image (y0 - 1 + r, x0 - 1 + c), its centre s_in[r + 3][c + 3]
    for (int i = tid; i < SH * SW; i += NT) {
        const int r = i / SW, c = i % SW;
        const float center = s_in[r + 3][c + 3];
        float d[16], nd[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            d[k] = s_in[r + 3 + RING_DY[k]][c + 3 + RING_DX[k]] - center;
            nd[k] = -d[k];
        }
        const float score = fmaxf(arc_min_max(d), arc_min_max(nd));
        const float low = score > th_low ? score : 0.0f;
        s_sc[r][c] = low + (score > th_high ? SCORE_BONUS : 0.0f);
    }
    __syncthreads();

    // 3. 3x3 NMS: strict > against raster-earlier neighbours, >= later
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x >= W || y >= H) return;
    const int r = threadIdx.y + 1, c = threadIdx.x + 1;
    const float best = s_sc[r][c];
    const bool keep =
        best > s_sc[r - 1][c - 1] && best > s_sc[r - 1][c] && best > s_sc[r - 1][c + 1] &&
        best > s_sc[r][c - 1] &&
        best >= s_sc[r][c + 1] &&
        best >= s_sc[r + 1][c - 1] && best >= s_sc[r + 1][c] && best >= s_sc[r + 1][c + 1];
    out[y * W + x] = keep ? best : 0.0f;
}

}  // namespace

// img, out: device pointers to contiguous float32 [H, W]; stream: the
// caller's cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int fast_nms_launch(const float* img, float* out, int H, int W,
                               float th_low, float th_high, cudaStream_t stream) {
    const dim3 block(TW, TH);
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    fast_nms_kernel<<<grid, block, 0, stream>>>(img, out, H, W, th_low, th_high);
    return static_cast<int>(cudaGetLastError());
}
