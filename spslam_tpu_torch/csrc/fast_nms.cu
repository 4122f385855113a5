// Fused FAST-9/16 corner score + two-threshold bonus + 3x3 NMS + detection
// border, for every level of an image pyramid in ONE launch.
//
// Replaces the TPU Pallas kernel spslam_tpu/ops/fast_pallas.py
// (fast_nms_scores_pallas, body _fast_nms_kernel) and the border mask that
// detect_levels applies to its result.  The plain PyTorch version is
// fast_nms_scores_levels_plain in spslam_tpu_torch/ops/fast_cuda.py
// (nms3x3(fast_score_map(img)) per level, then the mask); with border >= 4
// kernel and plain version agree bit for bit on the whole image, with
// border 0 they agree away from the outer 4 px (pixels outside the image
// read 0 here, as in the Pallas kernel's zero pad; the plain version wraps).
//
// Bound: operations, not bytes, whenever a fair share of the pixels needs
// the ring.  The function moves 8 B per pixel (float32 in, float32 out; the
// levels were just written by the pyramid and sit in L2).  A pixel that
// needs the full ring costs about 130 lane operations, some 95 of them
// min/max/compare/select, which an SM executes at half its float32 add rate
// (64 lanes a clock; the loop kernel at the end of this file measures it).
// fast_nms_work() in ops/fast_cuda.py counts bytes and operations; the
// smoke script prints the larger of the two times, and PERF.md has the
// card's numbers.  On top of either bound a launch costs a few
// microseconds, which at this size is as much as the work.
//
// What the design does about it:
//  * fewer operations per score.  Only scores above th_low >= 0 survive, so
//    the bright and the dark differences may each be clamped at 0 without
//    changing a bit of the result.  Non-negative floats order like their
//    bit patterns as int32, so the 9-arc minimum and the maximum over the
//    16 arcs run on Hopper's three-input integer min/max (DPX:
//    __vimin3_s32_relu, __vimin3_s32, __vimax3_s32), the clamp folded into
//    the first minimum: 40 operations per polarity against 79 with
//    two-input fminf/fmaxf, and no negations (dark = centre - ring, the
//    exact negation of ring - centre).
//  * the ring only where it can matter, with all lanes busy.  Any 9-arc
//    holds two neighbouring compass pixels, so a 6-operation test on the
//    four compass differences rejects most pixels exactly
//    (compass_candidate).  The pixels that pass queue up per warp until
//    they fill its 32 lanes, and only then does the warp run the ring: no
//    lane idles beside a rejected neighbour.
//  * enough warps to hide latency.  The work of a frame is small (fewer
//    than a million pixels over 528 warp schedulers), so a warp that walks
//    a tall tile alone leaves its scheduler stalled on every dependent
//    instruction.  A tile is 30x30 outputs (32x32 scores: the 32 lanes of a
//    warp are the score columns, halo scores cost (32/30)^2 = 1.14 of the
//    outputs) shared by a block of 4 warps that take every 4th score row;
//    the scores meet in shared memory for NMS.  940 blocks for the 8 levels
//    of 640x480: 7 per SM, 7 warps per scheduler.
//  * one launch per frame.  The grid is flat over the tiles of all levels,
//    the level table travels by value as a kernel argument, nothing is
//    allocated, copied or synchronised here: the launch can be captured in
//    a CUDA graph.
//  * the detection border inside the kernel.  Tiles are laid over the
//    interior [b, H-b) x [b, W-b) only; scores are computed on the interior
//    plus the 1-px ring NMS reads, and the tiles on the rim also store the
//    zeros of the frame.  No mask kernels follow the launch.
//  * ring offsets are immediates: every ring load is a shared-memory load at
//    a compile-time offset from the pixel's centre pointer.
//  * loads.  A level's row pitch is 4*W bytes (2,132 at level 1), not a
//    multiple of 16, so TMA tensor maps and 16-byte cp.async do not apply
//    to the levels as the pyramid makes them.  Coalesced 4-byte loads, 11
//    in flight per thread, are enough for a kernel whose input is in L2
//    and whose time goes to operations and launch.  Do not pad the pyramid
//    for the sake of wider loads.
//
// Only sub/min/max/compare/add on float32 values (no multiply, so nothing
// to contract); built without --use_fast_math.

#include <cuda_runtime.h>

// The level table of one launch, passed by value (C linkage: the caller
// fills it through ctypes).
constexpr int MAX_LEVELS = 16;

struct Level {
    const float* img;   // [H, W] float32, contiguous
    float* out;         // [H, W] float32, contiguous
    int H, W;
    int tile0;          // index of the level's first tile in the flat grid
    int tiles_x;        // tiles per row of tiles
};

struct LevelTable {
    Level lv[MAX_LEVELS];
};

namespace {

constexpr int WARPS = 4;       // warps of the block that shares a tile
constexpr int NT = 32 * WARPS;
constexpr int TILE = 30;       // a tile is TILE x TILE outputs (ops/fast_cuda.py TILE)
constexpr int TW = TILE;       // output columns per tile
constexpr int TH = TILE;       // output rows per tile
constexpr int SW = TW + 2;     // score columns: one per lane
constexpr int SH = TH + 2;     // score rows
constexpr int IN_W = SW + 6;   // staged columns (3-px ring each side)
constexpr int IN_H = SH + 6;   // staged rows
constexpr float SCORE_BONUS = 1e6f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(SW == 32, "a warp's lanes are the tile's score columns");

// max over the 16 arc starts of the min over 9 circularly contiguous
// entries, each entry clamped at 0 first.  d holds float32 bit patterns:
// a negative float is a negative int32, so the _relu of the first minimum
// is the clamp; from there on all values are non-negative floats, which
// order like their bits.
__device__ __forceinline__ int arc9_clamped(const int (&d)[16]) {
    int w3[16], w9[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w3[k] = __vimin3_s32_relu(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) w9[k] = __vimin3_s32(w3[k], w3[(k + 3) & 15], w3[(k + 6) & 15]);
    const int m0 = __vimax3_s32(w9[0], w9[1], w9[2]);
    const int m1 = __vimax3_s32(w9[3], w9[4], w9[5]);
    const int m2 = __vimax3_s32(w9[6], w9[7], w9[8]);
    const int m3 = __vimax3_s32(w9[9], w9[10], w9[11]);
    const int m4 = __vimax3_s32(w9[12], w9[13], w9[14]);
    return max(__vimax3_s32(m0, m1, m2), __vimax3_s32(m3, m4, w9[15]));
}

// Exact early reject.  Any 9-arc of the ring holds two neighbouring compass
// pixels (ring positions 0, 4, 8, 12), one of north/south and one of
// east/west, so a score above th needs max(n, s) and max(e, w) above th
// (bright) or min(n, s) and min(e, w) below -th (dark).  p[0] is the centre.
__device__ __forceinline__ bool compass_candidate(const float* p, float th) {
    const float c = p[0];
    const float n = p[3 * IN_W] - c, e = p[3] - c, s = p[-3 * IN_W] - c, w = p[-3] - c;
    const float hi = fminf(fmaxf(n, s), fmaxf(e, w));
    const float lo = fmaxf(fminf(n, s), fminf(e, w));
    return hi > th || lo < -th;
}

// Thresholded FAST score of the pixel whose staged value is p[0]; the ring
// is read at immediate offsets from p.
__device__ __forceinline__ float ring_score(const float* p, float th_low, float th_high) {
    const float c = p[0];
    // ring order of ops/fast.py CIRCLE_OFFSETS, (dx, dy)
    int d[16], g[16];
#define RING(k, dx, dy)                         \
    {                                           \
        const float v = p[(dy) * IN_W + (dx)];  \
        d[k] = __float_as_int(v - c);           \
        g[k] = __float_as_int(c - v);           \
    }
    RING(0, 0, 3) RING(1, 1, 3) RING(2, 2, 2) RING(3, 3, 1)
    RING(4, 3, 0) RING(5, 3, -1) RING(6, 2, -2) RING(7, 1, -3)
    RING(8, 0, -3) RING(9, -1, -3) RING(10, -2, -2) RING(11, -3, -1)
    RING(12, -3, 0) RING(13, -3, 1) RING(14, -2, 2) RING(15, -1, 3)
#undef RING
    const float score = __int_as_float(max(arc9_clamped(d), arc9_clamped(g)));
    const float low = score > th_low ? score : 0.0f;
    return low + (score > th_high ? SCORE_BONUS : 0.0f);
}

__global__ void __launch_bounds__(NT)
fast_nms_levels_kernel(const __grid_constant__ LevelTable tab, int n_levels, float th_low,
                       float th_high, int border) {
    __shared__ float s_in[IN_H * IN_W];   // image rows y0 - 4 .., columns x0 - 4 ..
    __shared__ float s_sc[SH * SW];       // score rows y0 - 1 .., columns x0 - 1 ..
    __shared__ int s_q[WARPS][64];        // per warp: queued candidates

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int t = blockIdx.x;

    int l = 0;
    for (int i = 1; i < n_levels; ++i)
        if (t >= tab.lv[i].tile0) l = i;
    const float* __restrict__ img = tab.lv[l].img;
    float* __restrict__ out = tab.lv[l].out;
    const int H = tab.lv[l].H, W = tab.lv[l].W;
    const int tiles_x = tab.lv[l].tiles_x;
    const int ti = t - tab.lv[l].tile0;
    const int ty = ti / tiles_x, tx = ti - ty * tiles_x;

    // interior [border, iy1) x [border, ix1); this tile's outputs [y0, cy1) x [x0, cx1)
    const int ix1 = W - border, iy1 = H - border;
    const int x0 = border + tx * TW, y0 = border + ty * TH;
    const int cx1 = min(x0 + TW, ix1), cy1 = min(y0 + TH, iy1);
    // the rectangle this tile stores: its outputs, and on the rim the frame
    const int ox0 = tx == 0 ? 0 : x0, ox1 = x0 + TW >= ix1 ? W : x0 + TW;
    const int oy0 = ty == 0 ? 0 : y0, oy1 = y0 + TH >= iy1 ? H : y0 + TH;
    const bool has_outputs = cx1 > x0 && cy1 > y0;
    // score rows needed: image rows y0 - 1 .. cy1, local r = 0 .. nr - 1
    const int nr = has_outputs ? cy1 - y0 + 2 : 0;

    // 1. stage the image rows the needed scores read; 0 outside the image
    for (int i = threadIdx.x; i < (nr + 6) * IN_W && nr > 0; i += NT) {
        const int r = i / IN_W, col = i - r * IN_W;
        const int gy = y0 - 4 + r, gx = x0 - 4 + col;
        s_in[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[(size_t)gy * W + gx] : 0.0f;
    }

    // 2. a tile on the rim also stores the zeros of the frame
    if (ox0 < x0 || oy0 < y0 || ox1 > cx1 || oy1 > cy1) {
        for (int y = oy0 + warp; y < oy1; y += WARPS)
            for (int x = ox0 + lane; x < ox1; x += 32)
                if (y < y0 || y >= cy1 || x < x0 || x >= cx1) out[(size_t)y * W + x] = 0.0f;
    }
    if (nr == 0) return;
    __syncthreads();

    // 3. scores: a warp takes every WARPS-th score row; lane j is image
    //    column x0 - 1 + j, score row r is image row y0 - 1 + r, its centre
    //    staged at row r + 3, column j + 3.  A pixel that fails the compass
    //    test scores 0; one that passes queues up (as its index in the score
    //    tile) until the queue fills the warp's 32 lanes, so the ring runs
    //    on candidates only, with every lane busy but in the last batch.
    //    (One queue per warp: a queue shared by the block, with a barrier
    //    before the ring, packs the batches better and measured slower.)
    const float th_reject = fminf(th_low, th_high);
    const float* centre0 = s_in + 3 * IN_W + 3;   // staged centre of score index 0
    int* q = s_q[warp];
    int qn = 0;
    const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll 1
    for (int r = warp; r < nr; r += WARPS) {
        const int idx = r * SW + lane;
        const bool cand = compass_candidate(centre0 + r * IN_W + lane, th_reject);
        const unsigned m = __ballot_sync(FULL, cand);
        if (cand) q[qn + __popc(m & lanes_below)] = idx;
        else s_sc[idx] = 0.0f;
        qn += __popc(m);
        if (qn >= 32) {
            __syncwarp();
            const int i = q[lane];
            const int rest = lane + 32 < qn ? q[lane + 32] : 0;
            s_sc[i] = ring_score(centre0 + (i >> 5) * IN_W + (i & 31), th_low, th_high);
            __syncwarp();
            qn -= 32;
            if (lane < qn) q[lane] = rest;
        }
    }
    __syncwarp();
    if (lane < qn) {
        const int i = q[lane];
        s_sc[i] = ring_score(centre0 + (i >> 5) * IN_W + (i & 31), th_low, th_high);
    }
    __syncthreads();

    // 4. 3x3 NMS of output row y0 + ro (score row ro + 1): strict > against
    //    the raster-earlier neighbours (row above, left), >= against the later
    const int x = x0 - 1 + lane;
    if (lane >= 1 && lane <= TW && x < cx1) {
        for (int ro = warp; ro < nr - 2; ro += WARPS) {
            const float* c = s_sc + (ro + 1) * SW + lane;
            const float best = c[0];
            const bool keep =
                best > c[-SW - 1] && best > c[-SW] && best > c[-SW + 1] && best > c[-1] &&
                best >= c[1] && best >= c[SW - 1] && best >= c[SW] && best >= c[SW + 1];
            out[(size_t)(y0 + ro) * W + x] = keep ? best : 0.0f;
        }
    }
}

// Register-only loops that measure the rate at which the card executes one
// kind of operation; called by the smoke script alone, for the kernel's bound.
constexpr int RATE_THREADS = 256;
constexpr int RATE_UNROLL = 16;

template <int KIND>
__global__ void __launch_bounds__(RATE_THREADS)
rate_kernel(const float* __restrict__ seed, float* __restrict__ out, int iters) {
    float x[8];
    int y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        x[i] = seed[i] + static_cast<float>(threadIdx.x);
        y[i] = __float_as_int(x[i]);
    }
    for (int it = 0; it < iters; it += RATE_UNROLL) {
#pragma unroll
        for (int u = 0; u < RATE_UNROLL; ++u) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (KIND == 0) {          // float32 add
                    x[i] = x[i] + x[(i + 1) & 7];
                } else if (KIND == 1) {   // float32 min, max
                    x[i] = fminf(x[i], x[(i + 1) & 7]);
                    x[i] = fmaxf(x[i], x[(i + 3) & 7]);
                } else {                  // three-input int32 min, max
                    y[i] = __vimin3_s32_relu(y[i], y[(i + 1) & 7], y[(i + 2) & 7]);
                    y[i] = __vimax3_s32(y[i], y[(i + 3) & 7], y[(i + 5) & 7]);
                }
            }
        }
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += x[i] + __int_as_float(y[i]);
    out[blockIdx.x * RATE_THREADS + threadIdx.x] = acc;
}

}  // namespace

// Side of a tile in outputs; the caller lays its level table out with it.
extern "C" int fast_nms_tile() { return TILE; }

// One launch over the n_tiles tiles of all levels of `tab` (largest level
// first, tile0 ascending) on `stream`.  Nothing is allocated, copied or
// synchronised.  Returns the cudaError_t of the launch.
extern "C" int fast_nms_levels_launch(LevelTable tab, int n_levels, int n_tiles, float th_low,
                                      float th_high, int border, cudaStream_t stream) {
    fast_nms_levels_kernel<<<n_tiles, NT, 0, stream>>>(tab, n_levels, th_low, th_high, border);
    return static_cast<int>(cudaGetLastError());
}

// Lane operations one thread of the rate loop does per iteration.
extern "C" int fast_nms_rate_ops(int kind) { return kind == 0 ? 8 : 16; }

// seed: 8 floats; out: blocks * 256 floats; iters: a multiple of 16.
extern "C" int fast_nms_rate_launch(int kind, const float* seed, float* out, int iters,
                                    int blocks, cudaStream_t stream) {
    if (kind == 0) rate_kernel<0><<<blocks, RATE_THREADS, 0, stream>>>(seed, out, iters);
    else if (kind == 1) rate_kernel<1><<<blocks, RATE_THREADS, 0, stream>>>(seed, out, iters);
    else rate_kernel<2><<<blocks, RATE_THREADS, 0, stream>>>(seed, out, iters);
    return static_cast<int>(cudaGetLastError());
}
