// Fused 3x3 convolution (stride 1, pad 1, NHWC) with BatchNorm, written
// for Hopper (sm_90a): forward, dx and dw.
//
// Replaces the four Pallas TPU kernels of
// incubator_mxnet_tpu/ops/fused_conv.py:
//
//   forward  `_fwd_kernel` (:139), launched by `_fwd_impl` (:350):
//       xn = [relu(x*scale + bias)]              float32, rounded to T
//       y[r, o] = sum_t sum_c valid_t(r) * xn[r + off_t, c] * W[t, c, o]
//       s1 = sum_M y,  s2 = sum_M y^2            float32, from y rounded
//   dx       `_bwd_dx_kernel` (:217), launched by `_bwd_impl` (:399), and
//            `_bwd_dx_kernel_nb` (:180), its split over C_out (:426):
//       dyt = dy + ds1 + 2*y*ds2                 float32, rounded to T
//       dxn[r, c] = sum_t sum_o valid_t(r - off_t) * dyt[r - off_t, o]
//                   * W[t, c, o]
//       with the prologue: z = x*scale + bias, dz = dxn * [z > 0],
//       dx = dz*scale, dscale = sum_M dz*x, dbias = sum_M dz;
//       without it dx = dxn
//   dw       `_bwd_dw_kernel` (:244), launched by `_bwd_impl` (:445):
//       dw[t, c, o] = sum_r valid_t(r) * xn[r + off_t, c] * dyt[r, o]
//
// Rows r run over the flattened N*H*W pixels, x is (M, C), W the HWIO
// kernel (3, 3, C, C_out) read as (9, C, C_out), and tap t = 3*(dh+1) +
// (dw+1) for dh, dw in {-1, 0, 1}, off_t = dh*W + dw.  valid_t(r) says
// that pixel r's neighbour (h + dh, w + dw) lies in r's own image; it is
// computed from each row's own (h, w), never from flat-row neighbours
// (the row after an image's last pixel is the next image's first).  An
// out-of-image neighbour contributes 0: the mask applies after the
// prologue, as the TPU kernel masks the prologue's output, so the zero
// padding is of the normalized input, not relu(bias).
//
// Numerics follow the TPU kernels and csrc/fused_matmul_bn.cu: operands
// in the input type T (float32 or bfloat16), the prologue and dyt
// computed in float32 with __fmul_rn/__fadd_rn (no FMA contraction, so
// they round as PyTorch's two ops do) and rounded to T before the
// product, products accumulated in float32, statistics from y after it
// is rounded to T.  Every load and store masks its ragged edge; no
// padded copy of any operand exists in device memory.
//
// Every kernel runs on the tensor cores: bfloat16 operands as they are
// (the product of two bf16 values is exact in float32), float32 ones
// split into tf32 hi + lo parts, three products each (3xTF32, below).
//
// Sums across M.  Blocks run in no order, so the forwards and dx write
// one float32 partial row per run of stages (s1/s2, dscale/dbias), and
// dw splits the pixels into runs that each write a float32 partial of
// the whole (9*C, C_out) gradient; the wrapper sums them in a fixed
// order.  No atomics: the result is the same from run to run.
//
// Bound.  Each kernel does 2*M*9*C*C_out operations.  At ResNet-50's
// 3x3 shapes at B=128 (M = 401,408 rows at 64 channels down to 6,272 at
// 512) that is 29.6 GFLOP a launch.  In float32 the three tf32 products
// are 3 x 29.6 GFLOP, 0.179 ms at the tensor cores' 495 TFLOP/s of
// tf32, above the bytes of every kernel (x, y, dy, the 73 KB to 9.4 MB
// kernel: at most 0.123 ms at 3.35 TB/s, dx at stage 1); on the FMA
// units (67 TFLOP/s) one product alone would take 0.44 ms.  In bfloat16
// the tensor cores' 989 TFLOP/s bound it by bytes at stage 1 (dw: 154
// MB, 0.046 ms, against 0.030 ms of operations) and by operations at
// stages 2-4.  Implicit GEMM on wgmma with TMA-fed halo tiles is later
// work for all of them.
//
// The bf16 dw (fused_conv3_bn_dw_mma) replaces the same TPU kernel,
// `_bwd_dw_kernel` (:244), on the tensor cores.  The TPU kernel rounds
// both operands to the input type before its product (the prologue's
// relu(x*scale + bias) and dyt), and the product of two bf16 values is
// exact in float32, so mma.sync.m16n8k16 on bf16 with float32 sums gives
// the FMA tile's numbers up to the order of the sums.  The design takes
// the 3x3 geometry out of the inner loop, where the FMA tile spends
// integer divisions and a masked scalar load on each of A's elements,
// nine times for each x value:
//   - A block owns the float32 sums of the three taps (dw = -1, 0, 1) of
//     one kernel row dh for a 64 x 64 tile of (c, o); 8 warps, each 16 c
//     x 32 o x 3 taps.  The grid is (3 * tiles of (c, o), runs of
//     stages), the three dh of a tile side by side, so that they read
//     the same rows of y and dy while L2 holds them.
//   - The pixels are walked in segments of an image row, at most 62
//     wide (a whole row up to W = 62), and a stage holds as many
//     segments as fit in 64 positions, each segment as its pixels with
//     one halo position on either side.  dyt is staged at a segment's
//     pixels and 0 at its halo positions; xn, of image row h + dh, at
//     every position (0 outside the image).  So the three taps are three
//     row offsets into one xn tile, and a tap's product over a
//     segment's positions sums exactly the pixels whose neighbour lies
//     in the image: no mask and no index arithmetic per element.
//   - The raw rows of x, y and dy go by cp.async (16 bytes a copy,
//     zeros where a chunk lies outside) into a ring of three raw stages,
//     two stages ahead of the product, so that loads stay in flight
//     without holding registers (126 a thread: two blocks an SM).  Each
//     thread stages the chunks it copied: the prologue and dyt applied
//     in float32 with __fmul_rn/__fadd_rn, rounded to bf16 and stored as
//     [position][channel] tiles whose rows are padded by 16 bytes, so
//     that ldmatrix rows fall on distinct banks.  Both operands come
//     from their tiles by ldmatrix.trans; dyt's fragments are shared by
//     the three taps.  Where a start is not 16-byte aligned or C (C_out)
//     is not a multiple of 8, the rows of x (y and dy) load element by
//     element.
//   - Each run writes its float32 (9*C, C_out) partial; the wrapper sums
//     the runs in a fixed order.  No atomics: the same bits every run.
//
// The float32 dw (fused_conv3_bn_dw_tf32) replaces the same TPU kernel
// on the tensor cores, on the bf16 tile's walk, grid and runs, keeping
// float32 numbers.  The TPU kernel multiplies float32 operands
// unrounded, and one tf32 or bf16 pass keeps about three digits, so
// each operand is split into tf32 hi = rna(v) and lo = rna(v - hi)
// (mma.cuh: split_tf32), and three mma.sync.m16n8k8 tf32 products,
// lo.hi + hi.lo + hi.hi, go into float32 sums: about 2^-21 of each
// product.  The tensor core truncates each sum it returns, so a tap's
// products go into a part that starts at 0 each stage (24 products a
// chain), added to the run's sum rounded to nearest: one register for
// all of a run's products drifted past the float32 tolerance at
// ResNet-50's shapes (phase 3 of chip_smoke.py compares them).  The FMA
// tile it replaces
// spent an integer division and a masked scalar load on each of A's
// elements and ran 2.1x slower than its plain version.
//   - The raw rows of x, y and dy go by cp.async (16 bytes, zeros
//     outside; element loads where a start is unaligned or C (C_out) is
//     not a multiple of 4) straight into a ring slot laid out as the
//     operand tiles: x one row below its position (a zero guard row
//     either side), y and dy at their position.  Each thread applies the
//     prologue in place to the x chunks it copied (0 outside the image)
//     and turns its y and dy chunks into dyt (0 at the halo), in float32
//     with __fmul_rn/__fadd_rn, split into tf32 hi and lo in place of dy
//     and y; one barrier a stage publishes the slot.  So shared memory
//     holds one float32 tile per operand a stage and no separate operand
//     buffers: 55,872 bytes a slot; a ring of two, one stage loading
//     while one multiplies, at two blocks an SM (112,768 bytes a block).
//   - The tiles' row strides are 8 mod 32 floats, so the 32-bit fragment
//     loads (a lane reads row t, column g) fall on 32 distinct banks; the
//     three taps read the x tile at row offsets 0, 1, 2 as in bf16,
//     splitting x as its fragment is loaded, and read dyt's parts as
//     they lie (one split for the three taps).
//
// The bf16 forward (fused_conv3_bn_fwd_mma) replaces `_fwd_kernel`
// (:139) on the tensor cores, on the same walk of the pixels, with the
// product turned around: the FMA tile loaded, masked, normalised and
// rounded each x value nine times, with a division for tap and channel
// on each.  Each launch is 29.6 GFLOP at ResNet-50's shapes (0.030 ms at
// 989 TFLOP/s, about what x, W and y take at 3.35 TB/s at stage 1).
//   - A block owns 64 positions (one stage) x 64 output channels (128
//     where C_out > 64) and walks a run of stages; 8 warps, each 16 or
//     32 positions x 32 channels.  A stage's depth runs in steps (dh,
//     chunk of channels): xn of image row h + dh is staged as a bf16
//     [position][channel] tile one row below its position (a zero guard
//     row either side; 0 outside the image, the halo holding the real
//     neighbour where a row takes several segments), so that the three
//     taps dw = -1, 0, 1 are A at row offsets 0, 1, 2 by ldmatrix, and B
//     is W[3 (dh + 1) + dw]'s [c][o] chunk by ldmatrix.trans.  No mask
//     and no index arithmetic per element.
//   - Raw x rows go by cp.async (16 bytes, zeros outside; element loads
//     where a start is unaligned or C is not a multiple of 8) into a ring
//     of three steps, two ahead of the product; each thread applies the
//     prologue in place to the chunks it copied, once for each copy, and
//     one barrier a step publishes the tile.  Where C <= 64 the block's
//     whole W slice (3 x 3 x 64 x 64 bf16, 74 KB padded to 83) stays in
//     shared memory for its run; else W streams with x by chunks of 32
//     channels (C > 64 means every kernel row reads W anew from L2 a
//     stage: about as many bytes as x).
//   - The epilogue rounds y to bf16, stores it at the segments' own
//     pixels (a halo position's result and those past the segments are
//     dropped) and adds the rounded values to float32 column sums held in
//     registers for the run; these are reduced by shuffles, then across
//     the warps in order, into one partial row of s1 and s2 a run, which
//     the wrapper sums in a fixed order.  No atomics.
//
// The bf16 dx (fused_conv3_bn_dx_mma) replaces `_bwd_dx_kernel` (:217)
// and its split over C_out `_bwd_dx_kernel_nb` (:180) on the tensor
// cores, on the forward's walk with the product turned around: the FMA
// tile divided for tap and channel, masked and turned each dy/y value
// into dyt at each of its nine reads.  Each launch is 29.6 GFLOP at
// ResNet-50's shapes; stage 1 must move x, y, dy and dx (0.061 ms at
// 3.35 TB/s).
//   - A block owns 64 positions (one stage) x 64 input channels c (128
//     where C > 64) and walks a run of stages; 8 warps, each 16 or 32
//     positions x 32 channels.  A stage's depth runs in steps (dh, chunk
//     of output channels o: all of them where C and Co <= 64, else 32):
//     dyt of image row h - dh is staged as a
//     bf16 [position][o] tile one row below its position (a zero guard
//     row either side; 0 outside the image, the halo holding the real
//     neighbour where a row takes several segments), so that tap dw,
//     which reads dyt at w - dw, is A at row offset 1 - dw (2, 1, 0 for
//     dw = -1, 0, 1) by ldmatrix; B is W[3 (dh + 1) + dw + 1]'s [c][o]
//     chunk, which is B's (n, k) layout as W lies: ldmatrix without
//     .trans.
//   - y and dy go by cp.async (16 bytes, zeros outside; element loads
//     where a start is unaligned or Co is not a multiple of 8) into a
//     ring of steps: dy into the dyt tile, y into a raw tile beside it;
//     each thread turns the chunks it copied into dyt in place (dyt8; 0
//     outside the image, where it would be ds1), and one barrier a step
//     publishes the tile.  Where C and Co <= 64 the block's whole W slice
//     (3 x 3 x 64 x 64 bf16) stays in shared memory for its run and the
//     ring holds two steps, one ahead (111,680 bytes: two blocks an SM;
//     three steps leave one, which ran 1.5x slower on an H100 SXM);
//     else W streams through a ring of three steps, two ahead, 32 o a
//     step (104,928 bytes at 128 channels, 67,552 at 64).  W's tiles are
//     swizzled rather than padded (w_at), which is what lets both fit
//     two blocks an SM beside y's raw tiles.
//   - Every chunk of C_out sums into the same registers, so the ReLU /
//     normalize backward sees the total dxn: the TPU's split over C_out
//     (kernel 15, a VMEM limit) needs no counterpart.  The epilogue works
//     in the accumulator layout at the segments' own pixels: x pairs are
//     loaded there, z = x*scale + bias, dz = dxn where z > 0, dx =
//     dz*scale rounded to bf16 in pairs; the column sums of dz*x and dz
//     stay in registers for the run and are reduced by shuffles, then
//     across the warps in order, into one float32 partial row a run.  No
//     atomics.
//
// The float32 dx (fused_conv3_bn_dx_tf32) replaces the same TPU kernels
// on the tensor cores, on the bf16 dx tile's walk, grid, steps and
// epilogue, keeping float32 numbers: dyt and W are split into tf32 hi +
// lo and three mma.sync.m16n8k8 products, lo.hi + hi.lo + hi.hi, go
// into float32 sums (mma.cuh), as in the float32 dw.  The FMA tile it
// replaces divided for tap and channel, masked and turned each dy/y
// value into dyt at each of its nine reads, and took 3.85 ms at (128, 56,
// 56, 64 -> 64), 11 % of its 3xTF32 bound (3 x 29.6 GFLOP: 0.179 ms at
// 495 TFLOP/s; its bytes take 0.123 ms).
//   - A block owns 64 positions (one stage) x 64 input channels at every
//     C, 8 warps each 16 positions x 32 channels; a stage's depth runs in
//     steps (dh, 32 output channels), dyt of image row h - dh one row
//     below its position, the taps dw = -1, 0, 1 at row offsets 2, 1, 0.
//   - W cannot stay resident: its 3 x 3 x 64 x 64 float32 slice is 147
//     KB.  It streams with y and dy, a kernel row's three taps of the
//     step's 32 output channels (27,648 bytes) a step.  A ring slot holds
//     a step: dy and y by cp.async (16 bytes, zeros outside; element
//     loads where a start is unaligned or Co is not a multiple of 4)
//     straight into the layout of the dyt tile, each thread turning the
//     chunks it copied into dyt in float32 (dyt4; 0 outside the image,
//     where it would be ds1) split into tf32 hi in place of dy and lo in
//     place of y, and W's [t][c][o] rows, split as their fragments are
//     loaded: 46,656 bytes a slot, a ring of two (one step loading while
//     one multiplies) at two blocks an SM, as PR 15's dw tile found best.
//     Row strides of 36 floats put the 32 lanes of a fragment load (row
//     g, column t4) on 32 distinct banks.
//   - The tensor core truncates each sum it returns, so a step's products
//     (its three taps over 32 output channels: 12 k8 steps, 36 mma) go
//     into a part that starts at 0, and the part into the stage's
//     float32 sum rounded to nearest: the depth is 9*C_out, up to 4608.
//     Every chunk of C_out sums into the same registers, so the ReLU /
//     normalize backward sees the total dxn (no kernel 15).  The epilogue
//     is the bf16 tile's in float32.
//
// The float32 forward (fused_conv3_bn_fwd_tf32) replaces `_fwd_kernel`
// (:139) on the tensor cores, on the bf16 forward tile's walk, grid and
// runs, with the float32 dx tile's roles mirrored, keeping float32
// numbers: xn and W are split into tf32 hi + lo and three m16n8k8
// products, lo.hi + hi.lo + hi.hi, go into float32 sums.  At (128, 56,
// 56, 64 -> 64) that is bound by operations: 3 x 29.6 GFLOP, 0.179 ms at
// 495 TFLOP/s, against 0.061 ms of bytes.
//   - A block owns 64 positions (one stage) x 64 output channels at
//     every C_out, 8 warps each 16 positions x 32 channels; a stage's
//     depth runs in steps (dh, 32 input channels), xn of image row h +
//     dh one row below its position, the taps dw = -1, 0, 1 at row
//     offsets 0, 1, 2.
//   - W cannot stay resident (147 KB in float32 at C = C_out = 64): it
//     streams with x, a kernel row's three taps of the step's 32 input
//     channels (27,648 bytes) a step.  A ring slot holds a step: x by
//     cp.async (16 bytes, zeros outside; element loads where a start is
//     unaligned or C is not a multiple of 4) straight into the layout of
//     the xn tile, each thread applying the prologue in float32 with
//     __fmul_rn/__fadd_rn to the chunks it copied (0 outside the image,
//     where it would be relu(bias)) and splitting them into tf32 hi in
//     place and lo beside it, and W's [t][c][o] rows, split as their
//     fragments are loaded: 46,656 bytes a slot, a ring of two (one step
//     loading while one multiplies) at two blocks an SM.  Row strides of
//     36 floats (xn) and 72 (W) put the 32 lanes of a fragment load on
//     32 distinct banks.
//   - A step's products (its three taps over 32 input channels: 12 k8
//     steps, 36 mma) go into a part that starts at 0, and the part into
//     the stage's float32 sum rounded to nearest.
//   - The epilogue stores y in float32 from a staging tile of the warp's
//     own (16 positions x 32 channels, no barrier), a lane's four
//     channels 16 bytes at a time where alignment allows, at the
//     segments' own pixels; each lane adds what it stores to its column
//     sums of y and y^2, which are reduced by shuffles, then across the
//     warps in order, into one float32 partial row a run.  No atomics.
//     113,792 bytes of shared memory a block: two blocks an SM.

#include "common.cuh"
#include "mma.cuh"

namespace {

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Shapes the kernels take: every size positive, M = N*H*W and every
// flat index (9*C, 9*C_out) in 32 bits, with 128 to spare.
bool shape_ok(long long N, int H, int W, int C, int Co) {
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return false;
  const long long lim = 0x7fffffffLL - 128;
  return N * H * W <= lim && 9LL * C <= lim && 9LL * Co <= lim;
}

// ---------------------------------------------------------------------
// dw in bfloat16 on the tensor cores.  See the note at the top.

using mx::a_ptr;
using mx::b_ptr;
using mx::bf16;
using mx::cp_async16;
using mx::cp_async_commit;
using mx::cp_async_wait;
using mx::dyt8;
using mx::ldsm_x4_t;
using mx::load8;
using mx::mma;
using mx::prologue8;

constexpr int kTcTile = 64;      // c and o of dw a block owns
constexpr int kTcPos = 64;       // positions a stage holds
constexpr int kTcMaxSeg = kTcPos - 2;  // widest segment: two halo positions
constexpr int kTcThreads = 256;  // 8 warps: 4 over c x 2 over o
constexpr int kTcLd = kTcTile + 8;     // bf16 row stride: 16 bytes pad
constexpr int kTcXRows = kTcPos + 2;   // xn rows: a zero guard either side
constexpr int kTcChunks = kTcPos * (kTcTile / 8) / kTcThreads;  // 2
constexpr int kTcRing = 3;       // raw stages: two load while one is staged

// The arguments of the dw tiles: T = bf16 (fused_conv3_bn_dw_mma) or
// float (fused_conv3_bn_dw_tf32).
template <typename T>
struct DwArgs {
  const T* x;           // (M, C)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  const T* y;           // (M, Co)
  const T* dy;          // (M, Co)
  const float* ds1;     // (Co,)
  const float* ds2;     // (Co,)
  float* part;          // (runs, 9*C, Co)
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int vec;              // bit 0: x loads 16 bytes; bit 1: y and dy do
  int seg_w;            // pixels of a segment (the last of a row: fewer)
  int stage_segs;       // segments a stage holds
  int row_segs;         // segments of an image row
  int segs;             // N * H * row_segs
  int stages;           // ceil(segs / stage_segs)
  int run_stages;       // stages of a run (the last run: fewer)
};
using TcArgs = DwArgs<bf16>;

// The walk of the pixels for an image width W: segments of seg_w
// pixels, stage_segs of them to a stage (64 positions at most, a
// segment taking seg_w + 2), row_segs to an image row.  A row wider than
// kTcMaxSeg takes several segments, one a stage.
void tc_geometry(int W, int* seg_w, int* stage_segs, int* row_segs) {
  *seg_w = W < kTcMaxSeg ? W : kTcMaxSeg;
  *stage_segs = kTcPos / (*seg_w + 2);
  *row_segs = (W + *seg_w - 1) / *seg_w;
}

// Dynamic shared memory of fused_conv3_bn_dw_mma, in order: the ring of
// raw stages (x, y, dy: kTcRaw bf16 values each, [position][channel]),
// the two operand buffers (xn: kTcXRows rows, then dyt: kTcPos rows, of
// kTcLd), the per-channel constants (4 x kTcTile floats).
constexpr int kTcRaw = kTcPos * kTcTile;
constexpr int kTcOps = (kTcXRows + kTcPos) * kTcLd;
constexpr size_t kTcSmem =
    (kTcRing * 3 * kTcRaw + 2 * kTcOps) * sizeof(bf16) +
    4 * kTcTile * sizeof(float);

// Grid (3 * ceil(C / 64) * ceil(Co / 64), runs): block (t, r) takes
// kernel row dh = t % 3 - 1 and tile t / 3 of (c, o) over run r of the
// stages, and writes its three taps' float32 sums to part[r].
__global__ void __launch_bounds__(kTcThreads, 2)
    fused_conv3_bn_dw_mma(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);
  bf16* ops = raw + kTcRing * 3 * kTcRaw;
  float* sc_s = reinterpret_cast<float*>(ops + 2 * kTcOps);
  float* bi_s = sc_s + kTcTile;
  float* d1_s = bi_s + kTcTile;
  float* d2_s = d1_s + kTcTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp & 3, wo = warp >> 2;  // the warp's 16 x 32 tile
  const int tiles_c = (a.C + kTcTile - 1) / kTcTile;
  const int dh = static_cast<int>(blockIdx.x % 3) - 1;
  const int tile = static_cast<int>(blockIdx.x / 3);
  const int c0 = (tile % tiles_c) * kTcTile, o0 = (tile / tiles_c) * kTcTile;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2;

  // Both operand buffers start at 0: the guard rows, the positions past
  // a stage's segments and past its last step of 16 are never written
  // again.
  {
    uint4* z = reinterpret_cast<uint4*>(ops);
    for (int i = tid; i < 2 * kTcOps / 8; i += kTcThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // per-channel constants, 0 past C and Co (a zero channel stays zero)
  for (int i = tid; i < kTcTile; i += kTcThreads) {
    const bool in_c = a.prologue && c0 + i < a.C;
    sc_s[i] = in_c ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in_c ? a.bias[c0 + i] : 0.f;
    const bool in_o = o0 + i < a.Co;
    d1_s[i] = in_o ? a.ds1[o0 + i] : 0.f;
    d2_s[i] = in_o ? a.ds2[o0 + i] : 0.f;
  }

  // This thread's chunks: positions tid / 8 + 32 i of a stage, channels
  // cc .. cc + 7 of the tile, for x and for dyt; the thread loads them
  // and stages them itself, so the raw ring needs no barrier.  A
  // position is fixed for the whole run: segment sg of the stage, place
  // p in it (0 and seg_w + 1 are the halo).  The segment's image row
  // (n * H + h), its h and its index in the row advance by stage_segs
  // segments a stage, as the loads run ahead.
  const int cc = (tid & 7) * 8;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses
  int pos[kTcChunks], place[kTcChunks], seg[kTcChunks];
  int img_row[kTcChunks], h[kTcChunks], sr[kTcChunks];
#pragma unroll
  for (int i = 0; i < kTcChunks; ++i) {
    pos[i] = (tid >> 3) + (kTcThreads / 8) * i;
    const int sg = pos[i] / pitch;
    place[i] = pos[i] - sg * pitch;
    seg[i] = st_begin * a.stage_segs + sg;
    img_row[i] = seg[i] / a.row_segs;
    sr[i] = seg[i] - img_row[i] * a.row_segs;
    h[i] = img_row[i] % a.H;
  }

  // Loads the stage the positions point at into raw slot `slot` (cp.async
  // of 16 bytes, zeros where a chunk lies outside; element loads where
  // a start or width does not allow 16 bytes), moves the positions on
  // by a stage, and returns the stage's flags: bit 2i, chunk i's x lies
  // in the image; bit 2i + 1, its dyt is a segment's own pixel.
  auto fetch = [&](int slot) {
    unsigned flags = 0;
    bf16* rx = raw + slot * 3 * kTcRaw;
    bf16* ry = rx + kTcRaw;
    bf16* rd = ry + kTcRaw;
#pragma unroll
    for (int i = 0; i < kTcChunks; ++i) {
      if (pos[i] < npos) {
        const bool live = seg[i] < a.segs;
        const int p = place[i];
        const int w = sr[i] * a.seg_w + p - 1;  // this position's pixel
        // x at (n, h + dh, w); dyt at (n, h, w) for a segment's own pixels
        const bool xin = live && h[i] + dh >= 0 && h[i] + dh < a.H &&
                         w >= 0 && w < a.W;
        const bool din = live && p >= 1 && p <= a.seg_w && w < a.W;
        flags |= (xin ? 1u : 0u) << (2 * i) | (din ? 2u : 0u) << (2 * i);
        const int at = pos[i] * kTcTile + cc;
        const bf16* xr =
            a.x + (xin ? static_cast<int64_t>(img_row[i] + dh) * a.W + w
                       : 0) * a.C;
        const int64_t dpix =
            din ? static_cast<int64_t>(img_row[i]) * a.W + w : 0;
        const bf16* yr = a.y + dpix * a.Co;
        const bf16* gr = a.dy + dpix * a.Co;
        if (vec_x) {
          const bool full = xin && c0 + cc < a.C;
          cp_async16(rx + at, full ? xr + c0 + cc : a.x, full);
        } else {
          *reinterpret_cast<uint4*>(rx + at) =
              load8(xr, c0 + cc, a.C, xin, false);
        }
        if (vec_y) {
          const bool full = din && o0 + cc < a.Co;
          cp_async16(ry + at, full ? yr + o0 + cc : a.y, full);
          cp_async16(rd + at, full ? gr + o0 + cc : a.dy, full);
        } else {
          *reinterpret_cast<uint4*>(ry + at) =
              load8(yr, o0 + cc, a.Co, din, false);
          *reinterpret_cast<uint4*>(rd + at) =
              load8(gr, o0 + cc, a.Co, din, false);
        }
      }
      seg[i] += a.stage_segs;
      if (a.row_segs == 1) {
        img_row[i] += a.stage_segs;
        h[i] += a.stage_segs;
        while (h[i] >= a.H) h[i] -= a.H;
      } else if (++sr[i] == a.row_segs) {  // one segment a stage
        sr[i] = 0;
        ++img_row[i];
        if (++h[i] == a.H) h[i] = 0;
      }
    }
    return flags;
  };

  float acc[3][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // the first kTcRing - 1 stages in flight; one group a stage, empty past
  // the run, so that a wait counts stages
  unsigned ring_flags = 0;  // 4 bits a slot
#pragma unroll
  for (int k = 0; k < kTcRing - 1; ++k) {
    if (st_begin + k < st_end) ring_flags |= fetch(k) << (4 * k);
    cp_async_commit();
  }
  const int ksteps = (npos + 15) / 16;
  __syncthreads();  // the zeroed buffers and the constants
  int buf = 0, slot = 0;
  for (int st = st_begin; st < st_end; ++st, buf ^= 1) {
    bf16* xs = ops + buf * kTcOps;
    bf16* ds = xs + kTcXRows * kTcLd;
    cp_async_wait<kTcRing - 2>();  // this thread's chunks of stage st
    // stage: xn (prologue rounded to bf16, 0 outside the image) one row
    // below its position (the guard), dyt (rounded to bf16) at the
    // segments' pixels and 0 at their halo
    {
      const unsigned flags = ring_flags >> (4 * slot);
      const bf16* rx = raw + slot * 3 * kTcRaw;
      float sc[8], bi[8], d1[8], d2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = sc_s[cc + j];
        bi[j] = bi_s[cc + j];
        d1[j] = d1_s[cc + j];
        d2[j] = d2_s[cc + j];
      }
#pragma unroll
      for (int i = 0; i < kTcChunks; ++i) {
        if (pos[i] >= npos) continue;
        const int at = pos[i] * kTcTile + cc;
        uint4 v = *reinterpret_cast<const uint4*>(rx + at);
        if (a.prologue)  // x is 0 outside the image and past C already
          v = flags >> (2 * i) & 1 ? prologue8(v, sc, bi)
                                   : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(xs + (pos[i] + 1) * kTcLd + cc) = v;
        *reinterpret_cast<uint4*>(ds + pos[i] * kTcLd + cc) =
            flags >> (2 * i) & 2
                ? dyt8(*reinterpret_cast<const uint4*>(rx + kTcRaw + at),
                       *reinterpret_cast<const uint4*>(rx + 2 * kTcRaw + at),
                       d1, d2)
                : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // stage st + kTcRing - 1 into the slot that stage st - 1 left (this
    // thread's own chunks, staged already); the other operand buffer is
    // free: every warp left its product at the barrier
    const int next = slot == 0 ? kTcRing - 1 : slot - 1;
    if (st + kTcRing - 1 < st_end)
      ring_flags = (ring_flags & ~(0xfu << (4 * next))) |
                   fetch(next) << (4 * next);
    cp_async_commit();
    slot = slot + 1 == kTcRing ? 0 : slot + 1;
#pragma unroll
    for (int kk = 0; kk < kTcPos / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t bf[2][4];  // B = dyt: depth positions, columns o
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldsm_x4_t(bf[q], a_ptr<kTcLd>(ds, 16 * kk, 32 * wo + 16 * q));
#pragma unroll
      for (int t = 0; t < 3; ++t) {  // A = xn^T at tap offset t: rows c
        uint32_t af[4];
        ldsm_x4_t(af, b_ptr<kTcLd>(xs, 16 * kk + t, 16 * wc));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma(acc[t][2 * q], af, bf[q][0], bf[q][1]);
          mma(acc[t][2 * q + 1], af, bf[q][2], bf[q][3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the ring's empty groups

  // this run's float32 partial: acc[t][j][e] is tap 3 (dh + 1) + t at
  // c = 16 wc + g + 8 (e / 2), o = 32 wo + 8 j + 2 t4 + e % 2 of the tile
  float* dst = a.part + static_cast<int64_t>(blockIdx.y) * 9 * a.C * a.Co;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (a.Co & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + 16 * wc + g + 8 * hf;
      if (c >= a.C) continue;
      float* out =
          dst + (static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c) * a.Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + 32 * wo + 8 * j + 2 * t4;
        const float v0 = acc[t][j][2 * hf], v1 = acc[t][j][2 * hf + 1];
        if (pairs && o + 1 < a.Co) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          if (o < a.Co) out[o] = v0;
          if (o + 1 < a.Co) out[o + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------
// dw in float32 on the tensor cores (3xTF32).  See the note at the top.

using mx::dyt4;
using mx::load4;
using mx::mma_3xtf32;
using mx::prologue4;
using mx::split_tf32;

constexpr int kTfLd = kTcTile + 8;   // float row stride: 8 mod 32 banks
constexpr int kTfRowChunks = kTcTile / 4;                // float4 a row
constexpr int kTfRowStep = kTcThreads / kTfRowChunks;    // a thread's
constexpr int kTfChunks = kTcPos / kTfRowStep;           // positions apart
constexpr int kTfRing = 2;           // stages: one loads while one multiplies

// A ring slot holds a stage: x, turned into xn in place (kTcXRows rows of
// kTfLd: position p at row p + 1, a zero guard row either side), y and
// dy (kTcPos rows of kTfLd each), turned in place into dyt's tf32 lo and
// hi parts; after the ring, the per-channel constants (4 x kTcTile
// floats).  The padded strides are 8 mod 32 floats, so the 32 lanes of
// a fragment load, at rows t4 and columns g, read 32 distinct banks.
template <int RING>
struct DwTf {
  static constexpr int kX = kTcXRows * kTfLd;
  static constexpr int kY = kTcPos * kTfLd;
  static constexpr int kSlot = kX + 2 * kY;  // floats
  static constexpr size_t kSmem =
      (RING * kSlot + 4 * kTcTile) * sizeof(float);
};

// Grid (3 * ceil(C / 64) * ceil(Co / 64), runs), as fused_conv3_bn_dw_mma:
// block (t, r) takes kernel row dh = t % 3 - 1 and tile t / 3 of (c, o)
// over run r of the stages, and writes its three taps' float32 sums to
// part[r].
template <int RING>
__global__ void __launch_bounds__(kTcThreads, RING == 2 ? 2 : 1)
    fused_conv3_bn_dw_tf32(DwArgs<float> a) {
  using G = DwTf<RING>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sc_s = ring + RING * G::kSlot;
  float* bi_s = sc_s + kTcTile;
  float* d1_s = bi_s + kTcTile;
  float* d2_s = d1_s + kTcTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp & 3, wo = warp >> 2;  // the warp's 16 x 32 tile
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_c = (a.C + kTcTile - 1) / kTcTile;
  const int dh = static_cast<int>(blockIdx.x % 3) - 1;
  const int tile = static_cast<int>(blockIdx.x / 3);
  const int c0 = (tile % tiles_c) * kTcTile, o0 = (tile / tiles_c) * kTcTile;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2;

  // The ring starts at 0: the guard rows and the positions past a
  // stage's segments are never written again.
  {
    float4* z = reinterpret_cast<float4*>(ring);
    for (int i = tid; i < RING * G::kSlot / 4; i += kTcThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // per-channel constants, 0 past C and Co (a zero channel stays zero)
  for (int i = tid; i < kTcTile; i += kTcThreads) {
    const bool in_c = a.prologue && c0 + i < a.C;
    sc_s[i] = in_c ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in_c ? a.bias[c0 + i] : 0.f;
    const bool in_o = o0 + i < a.Co;
    d1_s[i] = in_o ? a.ds1[o0 + i] : 0.f;
    d2_s[i] = in_o ? a.ds2[o0 + i] : 0.f;
  }

  // This thread's chunks: positions (tid >> 4) + 16 i of a stage,
  // channels cc .. cc + 3 of the tile, for x, y and dy; the thread
  // copies them and stages them itself.  Position i is place[i] of the
  // stage's segment sg[i] (places 0 and seg_w + 1 are the halo).
  const int cc = (tid & 15) * 4;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses
  int sg[kTfChunks], place[kTfChunks];
#pragma unroll
  for (int i = 0; i < kTfChunks; ++i) {
    const int p = (tid >> 4) + kTfRowStep * i;
    sg[i] = p / pitch;
    place[i] = p - sg[i] * pitch;
  }

  // Loads stage st into ring slot `slot` (cp.async of 16 bytes, zeros
  // where a chunk lies outside; element loads where a start or width
  // does not allow 16 bytes) and returns its flags: bit 2i, chunk i's x
  // lies in the image; bit 2i + 1, its dyt is a segment's own pixel.
  // Where an image row takes several segments, a stage holds one.
  auto fetch = [&](int st, int slot) {
    unsigned flags = 0;
    float* rx = ring + slot * G::kSlot;
    float* ry = rx + G::kX;
    float* rd = ry + G::kY;
    const int seg0 = st * a.stage_segs;
    const int img0 = seg0 / a.row_segs, sr = seg0 - img0 * a.row_segs;
#pragma unroll
    for (int i = 0; i < kTfChunks; ++i) {
      const int p = (tid >> 4) + kTfRowStep * i;
      if (p < npos) {
        const bool live = seg0 + sg[i] < a.segs;
        const int img_row = img0 + sg[i];  // sg[i] is 0 where row_segs > 1
        const int h = img_row % a.H;
        const int w = sr * a.seg_w + place[i] - 1;  // this position's pixel
        // x at (n, h + dh, w); dyt at (n, h, w) for a segment's own pixels
        const bool xin = live && h + dh >= 0 && h + dh < a.H && w >= 0 &&
                         w < a.W;
        const bool din = live && place[i] >= 1 && place[i] <= a.seg_w &&
                         w < a.W;
        flags |= (xin ? 1u : 0u) << (2 * i) | (din ? 2u : 0u) << (2 * i);
        const float* xr =
            a.x + (xin ? static_cast<int64_t>(img_row + dh) * a.W + w : 0) *
                      a.C;
        const int64_t dpix =
            (din ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.Co;
        float* xd = rx + (p + 1) * kTfLd + cc;
        float* yd = ry + p * kTfLd + cc;
        float* dd = rd + p * kTfLd + cc;
        if (vec_x) {
          const bool full = xin && c0 + cc < a.C;
          cp_async16(xd, full ? xr + c0 + cc : a.x, full);
        } else {
          *reinterpret_cast<float4*>(xd) = load4(xr, c0 + cc, a.C, xin);
        }
        if (vec_y) {
          const bool full = din && o0 + cc < a.Co;
          cp_async16(yd, full ? a.y + dpix + o0 + cc : a.y, full);
          cp_async16(dd, full ? a.dy + dpix + o0 + cc : a.dy, full);
        } else {
          *reinterpret_cast<float4*>(yd) =
              load4(a.y + dpix, o0 + cc, a.Co, din);
          *reinterpret_cast<float4*>(dd) =
              load4(a.dy + dpix, o0 + cc, a.Co, din);
        }
      }
    }
    return flags;
  };

  float acc[3][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  __syncthreads();  // the zeroed ring and the constants
  // the first RING - 1 stages in flight; one group a stage, empty past
  // the run, so that a wait counts stages
  constexpr int kBits = 2 * kTfChunks;  // flags a slot
  unsigned ring_flags = 0;
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    if (st_begin + k < st_end)
      ring_flags |= fetch(st_begin + k, k) << (kBits * k);
    cp_async_commit();
  }
  const int ksteps = (npos + 7) / 8;
  int slot = 0;
  for (int st = st_begin; st < st_end; ++st) {
    float* rx = ring + slot * G::kSlot;
    float* ry = rx + G::kX;
    float* rd = ry + G::kY;
    cp_async_wait<RING - 2>();  // this thread's chunks of stage st
    {  // xn (the prologue, 0 outside the image) in place, in float32; dyt
       // (0 at the halo) in float32, split into tf32 hi in place of dy
       // and lo in place of y
      const unsigned flags = ring_flags >> (kBits * slot);
      float sc[4], bi[4], d1[4], d2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = sc_s[cc + j];
        bi[j] = bi_s[cc + j];
        d1[j] = d1_s[cc + j];
        d2[j] = d2_s[cc + j];
      }
#pragma unroll
      for (int i = 0; i < kTfChunks; ++i) {
        const int p = (tid >> 4) + kTfRowStep * i;
        if (p >= npos) continue;
        if (a.prologue) {  // x is 0 outside the image and past C already
          float4* q = reinterpret_cast<float4*>(rx + (p + 1) * kTfLd + cc);
          *q = flags >> (2 * i) & 1 ? prologue4(*q, sc, bi)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4* d = reinterpret_cast<float4*>(rd + p * kTfLd + cc);
        float4* yl = reinterpret_cast<float4*>(ry + p * kTfLd + cc);
        const float4 v = flags >> (2 * i) & 2
                             ? dyt4(*yl, *d, d1, d2)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(d) = hi;
        *reinterpret_cast<uint4*>(yl) = lo;
      }
    }
    __syncthreads();
    // stage st + RING - 1 into the slot that stage st - 1 left: every
    // warp left its product at the barrier
    const int next = slot == 0 ? RING - 1 : slot - 1;
    if (st + RING - 1 < st_end)
      ring_flags = (ring_flags & ~(((1u << kBits) - 1) << (kBits * next))) |
                   fetch(st + RING - 1, next) << (kBits * next);
    cp_async_commit();
    // Each tap's products over the stage go into a part that starts at
    // 0, and the part into acc, rounded to nearest: the tensor core
    // truncates each sum, and a chain of every product of a run in one
    // register drifts by as many ulps, past the float32 tolerance at
    // ResNet-50's shapes; 24 products a chain keep the drift of each
    // part far below its rounding.
    const uint32_t* bhi = reinterpret_cast<const uint32_t*>(rd);
    const uint32_t* blo = reinterpret_cast<const uint32_t*>(ry);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float part[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTcPos / 8; ++kk) {
        if (kk >= ksteps) break;
        // A = xn^T at tap offset t: rows c, depth positions, split into
        // tf32 hi + lo as loaded
        const float* q = rx + (8 * kk + t4 + t) * kTfLd + 16 * wc + g;
        uint32_t ah[4], al[4];
        split_tf32(q[0], ah[0], al[0]);
        split_tf32(q[8], ah[1], al[1]);
        split_tf32(q[4 * kTfLd], ah[2], al[2]);
        split_tf32(q[4 * kTfLd + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // B = dyt: depth positions, cols o
          const int at = (8 * kk + t4) * kTfLd + 32 * wo + 8 * j + g;
          const uint32_t bh[2] = {bhi[at], bhi[at + 4 * kTfLd]};
          const uint32_t bl[2] = {blo[at], blo[at + 4 * kTfLd]};
          mma_3xtf32(part[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][j][e] = __fadd_rn(acc[t][j][e], part[j][e]);
    }
    slot = slot + 1 == RING ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // the ring's empty groups

  // this run's float32 partial: acc[t][j][e] is tap 3 (dh + 1) + t at
  // c = 16 wc + g + 8 (e / 2), o = 32 wo + 8 j + 2 t4 + e % 2 of the tile
  float* dst = a.part + static_cast<int64_t>(blockIdx.y) * 9 * a.C * a.Co;
  const bool pairs = (a.Co & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + 16 * wc + g + 8 * hf;
      if (c >= a.C) continue;
      float* out =
          dst + (static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c) * a.Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + 32 * wo + 8 * j + 2 * t4;
        const float v0 = acc[t][j][2 * hf], v1 = acc[t][j][2 * hf + 1];
        if (pairs && o + 1 < a.Co) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          if (o < a.Co) out[o] = v0;
          if (o + 1 < a.Co) out[o + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------
// The forward in bfloat16 on the tensor cores.  See the note at the top.

using mx::ldsm_x4;

constexpr int kFwThreads = 256;  // 8 warps over 64 positions x BN channels
constexpr int kFwRing = 3;       // operand steps: two load while one multiplies

// fused_conv3_bn_fwd_mma's tile: BN output channels a block (64, or 128
// where C_out > 64), KC input channels a step.  RES (C <= KC = 64): the
// block's whole W slice stays in shared memory for its run; else KC = 32
// and W streams through the ring with x, a chunk a step.
template <int BN, int KC, bool RES>
struct FwTc {
  static constexpr int kWarpsN = BN / 32;          // 32 channels a warp
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMw = kTcPos / kWarpsM;     // positions a warp
  static constexpr int kMI = kMw / 16;             // its m16 tiles
  static constexpr int kXLd = KC + 8;              // bf16 row strides: 16
  static constexpr int kWLd = BN + 8;              // bytes of pad
  static constexpr int kXTile = kTcXRows * kXLd;   // xn of one step
  static constexpr int kWTile = 3 * KC * kWLd;     // W[3 (dh + 1) + t][c][o]
  static constexpr int kRowChunks = KC / 8;        // uint4 of an x position
  static constexpr int kXChunks = kTcPos * kRowChunks / kFwThreads;
  static constexpr int kWChunks = 3 * KC * (BN / 8) / kFwThreads;
  static constexpr int kWTiles = RES ? 3 : kFwRing;  // one a dh, or a step
  static constexpr size_t kSmem =
      (kFwRing * kXTile + kWTiles * kWTile) * sizeof(bf16) +
      2 * kWarpsM * BN * sizeof(float);
};

// The arguments of the forward tiles: T = bf16 (fused_conv3_bn_fwd_mma)
// or float (fused_conv3_bn_fwd_tf32).
template <typename T>
struct FwArgs {
  const T* x;           // (M, C)
  const T* w;           // (9, C, Co)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  T* y;                 // (M, Co)
  float* s1;            // (runs, Co)
  float* s2;            // (runs, Co)
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int vec;              // bit 0: x loads 16 bytes; bit 1: w does; bit 2
                        // (float32): y stores 16 bytes
  int seg_w;            // the pixel walk of tc_geometry
  int stage_segs;
  int row_segs;
  int segs;             // N * H * row_segs
  int stages;           // ceil(segs / stage_segs)
  int run_stages;       // stages of a run (the last run: fewer)
};

// Grid (ceil(Co / BN), runs): block (j, r) computes output channels
// [j BN, (j + 1) BN) at every pixel of run r's stages, a stage at a
// time, and writes its float32 sums of y and y^2 to s1[r], s2[r].  A
// stage's depth runs in steps (dh, chunk of KC channels): xn of image
// row h + dh as a [position][channel] tile, one row below its position
// (a zero guard row), so that tap dw of the kernel row is the tile at
// row offset dw + 1; W[3 (dh + 1) + dw + 1] for that chunk.
template <int BN, int KC, bool RES>
__global__ void __launch_bounds__(kFwThreads, 2)
    fused_conv3_bn_fwd_mma(FwArgs<bf16> a) {
  using G = FwTc<BN, KC, RES>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xring = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = xring + kFwRing * G::kXTile;
  float* red = reinterpret_cast<float*>(wbuf + G::kWTiles * G::kWTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * BN;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const int nck = (a.C + KC - 1) / KC;  // channel chunks: 1 where RES
  const int per_stage = 3 * nck;        // steps a stage
  const int nsteps = (st_end - st_begin) * per_stage;
  const bool vec_x = a.vec & 1, vec_w = a.vec & 2;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses

  // The x ring starts at 0: the guard rows and the positions past a
  // stage's segments are never written again.  The barrier keeps every
  // zero ahead of the copies that land in the ring.
  {
    uint4* z = reinterpret_cast<uint4*>(xring);
    for (int i = tid; i < kFwRing * G::kXTile / 8; i += kFwThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // This thread's x chunks: positions pos[i] of a stage, channels cc ..
  // cc + 7 of a step's chunk; it loads them and applies the prologue to
  // them itself, so no barrier separates the two.  A position's segment
  // and place in it are fixed; its pixel follows the stage (locate).
  const int cc = (tid % G::kRowChunks) * 8;
  int pos[G::kXChunks], sg[G::kXChunks], place[G::kXChunks];
  int64_t pix[G::kXChunks];  // its pixel (n, h, w) as a row of x, or -1
  int hrow[G::kXChunks];     // its h
#pragma unroll
  for (int i = 0; i < G::kXChunks; ++i) {
    pos[i] = tid / G::kRowChunks + (kFwThreads / G::kRowChunks) * i;
    sg[i] = pos[i] / pitch;
    place[i] = pos[i] - sg[i] * pitch;
  }
  int ld_stage = -1;
  auto locate = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kXChunks; ++i) {
      const int seg = st * a.stage_segs + sg[i];
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + place[i] - 1;
      const bool ok = pos[i] < npos && seg < a.segs && w >= 0 && w < a.W;
      pix[i] = ok ? static_cast<int64_t>(img_row) * a.W + w : -1;
      hrow[i] = img_row % a.H;
    }
  };

  // W[3 (dh + 1) + t][c0 + c][o0 + o] for t < 3, c < KC, o < BN into a
  // [t][c][o] tile; 0 past C and Co.
  auto load_w = [&](bf16* dst, int dh, int c0) {
    constexpr int kCols = BN / 8;
#pragma unroll
    for (int j = 0; j < G::kWChunks; ++j) {
      const int e = tid + kFwThreads * j;
      const int row = e / kCols, col = (e - row * kCols) * 8;
      const int t = row / KC, c = c0 + row - t * KC;
      const bool in = c < a.C;
      const bf16* src =
          a.w + (in ? static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c : 0) *
                    a.Co;
      bf16* d = dst + row * G::kWLd + col;
      if (vec_w) {
        const bool full = in && o0 + col < a.Co;
        cp_async16(d, full ? src + o0 + col : a.w, full);
      } else {
        *reinterpret_cast<uint4*>(d) = load8(src, o0 + col, a.Co, in, false);
      }
    }
  };

  // Loads step k of the run into ring slot `slot` (cp.async of 16
  // bytes, zeros where a chunk lies outside; element loads where a start
  // or C does not allow 16 bytes) and returns its flags: bit i, chunk
  // i's pixel lies in the image.
  auto load_step = [&](int k, int slot) {
    const int sl = k / per_stage, r = k - sl * per_stage;
    const int dh = r / nck - 1, c0 = (r % nck) * KC;
    if (sl != ld_stage) {
      locate(st_begin + sl);
      ld_stage = sl;
    }
    unsigned flags = 0;
    bf16* xs = xring + slot * G::kXTile;
#pragma unroll
    for (int i = 0; i < G::kXChunks; ++i) {
      if (pos[i] >= npos) continue;
      const int hh = hrow[i] + dh;
      const bool in = pix[i] >= 0 && hh >= 0 && hh < a.H;
      flags |= (in ? 1u : 0u) << i;
      const bf16* row =
          a.x + (in ? pix[i] + static_cast<int64_t>(dh) * a.W : 0) * a.C;
      bf16* d = xs + (pos[i] + 1) * G::kXLd + cc;
      if (vec_x) {
        const bool full = in && c0 + cc < a.C;
        cp_async16(d, full ? row + c0 + cc : a.x, full);
      } else {
        *reinterpret_cast<uint4*>(d) = load8(row, c0 + cc, a.C, in, false);
      }
    }
    if (!RES) load_w(wbuf + slot * G::kWTile, dh, c0);
    return flags;
  };

  float acc[G::kMI][4][4];
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float s1[4][2], s2[4][2];  // this thread's column sums of y, y^2
#pragma unroll
  for (int j = 0; j < 4; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;

  // Rounds stage st's sums to bf16, stores them at its segments' pixels
  // (a halo position's and those past the segments are dropped), adds
  // the rounded values to the column sums, and clears the sums.
  const bool pairs = (a.Co & 1) == 0;  // bf16 pairs stay 4-byte aligned
  auto epilogue = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = G::kMw * wm + 16 * i + g + 8 * hf;
        const int sgq = q / pitch, p = q - sgq * pitch;
        const int seg = st * a.stage_segs + sgq;
        const int img_row = seg / a.row_segs;
        const int w = (seg - img_row * a.row_segs) * a.seg_w + p - 1;
        const bool keep =
            q < npos && p >= 1 && p <= a.seg_w && seg < a.segs && w < a.W;
        bf16* yr =
            a.y + (keep ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.Co;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + 32 * wn + 8 * j + 2 * t4;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
          acc[i][j][2 * hf] = acc[i][j][2 * hf + 1] = 0.f;
          if (!keep) continue;
          const float2 f = __bfloat1622float2(v);
          if (pairs && o + 1 < a.Co) {
            *reinterpret_cast<__nv_bfloat162*>(yr + o) = v;
          } else {
            if (o < a.Co) yr[o] = v.x;
            if (o + 1 < a.Co) yr[o + 1] = v.y;
          }
          if (o < a.Co) {
            s1[j][0] += f.x;
            s2[j][0] += f.x * f.x;
          }
          if (o + 1 < a.Co) {
            s1[j][1] += f.y;
            s2[j][1] += f.y * f.y;
          }
        }
      }
  };

  // the resident W joins step 0's group; then the first kFwRing - 1
  // steps in flight, one group a step (empty past the run), so that a
  // wait counts steps
  if (RES) {
#pragma unroll
    for (int dh = -1; dh <= 1; ++dh) load_w(wbuf + (dh + 1) * G::kWTile, dh, 0);
  }
  constexpr unsigned kMask = (1u << G::kXChunks) - 1;
  unsigned ring_flags = 0;  // G::kXChunks bits a slot
#pragma unroll
  for (int k = 0; k < kFwRing - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (G::kXChunks * k);
    cp_async_commit();
  }
  int slot = 0, r_c = 0, sl_c = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int dh = r_c / nck - 1, c0 = (r_c % nck) * KC;
    bf16* xs = xring + slot * G::kXTile;
    cp_async_wait<kFwRing - 2>();  // this thread's chunks of step s
    if (a.prologue) {  // in place: relu(x*scale + bias) rounded, 0 outside
      float sc[8], bi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + cc + j;
        sc[j] = c < a.C ? __ldg(a.scale + c) : 0.f;
        bi[j] = c < a.C ? __ldg(a.bias + c) : 0.f;
      }
      const unsigned flags = ring_flags >> (G::kXChunks * slot);
#pragma unroll
      for (int i = 0; i < G::kXChunks; ++i) {
        if (pos[i] >= npos) continue;
        uint4* p = reinterpret_cast<uint4*>(xs + (pos[i] + 1) * G::kXLd + cc);
        *p = flags >> i & 1 ? prologue8(*p, sc, bi) : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // step s + kFwRing - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? kFwRing - 1 : slot - 1;
    if (s + kFwRing - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (G::kXChunks * next))) |
                   load_step(s + kFwRing - 1, next)
                       << (G::kXChunks * next);
    cp_async_commit();
    const bf16* wt = wbuf + (RES ? dh + 1 : slot) * G::kWTile;
    const int ksteps = ((a.C - c0 < KC ? a.C - c0 : KC) + 15) / 16;
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // tap dw = t - 1: row offset t
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (kk >= ksteps) break;
        uint32_t af[G::kMI][4];  // A = xn: rows positions, depth c
#pragma unroll
        for (int i = 0; i < G::kMI; ++i)
          ldsm_x4(af[i], a_ptr<G::kXLd>(xs, G::kMw * wm + 16 * i + t, 16 * kk));
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // B = W[t]: depth c, columns o
          uint32_t bf[4];
          ldsm_x4_t(bf, a_ptr<G::kWLd>(wt + t * KC * G::kWLd, 16 * kk,
                                       32 * wn + 16 * q));
#pragma unroll
          for (int i = 0; i < G::kMI; ++i) {
            mma(acc[i][2 * q], af[i], bf[0], bf[1]);
            mma(acc[i][2 * q + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    slot = slot + 1 == kFwRing ? 0 : slot + 1;
    if (++r_c == per_stage) {
      epilogue(st_begin + sl_c);
      r_c = 0;
      ++sl_c;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups

  // the run's column sums: over the 8 rows of each lane quad by shuffles,
  // then over the warps along the positions in order; the same bits
  // every run
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = s1[j][e], v2 = s2[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = 32 * wn + 8 * j + 2 * t4 + e;
        red[wm * BN + col] = v1;
        red[(G::kWarpsM + wm) * BN + col] = v2;
      }
    }
  __syncthreads();
  if (tid < BN && o0 + tid < a.Co) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < G::kWarpsM; ++k) {
      v1 += red[k * BN + tid];
      v2 += red[(G::kWarpsM + k) * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.Co + o0 + tid;
    a.s1[at] = v1;
    a.s2[at] = v2;
  }
}

template <int BN, int KC, bool RES>
cudaError_t launch_fwd_mma(const FwArgs<bf16>& a, unsigned tiles,
                           unsigned runs, cudaStream_t stream) {
  constexpr size_t smem = FwTc<BN, KC, RES>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_fwd_mma<BN, KC, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_conv3_bn_fwd_mma<BN, KC, RES>
      <<<dim3(tiles, runs), kFwThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// dx in bfloat16 on the tensor cores.  See the note at the top.

using mx::unpack;

// fused_conv3_bn_dx_mma's tile: BN input channels c a block (64, or 128
// where C > 64), KC output channels o a step, a ring of RING steps.  A
// ring slot holds one step's operands: the dyt tile ([position][o], one
// row below its position, a zero guard row either side; rows padded by
// 16 bytes), the step's raw y rows (read back only by the thread that
// copied them) and, unless RES, W's three taps of the step's kernel row
// as [t][c][o] tiles.  RES (C and Co <= KC = 64): the block's whole W
// slice stays in shared memory for its run, and a ring of two steps
// leaves room for it at two blocks an SM.  W's rows are swizzled rather
// than padded (w_at), so that ldmatrix's eight rows fall on distinct
// banks.
template <int BN, int KC, bool RES, int RING>
struct DxTc {
  static constexpr int kWarpsN = BN / 32;          // 32 channels a warp
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMw = kTcPos / kWarpsM;     // positions a warp
  static constexpr int kMI = kMw / 16;             // its m16 tiles
  static constexpr int kDLd = KC + 8;              // dyt row stride
  static constexpr int kDTile = kTcXRows * kDLd;
  static constexpr int kYTile = kTcPos * KC;
  static constexpr int kWTile = 3 * BN * KC;       // a kernel row's taps
  static constexpr int kSlot = kDTile + kYTile + (RES ? 0 : kWTile);
  static constexpr int kRowChunks = KC / 8;        // uint4 of a position
  static constexpr int kChunks = kTcPos * kRowChunks / kFwThreads;
  static constexpr int kWChunks = 3 * BN * kRowChunks / kFwThreads;
  static constexpr size_t kSmem =
      (RING * kSlot + (RES ? 3 * kWTile : 0)) * sizeof(bf16) +
      (2 + 2 * kWarpsM) * BN * sizeof(float);
};

// Element (row, 8 * chunk) of a swizzled W tile of KC-value rows: chunk
// k of row r is stored at chunk k ^ (r % 8) (KC = 64, 128-byte rows), k
// ^ (r / 2 % 4) (KC = 32, 64-byte rows).
template <int KC>
__device__ __forceinline__ int w_at(int row, int chunk) {
  return row * KC + ((chunk ^ (KC == 64 ? row & 7 : row >> 1 & 3)) << 3);
}

// The arguments of the dx tiles: T = bf16 (fused_conv3_bn_dx_mma) or
// float (fused_conv3_bn_dx_tf32).
template <typename T>
struct DxArgs {
  const T* x;           // (M, C)
  const T* w;           // (9, C, Co)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  const T* y;           // (M, Co)
  const T* dy;          // (M, Co)
  const float* ds1;     // (Co,)
  const float* ds2;     // (Co,)
  T* dx;                // (M, C)
  float* dscale;        // (runs, C), written only with the prologue
  float* dbias;         // (runs, C)
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int vec;              // bit 0: x loads a pair at a time; bit 1: y and
                        // dy load 16 bytes; bit 2: w does
  int seg_w;            // the pixel walk of tc_geometry
  int stage_segs;
  int row_segs;
  int segs;             // N * H * row_segs
  int stages;           // ceil(segs / stage_segs)
  int run_stages;       // stages of a run (the last run: fewer)
};

// Grid (ceil(C / BN), runs): block (j, r) computes dx at input channels
// [j BN, (j + 1) BN) for every pixel of run r's stages, a stage at a
// time, and with the prologue writes its float32 sums of dz*x and dz to
// dscale[r], dbias[r].  A stage's depth runs in steps (dh, chunk of KC
// output channels): dyt of image row h - dh as a [position][o] tile one
// row below its position, so that tap dw of the kernel row (which reads
// dyt at w - dw) is the tile at row offset 1 - dw; W[3 (dh + 1) + dw +
// 1]'s [c][o] chunk is B as it lies.
template <int BN, int KC, bool RES, int RING>
__global__ void __launch_bounds__(kFwThreads, 2)
    fused_conv3_bn_dx_mma(DxArgs<bf16> a) {
  using G = DxTc<BN, KC, RES, RING>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* wres = ring + RING * G::kSlot;  // RES: W[3 (dh + 1) + t][c][o]
  float* sc_s = reinterpret_cast<float*>(wres + (RES ? 3 * G::kWTile : 0));
  float* bi_s = sc_s + BN;
  float* red = bi_s + BN;  // [dscale, dbias][position warp][column]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * BN;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const int nck = (a.Co + KC - 1) / KC;  // output-channel chunks: 1 if RES
  const int per_stage = 3 * nck;               // steps a stage
  const int nsteps = (st_end - st_begin) * per_stage;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2, vec_w = a.vec & 4;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses

  // The dyt tiles start at 0: the guard rows and the positions past a
  // stage's segments are never written again.  The per-channel
  // constants are 0 past C (a zero channel stays zero).  The barrier
  // keeps both ahead of the copies and of their readers.
  for (int s = 0; s < RING; ++s) {
    uint4* z = reinterpret_cast<uint4*>(ring + s * G::kSlot);
    for (int i = tid; i < G::kDTile / 8; i += kFwThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < BN; i += kFwThreads) {
    const bool in = a.prologue && c0 + i < a.C;
    sc_s[i] = in ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in ? a.bias[c0 + i] : 0.f;
  }
  __syncthreads();

  // This thread's chunks: positions pos[i] of a stage, output channels
  // cc .. cc + 7 of a step's chunk; it loads y and dy there and turns
  // them into dyt itself, so no barrier separates the two.  A
  // position's segment and place in it are fixed; its pixel follows the
  // stage (locate), as in the forward.
  const int cc = (tid % G::kRowChunks) * 8;
  int pos[G::kChunks], sg[G::kChunks], place[G::kChunks];
  int64_t pix[G::kChunks];  // its pixel (n, h, w) as a row of dy, or -1
  int hrow[G::kChunks];     // its h
#pragma unroll
  for (int i = 0; i < G::kChunks; ++i) {
    pos[i] = tid / G::kRowChunks + (kFwThreads / G::kRowChunks) * i;
    sg[i] = pos[i] / pitch;
    place[i] = pos[i] - sg[i] * pitch;
  }
  int ld_stage = -1;
  auto locate = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      const int seg = st * a.stage_segs + sg[i];
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + place[i] - 1;
      const bool ok = pos[i] < npos && seg < a.segs && w >= 0 && w < a.W;
      pix[i] = ok ? static_cast<int64_t>(img_row) * a.W + w : -1;
      hrow[i] = img_row % a.H;
    }
  };

  // W[3 (dh + 1) + t][c0 + c][o0 + o] for t < 3, c < BN, o < KC into a
  // swizzled [t][c][o] tile; 0 past C and Co.
  auto load_w = [&](bf16* dst, int dh, int o0) {
#pragma unroll
    for (int j = 0; j < G::kWChunks; ++j) {
      const int e = tid + kFwThreads * j;
      const int row = e / G::kRowChunks, ch = e - row * G::kRowChunks;
      const int t = row / BN, c = c0 + row - t * BN;
      const bool in = c < a.C;
      const bf16* src =
          a.w + (in ? static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c : 0) *
                    a.Co;
      bf16* d = dst + w_at<KC>(row, ch);
      if (vec_w) {
        const bool full = in && o0 + 8 * ch < a.Co;
        cp_async16(d, full ? src + o0 + 8 * ch : a.w, full);
      } else {
        *reinterpret_cast<uint4*>(d) =
            load8(src, o0 + 8 * ch, a.Co, in, false);
      }
    }
  };

  // Loads step k of the run into ring slot `slot`: y and dy of image row
  // h - dh at every position (cp.async of 16 bytes, zeros where a chunk
  // lies outside; element loads where a start or Co does not allow 16
  // bytes), dy into the dyt tile, and W's chunk; returns the flags: bit
  // i, chunk i's pixel lies in the image.
  auto load_step = [&](int k, int slot) {
    const int sl = k / per_stage, r = k - sl * per_stage;
    const int dh = r / nck - 1, o0 = (r % nck) * KC;
    if (sl != ld_stage) {
      locate(st_begin + sl);
      ld_stage = sl;
    }
    unsigned flags = 0;
    bf16* ds = ring + slot * G::kSlot;
    bf16* ys = ds + G::kDTile;
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      if (pos[i] >= npos) continue;
      const int hh = hrow[i] - dh;
      const bool in = pix[i] >= 0 && hh >= 0 && hh < a.H;
      flags |= (in ? 1u : 0u) << i;
      const int64_t row =
          (in ? pix[i] - static_cast<int64_t>(dh) * a.W : 0) * a.Co;
      bf16* dd = ds + (pos[i] + 1) * G::kDLd + cc;
      bf16* yd = ys + pos[i] * KC + cc;
      if (vec_y) {
        const bool full = in && o0 + cc < a.Co;
        cp_async16(yd, full ? a.y + row + o0 + cc : a.y, full);
        cp_async16(dd, full ? a.dy + row + o0 + cc : a.dy, full);
      } else {
        *reinterpret_cast<uint4*>(yd) =
            load8(a.y + row, o0 + cc, a.Co, in, false);
        *reinterpret_cast<uint4*>(dd) =
            load8(a.dy + row, o0 + cc, a.Co, in, false);
      }
    }
    if (!RES) load_w(ys + G::kYTile, dh, o0);
    return flags;
  };

  // x[m, c] and x[m, c + 1] as a bf16 pair, 0 past C; `at` is m * C
  auto x_pair = [&](int64_t at, int c) -> uint32_t {
    if (c >= a.C) return 0u;
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(a.x + at + c);
    if (vec_x) return __ldg(reinterpret_cast<const unsigned int*>(p));
    return static_cast<uint32_t>(p[0]) |
           (c + 1 < a.C ? static_cast<uint32_t>(p[1]) << 16 : 0u);
  };

  float acc[G::kMI][4][4];
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float dsc[4][2], dbi[4][2];  // this thread's column sums of dz*x, dz
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dsc[j][0] = dsc[j][1] = dbi[j][0] = dbi[j][1] = 0.f;

  // Stage st's epilogue in the accumulator layout, at the segments' own
  // pixels (a halo position's sums and those past the segments are
  // dropped): with the prologue z = x*scale + bias, dz = dxn where z >
  // 0, dx = dz*scale, and dz*x and dz added to the column sums; dx
  // rounded to bf16 in pairs and stored; the sums cleared.
  const bool pairs = (a.C & 1) == 0;  // bf16 pairs stay 4-byte aligned
  auto epilogue = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = G::kMw * wm + 16 * i + g + 8 * hf;
        const int sgq = q / pitch, p = q - sgq * pitch;
        const int seg = st * a.stage_segs + sgq;
        const int img_row = seg / a.row_segs;
        const int w = (seg - img_row * a.row_segs) * a.seg_w + p - 1;
        const bool keep =
            q < npos && p >= 1 && p <= a.seg_w && seg < a.segs && w < a.W;
        const int64_t at =
            (keep ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = 32 * wn + 8 * j + 2 * t4, c = c0 + cl;
          float v0 = acc[i][j][2 * hf], v1 = acc[i][j][2 * hf + 1];
          acc[i][j][2 * hf] = acc[i][j][2 * hf + 1] = 0.f;
          if (!keep) continue;
          if (a.prologue) {
            const float2 xf = unpack(x_pair(at, c));
            const float sc0 = sc_s[cl], sc1 = sc_s[cl + 1];
            const float dz0 =
                __fadd_rn(__fmul_rn(xf.x, sc0), bi_s[cl]) > 0.f ? v0 : 0.f;
            const float dz1 =
                __fadd_rn(__fmul_rn(xf.y, sc1), bi_s[cl + 1]) > 0.f ? v1
                                                                     : 0.f;
            dsc[j][0] += dz0 * xf.x;
            dsc[j][1] += dz1 * xf.y;
            dbi[j][0] += dz0;
            dbi[j][1] += dz1;
            v0 = __fmul_rn(dz0, sc0);
            v1 = __fmul_rn(dz1, sc1);
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          bf16* out = a.dx + at + c;
          if (pairs && c + 1 < a.C) {
            *reinterpret_cast<__nv_bfloat162*>(out) = v;
          } else {
            if (c < a.C) out[0] = v.x;
            if (c + 1 < a.C) out[1] = v.y;
          }
        }
      }
  };

  // the resident W joins step 0's group; then the first RING - 1 steps
  // in flight, one group a step (empty past the run), so that a wait
  // counts steps
  if (RES) {
#pragma unroll
    for (int dh = -1; dh <= 1; ++dh)
      load_w(wres + (dh + 1) * G::kWTile, dh, 0);
  }
  constexpr unsigned kMask = (1u << G::kChunks) - 1;
  unsigned ring_flags = 0;  // G::kChunks bits a slot
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (G::kChunks * k);
    cp_async_commit();
  }
  int slot = 0, r_c = 0, sl_c = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int dh = r_c / nck - 1, o0 = (r_c % nck) * KC;
    bf16* ds = ring + slot * G::kSlot;
    const bf16* ys = ds + G::kDTile;
    const bf16* ws = RES ? wres + (dh + 1) * G::kWTile : ys + G::kYTile;
    cp_async_wait<RING - 2>();  // this thread's chunks of step s
    {  // dyt in place of dy, rounded to bf16; 0 outside the image
      float d1[8], d2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o0 + cc + j;
        d1[j] = o < a.Co ? __ldg(a.ds1 + o) : 0.f;
        d2[j] = o < a.Co ? __ldg(a.ds2 + o) : 0.f;
      }
      const unsigned flags = ring_flags >> (G::kChunks * slot);
#pragma unroll
      for (int i = 0; i < G::kChunks; ++i) {
        if (pos[i] >= npos) continue;
        uint4* d = reinterpret_cast<uint4*>(ds + (pos[i] + 1) * G::kDLd + cc);
        *d = flags >> i & 1
                 ? dyt8(*reinterpret_cast<const uint4*>(ys + pos[i] * KC + cc),
                        *d, d1, d2)
                 : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // step s + RING - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? RING - 1 : slot - 1;
    if (s + RING - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (G::kChunks * next))) |
                   load_step(s + RING - 1, next) << (G::kChunks * next);
    cp_async_commit();
    const int ksteps = ((a.Co - o0 < KC ? a.Co - o0 : KC) + 15) / 16;
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // tap dw = t - 1: row offset 2 - t
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (kk >= ksteps) break;
        uint32_t af[G::kMI][4];  // A = dyt: rows positions, depth o
#pragma unroll
        for (int i = 0; i < G::kMI; ++i)
          ldsm_x4(af[i], a_ptr<G::kDLd>(ds, G::kMw * wm + 16 * i + 2 - t,
                                        16 * kk));
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // B = W[t]: rows c, depth o
          const int row = t * BN + 32 * wn + 16 * q + (lane & 7) +
                          ((lane >> 4) << 3);
          uint32_t bf[4];
          ldsm_x4(bf, ws + w_at<KC>(row, 2 * kk + (lane >> 3 & 1)));
#pragma unroll
          for (int i = 0; i < G::kMI; ++i) {
            mma(acc[i][2 * q], af[i], bf[0], bf[1]);
            mma(acc[i][2 * q + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    slot = slot + 1 == RING ? 0 : slot + 1;
    if (++r_c == per_stage) {
      epilogue(st_begin + sl_c);
      r_c = 0;
      ++sl_c;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups
  if (!a.prologue) return;  // uniform across the block

  // the run's column sums: over the 8 rows of each lane quad by shuffles,
  // then over the warps along the positions in order; the same bits
  // every run
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = dsc[j][e], v2 = dbi[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = 32 * wn + 8 * j + 2 * t4 + e;
        red[wm * BN + col] = v1;
        red[(G::kWarpsM + wm) * BN + col] = v2;
      }
    }
  __syncthreads();
  if (tid < BN && c0 + tid < a.C) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < G::kWarpsM; ++k) {
      v1 += red[k * BN + tid];
      v2 += red[(G::kWarpsM + k) * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.C + c0 + tid;
    a.dscale[at] = v1;
    a.dbias[at] = v2;
  }
}

template <int BN, int KC, bool RES, int RING>
cudaError_t launch_dx_mma(const DxArgs<bf16>& a, unsigned tiles, unsigned runs,
                          cudaStream_t stream) {
  constexpr size_t smem = DxTc<BN, KC, RES, RING>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dx_mma<BN, KC, RES, RING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_conv3_bn_dx_mma<BN, KC, RES, RING>
      <<<dim3(tiles, runs), kFwThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// dx in float32 on the tensor cores (3xTF32).  See the note at the top.

constexpr int kXtBN = 64;              // input channels c a block owns
constexpr int kXtKC = 32;              // output channels o a step
constexpr int kXtLd = kXtKC + 4;       // float row stride: 36, see below
constexpr int kXtWarpsM = 4;           // 4 warps over positions x 2 over c
constexpr int kXtMw = kTcPos / kXtWarpsM;           // 16 positions a warp
constexpr int kXtDTile = kTcXRows * kXtLd;          // dyt's hi, or its lo
constexpr int kXtWTile = 3 * kXtBN * kXtLd;         // a kernel row's taps
constexpr int kXtSlot = 2 * kXtDTile + kXtWTile;    // floats
constexpr int kXtRowChunks = kXtKC / 4;             // float4 of a position
constexpr int kXtChunks = kTcPos * kXtRowChunks / kFwThreads;
constexpr int kXtWChunks = 3 * kXtBN * kXtRowChunks / kFwThreads;
constexpr int kXtRing = 2;             // steps: one loads while one multiplies
// A ring slot holds a step: dy, turned in place into dyt's tf32 hi, and
// y, turned into its lo (both [position][o], one row below the position,
// a zero guard row either side), then W's three taps of the step's
// kernel row as [t][c][o]; after the ring, scale and bias of the tile's
// channels and the [dscale, dbias][position warp][c] sums.  A row
// stride of 36 floats puts the 32 lanes of a fragment load (a lane reads
// row g, column t4) on 32 distinct banks.
constexpr size_t kXtSmem =
    (kXtRing * kXtSlot + (2 + 2 * kXtWarpsM) * kXtBN) * sizeof(float);

// Grid (ceil(C / 64), runs), as fused_conv3_bn_dx_mma's: block (j, r)
// computes dx at input channels [64 j, 64 (j + 1)) for every pixel of run
// r's stages, a stage at a time, and with the prologue writes its float32
// sums of dz*x and dz to dscale[r], dbias[r].  A stage's depth runs in
// steps (dh, chunk of 32 output channels), each the bf16 tile's.
__global__ void __launch_bounds__(kFwThreads, 2)
    fused_conv3_bn_dx_tf32(DxArgs<float> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sc_s = ring + kXtRing * kXtSlot;
  float* bi_s = sc_s + kXtBN;
  float* red = bi_s + kXtBN;  // [dscale, dbias][position warp][column]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kXtWarpsM, wn = warp / kXtWarpsM;  // 16 x 32
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * kXtBN;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const int nck = (a.Co + kXtKC - 1) / kXtKC;  // output-channel chunks
  const int per_stage = 3 * nck;              // steps a stage
  const int nsteps = (st_end - st_begin) * per_stage;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2, vec_w = a.vec & 4;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses

  // The dyt tiles start at 0: the guard rows and the positions past a
  // stage's segments are never written again.  The per-channel
  // constants are 0 past C (a zero channel stays zero).  The barrier
  // keeps both ahead of the copies and of their readers.
  for (int s = 0; s < kXtRing; ++s) {
    float4* z = reinterpret_cast<float4*>(ring + s * kXtSlot);
    for (int i = tid; i < 2 * kXtDTile / 4; i += kFwThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < kXtBN; i += kFwThreads) {
    const bool in = a.prologue && c0 + i < a.C;
    sc_s[i] = in ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in ? a.bias[c0 + i] : 0.f;
  }
  __syncthreads();

  // This thread's chunks: positions pos[i] of a stage, output channels
  // cc .. cc + 3 of a step's chunk; it copies y and dy there and turns
  // them into dyt itself, so no barrier separates the two.  A
  // position's segment and place in it are fixed; its pixel follows the
  // stage (locate), as in the bf16 tile.
  const int cc = (tid % kXtRowChunks) * 4;
  int pos[kXtChunks], sg[kXtChunks], place[kXtChunks];
  int64_t pix[kXtChunks];  // its pixel (n, h, w) as a row of dy, or -1
  int hrow[kXtChunks];     // its h
#pragma unroll
  for (int i = 0; i < kXtChunks; ++i) {
    pos[i] = tid / kXtRowChunks + (kFwThreads / kXtRowChunks) * i;
    sg[i] = pos[i] / pitch;
    place[i] = pos[i] - sg[i] * pitch;
  }
  int ld_stage = -1;
  auto locate = [&](int st) {
#pragma unroll
    for (int i = 0; i < kXtChunks; ++i) {
      const int seg = st * a.stage_segs + sg[i];
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + place[i] - 1;
      const bool ok = pos[i] < npos && seg < a.segs && w >= 0 && w < a.W;
      pix[i] = ok ? static_cast<int64_t>(img_row) * a.W + w : -1;
      hrow[i] = img_row % a.H;
    }
  };

  // W[3 (dh + 1) + t][c0 + c][o0 + o] for t < 3, c < 64, o < 32 into a
  // [t][c][o] tile; 0 past C and Co.
  auto load_w = [&](float* dst, int dh, int o0) {
#pragma unroll
    for (int j = 0; j < kXtWChunks; ++j) {
      const int e = tid + kFwThreads * j;
      const int row = e / kXtRowChunks, ch = e - row * kXtRowChunks;
      const int t = row / kXtBN, c = c0 + row - t * kXtBN;
      const bool in = c < a.C;
      const float* src =
          a.w + (in ? static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c : 0) *
                    a.Co;
      float* d = dst + row * kXtLd + 4 * ch;
      if (vec_w) {
        const bool full = in && o0 + 4 * ch < a.Co;
        cp_async16(d, full ? src + o0 + 4 * ch : a.w, full);
      } else {
        *reinterpret_cast<float4*>(d) = load4(src, o0 + 4 * ch, a.Co, in);
      }
    }
  };

  // Loads step k of the run into ring slot `slot`: dy and y of image row
  // h - dh at every position into the dyt tiles (cp.async of 16 bytes,
  // zeros where a chunk lies outside; element loads where a start or Co
  // does not allow 16 bytes), and W's chunk; returns the flags: bit i,
  // chunk i's pixel lies in the image.
  auto load_step = [&](int k, int slot) {
    const int sl = k / per_stage, r = k - sl * per_stage;
    const int dh = r / nck - 1, o0 = (r % nck) * kXtKC;
    if (sl != ld_stage) {
      locate(st_begin + sl);
      ld_stage = sl;
    }
    unsigned flags = 0;
    float* dhi = ring + slot * kXtSlot;
    float* dlo = dhi + kXtDTile;
#pragma unroll
    for (int i = 0; i < kXtChunks; ++i) {
      if (pos[i] >= npos) continue;
      const int hh = hrow[i] - dh;
      const bool in = pix[i] >= 0 && hh >= 0 && hh < a.H;
      flags |= (in ? 1u : 0u) << i;
      const int64_t row =
          (in ? pix[i] - static_cast<int64_t>(dh) * a.W : 0) * a.Co;
      const int at = (pos[i] + 1) * kXtLd + cc;
      if (vec_y) {
        const bool full = in && o0 + cc < a.Co;
        cp_async16(dlo + at, full ? a.y + row + o0 + cc : a.y, full);
        cp_async16(dhi + at, full ? a.dy + row + o0 + cc : a.dy, full);
      } else {
        *reinterpret_cast<float4*>(dlo + at) =
            load4(a.y + row, o0 + cc, a.Co, in);
        *reinterpret_cast<float4*>(dhi + at) =
            load4(a.dy + row, o0 + cc, a.Co, in);
      }
    }
    load_w(dlo + kXtDTile, dh, o0);
    return flags;
  };

  // x[m, c] and x[m, c + 1], 0 past C; `at` is m * C
  auto x_pair = [&](int64_t at, int c) -> float2 {
    if (c >= a.C) return make_float2(0.f, 0.f);
    const float* p = a.x + at + c;
    if (vec_x) return __ldg(reinterpret_cast<const float2*>(p));
    return make_float2(__ldg(p), c + 1 < a.C ? __ldg(p + 1) : 0.f);
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float dsc[4][2], dbi[4][2];  // this thread's column sums of dz*x, dz
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dsc[j][0] = dsc[j][1] = dbi[j][0] = dbi[j][1] = 0.f;

  // Stage st's epilogue in the accumulator layout, at the segments' own
  // pixels (a halo position's sums and those past the segments are
  // dropped): with the prologue z = x*scale + bias, dz = dxn where z >
  // 0, dx = dz*scale, and dz*x and dz added to the column sums; dx
  // stored in pairs; the sums cleared.
  const bool pairs = (a.C & 1) == 0;  // float2 stores stay 8-byte aligned
  auto epilogue = [&](int st) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = kXtMw * wm + g + 8 * hf;
      const int sgq = q / pitch, p = q - sgq * pitch;
      const int seg = st * a.stage_segs + sgq;
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + p - 1;
      const bool keep =
          q < npos && p >= 1 && p <= a.seg_w && seg < a.segs && w < a.W;
      const int64_t at =
          (keep ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 32 * wn + 8 * j + 2 * t4, c = c0 + cl;
        float v0 = acc[j][2 * hf], v1 = acc[j][2 * hf + 1];
        acc[j][2 * hf] = acc[j][2 * hf + 1] = 0.f;
        if (!keep) continue;
        if (a.prologue) {
          const float2 xf = x_pair(at, c);
          const float sc0 = sc_s[cl], sc1 = sc_s[cl + 1];
          const float dz0 =
              __fadd_rn(__fmul_rn(xf.x, sc0), bi_s[cl]) > 0.f ? v0 : 0.f;
          const float dz1 =
              __fadd_rn(__fmul_rn(xf.y, sc1), bi_s[cl + 1]) > 0.f ? v1
                                                                   : 0.f;
          dsc[j][0] += dz0 * xf.x;
          dsc[j][1] += dz1 * xf.y;
          dbi[j][0] += dz0;
          dbi[j][1] += dz1;
          v0 = __fmul_rn(dz0, sc0);
          v1 = __fmul_rn(dz1, sc1);
        }
        float* out = a.dx + at + c;
        if (pairs && c + 1 < a.C) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          if (c < a.C) out[0] = v0;
          if (c + 1 < a.C) out[1] = v1;
        }
      }
    }
  };

  // the first kXtRing - 1 steps in flight, one group a step (empty past
  // the run), so that a wait counts steps
  constexpr unsigned kMask = (1u << kXtChunks) - 1;
  unsigned ring_flags = 0;  // kXtChunks bits a slot
#pragma unroll
  for (int k = 0; k < kXtRing - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (kXtChunks * k);
    cp_async_commit();
  }
  int slot = 0, r_c = 0, sl_c = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int o0 = (r_c % nck) * kXtKC;
    float* dhi = ring + slot * kXtSlot;
    float* dlo = dhi + kXtDTile;
    const float* ws = dlo + kXtDTile;
    cp_async_wait<kXtRing - 2>();  // this thread's chunks of step s
    {  // dyt in float32, split into tf32 hi in place of dy and lo in place
       // of y; 0 outside the image (it is ds1 there)
      float d1[4], d2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + cc + j;
        d1[j] = o < a.Co ? __ldg(a.ds1 + o) : 0.f;
        d2[j] = o < a.Co ? __ldg(a.ds2 + o) : 0.f;
      }
      const unsigned flags = ring_flags >> (kXtChunks * slot);
#pragma unroll
      for (int i = 0; i < kXtChunks; ++i) {
        if (pos[i] >= npos) continue;
        const int at = (pos[i] + 1) * kXtLd + cc;
        float4* d = reinterpret_cast<float4*>(dhi + at);
        float4* yl = reinterpret_cast<float4*>(dlo + at);
        const float4 v = flags >> i & 1 ? dyt4(*yl, *d, d1, d2)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(d) = hi;
        *reinterpret_cast<uint4*>(yl) = lo;
      }
    }
    __syncthreads();
    // step s + kXtRing - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? kXtRing - 1 : slot - 1;
    if (s + kXtRing - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (kXtChunks * next))) |
                   load_step(s + kXtRing - 1, next) << (kXtChunks * next);
    cp_async_commit();
    // The step's products, its three taps over its chunk of o, go into a
    // part that starts at 0, and the part into acc, rounded to nearest:
    // the tensor core truncates each sum it returns, and one register for
    // a chain of all 9*C_out products drifts by as many ulps.  A = dyt
    // (rows positions at row offset 2 - t, depth o) as split; B = W[t]'s
    // [c][o] rows as they lie, split as loaded.
    const uint32_t* a_hi = reinterpret_cast<const uint32_t*>(dhi);
    const uint32_t* a_lo = reinterpret_cast<const uint32_t*>(dlo);
    const int ksteps = ((a.Co - o0 < kXtKC ? a.Co - o0 : kXtKC) + 7) / 8;
    float part[4][4] = {};
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // tap dw = t - 1: row offset 2 - t
#pragma unroll
      for (int kk = 0; kk < kXtKC / 8; ++kk) {
        if (kk >= ksteps) break;
        const int at = (kXtMw * wm + g + 2 - t) * kXtLd + 8 * kk + t4;
        const uint32_t ah[4] = {a_hi[at], a_hi[at + 8 * kXtLd], a_hi[at + 4],
                                a_hi[at + 8 * kXtLd + 4]};
        const uint32_t al[4] = {a_lo[at], a_lo[at + 8 * kXtLd], a_lo[at + 4],
                                a_lo[at + 8 * kXtLd + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* q =
              ws + (t * kXtBN + 32 * wn + 8 * j + g) * kXtLd + 8 * kk + t4;
          uint32_t bh[2], bl[2];
          split_tf32(q[0], bh[0], bl[0]);
          split_tf32(q[4], bh[1], bl[1]);
          mma_3xtf32(part[j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    slot = slot + 1 == kXtRing ? 0 : slot + 1;
    if (++r_c == per_stage) {
      epilogue(st_begin + sl_c);
      r_c = 0;
      ++sl_c;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups
  if (!a.prologue) return;  // uniform across the block

  // the run's column sums: over the 8 rows of each lane quad by shuffles,
  // then over the warps along the positions in order; the same bits
  // every run
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = dsc[j][e], v2 = dbi[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = 32 * wn + 8 * j + 2 * t4 + e;
        red[wm * kXtBN + col] = v1;
        red[(kXtWarpsM + wm) * kXtBN + col] = v2;
      }
    }
  __syncthreads();
  if (tid < kXtBN && c0 + tid < a.C) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < kXtWarpsM; ++k) {
      v1 += red[k * kXtBN + tid];
      v2 += red[(kXtWarpsM + k) * kXtBN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.C + c0 + tid;
    a.dscale[at] = v1;
    a.dbias[at] = v2;
  }
}

// ---------------------------------------------------------------------
// The forward in float32 on the tensor cores (3xTF32).  See the note at
// the top.

constexpr int kFtBN = 64;              // output channels o a block owns
constexpr int kFtKC = 32;              // input channels c a step
constexpr int kFtXLd = kFtKC + 4;      // xn row stride: 36, see below
constexpr int kFtWLd = kFtBN + 8;      // W row stride: 72, see below
constexpr int kFtWarpsM = 4;           // 4 warps over positions x 2 over o
constexpr int kFtMw = kTcPos / kFtWarpsM;           // 16 positions a warp
constexpr int kFtXTile = kTcXRows * kFtXLd;         // xn's hi, or its lo
constexpr int kFtWTile = 3 * kFtKC * kFtWLd;        // a kernel row's taps
constexpr int kFtSlot = 2 * kFtXTile + kFtWTile;    // floats
constexpr int kFtRowChunks = kFtKC / 4;             // float4 of a position
constexpr int kFtChunks = kTcPos * kFtRowChunks / kFwThreads;
constexpr int kFtWRowChunks = kFtBN / 4;            // float4 of a W row
constexpr int kFtWChunks = 3 * kFtKC * kFtWRowChunks / kFwThreads;
constexpr int kFtRing = 2;             // steps: one loads while one multiplies
constexpr int kFtYLd = 32 + 8;         // a warp's staging row of y
constexpr int kFtYTile = kFtMw * kFtYLd;
// A ring slot holds a step: x, turned in place into xn's tf32 hi, and
// xn's lo beside it (both [position][c], one row below the position, a
// zero guard row either side), then W's three taps of the step's kernel
// row as [t][c][o]; after the ring, each warp's staging tile of y.  Row
// strides of 36 floats (xn) and 72 (W) put the 32 lanes of a fragment
// load (A: row g, column t4; B: row t4, column g) on 32 distinct banks,
// and one of 40 the staging tile's float2 stores.  The run's sums of y
// and y^2 meet in the ring once the last step has left it.
constexpr size_t kFtSmem =
    (kFtRing * kFtSlot + 8 * kFtYTile) * sizeof(float);
static_assert(2 * kFtWarpsM * kFtBN <= kFtRing * kFtSlot, "sums in the ring");

// Grid (ceil(Co / 64), runs), as fused_conv3_bn_fwd_mma's: block (j, r)
// computes output channels [64 j, 64 (j + 1)) at every pixel of run r's
// stages, a stage at a time, and writes its float32 sums of y and y^2
// to s1[r], s2[r].  A stage's depth runs in steps (dh, chunk of 32 input
// channels): xn of image row h + dh one row below its position, so that
// tap dw is the tile at row offset dw + 1, and W[3 (dh + 1) + dw + 1]'s
// [c][o] rows for that chunk.
__global__ void __launch_bounds__(kFwThreads, 2)
    fused_conv3_bn_fwd_tf32(FwArgs<float> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* ystage = ring + kFtRing * kFtSlot;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kFtWarpsM, wn = warp / kFtWarpsM;  // 16 x 32
  const int g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * kFtBN;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const int nck = (a.C + kFtKC - 1) / kFtKC;  // input-channel chunks
  const int per_stage = 3 * nck;              // steps a stage
  const int nsteps = (st_end - st_begin) * per_stage;
  const bool vec_x = a.vec & 1, vec_w = a.vec & 2, vec_y = a.vec & 4;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses

  // The xn tiles start at 0: the guard rows and the positions past a
  // stage's segments are never written again.  The barrier keeps every
  // zero ahead of the copies that land in the ring.
  for (int s = 0; s < kFtRing; ++s) {
    float4* z = reinterpret_cast<float4*>(ring + s * kFtSlot);
    for (int i = tid; i < 2 * kFtXTile / 4; i += kFwThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // This thread's x chunks: positions pos[i] of a stage, channels cc ..
  // cc + 3 of a step's chunk; it copies them and turns them into xn
  // itself, so no barrier separates the two.  A position's segment and
  // place in it are fixed; its pixel follows the stage (locate), as in
  // the bf16 tile.
  const int cc = (tid % kFtRowChunks) * 4;
  int pos[kFtChunks], sg[kFtChunks], place[kFtChunks];
  int64_t pix[kFtChunks];  // its pixel (n, h, w) as a row of x, or -1
  int hrow[kFtChunks];     // its h
#pragma unroll
  for (int i = 0; i < kFtChunks; ++i) {
    pos[i] = tid / kFtRowChunks + (kFwThreads / kFtRowChunks) * i;
    sg[i] = pos[i] / pitch;
    place[i] = pos[i] - sg[i] * pitch;
  }
  int ld_stage = -1;
  auto locate = [&](int st) {
#pragma unroll
    for (int i = 0; i < kFtChunks; ++i) {
      const int seg = st * a.stage_segs + sg[i];
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + place[i] - 1;
      const bool ok = pos[i] < npos && seg < a.segs && w >= 0 && w < a.W;
      pix[i] = ok ? static_cast<int64_t>(img_row) * a.W + w : -1;
      hrow[i] = img_row % a.H;
    }
  };

  // W[3 (dh + 1) + t][c0 + c][o0 + o] for t < 3, c < 32, o < 64 into a
  // [t][c][o] tile; 0 past C and Co.
  auto load_w = [&](float* dst, int dh, int c0) {
#pragma unroll
    for (int j = 0; j < kFtWChunks; ++j) {
      const int e = tid + kFwThreads * j;
      const int row = e / kFtWRowChunks, ch = e - row * kFtWRowChunks;
      const int t = row / kFtKC, c = c0 + row - t * kFtKC;
      const bool in = c < a.C;
      const float* src =
          a.w + (in ? static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c : 0) *
                    a.Co;
      float* d = dst + row * kFtWLd + 4 * ch;
      if (vec_w) {
        const bool full = in && o0 + 4 * ch < a.Co;
        cp_async16(d, full ? src + o0 + 4 * ch : a.w, full);
      } else {
        *reinterpret_cast<float4*>(d) = load4(src, o0 + 4 * ch, a.Co, in);
      }
    }
  };

  // Loads step k of the run into ring slot `slot`: x of image row h + dh
  // at every position into the hi tile (cp.async of 16 bytes, zeros
  // where a chunk lies outside; element loads where a start or C does
  // not allow 16 bytes), and W's chunk; returns the flags: bit i, chunk
  // i's pixel lies in the image.
  auto load_step = [&](int k, int slot) {
    const int sl = k / per_stage, r = k - sl * per_stage;
    const int dh = r / nck - 1, c0 = (r % nck) * kFtKC;
    if (sl != ld_stage) {
      locate(st_begin + sl);
      ld_stage = sl;
    }
    unsigned flags = 0;
    float* xs = ring + slot * kFtSlot;
#pragma unroll
    for (int i = 0; i < kFtChunks; ++i) {
      if (pos[i] >= npos) continue;
      const int hh = hrow[i] + dh;
      const bool in = pix[i] >= 0 && hh >= 0 && hh < a.H;
      flags |= (in ? 1u : 0u) << i;
      const float* row =
          a.x + (in ? pix[i] + static_cast<int64_t>(dh) * a.W : 0) * a.C;
      float* d = xs + (pos[i] + 1) * kFtXLd + cc;
      if (vec_x) {
        const bool full = in && c0 + cc < a.C;
        cp_async16(d, full ? row + c0 + cc : a.x, full);
      } else {
        *reinterpret_cast<float4*>(d) = load4(row, c0 + cc, a.C, in);
      }
    }
    load_w(xs + 2 * kFtXTile, dh, c0);
    return flags;
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};

  // Stage st's epilogue: the warp's sums into its staging tile in pairs,
  // cleared; then its rows at the segments' own pixels (a halo position's
  // and those past the segments are dropped) stored, a lane's four
  // channels 16 bytes at a time where vec_y allows (whole 32-byte sectors
  // of a row), and added to the lane's column sums of y and y^2.
  float* yst = ystage + warp * kFtYTile;
  const int cl = 4 * (lane & 7);          // the lane's columns of the warp's
  const int oc = o0 + 32 * wn + cl;       // 32, and their first channel
  auto epilogue = [&](int st) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(yst + (g + 8 * hf) * kFtYLd + 8 * j +
                                   2 * t4) =
            make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        acc[j][2 * hf] = acc[j][2 * hf + 1] = 0.f;
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kFtMw / 4; ++it) {
      const int r = 4 * it + (lane >> 3);
      const int q = kFtMw * wm + r;
      const int sgq = q / pitch, p = q - sgq * pitch;
      const int seg = st * a.stage_segs + sgq;
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + p - 1;
      const bool keep =
          q < npos && p >= 1 && p <= a.seg_w && seg < a.segs && w < a.W;
      if (!keep || oc >= a.Co) continue;
      const float4 v = *reinterpret_cast<const float4*>(yst + r * kFtYLd + cl);
      float* out = a.y + (static_cast<int64_t>(img_row) * a.W + w) * a.Co + oc;
      const float f[4] = {v.x, v.y, v.z, v.w};
      if (vec_y) {
        *reinterpret_cast<float4*>(out) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (oc + e < a.Co) out[e] = f[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // 0 past Co: W's columns there are 0
        s1[e] += f[e];
        s2[e] += f[e] * f[e];
      }
    }
    __syncwarp();
  };

  // the first kFtRing - 1 steps in flight, one group a step (empty past
  // the run), so that a wait counts steps
  constexpr unsigned kMask = (1u << kFtChunks) - 1;
  unsigned ring_flags = 0;  // kFtChunks bits a slot
#pragma unroll
  for (int k = 0; k < kFtRing - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (kFtChunks * k);
    cp_async_commit();
  }
  int slot = 0, r_c = 0, sl_c = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int c0 = (r_c % nck) * kFtKC;
    float* xhi = ring + slot * kFtSlot;
    float* xlo = xhi + kFtXTile;
    const float* ws = xlo + kFtXTile;
    cp_async_wait<kFtRing - 2>();  // this thread's chunks of step s
    {  // xn = relu(x*scale + bias) in float32 (or x), 0 outside the image,
       // split into tf32 hi in place of x and lo beside it
      float sc[4], bi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + cc + j;
        const bool in = a.prologue && c < a.C;
        sc[j] = in ? __ldg(a.scale + c) : 0.f;
        bi[j] = in ? __ldg(a.bias + c) : 0.f;
      }
      const unsigned flags = ring_flags >> (kFtChunks * slot);
#pragma unroll
      for (int i = 0; i < kFtChunks; ++i) {
        if (pos[i] >= npos) continue;
        const int at = (pos[i] + 1) * kFtXLd + cc;
        float4* hp = reinterpret_cast<float4*>(xhi + at);
        float4 v = *hp;
        if (!(flags >> i & 1))
          v = make_float4(0.f, 0.f, 0.f, 0.f);
        else if (a.prologue)
          v = prologue4(v, sc, bi);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(hp) = hi;
        *reinterpret_cast<uint4*>(xlo + at) = lo;
      }
    }
    __syncthreads();
    // step s + kFtRing - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? kFtRing - 1 : slot - 1;
    if (s + kFtRing - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (kFtChunks * next))) |
                   load_step(s + kFtRing - 1, next) << (kFtChunks * next);
    cp_async_commit();
    // The step's products, its three taps over its chunk of c, go into a
    // part that starts at 0, and the part into acc, rounded to nearest:
    // the tensor core truncates each sum it returns, and one register for
    // a chain of all 9*C products drifts by as many ulps.  A = xn (rows
    // positions at row offset t, depth c) as split; B = W[t]'s [c][o]
    // rows, split as loaded.
    const uint32_t* a_hi = reinterpret_cast<const uint32_t*>(xhi);
    const uint32_t* a_lo = reinterpret_cast<const uint32_t*>(xlo);
    const int ksteps = ((a.C - c0 < kFtKC ? a.C - c0 : kFtKC) + 7) / 8;
    float part[4][4] = {};
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // tap dw = t - 1: row offset t
#pragma unroll
      for (int kk = 0; kk < kFtKC / 8; ++kk) {
        if (kk >= ksteps) break;
        const int at = (kFtMw * wm + g + t) * kFtXLd + 8 * kk + t4;
        const uint32_t ah[4] = {a_hi[at], a_hi[at + 8 * kFtXLd], a_hi[at + 4],
                                a_hi[at + 8 * kFtXLd + 4]};
        const uint32_t al[4] = {a_lo[at], a_lo[at + 8 * kFtXLd], a_lo[at + 4],
                                a_lo[at + 8 * kFtXLd + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* q =
              ws + (t * kFtKC + 8 * kk + t4) * kFtWLd + 32 * wn + 8 * j + g;
          uint32_t bh[2], bl[2];
          split_tf32(q[0], bh[0], bl[0]);
          split_tf32(q[4 * kFtWLd], bh[1], bl[1]);
          mma_3xtf32(part[j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    slot = slot + 1 == kFtRing ? 0 : slot + 1;
    if (++r_c == per_stage) {
      epilogue(st_begin + sl_c);
      r_c = 0;
      ++sl_c;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups
  __syncthreads();     // every warp has left the ring: it takes the sums

  // the run's column sums: over the 4 lanes of each column by shuffles,
  // then over the warps along the positions in order; the same bits
  // every run
  float* red = ring;  // [s1, s2][position warp][column]
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v1 = s1[e], v2 = s2[e];
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      v1 += __shfl_xor_sync(0xffffffffu, v1, off);
      v2 += __shfl_xor_sync(0xffffffffu, v2, off);
    }
    if (lane < 8) {
      const int col = 32 * wn + cl + e;
      red[wm * kFtBN + col] = v1;
      red[(kFtWarpsM + wm) * kFtBN + col] = v2;
    }
  }
  __syncthreads();
  if (tid < kFtBN && o0 + tid < a.Co) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < kFtWarpsM; ++k) {
      v1 += red[k * kFtBN + tid];
      v2 += red[(kFtWarpsM + k) * kFtBN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.Co + o0 + tid;
    a.s1[at] = v1;
    a.s2[at] = v2;
  }
}

// Fills the arguments of a dw tile and its grid (3 * tiles of (c, o),
// runs); false where the runs do not tile the walk's stages.
template <typename T>
bool dw_args(DwArgs<T>* a, const void* x, const void* scale,
             const void* bias, int prologue, const void* y, const void* dy,
             const void* ds1, const void* ds2, void* dw_part, long long N,
             int H, int W, int C, int Co, long long run_stages,
             long long runs, int vec, dim3* grid) {
  tc_geometry(W, &a->seg_w, &a->stage_segs, &a->row_segs);
  const long long segs = N * H * a->row_segs;   // at most N*H*W
  const long long stages = ceil_div(segs, a->stage_segs);
  const long long tiles =
      3 * ceil_div(C, kTcTile) * ceil_div(Co, kTcTile);
  if (run_stages <= 0 || run_stages > stages ||
      runs != ceil_div(stages, run_stages) || runs > 65535 ||
      tiles > 0x7fffffffLL)
    return false;
  a->x = static_cast<const T*>(x);
  a->scale = static_cast<const float*>(scale);
  a->bias = static_cast<const float*>(bias);
  a->y = static_cast<const T*>(y);
  a->dy = static_cast<const T*>(dy);
  a->ds1 = static_cast<const float*>(ds1);
  a->ds2 = static_cast<const float*>(ds2);
  a->part = static_cast<float*>(dw_part);
  a->H = H;
  a->W = W;
  a->C = C;
  a->Co = Co;
  a->prologue = prologue;
  a->vec = vec;
  a->segs = static_cast<int>(segs);
  a->stages = static_cast<int>(stages);
  a->run_stages = static_cast<int>(run_stages);
  *grid = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(runs));
  return true;
}

// Fills the arguments of a dx tile of bn input channels a block; false
// where the runs do not tile the walk's stages.
template <typename T>
bool dx_args(DxArgs<T>* a, const void* x, const void* w, const void* scale,
             const void* bias, int prologue, const void* y, const void* dy,
             const void* ds1, const void* ds2, void* dx, void* dscale_part,
             void* dbias_part, long long N, int H, int W, int C, int Co,
             long long run_stages, long long runs, int vec, int bn) {
  tc_geometry(W, &a->seg_w, &a->stage_segs, &a->row_segs);
  const long long segs = N * H * a->row_segs;   // at most N*H*W
  const long long stages = ceil_div(segs, a->stage_segs);
  if (run_stages <= 0 || run_stages > stages ||
      runs != ceil_div(stages, run_stages) || runs > 65535 ||
      ceil_div(C, bn) > 0x7fffffffLL)
    return false;
  a->x = static_cast<const T*>(x);
  a->w = static_cast<const T*>(w);
  a->scale = static_cast<const float*>(scale);
  a->bias = static_cast<const float*>(bias);
  a->y = static_cast<const T*>(y);
  a->dy = static_cast<const T*>(dy);
  a->ds1 = static_cast<const float*>(ds1);
  a->ds2 = static_cast<const float*>(ds2);
  a->dx = static_cast<T*>(dx);
  a->dscale = static_cast<float*>(dscale_part);
  a->dbias = static_cast<float*>(dbias_part);
  a->H = H;
  a->W = W;
  a->C = C;
  a->Co = Co;
  a->prologue = prologue;
  a->vec = vec;
  a->segs = static_cast<int>(segs);
  a->stages = static_cast<int>(stages);
  a->run_stages = static_cast<int>(run_stages);
  return true;
}

// Fills the arguments of a forward tile of bn output channels a block;
// false where the runs do not tile the walk's stages.
template <typename T>
bool fw_args(FwArgs<T>* a, const void* x, const void* w, const void* scale,
             const void* bias, int prologue, void* y, void* s1_part,
             void* s2_part, long long N, int H, int W, int C, int Co,
             long long run_stages, long long runs, int vec, int bn) {
  tc_geometry(W, &a->seg_w, &a->stage_segs, &a->row_segs);
  const long long segs = N * H * a->row_segs;   // at most N*H*W
  const long long stages = ceil_div(segs, a->stage_segs);
  if (run_stages <= 0 || run_stages > stages ||
      runs != ceil_div(stages, run_stages) || runs > 65535 ||
      ceil_div(Co, bn) > 0x7fffffffLL)
    return false;
  a->x = static_cast<const T*>(x);
  a->w = static_cast<const T*>(w);
  a->scale = static_cast<const float*>(scale);
  a->bias = static_cast<const float*>(bias);
  a->y = static_cast<T*>(y);
  a->s1 = static_cast<float*>(s1_part);
  a->s2 = static_cast<float*>(s2_part);
  a->H = H;
  a->W = W;
  a->C = C;
  a->Co = Co;
  a->prologue = prologue;
  a->vec = vec;
  a->segs = static_cast<int>(segs);
  a->stages = static_cast<int>(stages);
  a->run_stages = static_cast<int>(run_stages);
  return true;
}

}  // namespace

// The bfloat16 dw on the tensor cores.  x (N, H, W, C), y and dy
// (N, H, W, Co) bfloat16, contiguous; scale and bias (C,) float32, read
// only when prologue is 1; ds1 and ds2 (Co,) float32.  The pixels are
// walked in segments of image rows (tc_geometry: segments of min(W, 62)
// pixels, 64 / (seg + 2) of them a stage); dw_part is (runs, 9*C, Co)
// float32, one partial of the (3, 3, C, Co) gradient for each run of
// run_stages stages (the last run may be shorter), with runs =
// ceil(stages / run_stages), every element written.  x loads 16 bytes at
// a time where bit 0 of vec is set (x 16-byte aligned, C a multiple of
// 8), y and dy where bit 1 is (both aligned, Co a multiple of 8).
extern "C" int mx_fused_conv3_bn_dw_mma(const void* x, const void* scale,
                                        const void* bias, int prologue,
                                        const void* y, const void* dy,
                                        const void* ds1, const void* ds2,
                                        void* dw_part, long long N, int H,
                                        int W, int C, int Co,
                                        long long run_stages, long long runs,
                                        int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  TcArgs a;
  dim3 grid;
  if (!dw_args(&a, x, scale, bias, prologue, y, dy, ds1, ds2, dw_part, N, H,
               W, C, Co, run_stages, runs, vec, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dw_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_conv3_bn_dw_mma<<<grid, kTcThreads, kTcSmem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The float32 dw on the tensor cores (3xTF32): as
// mx_fused_conv3_bn_dw_mma, with x, y and dy float32, on the same walk
// and runs; x loads 16 bytes at a time where bit 0 of vec is set (x
// 16-byte aligned, C a multiple of 4), y and dy where bit 1 is (both
// aligned, Co a multiple of 4).
extern "C" int mx_fused_conv3_bn_dw_tf32(const void* x, const void* scale,
                                         const void* bias, int prologue,
                                         const void* y, const void* dy,
                                         const void* ds1, const void* ds2,
                                         void* dw_part, long long N, int H,
                                         int W, int C, int Co,
                                         long long run_stages, long long runs,
                                         int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  DwArgs<float> a;
  dim3 grid;
  if (!dw_args(&a, x, scale, bias, prologue, y, dy, ds1, ds2, dw_part, N, H,
               W, C, Co, run_stages, runs, vec, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = DwTf<kTfRing>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dw_tf32<kTfRing>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_conv3_bn_dw_tf32<kTfRing><<<grid, kTcThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 forward on the tensor cores.  x (N, H, W, C) and w (3, 3,
// C, Co) bfloat16, contiguous; scale and bias (C,) float32, read only
// when prologue is 1; y (N, H, W, Co) bfloat16.  The pixels are walked
// as the bf16 dw walks them (tc_geometry), in runs of run_stages stages
// (the last run may be shorter), runs = ceil(stages / run_stages);
// s1_part and s2_part are (runs, Co) float32, one row of sums of y and
// y^2 for each run, every element written.  x loads 16 bytes at a time
// where bit 0 of vec is set (x 16-byte aligned, C a multiple of 8), w
// where bit 1 is (w 16-byte aligned, Co a multiple of 8).
extern "C" int mx_fused_conv3_bn_fwd_mma(const void* x, const void* w,
                                         const void* scale, const void* bias,
                                         int prologue, void* y, void* s1_part,
                                         void* s2_part, long long N, int H,
                                         int W, int C, int Co,
                                         long long run_stages, long long runs,
                                         int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  FwArgs<bf16> a;
  const int bn = Co <= 64 ? 64 : 128;
  if (!fw_args(&a, x, w, scale, bias, prologue, y, s1_part, s2_part, N, H, W,
               C, Co, run_stages, runs, vec, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned gt = static_cast<unsigned>(ceil_div(Co, bn));
  const unsigned gr = static_cast<unsigned>(runs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 64)
    err = bn == 64 ? launch_fwd_mma<64, 64, true>(a, gt, gr, s)
                   : launch_fwd_mma<128, 64, true>(a, gt, gr, s);
  else
    err = bn == 64 ? launch_fwd_mma<64, 32, false>(a, gt, gr, s)
                   : launch_fwd_mma<128, 32, false>(a, gt, gr, s);
  return static_cast<int>(err);
}

// The float32 forward on the tensor cores (3xTF32): as
// mx_fused_conv3_bn_fwd_mma, with x, w and y float32, on the same walk
// and runs, in tiles of 64 output channels at every C_out; x loads 16
// bytes at a time where bit 0 of vec is set (x 16-byte aligned, C a
// multiple of 4), w where bit 1 is (w aligned, Co a multiple of 4), and
// y stores 16 bytes at a time where bit 2 is (y aligned, Co a multiple
// of 4).
extern "C" int mx_fused_conv3_bn_fwd_tf32(const void* x, const void* w,
                                          const void* scale, const void* bias,
                                          int prologue, void* y, void* s1_part,
                                          void* s2_part, long long N, int H,
                                          int W, int C, int Co,
                                          long long run_stages, long long runs,
                                          int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  FwArgs<float> a;
  if (!fw_args(&a, x, w, scale, bias, prologue, y, s1_part, s2_part, N, H, W,
               C, Co, run_stages, runs, vec, kFtBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_fwd_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFtSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_conv3_bn_fwd_tf32<<<dim3(static_cast<unsigned>(ceil_div(Co, kFtBN)),
                                 static_cast<unsigned>(runs)),
                            kFwThreads, kFtSmem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 dx on the tensor cores.  x (N, H, W, C), w (3, 3, C, Co),
// y and dy (N, H, W, Co) and dx (N, H, W, C) bfloat16, contiguous; ds1
// and ds2 (Co,) float32.  The pixels are walked as the bf16 forward
// walks them (tc_geometry), in runs of run_stages stages (the last run
// may be shorter), runs = ceil(stages / run_stages).  With the
// prologue, scale and bias (C,) float32 are read and dscale_part and
// dbias_part (runs, C) float32, one row of sums of dz*x and dz for each
// run, every element written; without it they may be null.  x pairs
// load 4 bytes at a time where bit 0 of vec is set (x 16-byte aligned, C
// a multiple of 8), y and dy 16 bytes where bit 1 is (both aligned, Co a
// multiple of 8), w where bit 2 is (w aligned, Co a multiple of 8).
extern "C" int mx_fused_conv3_bn_dx_mma(
    const void* x, const void* w, const void* scale, const void* bias,
    int prologue, const void* y, const void* dy, const void* ds1,
    const void* ds2, void* dx, void* dscale_part, void* dbias_part,
    long long N, int H, int W, int C, int Co, long long run_stages,
    long long runs, int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  DxArgs<bf16> a;
  const int bn = C <= 64 ? 64 : 128;
  if (!dx_args(&a, x, w, scale, bias, prologue, y, dy, ds1, ds2, dx,
               dscale_part, dbias_part, N, H, W, C, Co, run_stages, runs, vec,
               bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned gt = static_cast<unsigned>(ceil_div(C, bn));
  const unsigned gr = static_cast<unsigned>(runs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 64 && Co <= 64)
    err = launch_dx_mma<64, 64, true, 2>(a, gt, gr, s);
  else if (C <= 64)
    err = launch_dx_mma<64, 32, false, 3>(a, gt, gr, s);
  else
    err = launch_dx_mma<128, 32, false, 3>(a, gt, gr, s);
  return static_cast<int>(err);
}

// The float32 dx on the tensor cores (3xTF32): as
// mx_fused_conv3_bn_dx_mma, with x, w, y, dy and dx float32, on the same
// walk and runs, in tiles of 64 input channels at every C; x pairs load
// 8 bytes at a time where bit 0 of vec is set (x 16-byte aligned, C a
// multiple of 4), y and dy 16 bytes where bit 1 is (both aligned, Co a
// multiple of 4), w where bit 2 is (w aligned, Co a multiple of 4).
extern "C" int mx_fused_conv3_bn_dx_tf32(
    const void* x, const void* w, const void* scale, const void* bias,
    int prologue, const void* y, const void* dy, const void* ds1,
    const void* ds2, void* dx, void* dscale_part, void* dbias_part,
    long long N, int H, int W, int C, int Co, long long run_stages,
    long long runs, int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  DxArgs<float> a;
  if (!dx_args(&a, x, w, scale, bias, prologue, y, dy, ds1, ds2, dx,
               dscale_part, dbias_part, N, H, W, C, Co, run_stages, runs, vec,
               kXtBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dx_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kXtSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_conv3_bn_dx_tf32<<<dim3(static_cast<unsigned>(ceil_div(C, kXtBN)),
                                static_cast<unsigned>(runs)),
                           kFwThreads, kXtSmem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
