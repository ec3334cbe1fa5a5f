// K3: score of one scan at M poses against an NDT grid.
//
// Replaces the jitted XLA scoring of the JAX package:
// ndt_2d_tpu/matching/matcher.py::score_points_at_pose (-> ndt/grid.py::
// score_points -> score_at_cells) and its jax.vmap over poses,
// matcher.py::score_points_batch, the particle filter's measurement.  With
// a grid axis (G = 4, the overlapping grids, matcher.py:411-416) a beam's
// term is the mean of its G clamped Gaussians, ((((0 + s0) + s1) + s2) + s3)
// / 4, before the beams are summed; at G = 1 it is the one grid's Gaussian.
//
// What bounds it on the card: the cell gathers.  Each (pose, beam) reads one
// cell's mean, information and count (24 bytes, scattered, from a grid that
// sits in L2) and evaluates one exp; 5000 poses x 100 beams is 0.5 M of
// them.  At M = 1 (the uncorrected score of every scan) it is latency: the
// launch, then one dependent chain of gathers.
//
// Every pose's beams are summed in one order: lane l of a warp adds beams
// l, l + 32, l + 64, ... in that order, summing from 0, and a fixed
// __shfl_down_sync tree (16, 8, 4, 2, 1) adds the lanes; the normalization
// -sum / max(used, 1) follows in the same launch.  A pose's score therefore
// depends neither on M, nor on its index, nor on the layout below: a
// particle's score and the scan's score at the same pose are the same bits.
//
// Two layouts of the SoA read.  M > 1 (score_batch, the particle launch's
// parent design; the particle filter's and KB2's launch is
// particle_kernel, below): one warp per pose,
// kWarps poses per block; each block stages the subsampled beams in shared
// memory, at most kChunk at a time (they are the same for every pose), and
// lane l evaluates its beams one after another.  M = 1 (score_at_pose, and the
// G = 4 grids of config 8): the pose gets a whole block.  Its threads evaluate
// up to kPoseThreads slots a pass at once, thread t slot base + t, each term's
// G grid gathers issued together (the grid loop is unrolled for G = 1 and 4),
// and stage the terms in shared memory; warp 0 then adds them in the order
// above, lane l slots l, l + 32, ... of the pass, while the other warps go on
// to the next pass (two buffers, one barrier a pass).  Only the arithmetic
// runs in parallel; every addition keeps its place.
//
// The pipelined step's start pose (K13's compose, matcher.py::
// mapping_step_async :660-664, localization_step_async :691-695) can be
// folded into the single-pose launch: given (prev, delta), every thread
// dead-reckons the pose with pose_chain.cu's expressions (the same cosf /
// sinf / atan2f, the same order), thread 0 writes it to pose_out for the
// search that follows, and the score uses it.
//
// The particle filter's launch (particle_kernel, M poses, a warp each):
// with motion on, each pose's warp first moves its particle by K9's motion
// sample (pf_motion.cuh, the body K9's own launch runs; ndt_2d_tpu/filter/
// particle_filter.py::pf_step's motion_model.sample) and lane 0 writes the
// moved pose; with motion off it scores the poses as given (the mesh's
// sharded measurement).  It reads each beam's cell as one record, the first
// 32 bytes of a row of K1's patch table (or of a [C, 8] cell table): mean
// x, mean y, i00, i01, i11 and the count >= 5 flag, the same bits as the
// SoA arrays (ndt/grid.py::packed_cell_table), two 16-byte loads from one
// 32-byte sector where the SoA gathers make five loads over three sectors.
// Lane l adds slots l, l + 32, ... from 0, then the same shuffle tree and
// -sum / max(used, 1): every score is score_points_kernel's and
// score_pose_kernel's at the same pose, bit for bit.  The launch asks for
// kParticleBlocks blocks an SM (32 registers), so config 7's 20,000 poses
// take three waves of the card, not five.  Loading a lane's next terms'
// records together (2 or 4 at a time), a block of eight poses whose
// (pose, beam) terms are spread over all its threads, and an approximate
// division with an exact fallback were each timed and were no faster
// (PERF.md §6, the particle launch).  One pose with the motion off (M = 1)
// gets a block instead (record_pose_kernel, score_pose_kernel's passes
// over record_term): the same order, the same bits.
//
// KB2, the stripe scores: one device's share of the scoring against a
// y-stripe-sharded map, ndt_2d_tpu/parallel/ndt_blocks.py::
// score_points_sharded (:88-113) and score_particles_sharded_map
// (:116-166), is the particle launch with the motion off on the grid rows
// [row0, row0 + h) with raw = 1, reading KB1's stripe table (the dense
// grid is row0 = 0, h = H, raw = 0).  A beam counts only when its GLOBAL
// bin (against the map's origin) lies in those rows; it reads the stripe's
// record (iy - row0) * W + ix.  raw = 1 writes -sum without the division:
// the stripes' partials are added in rank order first (K12's rank_sum) and
// the caller divides by max(used, 1) after, as JAX psums then divides.
// Given world points are scored at the identity pose with num_points =
// max_beams = P, so every point counts, in order (M = 1: a block).  The
// SoA launch's ScoreArgs keep row0, h and raw for the comparison arm.
#include "common.cuh"
#include "pf_motion.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 1024;        // most beams staged in shared memory
constexpr int kPoseThreads = 128;   // slots a pass of the block-per-pose
// The particle launch: poses (warps) a block, blocks an SM it asks for.
constexpr int kParticleWarps = 8;
constexpr int kParticleBlocks = 8;

// The launch's constants, set once a shape by the wrapper
// (kernels/score_points.py::_Args, field for field).
struct ScoreArgs {
  int P, max_beams, G, W, row0, h, raw;
  float cell;
};

// The particle launch's constants, set once a plan by the wrapper
// (kernels/score_points.py::_ParticleArgs, field for field): the rows
// [row0, row0 + h) of a W-wide grid (the whole grid: row0 = 0, h = H), G
// grids, a table row of `stride` floats whose first 8 are the cell's
// record, M poses, motion on or off, raw (-sum, no division) or not.
struct ParticleArgs {
  int P, max_beams, G, W, row0, h, stride, M, motion, raw;
  float cell;
};

// One particle launch, kept by the plan and filled a call
// (kernels/score_points.py::_ParticleLaunch, field for field): its
// constants, the tensors' pointers (noise and moved null with the motion
// off), the step's six motion scalars and the scan's point count.
struct ParticleLaunch {
  ParticleArgs a;
  const float* poses;
  const float* noise;
  const float* points;
  const uint8_t* pmask;
  const float* origin;
  const float* table;
  float* moved;
  float* out;
  float rot1, trans, rot2, s_rot1, s_trans, s_rot2;
  int num_points;
};

struct Grids {
  const float* origin;
  const float* mean;
  const float* info;
  const int* count;
  size_t C;
};

// A beam's term at world point (wx, wy): grid 0's clamped Gaussian, or the
// mean of the G grids' summed from 0 in grid order.  NG > 0 fixes the grid
// count at compile time (the loop unrolls and its gathers issue together);
// NG = 0 reads it from the arguments.
template <int NG>
__device__ __forceinline__ float beam_term(float wx, float wy, bool used,
                                           const ScoreArgs& a,
                                           const Grids& g) {
  const int G = NG > 0 ? NG : a.G;
  float term = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float ox = g.origin[2 * k], oy = g.origin[2 * k + 1];
    const float* gmean = g.mean + k * g.C * 2;
    const float* ginfo = g.info + k * g.C * 3;
    const int ix = (int)floorf((wx - ox) / a.cell);
    const int iy = (int)floorf((wy - oy) / a.cell);
    const bool valid = used && ix >= 0 && ix < a.W && iy >= a.row0 &&
                       iy < a.row0 + a.h;
    const int f = valid ? (iy - a.row0) * a.W + ix : 0;
    const float qx = wx - gmean[2 * f];
    const float qy = wy - gmean[2 * f + 1];
    const float e = -0.5f * (ginfo[3 * f] * qx * qx +
                             2.f * ginfo[3 * f + 1] * qx * qy +
                             ginfo[3 * f + 2] * qy * qy);
    const float sc = expf(fminf(e, 0.f));
    const float v = (valid && g.count[k * g.C + f] >= 5) ? sc : 0.f;
    term = G == 1 ? v : term + v;
  }
  if (G > 1) term = term / (float)G;
  return term;
}

__device__ __forceinline__ float lanes_tree(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}

// One pose's sum by a block: thread t evaluates slot base + t of each pass
// (term(i)) into sterm[pass & 1]; after the pass's barrier warp 0 adds the
// pass's slots, lane l slots l, l + 32, ... in order, so across passes lane
// l adds slots l, l + 32, l + 64, ... as a warp-per-pose lane does; then
// the lanes' tree.  The sum is thread 0's.
template <typename Term>
__device__ __forceinline__ float block_pose_sum(int slots, Term term) {
  __shared__ float sterm[2][kPoseThreads];
  const int lane = threadIdx.x & 31;
  const int T = blockDim.x;
  float acc = 0.f;
  int buf = 0;
  for (int base = 0; base < slots; base += T, buf ^= 1) {
    sterm[buf][threadIdx.x] = term(base + threadIdx.x);
    __syncthreads();
    if (threadIdx.x < 32) {
      const int n = min(T, slots - base);
      for (int j = lane; j < n; j += 32) acc += sterm[buf][j];
    }
  }
  return threadIdx.x < 32 ? lanes_tree(acc) : acc;
}

__global__ void score_points_kernel(ScoreArgs a,
                                    const float* __restrict__ points,
                                    const uint8_t* __restrict__ pmask,
                                    int num_points, int slots, int chunk,
                                    const float* __restrict__ poses, int M,
                                    Grids g, float* __restrict__ out) {
  extern __shared__ float sbeam[];  // [3, chunk]: x, y, in-use flag
  float* sx = sbeam;
  float* sy = sx + chunk;
  float* sv = sy + chunk;
  const ndt2d::Subsample sub(num_points, a.max_beams);
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = m < M;  // whole warps; every thread stages beams
  float px0 = 0.f, py0 = 0.f, c = 1.f, s = 0.f;
  if (active) {
    px0 = poses[3 * m];
    py0 = poses[3 * m + 1];
    c = cosf(poses[3 * m + 2]);
    s = sinf(poses[3 * m + 2]);
  }
  float acc = 0.f;
  for (int base = 0; base < slots; base += chunk) {
    const int n = min(chunk, slots - base);
    __syncthreads();  // every warp is done with the previous chunk
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = base + j;
      float x = 0.f, y = 0.f, v = 0.f;
      if (i < a.max_beams) {
        const int idx = sub.index(i, num_points, a.P);
        x = points[2 * idx];
        y = points[2 * idx + 1];
        v = (i < sub.used && pmask[idx]) ? 1.f : 0.f;
      }
      sx[j] = x;
      sy[j] = y;
      sv[j] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      const float px = sx[j], py = sy[j];
      const float wx = c * px - s * py + px0;
      const float wy = s * px + c * py + py0;
      acc += beam_term<0>(wx, wy, sv[j] != 0.f, a, g);
    }
  }
  if (!active) return;
  acc = lanes_tree(acc);
  if (lane == 0) out[m] = a.raw ? -acc : -acc / (float)max(sub.used, 1);
}

// One pose, one block (block_pose_sum), so lane l adds slots l, l + 32,
// ... as score_points_kernel's lane l does.  With prev non-null the pose
// is dead-reckoned from (prev, delta) first.
template <int NG>
__global__ void __launch_bounds__(kPoseThreads) score_pose_kernel(
    ScoreArgs a, const float* __restrict__ points,
    const uint8_t* __restrict__ pmask, int num_points, int slots,
    const float* __restrict__ pose, const float* __restrict__ prev,
    const float* __restrict__ delta, float* __restrict__ pose_out, Grids g,
    float* __restrict__ out) {
  float px0, py0, th;
  if (prev != nullptr) {  // pose_chain.cu's compose, expression for expression
    const float c0 = cosf(prev[2]), s0 = sinf(prev[2]);
    const float t = prev[2] + delta[2];
    px0 = prev[0] + c0 * delta[0] - s0 * delta[1];
    py0 = prev[1] + s0 * delta[0] + c0 * delta[1];
    th = atan2f(sinf(t), cosf(t));
    if (threadIdx.x == 0) {
      pose_out[0] = px0;
      pose_out[1] = py0;
      pose_out[2] = th;
    }
  } else {
    px0 = pose[0];
    py0 = pose[1];
    th = pose[2];
  }
  const float c = cosf(th), s = sinf(th);
  const ndt2d::Subsample sub(num_points, a.max_beams);
  const float acc = block_pose_sum(slots, [&](int i) {
    float term = 0.f;
    if (i < a.max_beams) {
      const int idx = sub.index(i, num_points, a.P);
      const float px = points[2 * idx], py = points[2 * idx + 1];
      const float wx = c * px - s * py + px0;
      const float wy = s * px + c * py + py0;
      term = beam_term<NG>(wx, wy, i < sub.used && pmask[idx], a, g);
    }
    return term;
  });
  if (threadIdx.x == 0)
    out[0] = a.raw ? -acc : -acc / (float)max(sub.used, 1);
}

// beam_term with each cell read as its record: grid k's row f of the
// table (f = 0 off the rows [row0, row0 + h) or unused), two 16-byte loads
// of its first 8 floats (mean x, mean y, i00, i01; i11, scorable, 0, 0)
// for the three SoA gathers, the same expressions in the same order.
template <int NG>
__device__ __forceinline__ float record_term(float wx, float wy, bool used,
                                             const ParticleArgs& a,
                                             const float* origin,
                                             const float* table) {
  const int G = NG > 0 ? NG : a.G;
  float term = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float ox = origin[2 * k], oy = origin[2 * k + 1];
    const int ix = (int)floorf((wx - ox) / a.cell);
    const int iy = (int)floorf((wy - oy) / a.cell);
    const bool valid = used && ix >= 0 && ix < a.W && iy >= a.row0 &&
                       iy < a.row0 + a.h;
    const int f = valid ? (iy - a.row0) * a.W + ix : 0;
    const float4* row = reinterpret_cast<const float4*>(
        table + ((size_t)k * a.W * a.h + f) * a.stride);
    const float4 r0 = __ldg(row), r1 = __ldg(row + 1);
    const float qx = wx - r0.x;
    const float qy = wy - r0.y;
    const float e = -0.5f * (r0.z * qx * qx + 2.f * r0.w * qx * qy +
                             r1.x * qy * qy);
    const float sc = expf(fminf(e, 0.f));
    const float v = (valid && r1.y != 0.f) ? sc : 0.f;
    term = G == 1 ? v : term + v;
  }
  if (G > 1) term = term / (float)G;
  return term;
}

// M poses, a warp each (kParticleWarps a block); the beams staged in
// shared memory as score_points_kernel stages them.  With a.motion the
// pose is particle m moved by the motion sample (written to moved by lane
// 0), else poses[m].
template <int NG>
__global__ void __launch_bounds__(kParticleWarps * 32, kParticleBlocks)
    particle_kernel(ParticleArgs a, const float* __restrict__ poses,
                    const float* __restrict__ noise, ndt2d::Motion mo,
                    const float* __restrict__ points,
                    const uint8_t* __restrict__ pmask, int num_points,
                    int slots, int chunk, const float* __restrict__ origin,
                    const float* __restrict__ table,
                    float* __restrict__ moved, float* __restrict__ out) {
  extern __shared__ float sbeam[];  // [3, chunk]: x, y, in-use flag
  float* sx = sbeam;
  float* sy = sx + chunk;
  float* sv = sy + chunk;
  const ndt2d::Subsample sub(num_points, a.max_beams);
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kParticleWarps + (threadIdx.x >> 5);
  const bool active = m < a.M;  // whole warps; every thread stages beams
  float pose[3] = {0.f, 0.f, 0.f};
  if (active) {
    if (a.motion) {
      ndt2d::motion_sample(poses + 3 * m, noise + 3 * m, mo, pose);
      if (lane == 0) {
        moved[3 * m] = pose[0];
        moved[3 * m + 1] = pose[1];
        moved[3 * m + 2] = pose[2];
      }
    } else {
      pose[0] = poses[3 * m];
      pose[1] = poses[3 * m + 1];
      pose[2] = poses[3 * m + 2];
    }
  }
  const float c = cosf(pose[2]), s = sinf(pose[2]);
  float acc = 0.f;
  for (int base = 0; base < slots; base += chunk) {
    const int n = min(chunk, slots - base);
    __syncthreads();  // every warp is done with the previous chunk
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = base + j;
      float x = 0.f, y = 0.f, v = 0.f;
      if (i < a.max_beams) {
        const int idx = sub.index(i, num_points, a.P);
        x = points[2 * idx];
        y = points[2 * idx + 1];
        v = (i < sub.used && pmask[idx]) ? 1.f : 0.f;
      }
      sx[j] = x;
      sy[j] = y;
      sv[j] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      const float px = sx[j], py = sy[j];
      const float wx = c * px - s * py + pose[0];
      const float wy = s * px + c * py + pose[1];
      acc += record_term<NG>(wx, wy, sv[j] != 0.f, a, origin, table);
    }
  }
  if (!active) return;
  acc = lanes_tree(acc);
  if (lane == 0) out[m] = a.raw ? -acc : -acc / (float)max(sub.used, 1);
}

// One pose with the motion off, one block (block_pose_sum over
// record_term): particle_kernel's sum at that pose, the same bits, with
// kPoseThreads slots in flight a pass where a warp has one.
template <int NG>
__global__ void __launch_bounds__(kPoseThreads) record_pose_kernel(
    ParticleArgs a, const float* __restrict__ pose,
    const float* __restrict__ points, const uint8_t* __restrict__ pmask,
    int num_points, int slots, const float* __restrict__ origin,
    const float* __restrict__ table, float* __restrict__ out) {
  const float px0 = pose[0], py0 = pose[1];
  const float c = cosf(pose[2]), s = sinf(pose[2]);
  const ndt2d::Subsample sub(num_points, a.max_beams);
  const float acc = block_pose_sum(slots, [&](int i) {
    float term = 0.f;
    if (i < a.max_beams) {
      const int idx = sub.index(i, num_points, a.P);
      const float px = points[2 * idx], py = points[2 * idx + 1];
      const float wx = c * px - s * py + px0;
      const float wy = s * px + c * py + py0;
      term = record_term<NG>(wx, wy, i < sub.used && pmask[idx], a, origin,
                             table);
    }
    return term;
  });
  if (threadIdx.x == 0)
    out[0] = a.raw ? -acc : -acc / (float)max(sub.used, 1);
}

// Threads of the block-per-pose launches: the slots, at least a warp, at
// most kPoseThreads.
int pose_threads(int slots) {
  return slots < kPoseThreads ? (slots > 32 ? slots : 32) : kPoseThreads;
}

}  // namespace

// The particle launch (ParticleLaunch): poses [M,3] f32 (motion on: the
// particles before the step, with noise [M,3] f32 standard normals and the
// step's six scalars; moved [M,3] f32 receives the moved particles),
// points [P,2] f32, pmask [P] u8, origin [G,2] f32 (the map's), table
// [G,h*W,stride] f32 (the rows [row0, row0 + h): K1's patch table or KB1's
// stripe table, stride 32, or a cell table, stride 8) -> out [M] f32:
// -sum / max(used, 1) at each (moved) pose, or the raw -sum.  M = 1 with
// the motion off: one block (record_pose_kernel).
NDT2D_API int ndt2d_particle_scores(const void* launch, void* stream) {
  const ParticleLaunch& l = *static_cast<const ParticleLaunch*>(launch);
  const ParticleArgs& a = l.a;
  const int slots = ((a.max_beams + 31) / 32) * 32;
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  if (a.M == 1 && !a.motion) {
    const int T = pose_threads(slots);
    if (a.G == 1)
      record_pose_kernel<1><<<1, T, 0, st>>>(a, l.poses, l.points, l.pmask,
                                             l.num_points, slots, l.origin,
                                             l.table, l.out);
    else if (a.G == 4)
      record_pose_kernel<4><<<1, T, 0, st>>>(a, l.poses, l.points, l.pmask,
                                             l.num_points, slots, l.origin,
                                             l.table, l.out);
    else
      record_pose_kernel<0><<<1, T, 0, st>>>(a, l.poses, l.points, l.pmask,
                                             l.num_points, slots, l.origin,
                                             l.table, l.out);
    return (int)cudaGetLastError();
  }
  const int chunk = slots < kChunk ? (slots > 32 ? slots : 32) : kChunk;
  const size_t smem = (size_t)3 * chunk * sizeof(float);
  const ndt2d::Motion mo{l.rot1, l.trans, l.rot2,
                         l.s_rot1, l.s_trans, l.s_rot2};
  const int blocks = (a.M + kParticleWarps - 1) / kParticleWarps;
  const int threads = 32 * kParticleWarps;
  if (a.G == 1)
    particle_kernel<1><<<blocks, threads, smem, st>>>(
        a, l.poses, l.noise, mo, l.points, l.pmask, l.num_points, slots,
        chunk, l.origin, l.table, l.moved, l.out);
  else if (a.G == 4)
    particle_kernel<4><<<blocks, threads, smem, st>>>(
        a, l.poses, l.noise, mo, l.points, l.pmask, l.num_points, slots,
        chunk, l.origin, l.table, l.moved, l.out);
  else
    particle_kernel<0><<<blocks, threads, smem, st>>>(
        a, l.poses, l.noise, mo, l.points, l.pmask, l.num_points, slots,
        chunk, l.origin, l.table, l.moved, l.out);
  return (int)cudaGetLastError();
}

// args: the launch's constants (ScoreArgs).  points [P,2] f32, pmask [P]
// u8; G grids holding the rows [row0, row0 + h) of a W-wide map: origin
// [G,2] f32 (the map's), mean [G,h*W,2] f32, info [G,h*W,3] f32, count
// [G,h*W] i32 -> out [M] f32: -sum / max(used, 1), or the raw -sum when
// raw != 0.  M > 1 scores poses [M,3] f32, a warp each.  M = 1 scores one
// pose in one block: poses [3] f32, or, when prev is non-null, the pose
// dead-reckoned from prev [3] and delta [3] f32, also written to
// pose_out [3] f32.
NDT2D_API int ndt2d_score_points(const void* args, const void* points,
                                 const void* pmask, int num_points,
                                 const void* poses, int M, const void* origin,
                                 const void* mean, const void* info,
                                 const void* count, void* out,
                                 const void* prev, const void* delta,
                                 void* pose_out, void* stream) {
  const ScoreArgs a = *static_cast<const ScoreArgs*>(args);
  const int slots = ((a.max_beams + 31) / 32) * 32;
  const Grids g{static_cast<const float*>(origin),
                static_cast<const float*>(mean),
                static_cast<const float*>(info),
                static_cast<const int*>(count), (size_t)a.W * a.h};
  const auto pts = static_cast<const float*>(points);
  const auto pm = static_cast<const uint8_t*>(pmask);
  const auto po = static_cast<const float*>(poses);
  const auto st = reinterpret_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (M == 1) {
    const int T = pose_threads(slots);
    const auto pv = static_cast<const float*>(prev);
    const auto dl = static_cast<const float*>(delta);
    float* pw = static_cast<float*>(pose_out);
    if (a.G == 1)
      score_pose_kernel<1><<<1, T, 0, st>>>(a, pts, pm, num_points, slots,
                                            po, pv, dl, pw, g, o);
    else if (a.G == 4)
      score_pose_kernel<4><<<1, T, 0, st>>>(a, pts, pm, num_points, slots,
                                            po, pv, dl, pw, g, o);
    else
      score_pose_kernel<0><<<1, T, 0, st>>>(a, pts, pm, num_points, slots,
                                            po, pv, dl, pw, g, o);
    return (int)cudaGetLastError();
  }
  const int chunk = slots < kChunk ? (slots > 32 ? slots : 32) : kChunk;
  const size_t smem = (size_t)3 * chunk * sizeof(float);
  score_points_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, smem, st>>>(
      a, pts, pm, num_points, slots, chunk, po, M, g, o);
  return (int)cudaGetLastError();
}
