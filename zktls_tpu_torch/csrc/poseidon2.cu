// Poseidon2 over Baby-Bear (width 16 and 24) for Hopper: one device-side
// permutation, three entry points.
//
//   zk_poseidon2_permute        (N, width) states -> permuted states
//   zk_poseidon2_hash_rows      (N, W) matrix -> (N, 8) leaf digests
//   zk_poseidon2_merkle_levels  (N, 8) leaf digests -> every tree level
//
// What they replace.  `permute` is the Pallas TPU kernel
// zktls_tpu/ops/pallas_poseidon2.py:107 (_permute_fn_pallas, body
// _kernel_factory): initial M_E, RF/2 external rounds, RP internal rounds,
// RF/2 external rounds on Montgomery uint32 states.  `hash_rows` and
// `merkle_levels` replace the jitted zktls_tpu/ops/merkle.py:134 _tree_fn
// (leaf sponge and every compression level in one program), whose
// permutations are that same kernel.  All three are bit-identical to the
// reference: inputs and outputs are canonical values in [0, p).
//
// What bounds them.  A width-24 permutation is 1,356 Montgomery products and
// 192 bytes; an H100 issues 64 32-bit integer operations per clock per SM
// and moves 3.35 TB/s, so the products alone (3 multiplies each: a·b, the
// low word times p^-1, the high word of m·p) take four times longer than the
// bytes: every entry point is bound by integer issue.  Adds, compares and selects go down the same pipe as the
// multiplies (the measured times follow the count of all of them), so the
// design counts every operation, not only the multiplies.
//
// What the design does about it.
//   * Each thread owns one state and keeps all lanes in registers for every
//     round; round constants come from __constant__ memory, the same address
//     for a whole warp.
//   * A Montgomery product is four operations: a wide multiply (a·b, 64
//     bits), m = lo·p^-1, the upper word of m·p, and one three-input add
//     hi(a·b) - hi(m·p) + p.  The reduction to [0, p) is one fused add-min,
//     min(t - p, t) on unsigned values (__viaddmin_u32, a single Hopper
//     instruction), and is skipped where the next product tolerates an
//     unreduced operand: x^7 costs four products and two reductions.
//   * A modular add is two operations (add, fused add-min), and the 4x4
//     block of M_E shares its partial sums: 11 adds per block instead of 15.
//   * Inside an internal round the lanes stay unreduced in [0, 2p) and
//     their sum is kept in a 64-bit accumulator, reduced once per round.
//   * In the sponge and the tree the rounds are loops.  Unrolled, a
//     permutation is 160 KB of straight-line code, more than the instruction
//     cache holds: warps that drift apart, as they do in a sponge, then wait
//     for their code.
//   * `hash_rows` walks a row 16 columns at a time with the sponge state in
//     registers: add into the rate lanes, permute, next block.  The matrix is
//     read once, as the int64 row-major tensor the prover holds, and only the
//     digests are written: no state ever goes through device memory.
//   * `merkle_levels` gives each block 512 neighbouring nodes and lets it
//     reduce them through shared memory as far as they go (nine levels), so
//     a 131072-leaf tree is two launches, not seventeen.  Where a level is
//     too narrow to fill even one block, 16 threads share each state, one
//     lane each, and the linear layers become warp shuffles: the top of a
//     tree is a chain of dependent permutations, and this shortens each.
//
// Interface: plain C, loaded with ctypes (ops/cuda_poseidon2.py).  Field
// tensors of the port are int64 holding values < p; `permute` takes the same
// values as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 0x78000001u;        // 2^31 - 2^27 + 1
constexpr uint32_t kNegP = 0x87ffffffu;     // 2^32 - p
constexpr uint32_t kPInv = 0x88000001u;     // p^-1 mod 2^32
constexpr int kRF = 8;
constexpr int kRate = 16;                   // leaf sponge: width 24, rate 16
constexpr int kDigest = 8;
constexpr int kTreeBlock = 256;             // threads of a merkle block

__constant__ uint32_t c_erc16[kRF * 16];
__constant__ uint32_t c_irc16[13];
__constant__ uint32_t c_diag16[16];
__constant__ uint32_t c_erc24[kRF * 24];
__constant__ uint32_t c_irc24[21];
__constant__ uint32_t c_diag24[24];

// t in [0, 2p) -> t mod p: min(t - p, t) on unsigned values (t - p wraps
// above t when t < p).
__device__ __forceinline__ uint32_t fold(uint32_t t) {
  return __viaddmin_u32(t, kNegP, t);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  return fold(a + b);  // a, b < p: the sum is < 2p < 2^32
}

// Montgomery product without its last reduction: a value congruent to
// a·b·2^-32 in [0, a·b/2^32 + p], so below 2p whenever a·b < 2^32·p (for
// a < 2p, b < p) and below 2^32 whenever a·b < 2.41 p^2.
__device__ __forceinline__ uint32_t mont_raw(uint32_t a, uint32_t b) {
  uint64_t ab = (uint64_t)a * b;
  // m = lo·p^-1 makes m·p and a·b agree in their lower words, so the upper
  // words subtract without a borrow: wide multiply, low multiply, high
  // multiply, one three-input add
  uint32_t m = (uint32_t)ab * kPInv;
  return (uint32_t)(ab >> 32) - __umulhi(m, kP) + kP;
}

// a·b·2^-32 mod p in [0, p), for a·b < 2^32·p.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  return fold(mont_raw(a, b));
}

// x^7 for x in [0, p), reducing only where the next product needs it.
// Bounds in units of p: x2 < 1, x4 < 1.47, x6 < 0.47·1.47 + 1 = 1.69,
// x6·x < 1.8 before the last fold.
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mont_mul(x, x);
  uint32_t x4 = mont_raw(x2, x2);
  uint32_t x6 = mont_raw(x4, x2);
  return mont_mul(x6, x);
}

// M_E: M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on each 4-lane block,
// then every lane adds the sum of its position across blocks.
template <int W>
__device__ __forceinline__ void external_matrix(uint32_t (&s)[W]) {
  uint32_t sums[4];
#pragma unroll
  for (int b = 0; b < W; b += 4) {
    uint32_t x0 = s[b], x1 = s[b + 1], x2 = s[b + 2], x3 = s[b + 3];
    uint32_t t01 = add_mod(x0, x1), t23 = add_mod(x2, x3);
    uint32_t t0123 = add_mod(t01, t23);
    uint32_t t01123 = add_mod(t0123, x1), t01233 = add_mod(t0123, x3);
    s[b] = add_mod(t01123, t01);
    s[b + 1] = add_mod(t01123, add_mod(x2, x2));
    s[b + 2] = add_mod(t01233, t23);
    s[b + 3] = add_mod(t01233, add_mod(x0, x0));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sums[j] = b == 0 ? s[j] : add_mod(sums[j], s[b + j]);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = add_mod(s[i], sums[i & 3]);
}

// Round constants by width, read straight from the __constant__ symbols (a
// generic pointer to them would compile to global loads).
template <int W> __device__ __forceinline__ uint32_t erc(int r, int i);
template <> __device__ __forceinline__ uint32_t erc<16>(int r, int i) { return c_erc16[r * 16 + i]; }
template <> __device__ __forceinline__ uint32_t erc<24>(int r, int i) { return c_erc24[r * 24 + i]; }
template <int W> __device__ __forceinline__ uint32_t irc(int r);
template <> __device__ __forceinline__ uint32_t irc<16>(int r) { return c_irc16[r]; }
template <> __device__ __forceinline__ uint32_t irc<24>(int r) { return c_irc24[r]; }
template <int W> __device__ __forceinline__ uint32_t diag(int i);
template <> __device__ __forceinline__ uint32_t diag<16>(int i) { return c_diag16[i]; }
template <> __device__ __forceinline__ uint32_t diag<24>(int i) { return c_diag24[i]; }

template <int W>
__device__ __forceinline__ void external_round(uint32_t (&s)[W], int r) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = sbox(add_mod(s[i], erc<W>(r, i)));
  external_matrix<W>(s);
}

// A sum T < 79p of field values, held in 64 bits, mod p.  T/p is close to
// (T >> 27)/15 because p = 15·2^27 + 1: q = floor((T >> 27)·kBarrett/2^32)
// never exceeds T/p and falls short of it by less than 1.07, so T - q·p fits
// 32 bits and one fold finishes it.  Four operations.
constexpr uint32_t kBarrett = 286331152u;  // floor(2^32 / (15 + 2^-27))
__device__ __forceinline__ uint32_t reduce_sum(uint64_t t) {
  uint32_t q = __umulhi((uint32_t)(t >> 27), kBarrett);
  return fold((uint32_t)t - q * kP);
}

// Whether the sponge and the tree unroll the rounds of the permutation.
// They do not: unrolled, a permutation is 160 KB of straight-line code, more
// than the instruction cache holds, and warps that drift apart (a sponge
// runs the permutation forty times in a row) or a lone warp at the top of a
// tree then wait for their code.  As loops, a round's code stays cached
// and the round index reaches the constants as a uniform offset.  The
// permute kernel runs each warp through the code once, side by side with
// its neighbours, and is a little faster unrolled; its instruction count is
// then the count per state.
constexpr bool kUnrollFused = false;

// The permutation, in place, on canonical lanes.
template <int W, bool kUnroll>
__device__ __forceinline__ void permute(uint32_t (&s)[W]) {
  constexpr int RP = W == 16 ? 13 : 21;
  constexpr int kTimes = kUnroll ? 32 : 1;  // unroll factor of the rounds
  external_matrix<W>(s);
#pragma unroll kTimes
  for (int r = 0; r < kRF / 2; ++r) external_round<W>(s, r);
  // Internal rounds: lane j becomes tot + d_j·s_j, tot the sum of all lanes
  // after lane 0's S-box.  Lanes 1.. stay unreduced in [0, 2p) from round
  // to round (the product takes an operand below 2p), and their sum for the
  // next round is taken over the reduced products in a 64-bit accumulator:
  // sum_j (tot + t_j) = (W - 1)·tot + sum_j t_j.
  uint64_t acc = 0;
#pragma unroll
  for (int j = 1; j < W; ++j) acc += s[j];
  uint32_t rest = reduce_sum(acc);  // sum of lanes 1.., in [0, p)
#pragma unroll kTimes
  for (int r = 0; r < RP; ++r) {
    uint32_t boxed = sbox(add_mod(s[0], irc<W>(r)));
    uint32_t tot = add_mod(boxed, rest);
    acc = (uint64_t)tot * (W - 1);
#pragma unroll
    for (int j = 1; j < W; ++j) {
      uint32_t t = mont_mul(s[j], diag<W>(j));
      acc += t;
      s[j] = t + tot;
    }
    s[0] = add_mod(tot, mont_mul(boxed, diag<W>(0)));
    rest = reduce_sum(acc);
  }
#pragma unroll
  for (int j = 1; j < W; ++j) s[j] = fold(s[j]);
#pragma unroll kTimes
  for (int r = kRF / 2; r < kRF; ++r) external_round<W>(s, r);
}

template <int W>
__global__ void __launch_bounds__(256)
poseidon2_permute_kernel(const uint32_t* __restrict__ in,
                         uint32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[W];
  const uint4* src = reinterpret_cast<const uint4*>(in + i * W);
#pragma unroll
  for (int v = 0; v < W / 4; ++v) {
    uint4 q = src[v];
    s[4 * v] = q.x;
    s[4 * v + 1] = q.y;
    s[4 * v + 2] = q.z;
    s[4 * v + 3] = q.w;
  }
  permute<W, true>(s);
  uint4* dst = reinterpret_cast<uint4*>(out + i * W);
#pragma unroll
  for (int v = 0; v < W / 4; ++v)
    dst[v] = make_uint4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
}

__device__ __forceinline__ void store_digest(long long* dst,
                                             const uint32_t* s) {
  longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int v = 0; v < kDigest / 2; ++v)
    d[v] = make_longlong2((long long)s[2 * v], (long long)s[2 * v + 1]);
}

// Leaf sponge: thread i hashes row i of the row-major (n, w) int64 matrix.
// Eight blocks of 128 threads fit an SM at 64 registers, so the 131072 rows
// of the main path's matrices are resident at once.
__global__ void __launch_bounds__(128, 8)
poseidon2_hash_rows_kernel(const long long* __restrict__ rows, long long n,
                           int w, long long* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the values are < 2^31: only the low word of each int64 is read
  const uint32_t* row = reinterpret_cast<const uint32_t*>(rows + i * w);
  uint32_t s[24];
#pragma unroll
  for (int j = 0; j < 24; ++j) s[j] = 0u;
#pragma unroll 1
  for (int col = 0; col < w; col += kRate) {
#pragma unroll
    for (int j = 0; j < kRate; ++j) {
      uint32_t x = col + j < w ? __ldg(row + 2 * (col + j)) : 0u;
      s[j] = add_mod(s[j], x);
    }
    permute<24, kUnrollFused>(s);
  }
  store_digest(out + i * kDigest, s);
}

// First row of tree level k in the (2n - 1, 8) buffer: level 0 (n leaves)
// at 0, level k >= 1 (n / 2^k nodes) at 2n - n / 2^(k-1).
__device__ __forceinline__ long long level_offset(long long n, int k) {
  return k == 0 ? 0 : 2 * n - (n >> (k - 1));
}

// A width-16 permutation spread over 16 neighbouring threads of a warp, one
// lane each (`lane` = thread index mod 16): the S-boxes of a full round run
// side by side and the linear layers are warp shuffles, so a state takes a
// fraction of the time one thread needs for it.  For the narrow top of a
// tree, where a level has fewer nodes than the card has idle threads and
// only the time of one dependent chain counts.  Every thread of the warp
// must call it.  `erc_lane[r]` and `diag_lane` are this lane's constants.
__device__ __forceinline__ uint32_t lane_external_matrix(uint32_t x, int lane) {
  const unsigned all = 0xffffffffu;
  uint32_t pair = add_mod(x, __shfl_xor_sync(all, x, 1));
  uint32_t t0123 = add_mod(pair, __shfl_xor_sync(all, pair, 2));
  // row j of M4 is t0123 + x_j + 2·x_(j+1 mod 4)
  uint32_t next = __shfl_sync(all, x, (lane & 12) | ((lane + 1) & 3), 16);
  uint32_t y = add_mod(add_mod(t0123, x), add_mod(next, next));
  uint32_t two = add_mod(y, __shfl_xor_sync(all, y, 4));
  return add_mod(y, add_mod(two, __shfl_xor_sync(all, two, 8)));
}

__device__ __forceinline__ uint32_t lane_permute16(
    uint32_t x, int lane, const uint32_t (&erc_lane)[kRF], uint32_t diag_lane) {
  const unsigned all = 0xffffffffu;
  x = lane_external_matrix(x, lane);
#pragma unroll
  for (int r = 0; r < kRF / 2; ++r)
    x = lane_external_matrix(sbox(add_mod(x, erc_lane[r])), lane);
#pragma unroll 1
  for (int r = 0; r < 13; ++r) {
    // lane 0's S-box and the sum of the other lanes do not wait for each
    // other
    uint32_t boxed = sbox(add_mod(x, irc<16>(r)));
    uint32_t rest = lane == 0 ? 0u : x;
#pragma unroll
    for (int step = 1; step < 16; step <<= 1)
      rest = add_mod(rest, __shfl_xor_sync(all, rest, step));
    uint32_t tot = add_mod(rest, __shfl_sync(all, boxed, 0, 16));
    x = add_mod(tot, mont_mul(lane == 0 ? boxed : x, diag_lane));
  }
#pragma unroll
  for (int r = kRF / 2; r < kRF; ++r)
    x = lane_external_matrix(sbox(add_mod(x, erc_lane[r])), lane);
  return x;
}

// Tree levels: block b takes nodes [b·chunk, (b+1)·chunk) of level `level`
// (chunk a power of two, 2 <= chunk <= 2·kTreeBlock) and writes their
// parents, grandparents, ... up to the one node above them all, into the
// buffer.  The first parents are read from device memory; after that each
// level's digests pass through shared memory.  While a level has more than
// kTreeBlock/16 parents each thread permutes one state; from there up, 16
// threads share a state (lane_permute16).
__global__ void __launch_bounds__(kTreeBlock)
poseidon2_merkle_kernel(long long* __restrict__ buf, long long n_leaves,
                        int level, int chunk) {
  __shared__ uint32_t sh[kTreeBlock * kDigest];  // node i at sh[8i .. 8i+7]
  const int t = threadIdx.x;
  const int lane = t & 15, group = t >> 4;
  uint32_t erc_lane[kRF];
#pragma unroll
  for (int r = 0; r < kRF; ++r) erc_lane[r] = c_erc16[r * 16 + lane];
  const uint32_t diag_lane = c_diag16[lane];
  int active = chunk / 2;
  long long first = (long long)blockIdx.x * active;  // first parent, level+1
  for (bool from_memory = true;; from_memory = false) {
    ++level;
    const long long* below =
        buf + (level_offset(n_leaves, level - 1) + 2 * first) * kDigest;
    long long* here = buf + (level_offset(n_leaves, level) + first) * kDigest;
    if (active * 16 > kTreeBlock) {
      // one thread per parent
      uint32_t s[16];
      if (t < active) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[j] = from_memory ? (uint32_t)below[16 * t + j] : sh[16 * t + j];
      }
      __syncthreads();  // every read of sh is done before it is overwritten
      if (t < active) {
        permute<16, kUnrollFused>(s);
        store_digest(here + t * kDigest, s);
#pragma unroll
        for (int j = 0; j < kDigest; ++j) sh[t * kDigest + j] = s[j];
      }
    } else {
      // 16 threads per parent: thread t holds lane t % 16 of parent t / 16
      // (threads beyond the last parent permute zeros for the shuffles' sake)
      uint32_t x = 0u;
      if (group < active) x = from_memory ? (uint32_t)below[t] : sh[t];
      __syncthreads();
      x = lane_permute16(x, lane, erc_lane, diag_lane);
      if (group < active && lane < kDigest) {
        here[group * kDigest + lane] = (long long)x;
        sh[group * kDigest + lane] = x;
      }
    }
    if (active == 1) break;
    __syncthreads();
    active >>= 1;
    first >>= 1;
  }
}

}  // namespace

extern "C" {

// Selects `device` for one entry point and gives the caller's current
// device back when the entry point returns: the caller (torch) keeps its
// own current device, and a launch on another card must not move it.
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Copy one width's Montgomery-form constants into __constant__ memory of
// `device`: erc (8, width) row-major, irc (rp,), diag (width,).
int zk_poseidon2_set_constants(int device, int width, const uint32_t* erc,
                               const uint32_t* irc, const uint32_t* diag) {
  DeviceScope scope(device);
  cudaError_t e = scope.err;
  if (e != cudaSuccess) return (int)e;
  if (width == 16) {
    if ((e = cudaMemcpyToSymbol(c_erc16, erc, sizeof(c_erc16))) != cudaSuccess) return (int)e;
    if ((e = cudaMemcpyToSymbol(c_irc16, irc, sizeof(c_irc16))) != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbol(c_diag16, diag, sizeof(c_diag16));
  } else if (width == 24) {
    if ((e = cudaMemcpyToSymbol(c_erc24, erc, sizeof(c_erc24))) != cudaSuccess) return (int)e;
    if ((e = cudaMemcpyToSymbol(c_irc24, irc, sizeof(c_irc24))) != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbol(c_diag24, diag, sizeof(c_diag24));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

// out = Poseidon2(in) for n states of `width` lanes, enqueued on `stream`.
// in/out: device pointers to n·width uint32, 16-byte aligned.  Returns the
// cudaGetLastError() of the launch (0 on success).
int zk_poseidon2_permute(int device, int width, const uint32_t* in,
                         uint32_t* out, long long n, void* stream) {
  DeviceScope scope(device);
  cudaError_t e = scope.err;
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 16) {
    poseidon2_permute_kernel<16><<<blocks, threads, 0, st>>>(in, out, n);
  } else if (width == 24) {
    poseidon2_permute_kernel<24><<<blocks, threads, 0, st>>>(in, out, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[i] = sponge digest of row i: rows is a row-major (n, w) int64 matrix
// of values < p, out an (n, 8) int64 matrix, 16-byte aligned.  One launch.
int zk_poseidon2_hash_rows(int device, const long long* rows, long long n,
                           int w, long long* out, void* stream) {
  DeviceScope scope(device);
  cudaError_t e = scope.err;
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  poseidon2_hash_rows_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(rows, n, w, out);
  return (int)cudaGetLastError();
}

// buf is a (2n - 1, 8) int64 matrix, 16-byte aligned, whose first n rows
// (n a power of two) hold the leaf digests; fills in every level above
// them, the root last.  One launch per nine levels; *launches says how many.
int zk_poseidon2_merkle_levels(int device, long long* buf, long long n,
                               void* stream, int* launches) {
  *launches = 0;
  DeviceScope scope(device);
  cudaError_t e = scope.err;
  if (e != cudaSuccess) return (int)e;
  if (n < 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int level = 0;
  for (long long left = n; left > 1;) {
    const int chunk = left < 2 * kTreeBlock ? (int)left : 2 * kTreeBlock;
    poseidon2_merkle_kernel<<<(unsigned)(left / chunk), kTreeBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        buf, n, level, chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ++*launches;
    for (int c = chunk; c > 1; c >>= 1) ++level;
    left /= chunk;
  }
  return 0;
}

}  // extern "C"
