// Poseidon2 over Baby-Bear (width 16 and 24), one thread per state.
//
// Replaces the Pallas TPU kernel zktls_tpu/ops/pallas_poseidon2.py
// (_kernel_factory / _permute_fn_pallas): the full permutation — initial
// M_E, RF/2 external rounds, RP internal rounds, RF/2 external rounds — on
// (N, width) Montgomery uint32 states, bit-identical to the reference.
//
// Design for Hopper.  The Pallas kernel keeps a (width, 512) tile in VMEM
// with the batch on the 128-wide lane axis.  Here each thread owns one
// state and keeps all `width` lanes in registers for every round (24
// uint32 at most), so a state is read once and written once.  Round
// constants sit in __constant__ memory: all threads of a warp read the same
// constant at the same time, which the constant cache broadcasts.
//
// Bound.  A width-24 permutation does 8·24·4 + 21·(4 + 24) = 1,356
// Montgomery products of 4 integer multiplies each (lo, hi, m = lo·p',
// hi(m·p)) and moves 192 bytes; on an H100 (64 integer multiplies per
// clock per SM, 132 SMs, ~1.98 GHz) that is ~0.33 ns of multiply issue per
// state against ~0.06 ns of HBM traffic (3.35 TB/s): the kernel is bound
// by integer-multiply issue, not by memory.  Loads and stores are 16-byte
// vectors (a row is 64 or 96 bytes), so a warp's accesses cover whole
// cache lines; no shared-memory staging.
//
// Interface: plain C, loaded with ctypes (ops/cuda_poseidon2.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 0x78000001u;        // 2^31 - 2^27 + 1
constexpr uint32_t kNPrime = 0x77ffffffu;   // -p^-1 mod 2^32
constexpr int kRF = 8;

__constant__ uint32_t c_erc16[kRF * 16];
__constant__ uint32_t c_irc16[13];
__constant__ uint32_t c_diag16[16];
__constant__ uint32_t c_erc24[kRF * 24];
__constant__ uint32_t c_irc24[21];
__constant__ uint32_t c_diag24[24];

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2p < 2^32
  return s >= kP ? s - kP : s;
}

// Montgomery product: a·b·2^-32 mod p, inputs and output in [0, p).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  uint32_t lo = a * b;
  uint32_t hi = __umulhi(a, b);
  uint32_t m = lo * kNPrime;
  uint32_t mp_hi = __umulhi(m, kP);
  // lo + (m·p mod 2^32) ≡ 0 (mod 2^32): the carry is 1 unless lo == 0
  uint32_t t = hi + mp_hi + (lo != 0u);  // < 2p
  return t >= kP ? t - kP : t;
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = mont_mul(x, x);
  uint32_t x4 = mont_mul(x2, x2);
  return mont_mul(mont_mul(x4, x2), x);
}

// M_E: M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on each 4-lane block,
// then every lane adds the sum of its position across blocks.
template <int W>
__device__ __forceinline__ void external_matrix(uint32_t (&s)[W]) {
  uint32_t sums[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < W; b += 4) {
    uint32_t x0 = s[b], x1 = s[b + 1], x2 = s[b + 2], x3 = s[b + 3];
    uint32_t t0123 = add_mod(add_mod(x0, x1), add_mod(x2, x3));
    s[b] = add_mod(t0123, add_mod(x0, add_mod(x1, x1)));
    s[b + 1] = add_mod(t0123, add_mod(x1, add_mod(x2, x2)));
    s[b + 2] = add_mod(t0123, add_mod(x2, add_mod(x3, x3)));
    s[b + 3] = add_mod(t0123, add_mod(x3, add_mod(x0, x0)));
#pragma unroll
    for (int j = 0; j < 4; ++j) sums[j] = add_mod(sums[j], s[b + j]);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = add_mod(s[i], sums[i & 3]);
}

// Round constants by width, read straight from the __constant__ symbols so
// the (compile-time) indices become constant-cache operands.
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

template <int W, int RP>
__global__ void __launch_bounds__(256)
poseidon2_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 long long n) {
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
  external_matrix<W>(s);
#pragma unroll
  for (int r = 0; r < kRF / 2; ++r) external_round<W>(s, r);
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    s[0] = sbox(add_mod(s[0], irc<W>(r)));
    uint32_t tot = s[0];
#pragma unroll
    for (int j = 1; j < W; ++j) tot = add_mod(tot, s[j]);
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = add_mod(tot, mont_mul(s[j], diag<W>(j)));
  }
#pragma unroll
  for (int r = kRF / 2; r < kRF; ++r) external_round<W>(s, r);
  uint4* dst = reinterpret_cast<uint4*>(out + i * W);
#pragma unroll
  for (int v = 0; v < W / 4; ++v)
    dst[v] = make_uint4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
}

}  // namespace

extern "C" {

// Copy one width's Montgomery-form constants into __constant__ memory of
// `device`: erc (8, width) row-major, irc (rp,), diag (width,).
int zk_poseidon2_set_constants(int device, int width, const uint32_t* erc,
                               const uint32_t* irc, const uint32_t* diag) {
  cudaError_t e = cudaSetDevice(device);
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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 16) {
    poseidon2_kernel<16, 13><<<blocks, threads, 0, st>>>(in, out, n);
  } else if (width == 24) {
    poseidon2_kernel<24, 21><<<blocks, threads, 0, st>>>(in, out, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
