// Banded Needleman-Wunsch wavefront, score only, for Hopper (sm_90a).
//
// The GPU implementation of kma_tpu/ops/nw_kernel.py (the plain
// jax.numpy twin, nw_band_score_plain, defines the semantics; see its
// module docstring for the sheared-band geometry).  One warp scores one
// alignment: the L band lanes live in registers, PER = L / 32 lanes per
// thread, lane n = thread * PER + j.  Per DP row:
//   - the D[n-1]/P[n-1] neighbour read is a one-lane rotation (a warp
//     shuffle for the first lane of each thread),
//   - the within-row gap recurrence is an exclusive suffix max (in-thread
//     scan plus a warp shuffle scan over the thread totals),
//   - the match score is a 6x6 table in shared memory indexed by the
//     template code of the row and the query code of the lane.
// Rows run to the alignment's own t_len (rows past it are inactive in
// the plain loop, which leaves the state unchanged).
//
// Build (done at first use by nw_kernel.build_cuda_lib):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libkma_nw_band.so
//        nw_band.cu

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNegCap = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int PER>
__global__ void nw_band_kernel(const int32_t* __restrict__ t_len_p,
                               const int32_t* __restrict__ q_len_p,
                               const int32_t* __restrict__ kflag_p,
                               const int32_t* __restrict__ hband_p,
                               const uint8_t* __restrict__ qext,
                               const uint8_t* __restrict__ tcol,
                               const int8_t* __restrict__ dm,
                               int32_t* __restrict__ out, int B, int R,
                               int W1, int U, int MM) {
  constexpr int L = 32 * PER;
  __shared__ int32_t sdm[36];
  if (threadIdx.x < 36) sdm[threadIdx.x] = dm[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lid = threadIdx.x & 31;
  if (b >= B) return;

  const int tl = t_len_p[b], ql = q_len_p[b], kf = kflag_p[b];
  const int hb = hband_p[b];
  const int bq_len = 2 * hb + 1;
  const int neg = (tl + ql) * (MM + U + W1);
  const int c_pos0 = (tl + ql) >> 1;
  const int sn0 = ql - 1 - (c_pos0 - hb);
  const int Up = W1 > U ? W1 : U;
  const int n0 = lid * PER;

  int D[PER], P[PER], D2[PER], P2[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int n = n0 + j;
    int d = n < sn0 ? W1 + (sn0 - n - 1) * U : neg;
    if (n == sn0) d = 0;
    if (kf == 2 && n <= sn0) d = 0;
    int p = (n == sn0 && kf != 2) ? 0 : neg;
    if (n > bq_len) {
      d = kNegCap;
      p = kNegCap;
    }
    D[j] = D2[j] = d;
    P[j] = P2[j] = p;
  }
  int best = neg, en = 0;
  const uint8_t* qx = qext + (size_t)b * (R + L);
  const int rows = tl < R ? tl : R;

  for (int i = 0; i < rows; ++i) {
    const int c_pos = c_pos0 - i;
    const int sq_raw = c_pos + hb, eq_raw = c_pos - hb;
    en = eq_raw < 0 ? en + 1 : 0;
    const int eq = eq_raw > 0 ? eq_raw : 0;
    const bool interior = sq_raw < ql - 1;
    const int sn_cell = en + (ql - eq);
    const int edge_val = kf > 0 ? 0 : W1 + i * U;
    const int bval = interior ? neg : edge_val;
    const int blane = interior ? bq_len : sn_cell;
    const int top = blane - 1;
    const int* trow = sdm + 6 * (int)tcol[(size_t)i * B + b];
    const uint8_t* qrow = qx + (R - 1 - i);

    // neighbour lane n-1 (lane 0 wraps to lane L-1, as a rotation)
    const int src = (lid + 31) & 31;
    const int dl = __shfl_sync(kFull, D[PER - 1], src);
    const int pl = __shfl_sync(kFull, P[PER - 1], src);

    int D0[PER], Pv[PER], msc[PER], s[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int n = n0 + j;
      const int dm1 = j ? D[j - 1] : dl;
      const int pm1 = j ? P[j - 1] : pl;
      msc[j] = trow[qrow[n]];
      const int pv = max(dm1 + W1, pm1 + U);
      const int d0 = max(pv, D[j] + msc[j]);
      const bool inloop = n >= en + 1 && n <= top;
      int d0b = n == blane ? bval : d0;
      if (!(inloop || n == blane)) d0b = kNegCap;
      s[j] = n <= bq_len ? d0b + n * Up : kNegCap;
      D0[j] = d0;
      Pv[j] = pv;
    }
    // exclusive suffix max over lanes > n, floored at kNegCap
    int tot = s[0];
#pragma unroll
    for (int j = 1; j < PER; ++j) tot = max(tot, s[j]);
    int incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(kFull, incl, off);
      if (lid + off < 32) incl = max(incl, o);
    }
    int after = __shfl_down_sync(kFull, incl, 1);
    if (lid == 31) after = kNegCap;
    int run = max(after, kNegCap);
    int den_local = 0;
#pragma unroll
    for (int j = PER - 1; j >= 0; --j) {
      const int n = n0 + j;
      const int Q = run - (n + 1) * Up + W1;
      run = max(run, s[j]);
      const bool inloop = n >= en + 1 && n <= top;
      int dn = inloop ? max(D0[j], Q) : D[j];
      int pn = inloop ? Pv[j] : P[j];
      if (n == en) {
        dn = max(D[j] + msc[j], Q);
        pn = neg;
      }
      if (!interior && n == sn_cell) {
        dn = edge_val;
        pn = neg;
      }
      if (!(n >= en && n <= blane)) {
        dn = D2[j];
        pn = P2[j];
      }
      if (n == en) den_local = dn;
      D2[j] = D[j];
      P2[j] = P[j];
      D[j] = dn;
      P[j] = pn;
    }
    // den = D[en] (0 when en is past the last lane)
    const int owner = en / PER;
    int den = __shfl_sync(kFull, den_local, owner < 32 ? owner : 0);
    if (owner >= 32) den = 0;
    if (eq_raw <= 0 && kf < 0 && best < den) best = den;
  }

  // final score (nw.c:1155-1175)
  int den_local = 0, rmax = kNegCap;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int n = n0 + j;
    if (n == en) den_local = D[j];
    if (n >= en && n < bq_len) rmax = max(rmax, D[j]);
  }
  const int owner = en / PER;
  int den = __shfl_sync(kFull, den_local, owner < 32 ? owner : 0);
  if (owner >= 32) den = 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    rmax = max(rmax, __shfl_xor_sync(kFull, rmax, off));
  int score = kf < 0 ? max(best, den) : den;
  if (kf == -2) score = max(score, rmax);
  if (lid == 0) out[b] = score;
}

ffi::Error NwBandImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> t_len,
                      ffi::Buffer<ffi::S32> q_len,
                      ffi::Buffer<ffi::S32> kflag,
                      ffi::Buffer<ffi::S32> hband,
                      ffi::Buffer<ffi::U8> qext, ffi::Buffer<ffi::U8> tcol,
                      ffi::Buffer<ffi::S8> dm,
                      ffi::ResultBuffer<ffi::S32> out, int32_t W1,
                      int32_t U, int32_t MM) {
  const auto qd = qext.dimensions();
  const auto td = tcol.dimensions();
  if (qd.size() != 2 || td.size() != 2 || dm.element_count() != 36)
    return ffi::Error::InvalidArgument("nw_band: bad operand ranks");
  const int R = (int)td[0], B = (int)td[1];
  const int L = (int)qd[1] - R;
  if ((int)qd[0] != B || (int)t_len.element_count() != B)
    return ffi::Error::InvalidArgument("nw_band: batch mismatch");
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * kWarpsPerBlock;
  if (B == 0) return ffi::Error::Success();
  switch (L) {
    case 128:
      nw_band_kernel<4><<<blocks, threads, 0, stream>>>(
          t_len.typed_data(), q_len.typed_data(), kflag.typed_data(),
          hband.typed_data(), qext.typed_data(), tcol.typed_data(),
          dm.typed_data(), out->typed_data(), B, R, W1, U, MM);
      break;
    case 256:
      nw_band_kernel<8><<<blocks, threads, 0, stream>>>(
          t_len.typed_data(), q_len.typed_data(), kflag.typed_data(),
          hband.typed_data(), qext.typed_data(), tcol.typed_data(),
          dm.typed_data(), out->typed_data(), B, R, W1, U, MM);
      break;
    default:
      return ffi::Error::InvalidArgument("nw_band: lane width not 128/256");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    KmaNwBand, NwBandImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<int32_t>("W1")
        .Attr<int32_t>("U")
        .Attr<int32_t>("MM"));
