// Exhaustive checks of special.cuh's fast paths on the card, bound with
// ctypes by ops/cuda_dirichlet.py (check_fast_paths): for every float of
// each fast path's domain, NormalOps gives the bits of the compiler's
// operation, and the two series give the same bits on NormalOps as on
// IeeeOps over [kNormalLo, kNormalHi]. Each check counts the floats whose
// bits differ (NaN against NaN counts as equal).
//
// Build: as dirichlet_solve.cu (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>

#include "special.cuh"

namespace tclip {

__device__ __forceinline__ bool differ(float a, float b) {
  return __float_as_uint(a) != __float_as_uint(b) && !(isnan(a) && isnan(b));
}

template <int kWhich>
__device__ __forceinline__ bool mismatch(float x) {
  if (kWhich == 0) return differ(NormalOps::rcp(x), IeeeOps::rcp(x));
  if (kWhich == 1)
    return differ(NormalOps::div(x, 252.0f, kRcp252), IeeeOps::div(x, 252.0f, 0.0f));
  if (kWhich == 2)
    return differ(NormalOps::div(x, 42.0f, kRcp42), IeeeOps::div(x, 42.0f, 0.0f));
  if (kWhich == 3)
    return differ(NormalOps::div(x, 1260.0f, kRcp1260),
                  IeeeOps::div(x, 1260.0f, 0.0f));
  if (kWhich == 4) return differ(NormalOps::log(x), IeeeOps::log(x));
  float a0, a1, b0, b1;
  if (kWhich == 5) {
    digamma_trigamma_series<NormalOps>(x, a0, a1);
    digamma_trigamma_series<IeeeOps>(x, b0, b1);
  } else {
    digamma_lgamma_series<NormalOps>(x, a0, a1);
    digamma_lgamma_series<IeeeOps>(x, b0, b1);
  }
  return differ(a0, b0) || differ(a1, b1);
}

// floats with bit patterns lo, lo + 1, ..., lo + n - 1
template <int kWhich>
__global__ void check_kernel(unsigned lo, unsigned long long n,
                             unsigned long long* bad) {
  unsigned long long count = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < n; i += stride)
    count += mismatch<kWhich>(__uint_as_float(lo + (unsigned)i));
  if (count) atomicAdd(bad, count);
}

template <int kWhich>
int launch(unsigned lo, unsigned hi, unsigned long long* bad,
           cudaStream_t stream) {
  check_kernel<kWhich><<<132 * 8, 256, 0, stream>>>(
      lo, (unsigned long long)hi - lo + 1, bad);
  return (int)cudaGetLastError();
}

// both signs of the magnitudes [lo, hi] (bit patterns of positive floats)
template <int kWhich>
int launch_signed(unsigned lo, unsigned hi, unsigned long long* bad,
                  cudaStream_t stream) {
  const int rc = launch<kWhich>(lo, hi, bad, stream);
  return rc != 0 ? rc : launch<kWhich>(lo | 0x80000000u, hi | 0x80000000u, bad,
                                       stream);
}

}  // namespace tclip

// which: 0 rcp on 2^-126 <= |x| < 2^126; 1, 2, 3 div by 252, 42, 1260 on
// 2^-100 <= |a| <= 2^100; 4 log on positive normal finite x; 5, 6
// digamma_trigamma_series and digamma_lgamma_series on
// [kNormalLo, kNormalHi]. Adds the count of differing floats to *bad;
// returns 0 or the cudaError_t of the launch.
extern "C" int tclip_special_check(int which, unsigned long long* bad,
                                   void* stream) {
  using namespace tclip;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned normal_lo = 0x00800000u;   // 2^-126 = kNormalLo
  const unsigned normal_hi = 0x53800000u;   // 2^40 = kNormalHi
  switch (which) {
    case 0: return launch_signed<0>(normal_lo, 0x7e7fffffu, bad, s);
    case 1: return launch_signed<1>(0x0d800000u, 0x71800000u, bad, s);
    case 2: return launch_signed<2>(0x0d800000u, 0x71800000u, bad, s);
    case 3: return launch_signed<3>(0x0d800000u, 0x71800000u, bad, s);
    case 4: return launch<4>(normal_lo, 0x7f7fffffu, bad, s);
    case 5: return launch<5>(normal_lo, normal_hi, bad, s);
    case 6: return launch<6>(normal_lo, normal_hi, bad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
