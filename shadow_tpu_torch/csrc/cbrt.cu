// CUBIC's f32 cube root for Hopper (sm_90a), bit for bit as XLA's CPU
// backend computes jnp.cbrt (shadow_tpu/transport/tcp.py:586):
//
//   cbrt(x) = copysign(powf(|x|, f32(1/3)), x)
//
// with powf glibc 2.36's FMA build (sysdeps/ieee754/flt-32/e_powf.c, the
// ifunc's choice on x86-64 with FMA), run under FTZ/DAZ. No TPU kernel
// corresponds: XLA calls glibc there. transport/cbrt.py holds the same
// arithmetic as plain PyTorch (`cbrt_plain`) and the tables' provenance.
//
// One thread per element, a grid-stride loop. Every multiply-add that
// glibc's binary fuses is an explicit __fma_rn; every other operation is
// an unfused __dmul_rn / __dadd_rn / __dsub_rn, and the file is built
// with --fmad=false, so nvcc contracts nothing else.
//
// What bounds it: bytes. An element reads 4 B and writes 4 B against ~25
// double operations; at H100 rates (3.35 TB/s, 67 TFLOP/s f64 on the
// FMA pipes) 8 B take ~2.4 ps and 25 f64 operations ~0.37 ps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// glibc 2.36 __powf_log2_data: (1/c, log2 c) and the log2 polynomial
__constant__ double kInvc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0,
    0x1.0000000000000p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1,
    0x1.767dcf5534862p-1};
__constant__ double kLogc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5,
    0x0.0p+0,              0x1.338ca9f24f53dp-4,  0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3,  0x1.40645f0c6651cp-2,  0x1.88e9c2c1b9ff8p-2,
    0x1.ce0a44eb17bccp-2};
constexpr double kA0 = 0x1.27616c9496e0bp-2;
constexpr double kA1 = -0x1.71969a075c67ap-2;
constexpr double kA2 = 0x1.ec70a6ca7baddp-2;
constexpr double kA3 = -0x1.7154748bef6c8p-1;
constexpr double kA4 = 0x1.71547652ab82bp+0;

// glibc 2.36 __exp2f_data: 2^(i/32) less i << 47, as bits
__constant__ uint64_t kExp2[32] = {
    0x3FF0000000000000ull, 0x3FEFD9B0D3158574ull, 0x3FEFB5586CF9890Full,
    0x3FEF9301D0125B51ull, 0x3FEF72B83C7D517Bull, 0x3FEF54873168B9AAull,
    0x3FEF387A6E756238ull, 0x3FEF1E9DF51FDEE1ull, 0x3FEF06FE0A31B715ull,
    0x3FEEF1A7373AA9CBull, 0x3FEEDEA64C123422ull, 0x3FEECE086061892Dull,
    0x3FEEBFDAD5362A27ull, 0x3FEEB42B569D4F82ull, 0x3FEEAB07DD485429ull,
    0x3FEEA47EB03A5585ull, 0x3FEEA09E667F3BCDull, 0x3FEE9F75E8EC5F74ull,
    0x3FEEA11473EB0187ull, 0x3FEEA589994CCE13ull, 0x3FEEACE5422AA0DBull,
    0x3FEEB737B0CDC5E5ull, 0x3FEEC49182A3F090ull, 0x3FEED503B23E255Dull,
    0x3FEEE89F995AD3ADull, 0x3FEEFF76F2FB5E47ull, 0x3FEF199BDD85529Cull,
    0x3FEF3720DCEF9069ull, 0x3FEF5818DCFBA487ull, 0x3FEF7C97337B9B5Full,
    0x3FEFA4AFA2A490DAull, 0x3FEFD0765B6E4540ull};
constexpr double kShift = 0x1.8p+47;  // 0x1.8p52 / 32
constexpr double kC0 = 0x1.c6af84b912394p-5;
constexpr double kC1 = 0x1.ebfce50fac4f3p-3;
constexpr double kC2 = 0x1.62e42ff0c52d6p-1;

constexpr double kThird = 0x1.555556p-2;  // f32(1/3), widened
constexpr uint32_t kOff = 0x3f330000u;
// a subnormal x under DAZ: powf's x * 0x1p23f reads 0, so its integer
// image is 0 - (23 << 23) modulo 2^32
constexpr uint32_t kDazIx = 0u - (23u << 23);

// glibc's powf(x, f32(1/3)) for the integer image ix of x > 0 (normal,
// or kDazIx); log2_inline then exp2_inline of e_powf.c
__device__ __forceinline__ uint32_t powf_third_bits(uint32_t ix) {
  const uint32_t tmp = ix - kOff;
  const int i = static_cast<int>((tmp >> 19) & 15u);
  const uint32_t top = tmp & 0xff800000u;
  const uint32_t iz = ix - top;
  const int k = static_cast<int32_t>(top) >> 23;
  const double z = static_cast<double>(__uint_as_float(iz));
  const double r = __fma_rn(z, kInvc[i], -1.0);
  const double y0 = __dadd_rn(kLogc[i], static_cast<double>(k));
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(r, kA0, kA1);
  const double p = __fma_rn(r, kA2, kA3);
  const double r4 = __dmul_rn(r2, r2);
  double q = __fma_rn(r, kA4, y0);
  q = __fma_rn(p, r2, q);
  y = __fma_rn(y, r4, q);
  const double ylogx = __dmul_rn(y, kThird);

  double kd = __dadd_rn(ylogx, kShift);
  const uint64_t ki = static_cast<uint64_t>(__double_as_longlong(kd));
  kd = __dsub_rn(kd, kShift);
  const double e = __dsub_rn(ylogx, kd);
  const double s =
      __longlong_as_double(static_cast<long long>(kExp2[ki & 31] + (ki << 47)));
  const double zz = __fma_rn(e, kC0, kC1);
  const double e2 = __dmul_rn(e, e);
  double w = __fma_rn(e, kC2, 1.0);
  w = __fma_rn(zz, e2, w);
  w = __dmul_rn(w, s);
  return __float_as_uint(__double2float_rn(w));
}

__global__ void cbrt_kernel(const uint32_t* __restrict__ x,
                            uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const uint32_t bits = x[j];
    const uint32_t sign = bits & 0x80000000u;
    const uint32_t ix = bits & 0x7fffffffu;
    uint32_t r;
    if (ix == 0) {
      r = 0;
    } else if (ix >= 0x7f800000u) {  // powf returns |x| * |x|: nan quieted
      r = ix > 0x7f800000u ? (ix | 0x00400000u) : ix;
    } else {
      r = powf_third_bits(ix < 0x00800000u ? kDazIx : ix);
    }
    out[j] = r | sign;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100

}  // namespace

// out[j] = cbrt(x[j]) for j < n, on `stream`. Returns cudaGetLastError().
extern "C" int shadow_cbrt_launch(const void* x, void* out, int64_t n,
                                  void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cbrt_kernel<<<static_cast<int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shadow_cbrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
