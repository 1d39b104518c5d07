// Fused queue merge for Hopper (sm_90a): densify + rotate + merge-path.
//
// Replaces the Pallas kernel of shadow_tpu/core/merge_pallas.py:125
// (`_build_call` -> `_kernel`, called through `fused_merge`), whose
// arithmetic is `merge_body` there and in shadow_tpu_torch/core/merge.py.
// Per host row g:
//   1. densify the row's admitted incoming run out of the flat,
//      destination-grouped keys st/sss at starts[g] .. starts[g]+cnt[g]-1
//      (i64-max fillers past the count);
//   2. rotate the row's leading TIME_INVALID prefix (k slots) to the tail;
//   3. stable merge of resident [hc] and incoming [w] on (time, srcseq),
//      resident first on ties, with the merge-path quantities of
//      merge_body (pos_b, jb, isb, ia, ib) computed exactly as there, so
//      the output equals the plain version on every input, sorted or not;
//   4. gather time, srcseq and nw packed payload words into [hc + w].
//
// What bounds it: bytes. At the PHOLD shape (hc = 64, w = 24, nw = 1) a
// row reads ~2120 B and writes 2112 B against ~3.6k i64 compares, so
// H = 4096 rows move 17.3 MB: ~5.2 us at 3.35 TB/s. The design answers
// that simply: one block per row reads each resident and incoming key
// from device memory once into shared memory, every compare runs out of
// shared memory, and one thread per output slot writes the row once.
// Payload words are read straight from device memory by the slot that
// selects them (each word is read at most once). No tensor cores, TMA or
// tuning: the first port is right first.
//
// Preconditions: all arrays contiguous and m >= 1, which the Python
// wrapper checks; starts[g] >= 0, which the caller guarantees (queue_push
// takes starts from a searchsorted) and nothing checks, since a check
// would cost a device-to-host read per launch. A negative start reads
// before st. The time sentinel TIME_INVALID is i64 max.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int64_t kI64Max = INT64_MAX;

__global__ void merge_rows(const int64_t* __restrict__ qt,
                           const int64_t* __restrict__ qss,
                           const int64_t* __restrict__ qpay,
                           const int64_t* __restrict__ st,
                           const int64_t* __restrict__ sss,
                           const int64_t* __restrict__ bpay,
                           const int32_t* __restrict__ starts,
                           const int32_t* __restrict__ cnt,
                           int64_t* __restrict__ ot,
                           int64_t* __restrict__ oss,
                           int64_t* __restrict__ opay,
                           int hc, int w, int m, int nw) {
  extern __shared__ int64_t smem[];
  int64_t* at = smem;                                   // [hc] rotated times
  int64_t* ass = at + hc;                               // [hc] rotated srcseq
  int64_t* bt = ass + hc;                               // [w] densified times
  int64_t* bss = bt + w;                                // [w] densified srcseq
  int32_t* pos_b = reinterpret_cast<int32_t*>(bss + w); // [w]
  __shared__ int k_sh;

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ncol = hc + w;
  const int64_t* qt_r = qt + row * hc;
  const int64_t* qss_r = qss + row * hc;

  // k = length of the row's leading TIME_INVALID run (merge_body's
  // sum of the cumulative product of the empty mask)
  if (tid == 0) k_sh = hc;
  __syncthreads();
  for (int i = tid; i < hc; i += nt) {
    if (qt_r[i] != kI64Max) atomicMin(&k_sh, i);
  }
  __syncthreads();
  const int k = k_sh;

  for (int j = tid; j < hc; j += nt) {
    const int r = j + k;
    if (r < hc) {
      at[j] = qt_r[r];
      ass[j] = qss_r[r];
    } else {
      at[j] = kI64Max;
      ass[j] = 0;
    }
  }
  const int64_t s0 = starts[row];
  const int c0 = cnt[row];
  for (int l = tid; l < w; l += nt) {
    const bool ok = l < c0;
    int64_t g = s0 + l;
    g = g < m - 1 ? g : m - 1;
    bt[l] = ok ? st[g] : kI64Max;
    bss[l] = ok ? sss[g] : kI64Max;
  }
  __syncthreads();

  // pos_b[l] = l + #{i : (at[i], ass[i]) <= (bt[l], bss[l])}
  for (int l = tid; l < w; l += nt) {
    const int64_t b = bt[l];
    const int64_t bs = bss[l];
    int n = 0;
    for (int i = 0; i < hc; ++i) {
      const int64_t a = at[i];
      n += (a < b) | ((a == b) & (ass[i] <= bs));
    }
    pos_b[l] = l + n;
  }
  __syncthreads();

  for (int p = tid; p < ncol; p += nt) {
    int jb = 0;
    for (int l = 0; l < w; ++l) jb += pos_b[l] <= p;
    const int ib = min(max(jb - 1, 0), w - 1);
    const bool isb = jb > 0 && pos_b[ib] == p;
    const int ia = min(max(p - jb, 0), hc - 1);
    const int64_t o = row * ncol + p;
    int64_t* op = opay + o * nw;
    if (isb) {
      ot[o] = bt[ib];
      oss[o] = bss[ib];
      const int64_t* src = bpay + (row * w + ib) * nw;
      for (int x = 0; x < nw; ++x) op[x] = src[x];
    } else {
      ot[o] = at[ia];
      oss[o] = ass[ia];
      const int r = ia + k;
      if (r < hc) {
        const int64_t* src = qpay + (row * hc + r) * nw;
        for (int x = 0; x < nw; ++x) op[x] = src[x];
      } else {
        for (int x = 0; x < nw; ++x) op[x] = 0;
      }
    }
  }
}

}  // namespace

extern "C" size_t shadow_merge_smem_bytes(int hc, int w) {
  return (2 * static_cast<size_t>(hc) + 2 * static_cast<size_t>(w)) *
             sizeof(int64_t) +
         static_cast<size_t>(w) * sizeof(int32_t);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int shadow_merge_launch(const int64_t* qt, const int64_t* qss,
                                   const int64_t* qpay, const int64_t* st,
                                   const int64_t* sss, const int64_t* bpay,
                                   const int32_t* starts, const int32_t* cnt,
                                   int64_t* ot, int64_t* oss, int64_t* opay,
                                   int h, int hc, int w, int m, int nw,
                                   void* stream) {
  if (h == 0) return 0;
  const size_t smem = shadow_merge_smem_bytes(hc, w);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = hc + w <= 128 ? 128 : 256;
  merge_rows<<<h, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      qt, qss, qpay, st, sss, bpay, starts, cnt, ot, oss, opay, hc, w, m, nw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shadow_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
