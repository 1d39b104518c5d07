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
//      resident first on ties, through merge_body's own quantities
//        pos_b[l] = l + #{i : (at[i], ass[i]) <= (bt[l], bss[l])}
//        jb[p]    = #{l : pos_b[l] <= p}
//      and ib, isb, ia derived from them exactly as there;
//   4. gather time, srcseq and nw packed payload words into [hc + w].
//
// What bounds it: bytes, at every shape family the port runs. A row
// reads its hc resident times, the residents' srcseq and payload behind
// the cleared prefix, its admitted run of st/sss and its w incoming
// payloads, and writes (2 + nw)(hc + w) words: ~3.3 KB at PHOLD's
// hc = 64, w = 24, nw = 1 and ~135 KB at the TCP packet stack's
// hc = w = 576, nw = 6, against a few hundred to a few thousand integer
// compares (chip_smoke.merge_bytes and merge_ops count both per input).
//
// Design (PERF.md has the measurements behind each choice):
// - One warp per row, 8 rows per block (fewer when a block's shared
//   memory would pass 232,448 B or h is smaller; core/merge.py
//   `launch_plan` makes the plan, the launcher checks it). No phase needs
//   the block: every barrier is a __syncwarp, and a warp whose row lies
//   past h leaves at once. At H = 4096 that is 512 blocks of 256
//   threads; 1, 2, 4 or 8 rows per block time the same at PHOLD's shape.
// - One step of cp.async copies stages the row's keys in shared memory
//   (16-byte copies where both sides agree modulo 16, else 8-byte ones):
//   resident times and srcseq whole, and the densified incoming run once
//   starts and cnt are read. Fetching srcseq only behind the cleared
//   prefix, once k is known, reads fewer bytes but adds a dependent
//   round trip: at PHOLD's shapes (nw = 1, where nothing else differed)
//   that version took 7.62 and 9.07 us against 7.34 and 8.81 us now.
// - k, the cleared-prefix length, is the first set bit of a ballot over
//   32 slots at a time.
// - pos_b is an exact count on every input. When the row's residents
//   are in key order, which an __all_sync over adjacent pairs checks
//   per row, the predicate (at[i], ass[i]) <= b holds on a prefix of
//   them and fails after it, so a binary search returns the count
//   itself: log hc steps per incoming lane. Otherwise the count is taken
//   in full, one __ballot_sync + __popc per 32 residents per incoming
//   lane. A co-rank search taken without that check would give other
//   counts on an unsorted row, and merge_body's output depends on them.
// - jb is exact on every input without an O((hc + w) w) loop: a shared
//   histogram of pos_b (integer atomics, so the order of adds does not
//   matter) and a warp prefix scan (__shfl_up_sync) over hc + w slots.
// - Stores are coalesced: a warp writes a row's times, srcseq and
//   [hc + w, nw] payload span each as one contiguous lane-strided run,
//   the payload in 16-byte units when nw is even (the packet stack's 6)
//   and in 8-byte words otherwise (PHOLD's 1). Each unit is read from
//   qpay or bpay through its slot's source code in shared memory, eight
//   loads in flight per lane.
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr size_t kSmemLimit = 232448;
constexpr int kPayloadUnroll = 8;

// Shared bytes one row takes: rt, rss [hc] i64; bt, bss [w] i64;
// pos_b [w] i32; slot [hc + w] i32; rounded up to 16 bytes.
__host__ __device__ size_t row_smem_bytes(int hc, int w) {
  const size_t b = 16 * static_cast<size_t>(hc) +
                   20 * static_cast<size_t>(w) +
                   4 * static_cast<size_t>(hc + w);
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ bool key_le(int64_t at, int64_t as, int64_t bt,
                                       int64_t bs) {
  return at < bt || (at == bt && as <= bs);
}

__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(int64_t* dst, const int64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy n i64 from device to shared memory, lane-strided, asynchronously:
// 16-byte pieces when src and dst agree modulo 16, else 8-byte ones.
__device__ __forceinline__ void stage(int64_t* dst, const int64_t* src,
                                      int n, int lane) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = __cvta_generic_to_shared(dst);
  int head = n, pairs = 0;
  if (((s ^ d) & 15) == 0) {
    head = min(n, (s & 15) ? 1 : 0);
    pairs = (n - head) / 2;
  }
  for (int j = lane; j < head; j += 32) cp_async8(dst + j, src + j);
  for (int j = lane; j < pairs; j += 32) {
    cp_async16(dst + head + 2 * j, src + head + 2 * j);
  }
  for (int j = head + 2 * pairs + lane; j < n; j += 32) {
    cp_async8(dst + j, src + j);
  }
}

// One row's staging area in shared memory (row_smem_bytes).
struct RowSmem {
  int64_t* rt;     // [hc] resident times
  int64_t* rss;    // [hc] resident srcseq
  int64_t* bt;     // [w] densified incoming times
  int64_t* bss;    // [w] densified incoming srcseq
  int32_t* pos_b;  // [w]
  int32_t* slot;   // [hc + w]: histogram of pos_b, then source codes
};

__device__ __forceinline__ RowSmem carve(unsigned char* base, int hc,
                                         int w) {
  RowSmem r;
  r.rt = reinterpret_cast<int64_t*>(base);
  r.rss = r.rt + hc;
  r.bt = r.rss + hc;
  r.bss = r.bt + w;
  r.pos_b = reinterpret_cast<int32_t*>(r.bss + w);
  r.slot = r.pos_b + w;
  return r;
}

// The kernel's operands; the inputs are read-only for its whole run.
struct Args {
  const int64_t* qt;
  const int64_t* qss;
  const int64_t* qpay;
  const int64_t* st;
  const int64_t* sss;
  const int64_t* bpay;
  const int32_t* starts;
  const int32_t* cnt;
  int64_t* ot;
  int64_t* oss;
  int64_t* opay;
  int h, hc, w, m, nw;
};

// Start the async copies of row `row`'s keys into r: the resident times
// and srcseq whole, and the admitted run of st/sss at s0 (min(c0, w)
// entries); fillers and the histogram's zeros are stored directly.
__device__ __forceinline__ void stage_row(const Args& a, const RowSmem& r,
                                          int64_t row, int64_t s0, int c0,
                                          int lane) {
  const int hc = a.hc, w = a.w;
  stage(r.rt, a.qt + row * hc, hc, lane);
  stage(r.rss, a.qss + row * hc, hc, lane);
  const int nin = min(max(c0, 0), w);
  if (s0 + nin <= a.m) {
    stage(r.bt, a.st + s0, nin, lane);
    stage(r.bss, a.sss + s0, nin, lane);
  } else {  // past the end of st: merge_body clamps the index to m - 1
    for (int l = lane; l < nin; l += 32) {
      const int64_t g = s0 + l < a.m ? s0 + l : a.m - 1;
      cp_async8(r.bt + l, a.st + g);
      cp_async8(r.bss + l, a.sss + g);
    }
  }
  for (int l = nin + lane; l < w; l += 32) {
    r.bt[l] = kI64Max;
    r.bss[l] = kI64Max;
  }
  for (int p = lane; p < hc + w; p += 32) r.slot[p] = 0;
}

// Move a row's [ncol, nw] payload span, lane-strided in units of U words
// (U = 2 as 16-byte loads and stores, U = 1 as 8-byte ones), each unit
// read through the source code of its slot: up to kPayloadUnroll loads
// in flight per lane.
template <typename T, int U>
__device__ __forceinline__ void move_payload(const Args& a, const int32_t* slot,
                                             int64_t row, int lane) {
  const int hc = a.hc, w = a.w, nu = a.nw / U;  // units per slot
  const int64_t total = static_cast<int64_t>(hc + w) * nu;
  const T* qp = reinterpret_cast<const T*>(a.qpay + row * hc * a.nw);
  const T* bp = reinterpret_cast<const T*>(a.bpay + row * w * a.nw);
  T* op = reinterpret_cast<T*>(a.opay + row * (hc + w) * a.nw);
  const int q32 = 32 / nu, r32 = 32 % nu;
  int p = lane / nu, wd = lane % nu;  // slot and unit of element x
  for (int64_t x0 = lane; x0 < total; x0 += 32 * kPayloadUnroll) {
    T v[kPayloadUnroll];
#pragma unroll
    for (int u = 0; u < kPayloadUnroll; ++u) {
      v[u] = T{};
      if (x0 + 32 * u < total) {
        const int code = slot[p];
        if (code >= hc) {
          v[u] = __ldg(bp + static_cast<int64_t>(code - hc) * nu + wd);
        } else if (code >= 0) {
          v[u] = __ldg(qp + static_cast<int64_t>(code) * nu + wd);
        }
      }
      p += q32;
      wd += r32;
      if (wd >= nu) {
        wd -= nu;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kPayloadUnroll; ++u) {
      if (x0 + 32 * u < total) op[x0 + 32 * u] = v[u];
    }
  }
}

// Merge one staged row and write its outputs. All 32 lanes take part.
__device__ __forceinline__ void merge_row(const Args& a, const RowSmem& r,
                                          int64_t row, int lane) {
  const int hc = a.hc, w = a.w, ncol = hc + w;

  // -- k = length of the leading TIME_INVALID run
  int k = hc;
  for (int c = 0; c < hc; c += 32) {
    const int i = c + lane;
    const unsigned live =
        __ballot_sync(kFull, i < hc && r.rt[i] != kI64Max);
    if (live) {
      k = c + __ffs(live) - 1;
      break;
    }
  }

  // -- are the residents rt/rss[k .. hc) in key order?
  bool sorted = true;
  for (int c = k + 1; c < hc; c += 32) {
    const int i = c + lane;
    const bool ok =
        i >= hc || key_le(r.rt[i - 1], r.rss[i - 1], r.rt[i], r.rss[i]);
    if (!__all_sync(kFull, ok)) {
      sorted = false;
      break;
    }
  }

  // -- pos_b: the rotated row is rt/rss[k .. hc) and then k fillers
  //    (i64 max, 0), which are <= b only when bt = i64 max and bss >= 0
  if (sorted) {
    for (int l = lane; l < w; l += 32) {
      const int64_t b = r.bt[l], bs = r.bss[l];
      int lo = k, hi = hc;  // first resident not <= b
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_le(r.rt[mid], r.rss[mid], b, bs)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int fill = (b == kI64Max && bs >= 0) ? k : 0;
      r.pos_b[l] = l + (lo - k) + fill;
    }
  } else {
    for (int l = 0; l < w; ++l) {
      const int64_t b = r.bt[l], bs = r.bss[l];
      int n = 0;
      for (int c = k; c < hc; c += 32) {
        const int i = c + lane;
        n += __popc(__ballot_sync(
            kFull, i < hc && key_le(r.rt[i], r.rss[i], b, bs)));
      }
      if (lane == 0) {
        r.pos_b[l] = l + n + ((b == kI64Max && bs >= 0) ? k : 0);
      }
    }
  }
  __syncwarp();
  // pos_b[l] lies in [l, l + hc], inside [0, ncol)
  for (int l = lane; l < w; l += 32) atomicAdd(&r.slot[r.pos_b[l]], 1);
  __syncwarp();

  // -- jb by an inclusive scan of the histogram; times and srcseq out,
  //    each slot's payload source left in slot[p]: hc + ib for incoming,
  //    the resident's index in the row, or -1 for a zero filler
  int64_t* ot_r = a.ot + row * ncol;
  int64_t* oss_r = a.oss + row * ncol;
  int carry = 0;
  for (int c = 0; c < ncol; c += 32) {
    const int p = c + lane;
    int v = p < ncol ? r.slot[p] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    const int jb = carry + v;
    carry += __shfl_sync(kFull, v, 31);
    if (p < ncol) {
      const int ib = min(max(jb - 1, 0), w - 1);
      const bool isb = jb > 0 && r.pos_b[ib] == p;
      const int ra = min(max(p - jb, 0), hc - 1) + k;
      int64_t t = kI64Max, s = 0;
      int code = -1;
      if (isb) {
        t = r.bt[ib];
        s = r.bss[ib];
        code = hc + ib;
      } else if (ra < hc) {
        t = r.rt[ra];
        s = r.rss[ra];
        code = ra;
      }
      ot_r[p] = t;
      oss_r[p] = s;
      r.slot[p] = code;
    }
  }
  __syncwarp();

  // -- payload: 16-byte units when a slot's words pair up and the row's
  //    spans are 16-byte aligned, else 8-byte words
  const uintptr_t spans =
      reinterpret_cast<uintptr_t>(a.qpay + row * hc * a.nw) |
      reinterpret_cast<uintptr_t>(a.bpay + row * w * a.nw) |
      reinterpret_cast<uintptr_t>(a.opay + row * ncol * a.nw);
  if ((a.nw & 1) == 0 && (spans & 15) == 0) {
    move_payload<longlong2, 2>(a, r.slot, row, lane);
  } else {
    move_payload<int64_t, 1>(a, r.slot, row, lane);
  }
}

// Warp r of block b merges row b * warps_per_block + r.
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
merge_rows(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= a.h) return;  // the whole warp: nothing below syncs the block
  const RowSmem r =
      carve(smem + warp * row_smem_bytes(a.hc, a.w), a.hc, a.w);
  stage_row(a, r, row, __ldg(a.starts + row), __ldg(a.cnt + row), lane);
  cp_async_wait_all();
  __syncwarp();
  merge_row(a, r, row, lane);
}

}  // namespace

extern "C" size_t shadow_merge_row_smem_bytes(int hc, int w) {
  return row_smem_bytes(hc, w);
}

// Launches on `stream` with the grid core/merge.py `launch_plan` chose:
// `blocks` blocks of `warps_per_block` warps, one row each, and `smem`
// dynamic shared bytes per block. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a plan this kernel cannot take.
extern "C" int shadow_merge_launch(const int64_t* qt, const int64_t* qss,
                                   const int64_t* qpay, const int64_t* st,
                                   const int64_t* sss, const int64_t* bpay,
                                   const int32_t* starts, const int32_t* cnt,
                                   int64_t* ot, int64_t* oss, int64_t* opay,
                                   int h, int hc, int w, int m, int nw,
                                   int blocks, int warps_per_block,
                                   size_t smem, void* stream) {
  if (h == 0) return 0;
  if (warps_per_block < 1 || warps_per_block > kMaxWarpsPerBlock ||
      static_cast<int64_t>(blocks) * warps_per_block < h ||
      smem < warps_per_block * row_smem_bytes(hc, w) || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Args a{qt, qss, qpay, st, sss, bpay, starts, cnt, ot, oss, opay,
               h, hc, w, m, nw};
  merge_rows<<<blocks, 32 * warps_per_block, smem,
               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* shadow_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
