// Row accumulation, the transpose of a row gather, for Hopper (sm_90a):
//   out[r, :] = sum over n with idx[n] == r of val[n, :].
//
// Replaces the Pallas TPU kernel skybox_rt_tpu/diff/pallas_texgrad.py
// (_kernel, launched by accumulate_rows): the backward pass of the texel
// gather, of the per-tile record gather and of the vertex gathers of the
// differentiable pipeline.  The TPU kernel is a one-hot matrix product over
// a grid that runs in order, which is what makes its sum deterministic.
// Blocks on this card run in no order, so the design is this port's own.
//
// Contract: idx (N,) int32, val (N, C) float32 -> out (R, C) float32, any R
// and C.  An idx outside [0, R) is dropped, a negative one too.  float32
// additions only, and THE ORDER OF THE ADDITIONS INTO A ROW IS A FUNCTION OF
// (N, idx) ALONE, never of the schedule: two launches on the same inputs
// are equal bit for bit, and the plain torch version
// (diff/cuda_texgrad.accumulate_rows_reference) repeats the order exactly.
// No floating-point atomics anywhere.
//
// Order: n is cut into S segments of equal length L (both functions of N:
// see segments() in the wrapper).  partial[s, r, :] = 0 + the val[n, :] of
// segment s with idx[n] == r, added one by one in ascending n.  out[r, :] =
// 0 + partial[0, r, :] + partial[1, r, :] + ... in ascending s.  An empty
// (s, r) group adds +0, and a round-to-nearest sum that starts from +0 is
// never -0, so skipping the empty groups changes no bit.
//
// Design, a stable counting sort (group = (row, segment), key = r * S + s):
//   1. count   the kept values of every key (int atomics, one a peer group
//              of a warp: exact and free of order);
//   2. scan    the S * R counts in key order, one pass: a block takes a
//              chunk of whole rows (at most kScanKeys keys), scans it in
//              shared memory and finds its prefix by decoupled look-back
//              over the chunks before it, 32 at a time (each publishes its
//              sum, then its inclusive prefix, in one 64-bit word); every group gets its
//              offset, a row's groups are contiguous, segment by segment.
//              The same block marks its rows with more than kLongRow values
//              "long" and gives each a slot of a dense (slot, S, C) table of
//              partials;
//   3. place   one block a segment walks its L values in ascending n,
//              kThreads at a time; a value's rank in its group is its rank
//              among its warp's peers (__match_any_sync) plus the matches in
//              the earlier warps of the chunk (counted a warp at a time in a
//              shared-memory hash of the chunk's rows) plus the group's
//              cursor, which only this block advances (no atomic).  perm[offset + rank] =
//              n.  The cursors advance the offsets in place: afterwards
//              entry key holds the offset of key + 1;
//   4. groups  a warp a (long row, segment) walks the group's list and
//              writes its partial into the slot's table (+0 if empty);
//   5. sum     a warp a row, its lanes the columns: a short row walks its
//              list in order, keeps the segment's partial and the row's sum
//              in registers and adds the partial when the segment changes; a
//              long row adds its S partials from the table in ascending s.
// A list walk loads 64 list entries with two coalesced loads, the next 64
// while it adds, and the 64 values' columns with loads that depend on
// nothing but those entries, so a batch of 64 adds waits on one load.  No
// (S, R, C) table: a long row needs more than kLongRow values, so at most
// N / (kLongRow + 1) rows are long.  Six launches a call, the zeroing of the
// scratch's counters first (five when no row can be long).
//
// What bounds it on the H100: bytes, N * (4 + 4C) + 4RC (idx and val read
// once, the table written once), plus the sort's scratch: the S * R counts
// (4 MB for the texel table of a 1024x1024 step) are zeroed, counted, read
// and written by the scan and read and advanced by place; perm (4N bytes)
// is written once and read once.  Operations: the N * C additions and a few
// integer steps a value.  What limits it in practice is latency: a row's
// sum is a chain of dependent additions, as long as the row (short) or its
// longest group (long), so the slowest row sets the time of the last pass,
// and the small tables of a step are bound by the launches.
#include <cuda_runtime.h>

#include <cstddef>

// A named namespace, so that a profiler's (demangled) kernel names say
// whose kernels these are: diff_accumulate::count_kernel, ...
namespace diff_accumulate {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanPerThread = 8;
constexpr int kScanKeys = kThreads * kScanPerThread;   // 2048 keys a block
constexpr int kLongRow = 1024;   // longer rows are summed group by group
constexpr int kGroupBlocksPerSm = 8;
constexpr int kHashBits = 9;
constexpr int kHashSlots = 1 << kHashBits;   // 2 * kThreads
constexpr unsigned long long kAggregate = 1ull << 32;   // look-back flags
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive scan of x over the block; *total gets the block's sum.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sum[kWarps];
  __shared__ int block_sum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? warp_sum[lane] : 0;
    int ti = t;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ti, d);
      if (lane >= d) ti += y;
    }
    if (lane < kWarps) warp_sum[lane] = ti - t;
    if (lane == kWarps - 1) block_sum = ti;
  }
  __syncthreads();
  *total = block_sum;
  return warp_sum[warp] + inc - x;
}

// 0. the scratch's first `words` words = 0
__global__ void __launch_bounds__(kThreads)
zero_kernel(int* __restrict__ scratch, long long words) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads)
                     + threadIdx.x;
       i < words; i += static_cast<long long>(gridDim.x) * kThreads)
    scratch[i] = 0;
}

// 1. counts[r * S + n / L] += 1 for every kept n
__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ idx, int* __restrict__ counts, int N,
             int R, int S, int L) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int r = n < N ? idx[n] : -1;
  const bool keep = r >= 0 && r < R;
  const int key = keep ? r * S + n / L : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (keep && (peers & lanemask_lt()) == 0)
    atomicAdd(&counts[key], __popc(peers));
}

// 2. counts -> exclusive offsets in key order, in place; a chunk is
// `rows` whole rows.  status (one word a chunk) and ticket start at 0.
__global__ void __launch_bounds__(kThreads)
scan_kernel(int* __restrict__ counts, unsigned long long* status,
            int* ticket, int R, int S, int rows, int* __restrict__ rowslot,
            int* __restrict__ longrows, int* __restrict__ nlong) {
  __shared__ int s_keys[kScanKeys + 1];
  __shared__ int s_chunk, s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_chunk = atomicAdd(ticket, 1);   // in start order
  __syncthreads();
  const int chunk = s_chunk;
  const int r0 = chunk * rows;
  const int len = min(rows, R - r0) * S;
  const size_t base = static_cast<size_t>(r0) * S;
  for (int i = threadIdx.x; i < kScanKeys; i += kThreads)
    s_keys[i] = i < len ? counts[base + i] : 0;
  __syncthreads();
  int v[kScanPerThread];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) {
    v[i] = s_keys[threadIdx.x * kScanPerThread + i];
    sum += v[i];
  }
  int total;
  const int ex = block_exclusive_scan(sum, &total);
  if (warp == 0) {                  // look back, 32 chunks at a time
    int prefix = 0;
    if (chunk > 0) {
      if (lane == 0)
        atomicExch(&status[chunk],
                   kAggregate | static_cast<unsigned>(total));
      for (int j = chunk - 1 - lane;; j -= 32) {
        unsigned long long word = j >= 0 ? atomicAdd(&status[j], 0ull)
                                         : kInclusive;   // before chunk 0
        while (__any_sync(0xffffffffu, word < kAggregate))
          if (word < kAggregate) word = atomicAdd(&status[j], 0ull);
        const unsigned done = __ballot_sync(0xffffffffu, word >= kInclusive);
        const int upto = done ? __ffs(done) - 1 : 31;
        int got = lane <= upto ? static_cast<int>(word & 0xffffffffu) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          got += __shfl_xor_sync(0xffffffffu, got, d);
        prefix += got;
        if (done) break;
      }
    }
    if (lane == 0) {
      atomicExch(&status[chunk],
                 kInclusive | static_cast<unsigned>(prefix + total));
      s_prefix = prefix;
      s_keys[kScanKeys] = prefix + total;
    }
  }
  __syncthreads();                  // every thread has read its counts
  int run = s_prefix + ex;
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) {
    s_keys[threadIdx.x * kScanPerThread + i] = run;
    run += v[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kThreads)
    counts[base + i] = s_keys[i];
  // past the chunk's keys (and at kScanKeys) every entry is its end
  for (int rr = threadIdx.x; rr < rows && r0 + rr < R; rr += kThreads) {
    int slot = -1;
    if (s_keys[(rr + 1) * S] - s_keys[rr * S] > kLongRow) {
      slot = atomicAdd(nlong, 1);
      longrows[slot] = r0 + rr;
    }
    rowslot[r0 + rr] = slot;
  }
}

// 3. one block a segment: perm[offset[key] + rank] = n, ranks ascending in
// n.  A chunk's rank of a value = the matches in the earlier warps of the
// chunk + its rank among its warp's peers.  The earlier warps' matches come
// from a hash table of the chunk's rows in shared memory (at most kThreads
// rows in kHashSlots slots: a free slot always exists), each slot holding
// the row's count in each warp, one byte a warp (a warp counts at most 32);
// the leader of a warp's peers inserts the row and adds its count.  Two
// tables are used in turn, so one is cleared while the other is read.
__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ idx, int* __restrict__ cursor,
             int* __restrict__ perm, int N, int R, int S, int L) {
  __shared__ int s_key[2][kHashSlots];
  __shared__ unsigned long long s_count[2][kHashSlots];
  const int seg = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = seg * L;
  const int n1 = min(N, n0 + L);
  for (int i = threadIdx.x; i < kHashSlots; i += kThreads) {
    s_key[0][i] = -1;
    s_count[0][i] = 0;
  }
  __syncthreads();
  int next = n0 + static_cast<int>(threadIdx.x) < n1 ? idx[n0 + threadIdx.x]
                                                     : -1;
  int t = 0;
  for (int base = n0; base < n1; base += kThreads, t ^= 1) {
    const int n = base + threadIdx.x;
    const int r = next >= 0 && next < R ? next : -1;
    const bool keep = r >= 0;
    const int key = keep ? r * S + seg : 0;
    const int start = keep ? cursor[key] : 0;
    next = n + kThreads < n1 ? idx[n + kThreads] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (keep && lane == leader) {
      unsigned h = (static_cast<unsigned>(r) * 2654435761u)
                   >> (32 - kHashBits);
      for (;;) {
        const int old = atomicCAS(&s_key[t][h], -1, r);
        if (old == -1 || old == r) break;
        h = (h + 1) & (kHashSlots - 1);
      }
      atomicAdd(&s_count[t][h],
                static_cast<unsigned long long>(__popc(peers)) << (8 * warp));
      slot = static_cast<int>(h);
    }
    slot = __shfl_sync(0xffffffffu, slot, leader);
    __syncthreads();                // the chunk's counts are in
    if (keep) {
      const unsigned long long word = s_count[t][slot];
      int earlier = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = static_cast<int>((word >> (8 * w)) & 0xffu);
        total += c;
        earlier += w < warp ? c : 0;
      }
      const int rank = earlier + __popc(peers & lanemask_lt());
      perm[start + rank] = n;
      if (rank == total - 1) cursor[key] = start + total;
    }
    for (int i = threadIdx.x; i < kHashSlots; i += kThreads) {
      s_key[t ^ 1][i] = -1;
      s_count[t ^ 1][i] = 0;
    }
    __syncthreads();                // cursors advanced, next table clear
  }
}

// The list walk of one warp, lane = column c: the values perm[j0, j1) in
// order.  kSegments: out = 0 + partial + partial + ..., a partial restarting
// where n / L changes; otherwise the one partial of a single group.  A
// batch is 64 values: two coalesced loads of list entries (made while the
// batch before adds) and 64 column loads that depend on nothing else, so
// the batch's adds wait on one round trip.  Every load is unconditional (a
// lane past the list or the columns reads a valid address and adds +0,
// which a sum from +0, never -0, does not change).
template <bool kSegments>
__device__ float walk(const int* __restrict__ perm,
                      const float* __restrict__ val, int C, int c, int j0,
                      int j1, int L) {
  constexpr int kBatch = 64;
  const int lane = threadIdx.x & 31;
  const bool col = c < C;
  const size_t cc = col ? c : C - 1;
  float out = 0.0f, part = 0.0f;
  int last_seg = -1;
  int next[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    next[h] = j0 < j1 ? perm[min(j0 + 32 * h + lane, j1 - 1)] : 0;
  for (int jb = j0; jb < j1; jb += kBatch) {
    const int m = min(kBatch, j1 - jb);
    int pn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pn[h] = next[h];
      if (jb + kBatch < j1)
        next[h] = perm[min(jb + kBatch + 32 * h + lane, j1 - 1)];
    }
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      v[k] = val[static_cast<size_t>(__shfl_sync(0xffffffffu, pn[k / 32],
                                                 k % 32)) * C + cc];
    unsigned starts[2] = {0u, 0u};
    if (kSegments) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sg = pn[h] / L;
        const int prev = __shfl_up_sync(0xffffffffu, sg, 1);
        starts[h] = __ballot_sync(
            0xffffffffu,
            32 * h + lane < m && sg != (lane == 0 ? last_seg : prev));
        last_seg = __shfl_sync(0xffffffffu, sg, 31);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const float x = k < m && col ? v[k] : 0.0f;
      if (kSegments) {
        const bool start = (starts[k / 32] >> (k % 32)) & 1u;
        out = start ? __fadd_rn(out, part) : out;
        part = start ? 0.0f : part;
      }
      part = __fadd_rn(part, x);
    }
  }
  return kSegments ? __fadd_rn(out, part) : part;
}

// 4. a warp a (long row, segment): the group's partial into the table
__global__ void __launch_bounds__(kThreads)
long_groups_kernel(const int* __restrict__ after, const int* __restrict__ perm,
                   const float* __restrict__ val,
                   const int* __restrict__ nlong,
                   const int* __restrict__ longrows, float* __restrict__ table,
                   int C, int S, int L) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const int items = *nlong * S;
  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); it < items;
       it += warps) {
    const int slot = it / S, s = it - slot * S;
    const int key = longrows[slot] * S + s;
    const int j0 = key == 0 ? 0 : after[key - 1];
    const int j1 = after[key];
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const float p = walk<false>(perm, val, C, c, j0, j1, L);
      if (c < C) table[(static_cast<size_t>(slot) * S + s) * C + c] = p;
    }
  }
}

// 5. a warp a row: out[r, :] in the pinned order
__global__ void __launch_bounds__(kThreads)
sum_kernel(const int* __restrict__ after, const int* __restrict__ perm,
           const float* __restrict__ val, const int* __restrict__ rowslot,
           const float* __restrict__ table, float* __restrict__ out, int R,
           int C, int S, int L) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int slot = rowslot[r];
  const int j0 = r == 0 ? 0 : after[r * S - 1];
  const int j1 = after[r * S + S - 1];
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.0f;
    if (slot < 0) {
      acc = walk<true>(perm, val, C, c, j0, j1, L);
    } else if (c < C) {
      const float* p = table + static_cast<size_t>(slot) * S * C + c;
      for (int sb = 0; sb < S; sb += 32) {
        float v[32];
#pragma unroll
        for (int k = 0; k < 32; ++k)
          v[k] = p[static_cast<size_t>(min(sb + k, S - 1)) * C];
#pragma unroll
        for (int k = 0; k < 32; ++k)
          acc = __fadd_rn(acc, sb + k < S ? v[k] : 0.0f);
      }
    }
    if (c < C) out[static_cast<size_t>(r) * C + c] = acc;
  }
}

}  // namespace diff_accumulate

// Launches every pass on `stream` and returns the first cudaError_t (0 =
// launched).  Device pointers: idx (N,) int32, val (N, C) float32, out (R, C)
// float32, and one scratch buffer of 32-bit words laid out as the wrapper's
// scratch_sizes() says: look-back status (2 a chunk of `rows` rows) |
// counts (S * R) | ticket | long-row count | row slots (R) | long rows
// (max_long) | perm (N) | the long rows' float partials (max_long, S, C).
// S segments of L values cover N; rows = max(1, 2048 / S); max_long >=
// min(R, N / 1025).  The scratch's length is checked.
extern "C" int skybox_diff_accumulate_rows(
    const void* idx, const void* val, void* scratch, void* out, int N, int R,
    int C, int S, int L, int max_long, int words, void* stream) {
  using namespace diff_accumulate;
  const long long keys = static_cast<long long>(S) * R;
  const int rows = S <= kScanKeys ? kScanKeys / S : 1;
  const long long chunks = (R + rows - 1) / rows;
  const long long long_bound = N / (kLongRow + 1) < R ? N / (kLongRow + 1)
                                                      : R;
  const long long zeroed = 2 * chunks + keys + 2;
  if (N < 0 || R <= 0 || C <= 0 || S <= 0 || L <= 0 || S > kScanKeys
      || static_cast<long long>(S) * L < N || keys >= (1ll << 31)
      || max_long < long_bound
      || words < zeroed + R + max_long + N
                 + static_cast<long long>(max_long) * S * C)
    return static_cast<int>(cudaErrorInvalidValue);
  // the long groups' grid: kGroupBlocksPerSm blocks an SM of this device
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(sms) * kGroupBlocksPerSm;
  const long long need = (static_cast<long long>(max_long) * S + kWarps - 1)
                         / kWarps;
  const int group_blocks = static_cast<int>(need < most ? need : most);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  int* counts = reinterpret_cast<int*>(status + chunks);
  int* ticket = counts + keys;
  int* nlong = ticket + 1;
  int* rowslot = nlong + 1;
  int* longrows = rowslot + R;
  int* perm = longrows + max_long;
  float* table = reinterpret_cast<float*>(perm + N);
  const int* idx_i = static_cast<const int*>(idx);
  const float* val_f = static_cast<const float*>(val);

  zero_kernel<<<static_cast<int>((zeroed - 1) / kThreads + 1), kThreads, 0,
                st>>>(static_cast<int*>(scratch), zeroed);
  if (N > 0)
    count_kernel<<<(N - 1) / kThreads + 1, kThreads, 0, st>>>(
        idx_i, counts, N, R, S, L);
  scan_kernel<<<static_cast<int>(chunks), kThreads, 0, st>>>(
      counts, status, ticket, R, S, rows, rowslot, longrows, nlong);
  place_kernel<<<S, kThreads, 0, st>>>(idx_i, counts, perm, N, R, S, L);
  if (max_long > 0)
    long_groups_kernel<<<group_blocks, kThreads, 0, st>>>(
        counts, perm, val_f, nlong, longrows, table, C, S, L);
  sum_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      counts, perm, val_f, rowslot, table, static_cast<float*>(out), R, C,
      S, L);
  return static_cast<int>(cudaGetLastError());
}
