// Fused slice-range merge of a window query: fold every slice row by its
// per-(slice, row) delta of uniform-collapse levels and sum the slice axis
// into one (R, m) float32 row block per store.  A delta-level fold sends
// bucket i (key offset + i) to ceil((offset + i) / 2^delta) - offset; a
// negative delta marks a dead slice, which is never read.
//
// The slices are read where they lie: D slab nodes picked by a (D,) index
// tensor out of a (nodes, R, m) store, then optionally the live bank
// (R, m).  The window path passes the slab's pos and neg stores and the
// live bank's, so both stores of a query ride one launch (blockIdx.y picks
// the store) and share one (D + 1, R) delta tensor; the stacked front door
// passes one (D, R, m) block as D nodes with no live slice.  Counts are
// float32 or int32 (converted to float32 on load, exact below 2^24).
//
// Replaces: src/repro/kernels/bank_range_merge.py, _range_merge_kernel (the
// Pallas TPU kernel behind bank_range_merge_pallas).  Contract: the plain
// version repro_torch.kernels.ref.bank_range_merge_ref over the stacked
// block.
//
// What bounds it on an H100: memory.  Every live slice row is read once and
// every output written once, (live slices + 1) * R * m * 4 bytes (0.8 GB
// at 11 live slices of R = 8192, m = 2048), with one add per count read.
//
// What the design does about it: one CTA owns one (store, row).  For each
// live slice, in the fixed order d = 0..D-1 and then the live bank, the CTA
// copies the slice's whole row into shared memory with cp.async, 16 bytes
// a thread with neighbouring threads on neighbouring addresses (4 bytes
// when a row is not 16-byte aligned), so the reads coalesce at every
// delta.  A ring of six row buffers keeps five rows in flight while one
// folds.  The fold runs out of shared memory into registers: thread t owns
// buckets t, t + 256, ...; at delta 0 it adds its own buckets, at delta > 0
// the destinations that receive anything form one contiguous range, which
// maps onto consecutive threads, and each owner adds its contiguous run of
// at most 2^delta sources in ascending order.  The row copy leaves a gap of
// four words after every 32, so the runs that neighbouring threads read
// 2^delta words apart spread over the banks.  The output row is written
// once, coalesced.  Every destination sums its slices in order and each run
// ascending, the order of the plain per-bucket loop: integer-valued counts
// are bit-exact against the plain version, fractional sums repeat from run
// to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSkew = 4;  // words of gap after every 32 words of a staged row

struct MergeArgs {
  const void* store[2];  // (nodes, R, m) slice stores, counts of T
  const void* live[2];   // (R, m) live slices of T, or null
  float* out[2];         // (R, m) float32
  const int* nodes;      // (D,) node of each slice, or null for node d
  const int* deltas;     // (D + has_live, R): -1 dead, else 0..6
  int num_nodes;         // D
  int has_live;
  int rows;              // R
  int m;
  int offset;
  int vec;               // every row is 16-byte aligned
};

__host__ __device__ __forceinline__ int skewed(int i) { return i + (i >> 5) * kSkew; }

// Words of one staged row buffer, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int row_words(int m) { return (skewed(m - 1) + 4) & ~3; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return static_cast<float>(v); }

// STAGES row buffers; each thread owns PER buckets (m <= PER * kThreads).
template <typename T, int STAGES, int PER>
__global__ void __launch_bounds__(kThreads)
range_merge_kernel(MergeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = a.m;
  const int slices = a.num_nodes + a.has_live;
  const int words = row_words(m);
  T* bufs = reinterpret_cast<T*>(smem_raw);
  int* s_delta = reinterpret_cast<int*>(bufs + STAGES * words);
  const int r = blockIdx.x;
  const int y = blockIdx.y;
  const T* store = static_cast<const T*>(a.store[y]);
  const T* live = static_cast<const T*>(a.live[y]);

  for (int d = threadIdx.x; d < slices; d += kThreads)
    s_delta[d] = a.deltas[static_cast<long long>(d) * a.rows + r];
  __syncthreads();

  auto next_live = [&](int d) {
    while (d < slices && s_delta[d] < 0) ++d;
    return d;
  };
  auto issue = [&](int d, int stage) {
    const T* src;
    if (d < a.num_nodes) {
      const long long node = a.nodes != nullptr ? a.nodes[d] : d;
      src = store + (node * a.rows + r) * static_cast<long long>(m);
    } else {
      src = live + static_cast<long long>(r) * m;
    }
    T* dst = bufs + stage * words;
    if (a.vec) {
      for (int c = threadIdx.x; c < m / 4; c += kThreads)
        cp_async16(dst + skewed(4 * c), src + 4 * c);
    } else {
      for (int i = threadIdx.x; i < m; i += kThreads) cp_async4(dst + skewed(i), src + i);
    }
  };

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.0f;
  // prologue: the first STAGES - 1 live rows in flight, one commit group each
  int ld = next_live(0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ld < slices) {
      issue(ld, s);
      ld = next_live(ld + 1);
    }
    cp_async_commit();
  }
  int cur = next_live(0);
  for (int it = 0; cur < slices; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of `cur` have landed
    __syncthreads();              // and every thread's; the stage refilled below was
                                  // folded last iteration
    if (ld < slices) {
      issue(ld, (it + STAGES - 1) % STAGES);
      ld = next_live(ld + 1);
    }
    cp_async_commit();
    const T* now = bufs + (it % STAGES) * words;
    const int delta = s_delta[cur];
    if (delta == 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int b = threadIdx.x + j * kThreads;
        if (b < m) acc[j] += as_f32(now[skewed(b)]);
      }
    } else {
      const int span = 1 << delta;
      // destinations of keys offset .. offset + m - 1: ceil(key / 2^delta)
      const int first = max(-((-a.offset) >> delta) - a.offset, 0);
      const int last = min(-((-(a.offset + m - 1)) >> delta) - a.offset, m - 1);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int b = threadIdx.x + j * kThreads;
        if (b >= first && b <= last) {
          const int t = b + a.offset;  // destination key
          const int lo = max((t - 1) * span + 1 - a.offset, 0);
          const int hi = min(t * span - a.offset, m - 1);
          float sum = acc[j];
          for (int i = lo; i <= hi; ++i) sum += as_f32(now[skewed(i)]);
          acc[j] = sum;
        }
      }
    }
    cur = next_live(cur + 1);
  }
  float* out = a.out[y] + static_cast<long long>(r) * m;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int b = threadIdx.x + j * kThreads;
    if (b < m) out[b] = acc[j];
  }
}

template <typename T, int STAGES, int PER>
int launch(const MergeArgs& a, int stores, cudaStream_t stream) {
  const int slices = a.num_nodes + a.has_live;
  const size_t smem = sizeof(T) * STAGES * row_words(a.m) + sizeof(int) * slices;
  cudaError_t err = repro::allow_smem(range_merge_kernel<T, STAGES, PER>, smem);
  if (err != cudaSuccess) return err;
  range_merge_kernel<T, STAGES, PER><<<dim3(a.rows, stores), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Six stages up to m = 2048 (about 55 KB of shared memory), two beyond.
template <typename T>
int launch_for(const MergeArgs& a, int stores, cudaStream_t stream) {
  if (a.m <= 8 * kThreads) return launch<T, 6, 8>(a, stores, stream);
  if (a.m <= 64 * kThreads) return launch<T, 2, 64>(a, stores, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch over `stores` (1 or 2) stores, m <= 16384.  store_*: (nodes,
// R, m) counts (int32 when counts_int, else float32); live_*: (R, m) of the
// same type, or null when has_live is 0; out_*: (R, m) float32; nodes: (D,)
// int32 or null for nodes 0..D-1; deltas: (D + has_live, R) int32, -1 for a
// dead slice, else the fold depth 0..6; vec: every slice row starts on a
// 16-byte boundary.
extern "C" int bank_range_merge(const void* store_a, const void* store_b, const void* live_a,
                                const void* live_b, float* out_a, float* out_b, const int* nodes,
                                const int* deltas, int stores, int num_nodes, int has_live,
                                int rows, int m, int offset, int counts_int, int vec,
                                void* stream_handle) {
  if (rows <= 0 || m <= 0) return cudaSuccess;
  MergeArgs a;
  a.store[0] = store_a;
  a.store[1] = store_b;
  a.live[0] = live_a;
  a.live[1] = live_b;
  a.out[0] = out_a;
  a.out[1] = out_b;
  a.nodes = nodes;
  a.deltas = deltas;
  a.num_nodes = num_nodes;
  a.has_live = has_live;
  a.rows = rows;
  a.m = m;
  a.offset = offset;
  a.vec = vec;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return counts_int ? launch_for<int>(a, stores, stream) : launch_for<float>(a, stores, stream);
}
