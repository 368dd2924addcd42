// The sharded priority write, last writer wins, for Hopper.
//
// Replaces no Pallas kernel: the reference's sharded update is its dense
// update, an XLA scatter (`.at[idx].set`, repro/core/sharded.py), split
// into shards after.  A CUDA scatter has no defined winner among
// duplicate rows, and the port's first answer, a b x b comparison of the
// rows (core/amper.py::last_writer) for each shard and each field, took
// ~1.4 s on an H100 at b = 65,536 over 16 shards.  Same function as the
// port's kernels/ref.py::write_last_ref:
//
//   for j in 0 .. b-1, in order, for every field f:
//     if shard(idx[j]) is held here:
//       table[f][shard(idx[j])][idx[j] % n_local] = values[f][j]
//
// with shard(r) = r / n_local; rows of shards held elsewhere (another
// rank or card) and negative rows are skipped.
//
// Bound: bytes.  Each position's row and values are read once (4 or 8 B
// of row, 5 B of AMPER-fr's code and live flag, 4 B of PER's priority)
// and each distinct row's fields written once: 0.89 MB for the 2^28
// cell's two writes of a request, 0.27 us at 3.35 TB/s.  What remains is
// the launch, one grid-wide barrier and two dependent round trips to L2
// (claim, then check the slot).
//
// Design: one cooperative launch, every block resident, positions in a
// grid-stride loop.
//   * Claim pass: position j puts ((row + 1) << 32 | (j + 1)) into an
//     open-addressing table of 2^bits >= 2b 64-bit slots (the scratch),
//     probing linearly from a multiplicative hash of the row: a CAS into
//     an empty slot, or, in the slot that already holds the row, an
//     atomicMax, which keeps the largest position since the row's half is
//     the same.  It keeps its slot in `where[j]` (-1: skipped).
//   * One grid barrier.
//   * Write pass: position j reads its slot; the one position whose
//     number the slot holds is the row's last writer, stores every
//     field's value at the shard's local row (the held shards' numbers
//     and pointers are in the launch's parameters, searched in order)
//     and zeroes the slot.  A position
//     that reads the slot after that sees 0, which names no position, so
//     exactly one store per distinct row, and no race.
// Every slot a call claims is zeroed by the same call, so the table is
// empty again at its end: no fill before a call, nothing counted on the
// host, and a call can be captured in a CUDA graph.  The result is
// integer selection, independent of block order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// The wrapper (kernels/write_last.py) keeps these limits.
constexpr int kMaxFields = 2;  // AMPER-fr's code and live flag
constexpr int kMaxHeld = 32;   // shards held on one device

struct Params {
  const void* idx;
  int idx64;             // 1: int64 rows, 0: int32
  int b;
  long long n_local;     // rows of a shard
  int fields;
  int n_held;
  const void* values[kMaxFields];
  int size[kMaxFields];  // bytes of an element: 1 or 4
  void* table[kMaxFields][kMaxHeld];
  int shard[kMaxHeld];   // the held shards' numbers
  unsigned long long* slots;
  int bits;
  int* where;
};

__device__ __forceinline__ long long row_at(const Params& P, int j) {
  return P.idx64 ? static_cast<const long long*>(P.idx)[j]
                 : static_cast<long long>(static_cast<const int*>(P.idx)[j]);
}

// The held index of row r's shard, or -1.
__device__ __forceinline__ int held(const Params& P, long long r) {
  if (r < 0) return -1;
  const long long s = r / P.n_local;
  for (int k = 0; k < P.n_held; ++k)
    if (P.shard[k] == s) return k;
  return -1;
}

__device__ __forceinline__ void store(const Params& P, int f, int h,
                                      long long local, int j) {
  if (P.size[f] == 1) {
    static_cast<char*>(P.table[f][h])[local] =
        static_cast<const char*>(P.values[f])[j];
  } else {
    static_cast<int32_t*>(P.table[f][h])[local] =
        static_cast<const int32_t*>(P.values[f])[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    write_last_kernel(const __grid_constant__ Params P) {
  const int stride = gridDim.x * kThreads;
  const unsigned long long mask = (1ull << P.bits) - 1;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < P.b; j += stride) {
    const long long r = row_at(P, j);
    int slot = -1;
    if (held(P, r) >= 0) {
      const unsigned long long mine =
          (static_cast<unsigned long long>(r + 1) << 32) |
          static_cast<unsigned>(j + 1);
      unsigned long long h =
          (static_cast<unsigned long long>(r) * 0x9E3779B97F4A7C15ull) >>
          (64 - P.bits);
      while (true) {
        const unsigned long long old = atomicCAS(P.slots + h, 0ull, mine);
        if (old == 0) break;
        if ((old >> 32) == (mine >> 32)) {
          atomicMax(P.slots + h, mine);
          break;
        }
        h = (h + 1) & mask;
      }
      slot = static_cast<int>(h);
    }
    P.where[j] = slot;
  }
  cg::this_grid().sync();
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < P.b; j += stride) {
    const int slot = P.where[j];
    if (slot < 0) continue;
    const unsigned long long w = __ldcg(P.slots + slot);
    if (static_cast<unsigned>(w) != static_cast<unsigned>(j + 1)) continue;
    const long long r = static_cast<long long>(w >> 32) - 1;
    const int h = held(P, r);
    const long long local = r - P.shard[h] * P.n_local;
    for (int f = 0; f < P.fields; ++f) store(P, f, h, local, j);
    P.slots[slot] = 0;
  }
}

int g_blocks_per_sm = 0;  // resident blocks an SM (0: not asked yet)

}  // namespace

// values: `fields` device pointers of b elements of `sizes` bytes (1 or
// 4); tables: `fields` x `n_held` device pointers, field-major, each the
// n_local rows of shard shards[k]; slots: 2^bits 64-bit words with
// 2^bits >= 2b, zero when made and left zero by every call; where: b
// int32.  Calls on one slots buffer must not run at once (the wrapper
// keeps one a stream).  The wrapper checks the limits: at most kMaxFields
// fields and kMaxHeld distinct held shards, and every held row below
// 2^32 - 1.  One cooperative launch on `stream` (none for b = 0);
// returns its error, or 0.
extern "C" int write_last_launch(const void* idx, int idx64, int b,
                                 long long n_local, int fields,
                                 const void* const* values, const int* sizes,
                                 void* const* tables, int n_held,
                                 const int* shards, void* slots, int bits,
                                 void* where, int sms, void* stream) {
  if (b == 0 || n_held == 0) return cudaSuccess;
  Params P;
  P.idx = idx;
  P.idx64 = idx64;
  P.b = b;
  P.n_local = n_local;
  P.fields = fields;
  P.n_held = n_held;
  for (int f = 0; f < fields; ++f) {
    P.values[f] = values[f];
    P.size[f] = sizes[f];
    for (int k = 0; k < n_held; ++k) P.table[f][k] = tables[f * n_held + k];
  }
  for (int k = 0; k < n_held; ++k) P.shard[k] = shards[k];
  P.slots = static_cast<unsigned long long*>(slots);
  P.bits = bits;
  P.where = static_cast<int*>(where);
  if (g_blocks_per_sm == 0) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, write_last_kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_blocks_per_sm = n;
  }
  const long long want = (static_cast<long long>(b) + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(g_blocks_per_sm) * sms;
  const int grid = static_cast<int>(want < most ? want : most);
  if (grid < 1) return cudaErrorInvalidValue;
  void* args[] = {&P};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(write_last_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* write_last_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
